"""The PyTorch port's host data layer against the JAX package's on CPU:
the PFM reader, the FlyingThings3D set file and decoder, load_image, the
triplet datasets, file_cache, PrefetchLoader and prefetch_iterator, on
tiny fixtures each test writes itself in the datasets' own layouts.

The loaders' batches must be bit-equal to JAX's for the same seed (one
worker; YouTube-VOS draws its gaps from one RandomState shared by the
worker threads, so its order is reproducible with one worker only, in
both packages). Two deliberate differences from JAX's PrefetchLoader are
held here: an exception of sample_fn reaches the consumer (JAX's waits
forever), and a shard smaller than one batch under drop_remainder is
refused at construction (JAX's producer spins without yielding).
"""

import threading
from pathlib import Path

import numpy as np
import pytest

from qpwcnet_tpu.data import fchairs3d as j_fc3d
from qpwcnet_tpu.data import pipeline as j_pipeline
from qpwcnet_tpu.data import triplet as j_triplet
from qpwcnet_tpu.data.pfm import read_pfm as j_read_pfm
from qpwcnet_tpu.utils import cache as j_cache
from qpwcnet_torch.data import fchairs3d, pipeline, triplet
from qpwcnet_torch.data.pfm import read_pfm
from qpwcnet_torch.utils import cache


# -------------------------------------------------------------- fixtures

def write_pfm(path, arr: np.ndarray, little: bool = True,
              comment: bool = False) -> None:
    """A PFM file of arr, (H, W, 3) or (H, W) float32, rows bottom-up."""
    h, w = arr.shape[:2]
    header = (b"PF\n" if arr.ndim == 3 else b"Pf\n")
    if comment:
        header += b"# a comment\n"
    header += f"{w} {h}\n{-1.0 if little else 1.0}\n".encode()
    data = np.flipud(arr).astype("<f4" if little else ">f4")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(header + data.tobytes())


def _rgb(rng, h, w) -> np.ndarray:
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def write_fc3d(root, seqs=(("A", "0000", 5), ("B", "0001", 3)), h=24, w=40,
               seed=0, nan_at=None) -> None:
    """A FlyingThings3D tree: per (letter, sequence, frames) WebP frames
    numbered from 6 and each frame's into-future PFM flow (3 channels),
    a NaN in the flow of frame index ``nan_at`` of the first sequence."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    root = Path(root)
    for s, (letter, seq, n) in enumerate(seqs):
        left = root / "frames_finalpass_webp" / "TRAIN" / letter / seq / \
            "left"
        left.mkdir(parents=True)
        flo_dir = (root / "optical_flow" / "TRAIN" / letter / seq /
                   "into_future" / "left")
        for k in range(n):
            i = 6 + k
            Image.fromarray(_rgb(rng, h, w)).save(left / f"{i:04d}.webp",
                                                  quality=90)
            flo = rng.uniform(-5, 5, (h, w, 3)).astype(np.float32)
            if s == 0 and k == nan_at:
                flo[2, 3, 0] = np.nan
            write_pfm(flo_dir / f"OpticalFlowIntoFuture_{i:04d}_L.pfm", flo)


def write_vimeo(root, train=("00001/0001", "00001/0002", "00002/0001"),
                test=("00003/0001",), h=20, w=36, seed=1) -> None:
    """A Vimeo-90K triplet tree: sequences/<key>/im{1,2,3}.png and the
    train and test lists."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    root = Path(root)
    for key in train + test:
        d = root / "sequences" / key
        d.mkdir(parents=True)
        for i in (1, 2, 3):
            Image.fromarray(_rgb(rng, h, w)).save(d / f"im{i}.png")
    (root / "tri_trainlist.txt").write_text("\n".join(train) + "\n\n")
    (root / "tri_testlist.txt").write_text("\n".join(test) + "\n")


def write_ytvos(root, split="train", frames=(12, 5, 3, 2, 9), h=18, w=32,
                seed=2) -> None:
    """A YouTube-VOS tree: <split>/JPEGImages/<video>/<frame>.jpg, one
    video a nonzero count of ``frames`` (one with 2 frames, which is left
    out)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for v, n in enumerate(frames):
        if not n:
            continue
        d = Path(root) / split / "JPEGImages" / f"vid{v:03d}"
        d.mkdir(parents=True)
        for k in range(n):
            Image.fromarray(_rgb(rng, h, w)).save(d / f"{5 * k:05d}.jpg")


def _equal_batches(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)
        for x, y in zip(a, b))


def _take(it, n):
    return [next(it) for _ in range(n)]


# ------------------------------------------------------------------- PFM

@pytest.mark.parametrize("shape, little, comment", [
    ((6, 7, 3), True, False), ((6, 7), False, True), ((5, 4, 3), False,
                                                      False)])
def test_read_pfm_matches_jax(tmp_path, shape, little, comment):
    arr = np.random.RandomState(3).uniform(-9, 9, shape).astype(np.float32)
    arr.flat[5] = np.nan
    write_pfm(tmp_path / "f.pfm", arr, little, comment)
    got = read_pfm(tmp_path / "f.pfm")
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, j_read_pfm(tmp_path / "f.pfm"))


def test_read_pfm_refuses_other_files(tmp_path):
    (tmp_path / "x.pfm").write_bytes(b"P6\n2 2\n255\n")
    with pytest.raises(ValueError, match="not a PFM"):
        read_pfm(tmp_path / "x.pfm")
    (tmp_path / "y.pfm").write_bytes(b"PF\n2 two\n-1\n")
    with pytest.raises(ValueError, match="malformed"):
        read_pfm(tmp_path / "y.pfm")


# -------------------------------------------------------- FlyingThings3D

def test_fc3d_set_file_and_pairs_match_jax(tmp_path):
    write_fc3d(tmp_path / "f3d")
    n = fchairs3d.write_set_file(tmp_path / "f3d", tmp_path / "port.txt")
    j_n = j_fc3d.write_set_file(tmp_path / "f3d", tmp_path / "jax.txt")
    assert n == j_n == 4 + 2
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    pairs = fchairs3d.read_set_file(tmp_path / "port.txt")
    assert pairs == j_fc3d.read_set_file(tmp_path / "jax.txt")
    assert pairs == list(fchairs3d.fc3d_pairs(tmp_path / "f3d"))
    assert pairs[0][0].endswith("A/0000/left/0006.webp")
    assert pairs[0][2].endswith("OpticalFlowIntoFuture_0006_L.pfm")


def test_decode_pair_and_iterator_match_jax(tmp_path):
    write_fc3d(tmp_path / "f3d", nan_at=1)
    fchairs3d.write_set_file(tmp_path / "f3d", tmp_path / "set.txt")
    pairs = fchairs3d.read_set_file(tmp_path / "set.txt")
    ims, flo = fchairs3d.decode_pair(*pairs[0])
    assert ims.shape == (24, 40, 6) and ims.dtype == np.uint8
    assert flo.shape == (24, 40, 2) and flo.dtype == np.float32
    assert flo.flags["C_CONTIGUOUS"]
    got = list(fchairs3d.fc3d_iterator(tmp_path / "set.txt", seed=4))
    want = list(j_fc3d.fc3d_iterator(tmp_path / "set.txt", seed=4))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert _equal_batches(g, w)
    assert sum(np.isnan(f).any() for _, f in got) == 1


# ------------------------------------------------------------ load_image

@pytest.mark.parametrize("ext, size", [
    ("png", None), ("jpg", None), ("png", (10, 16)), ("jpg", (31, 50)),
    ("webp", (12, 20))])
def test_load_image_matches_jax(tmp_path, ext, size):
    from PIL import Image

    path = tmp_path / f"im.{ext}"
    Image.fromarray(_rgb(np.random.RandomState(5), 22, 34)).save(path)
    got = pipeline.load_image(path, size)
    assert got.dtype == np.uint8
    assert got.shape == ((22, 34) if size is None else size) + (3,)
    np.testing.assert_array_equal(got, j_pipeline.load_image(path, size))


# ---------------------------------------------------------- the triplets

def test_vimeo_triplet_matches_jax(tmp_path):
    write_vimeo(tmp_path)
    for split in ("train", "test"):
        got = triplet.VimeoTriplet(tmp_path, split)
        want = j_triplet.VimeoTriplet(tmp_path, split)
        assert got.keys() == want.keys() and len(got) == len(want)
        assert [got[k] for k in got.keys()] == list(want)
    assert len(triplet.VimeoTriplet(tmp_path)) == 3
    assert triplet.VimeoTriplet(tmp_path)["00001/0002"][2].endswith(
        "sequences/00001/0002/im3.png")


def test_youtube_vos_matches_jax(tmp_path):
    """Keys and the gap draws, call for call, against JAX's; the index is
    scanned once and then read from the cache (a video added later is not
    seen)."""
    write_ytvos(tmp_path / "ytvos")
    got = triplet.YoutubeVos(tmp_path / "ytvos", seed=7,
                             cache_dir=tmp_path / "pc")
    want = j_triplet.YoutubeVos(tmp_path / "ytvos", seed=7,
                                cache_dir=tmp_path / "jc")
    assert got.keys() == want.keys() == ["vid000", "vid001", "vid002",
                                         "vid004"]
    for _ in range(3):
        assert [got[k] for k in got.keys()] == [want[k]
                                                for k in want.keys()]
    assert (tmp_path / "pc" / "ytvos_train_index.json").read_text() == \
        (tmp_path / "jc" / "ytvos_train_index.json").read_text()
    write_ytvos(tmp_path / "ytvos", frames=(0,) * 5 + (4,))  # vid005
    again = triplet.YoutubeVos(tmp_path / "ytvos", cache_dir=tmp_path / "pc")
    assert again.keys() == got.keys()
    d = got["vid002"]
    assert d == (tuple(sorted(d)))


def test_dummy_triplet_dataset_matches_jax():
    got = triplet.DummyTripletDataset(n=5, hw=(12, 20))
    want = j_triplet.DummyTripletDataset(n=5, hw=(12, 20))
    assert got.keys() == want.keys() and len(got) == 5
    p, q = got[3][0], want[3][0]
    np.testing.assert_array_equal(pipeline.load_image(p),
                                  j_pipeline.load_image(q))
    assert not pipeline.load_image(p).any()
    folder = Path(p).parent
    del got
    assert not folder.exists()


def test_file_cache_matches_jax(tmp_path, monkeypatch):
    calls = []

    def scan():
        calls.append(1)
        return {"b": [1, 2], "a": "x"}

    monkeypatch.setenv("QPWCNET_TORCH_CACHE", str(tmp_path / "env"))
    cached = cache.file_cache("probe")(scan)
    assert cached() == scan() and cached() == {"b": [1, 2], "a": "x"}
    assert len(calls) == 2  # scan() itself once, the decorated fn once
    j_cache.file_cache("probe", cache_dir=tmp_path / "jax")(scan)()
    assert (tmp_path / "env" / "probe.json").read_text() == \
        (tmp_path / "jax" / "probe.json").read_text()
    other = cache.file_cache("probe", cache_dir=tmp_path / "arg")(scan)
    other()
    assert (tmp_path / "arg" / "probe.json").exists()


# ---------------------------------------------------------------- loader

def _sample(i: int):
    rng = np.random.RandomState(100 + i)
    return (rng.randint(0, 256, (3, 4, 6)).astype(np.uint8),
            np.full((3, 4, 2), float(i), np.float32))


@pytest.mark.parametrize("kw", [
    dict(), dict(seed=5, shuffle=True), dict(shuffle=False),
    dict(drop_remainder=False), dict(shard_index=1, shard_count=2)])
def test_prefetch_loader_matches_jax(kw):
    """Eight batches (several epochs) bit-equal to JAX's with one worker,
    and the same with four."""
    args = (_sample, 10, 3)
    want = j_pipeline.PrefetchLoader(*args, n_workers=1, **kw)
    w = _take(iter(want), 8)
    want.close()
    for n_workers in (1, 4):
        got = pipeline.PrefetchLoader(*args, n_workers=n_workers, **kw)
        g = _take(iter(got), 8)
        got.close()
        assert all(_equal_batches(a, b) for a, b in zip(g, w))


def test_prefetch_loader_shards_are_disjoint_and_complete():
    idx = []
    for s in range(3):
        loader = pipeline.PrefetchLoader(_sample, 11, 2, seed=3,
                                         drop_remainder=False, repeat=False,
                                         shard_index=s, shard_count=3)
        idx.append([int(v) for b in loader for v in b[1][:, 0, 0, 0]])
    flat = sorted(v for shard in idx for v in shard)
    assert flat == list(range(11))
    assert [len(s) for s in idx] == [4, 4, 3]
    with pytest.raises(ValueError, match="bad shard"):
        pipeline.PrefetchLoader(_sample, 11, 2, shard_index=3, shard_count=3)


def _drain_in_thread(it, timeout=30.0):
    """Iterate ``it`` in a thread; returns (items, exception), failing
    the test if it is still running after ``timeout`` s (a hang)."""
    out = {"items": [], "exc": None}

    def run():
        try:
            for item in it:
                out["items"].append(item)
        except Exception as e:  # the test reads it
            out["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the loader hung"
    return out["items"], out["exc"]


def test_prefetch_loader_raises_a_sample_error():
    def bad(i):
        if i == 4:
            raise OSError(f"cannot decode sample {i}")
        return _sample(i)

    loader = pipeline.PrefetchLoader(bad, 10, 2, shuffle=False)
    items, exc = _drain_in_thread(iter(loader))
    assert len(items) == 2
    assert isinstance(exc, OSError) and "sample 4" in str(exc)


def test_prefetch_loader_refuses_a_shard_below_one_batch():
    with pytest.raises(ValueError, match="fewer than one batch"):
        pipeline.PrefetchLoader(_sample, 7, 4, shard_index=1, shard_count=2)
    with pytest.raises(ValueError, match="fewer than one batch"):
        pipeline.PrefetchLoader(_sample, 0, 1, drop_remainder=False)
    # without drop_remainder a short shard makes short batches
    loader = pipeline.PrefetchLoader(_sample, 7, 4, drop_remainder=False,
                                     repeat=False, shard_index=1,
                                     shard_count=2)
    items, exc = _drain_in_thread(iter(loader))
    assert exc is None and [len(b[0]) for b in items] == [3]


def test_prefetch_iterator():
    assert list(pipeline.prefetch_iterator(iter(range(7)), depth=2)) == \
        list(range(7))

    def broken():
        yield 1
        raise KeyError("gone")

    items, exc = _drain_in_thread(pipeline.prefetch_iterator(broken()))
    assert items == [1] and isinstance(exc, KeyError)
    # a consumer that stops early stops the worker too
    it = pipeline.prefetch_iterator(iter(range(10 ** 6)), depth=1)
    assert next(it) == 0
    it.close()


def test_sample_fns_match_jax(tmp_path):
    write_vimeo(tmp_path / "vimeo")
    write_fc3d(tmp_path / "f3d")
    got = pipeline.triplet_sample_fn(triplet.VimeoTriplet(tmp_path /
                                                          "vimeo"), (8, 12))
    want = j_pipeline.triplet_sample_fn(
        j_triplet.VimeoTriplet(tmp_path / "vimeo"), (8, 12))
    for i in range(3):
        assert _equal_batches(got(i), want(i)) and got(i)[0].shape == \
            (8, 12, 3)
    pairs = list(fchairs3d.fc3d_pairs(tmp_path / "f3d"))
    got = pipeline.flow_sample_fn(pairs, fchairs3d.decode_pair)
    want = j_pipeline.flow_sample_fn(pairs, j_fc3d.decode_pair)
    assert _equal_batches(got(2), want(2))


@pytest.mark.parametrize("data", ["vimeo", "ytvos"])
def test_triplet_loader_matches_jax(tmp_path, data):
    """The triplet datasets through the loader, bit-equal to JAX's for
    the same seed with one worker."""
    if data == "vimeo":
        write_vimeo(tmp_path / "d")
        port, jax_ds = (triplet.VimeoTriplet(tmp_path / "d"),
                        j_triplet.VimeoTriplet(tmp_path / "d"))
    else:
        write_ytvos(tmp_path / "d")
        port = triplet.YoutubeVos(tmp_path / "d", cache_dir=tmp_path / "p")
        jax_ds = j_triplet.YoutubeVos(tmp_path / "d",
                                      cache_dir=tmp_path / "j")
    got = pipeline.PrefetchLoader(pipeline.triplet_sample_fn(port, (8, 12)),
                                  len(port), 2, seed=1, n_workers=1)
    want = j_pipeline.PrefetchLoader(
        j_pipeline.triplet_sample_fn(jax_ds, (8, 12)), len(jax_ds), 2,
        seed=1, n_workers=1)
    g, w = _take(iter(got), 5), _take(iter(want), 5)
    got.close()
    want.close()
    assert all(_equal_batches(a, b) for a, b in zip(g, w))
