"""Input pipeline (port of qpwcnet_tpu/data/pipeline.py): host threads
that read, decode and batch samples, and the batch preprocessing on the
batch's device.

  * host: file reads, PNG/WebP/JPEG/PFM/.flo decoding and batching
    (:class:`PrefetchLoader`, :func:`prefetch_iterator`);
  * device: /255, the flow or triplet augmentation (data/augment.py) or
    the plain resize, -0.5 and the NaN scrub (FlyingThings3D's flow holds
    NaNs).

Two differences from the JAX loader, both so that a fault ends a run
instead of hanging it: an exception raised while producing a batch (a
decode error in ``sample_fn``, an error of the iterator) is raised again
in the consumer, where JAX's consumer waits forever; and a loader whose
shard holds fewer samples than one batch under ``drop_remainder`` is
refused at construction, where JAX's producer spins without yielding.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from qpwcnet_torch.data.augment import (
    apply_flow_augmentation,
    augment_triplet_batch,
)
from qpwcnet_torch.ops.resize import resize_bilinear, spread_nonfinite


# ------------------------------------------------------------------ host

class _Raised:
    """A producer's exception on its way to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put item in q unless stop is set first; True when it went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


class PrefetchLoader:
    """Background-thread batch producer.

    sample_fn(index) -> tuple of numpy arrays; each batch stacks
    batch_size samples along axis 0 and goes into a bounded queue. Every
    epoch shuffles the whole index list with one ``RandomState(seed)``
    (the JAX loader's order, so the same seed gives the same batches) and
    keeps ``order[shard_index::shard_count]``: every process shuffles the
    same order and takes a disjoint slice, whose union covers each epoch
    once. Pass the process group's rank and world size (0 and 1 without
    one). ``n_workers`` threads call sample_fn; the order of a batch's
    samples does not depend on them.
    """

    def __init__(
        self,
        sample_fn: Callable[[int], Tuple[np.ndarray, ...]],
        n_samples: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        n_workers: int = 4,
        prefetch: int = 2,
        repeat: bool = True,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        if not (0 <= shard_index < shard_count):
            raise ValueError(f"bad shard {shard_index}/{shard_count}")
        shard = len(range(shard_index, n_samples, shard_count))
        if shard < (batch_size if drop_remainder else 1):
            raise ValueError(
                f"shard {shard_index}/{shard_count} of {n_samples} samples "
                f"holds {shard}, fewer than one batch of {batch_size}"
                + (" (drop_remainder)" if drop_remainder else ""))
        self.sample_fn = sample_fn
        self.n_samples = n_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.n_workers = n_workers
        self.repeat = repeat
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _batches(self, pool) -> Iterator[Tuple[np.ndarray, ...]]:
        rng = np.random.RandomState(self.seed)
        while True:
            order = np.arange(self.n_samples)
            if self.shuffle:
                rng.shuffle(order)
            order = order[self.shard_index::self.shard_count]
            for i in range(0, len(order), self.batch_size):
                idx = order[i:i + self.batch_size]
                if self.drop_remainder and len(idx) < self.batch_size:
                    break
                samples = list(pool.map(self.sample_fn, idx.tolist()))
                yield tuple(np.stack([s[k] for s in samples])
                            for k in range(len(samples[0])))
            if not self.repeat:
                return

    def _produce(self):
        try:
            with ThreadPoolExecutor(self.n_workers) as pool:
                for batch in self._batches(pool):
                    if not _put(self._q, batch, self._stop):
                        return
            _put(self._q, None, self._stop)
        except BaseException as e:  # re-raised in the consumer
            _put(self._q, _Raised(e), self._stop)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce,
                                            daemon=True)
            self._thread.start()
        while True:
            batch = self._q.get()
            if batch is None:
                return
            if isinstance(batch, _Raised):
                raise batch.exc
            yield batch

    def close(self):
        """Stop the producer (it ends after the batch it is decoding)."""
        self._stop.set()


def prefetch_iterator(it: Iterable, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue, so
    that producing the next item overlaps the device's work on this one
    (the host generator's batches; PrefetchLoader covers file datasets).
    An exception of the iterator is raised again here."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def worker():
        try:
            for item in it:
                if not _put(q, item, stop):
                    return
            _put(q, end, stop)
        except BaseException as e:  # re-raised in the consumer
            _put(q, _Raised(e), stop)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item
    finally:
        stop.set()


# ---------------------------------------------------------------- device

def _nan_scrub(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def _resize_pair(ims: torch.Tensor, flo: torch.Tensor, out_hw):
    """Resize images and flow to out_hw, rescaling the flow per axis. A
    NaN of the flow spreads along the resized axes, as in JAX
    (:func:`spread_nonfinite`); the images are whole /255 values."""
    h, w = ims.shape[1], ims.shape[2]
    oh, ow = out_hw
    ims_r = resize_bilinear(ims, out_hw)
    resized = tuple(d for d, (n, m) in enumerate(((h, oh), (w, ow)), 1)
                    if n != m)
    flo_r = spread_nonfinite(flo, resize_bilinear(flo, out_hw), resized)
    scale = torch.tensor([ow / w, oh / h], dtype=flo_r.dtype,
                         device=flo_r.device)
    return ims_r, flo_r * scale


def preprocess_flow_batch(ims_u8: torch.Tensor, flo: torch.Tensor,
                          out_hw=(256, 512),
                          draws: Optional[dict] = None) -> dict:
    """uint8 (B, H, W, 6) + flow (B, H, W, 2) -> {'ims': float32 in
    [-0.5, 0.5] at out_hw, 'flo': float32}: /255, the flow augmentation
    with ``draws`` (data/augment.py:draw_flow_augmentation, on the batch's
    device; its base scale is in the draws) or, without draws, a resize,
    then -0.5 and the NaN scrub. As in JAX, a NaN in a sample's flow
    channel zeroes that channel along every resampled axis (all of it
    under augmentation)."""
    flo = flo.float()
    if draws is None:
        ims, flo = _resize_pair(ims_u8.float() * (1.0 / 255.0), flo,
                                tuple(out_hw))
    else:  # gathers from the uint8 frames
        ims, flo = apply_flow_augmentation(ims_u8, flo, draws, out_hw)
    ims = ims - 0.5
    return {"ims": _nan_scrub(ims), "flo": _nan_scrub(flo)}


def preprocess_triplet_batch(gen: Optional[torch.Generator],
                             a_u8: torch.Tensor, b_u8: torch.Tensor,
                             c_u8: torch.Tensor,
                             augment: bool = True) -> dict:
    """uint8 triplet (B, H, W, 3) x3 -> {'ims': concat[frame0, frame2] -
    0.5, 'mid': frame1 - 0.5}, with the triplet-consistent augmentation
    drawn from ``gen`` when ``augment`` (``gen`` may be None otherwise)."""
    a, b, c = (t.float() * (1.0 / 255.0) for t in (a_u8, b_u8, c_u8))
    if augment:
        a, b, c = augment_triplet_batch(gen, a, b, c)
    return {"ims": torch.cat([a, c], dim=-1) - 0.5, "mid": b - 0.5}


# ------------------------------------------------------------ assemblers

def flow_sample_fn(pairs: Sequence, decode: Callable):
    """A sample_fn: index i -> decode(*pairs[i])."""

    def fn(i: int):
        return decode(*pairs[i])

    return fn


def load_image(path, size_hw=None) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB, resized to size_hw (PIL's
    bilinear) when given."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
    if size_hw is not None:
        img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img)


def triplet_sample_fn(dataset, size_hw=None):
    """A TripletDataset as a sample_fn: index i -> the three (H, W, 3)
    uint8 frames of its i-th key."""
    keys = dataset.keys()

    def fn(i: int):
        return tuple(load_image(p, size_hw) for p in dataset[keys[i]])

    return fn
