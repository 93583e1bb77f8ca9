"""Triplet-of-frames datasets for the frame-interpolation pretraining (the
port's copy of qpwcnet_tpu/data/triplet.py): Vimeo-90K triplets,
YouTube-VOS frames and a black-frame fixture.

Each dataset yields triplets of image file paths; the pipeline
(data/pipeline.py:triplet_sample_fn) decodes them on host threads.
"""

from __future__ import annotations

import abc
import tempfile
import weakref
from pathlib import Path

import numpy as np

from qpwcnet_torch.utils.cache import file_cache


class TripletDataset(abc.ABC):
    """Random-access triplets of file names."""

    @abc.abstractmethod
    def keys(self):
        ...

    @abc.abstractmethod
    def __getitem__(self, key):
        """key -> (path_0, path_1, path_2)."""

    @abc.abstractmethod
    def __len__(self):
        ...

    def __iter__(self):
        for k in self.keys():
            yield self[k]


class VimeoTriplet(TripletDataset):
    """Vimeo-90K triplets: keys from ``tri_<split>list.txt``, item
    ``sequences/<key>/im{1,2,3}.png``."""

    def __init__(self, root, split: str = "train"):
        self.root = Path(root)
        with open(self.root / f"tri_{split}list.txt") as f:
            self._keys = [ln.strip() for ln in f if ln.strip()]

    def keys(self):
        return list(self._keys)

    def __len__(self):
        return len(self._keys)

    def __getitem__(self, key):
        d = self.root / "sequences" / key
        return (str(d / "im1.png"), str(d / "im2.png"), str(d / "im3.png"))


class YoutubeVos(TripletDataset):
    """YouTube-VOS: one key a video of ``<split>/JPEGImages`` with 3 frames
    or more, its frame list scanned once and kept by :func:`file_cache`
    (under ``ytvos_<split>_index``, in ``cache_dir``); an item is three
    frames a random gap d in [1, max_gap + 1] apart, d and the start drawn
    from one ``RandomState(seed)`` shared by every caller (so the order
    of the draws, and the items, follow the order of the calls)."""

    def __init__(self, root, split: str = "train", max_gap: int = 8,
                 seed: int = 0, cache_dir=None):
        self.root = Path(root)
        self.max_gap = max_gap
        self._rng = np.random.RandomState(seed)
        frames_dir = self.root / split / "JPEGImages"

        @file_cache(f"ytvos_{split}_index", cache_dir=cache_dir)
        def scan():
            index = {}
            for vid in sorted(frames_dir.iterdir()):
                if vid.is_dir():
                    frames = sorted(str(p) for p in vid.glob("*.jpg"))
                    if len(frames) >= 3:
                        index[vid.name] = frames
            return index

        self._index = scan()
        self._keys = sorted(self._index)

    def keys(self):
        return list(self._keys)

    def __len__(self):
        return len(self._keys)

    def __getitem__(self, key):
        frames = self._index[key]
        n = len(frames)
        d = int(self._rng.randint(1, self.max_gap + 2))
        d = min(d, (n - 1) // 2)
        i0 = int(self._rng.randint(0, n - 2 * d))
        return (frames[i0], frames[i0 + d], frames[i0 + 2 * d])


class DummyTripletDataset(TripletDataset):
    """n triplets of one black PNG of size hw, written to a temporary
    directory that lives as long as the dataset: the pipeline without
    data."""

    def __init__(self, n: int = 8, hw=(64, 128)):
        from qpwcnet_torch.vis import write_png

        tmp = tempfile.TemporaryDirectory(prefix="qpwcnet_torch_dummy_")
        self._finalizer = weakref.finalize(self, tmp.cleanup)
        self._path = str(Path(tmp.name) / "black.png")
        write_png(self._path, np.zeros((hw[0], hw[1], 3), np.uint8))
        self._n = n

    def keys(self):
        return list(range(self._n))

    def __len__(self):
        return self._n

    def __getitem__(self, key):
        return (self._path, self._path, self._path)
