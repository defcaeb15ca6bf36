"""Video clips from tar shards, for the 3D (TVAE) trainer (counterpart of
``vqgan_tpu/data/video.py``).

Tar shards of ``.npy``/``.npz`` clip samples stream through the same
reader as images (``data/tar_stream.py``: brace expansion, decode workers,
shuffle buffer). One sample is an ``.npy`` holding a uint8 array (T, H, W, 3)
of RGB frames, or an ``.npz`` whose first entry is that array.
``video_transform`` makes every clip a fixed (frames, size, size, 3) float32
array in [-1, 1]:

  - temporal: a random (train) or centered (eval) window of ``frames``
    contiguous frames; a clip shorter than ``frames`` is looped;
  - spatial: the short side subsampled by an integer stride toward
    ``size``, then a center crop (in uint8, cheap on the host);
  - normalized to [-1, 1], as the image pipeline is.

``process_index`` of ``process_count`` processes reads its round-robin
share of the shards (``split_shards``); the defaults, 0 of 1, read every
shard. ``Trainer3D`` passes its rank and the world size.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

from vqgan_tpu_torch.data.tar_stream import TarImageStream, expand_braces, split_shards

CLIP_EXTS = (".npy", ".npz")


def decode_clip(data: bytes) -> Optional[np.ndarray]:
    """One tar member as a (T, H, W, 3) uint8 clip, or None. Anything but
    uint8 of that rank is refused: a silent cast would wrap integers above
    255 and truncate float clips in [0, 1] to black."""
    try:
        obj = np.load(io.BytesIO(data), allow_pickle=False)
        if hasattr(obj, "files"):  # npz: the first entry
            if not obj.files:
                return None
            obj = obj[obj.files[0]]
        arr = np.asarray(obj)
        if arr.ndim != 4 or arr.shape[-1] != 3 or arr.dtype != np.uint8:
            return None
        return arr
    except Exception:
        return None


def video_transform(frames: int, size: int, train: bool = True, seed: int = 0):
    """Clip → (frames, size, size, 3) float32 in [-1, 1]. The returned
    callable takes an optional per-call ``rng`` (the transforms' convention),
    so a position-addressed caller can make the temporal window a pure
    function of the sample's position; else it draws from one generator
    seeded ``seed``."""
    shared_rng = np.random.default_rng(seed)

    def transform(clip: np.ndarray, rng=None) -> np.ndarray:
        rng = shared_rng if rng is None else rng
        t, h, w, _ = clip.shape
        if t < frames:  # loop a short clip
            clip = np.concatenate([clip] * -(-frames // t), axis=0)
            t = clip.shape[0]
        start = int(rng.integers(t - frames + 1)) if train else (t - frames) // 2
        clip = clip[start: start + frames]
        stride = max(1, min(h, w) // size)
        clip = clip[:, ::stride, ::stride]
        h2, w2 = clip.shape[1:3]
        if h2 < size or w2 < size:
            raise ValueError(f"clip {h}x{w} smaller than target {size} after stride")
        y0, x0 = (h2 - size) // 2, (w2 - size) // 2
        clip = clip[:, y0: y0 + size, x0: x0 + size]
        return clip.astype(np.float32) / 127.5 - 1.0

    transform.accepts_rng = True
    return transform


class ClipStream:
    """An iterator over a ``TarImageStream`` of clips with ``close()``: a
    consumer that takes a few batches (the fixed eval batch) stops the
    decode workers instead of leaving them in their put-retry loop."""

    def __init__(self, stream: TarImageStream):
        self.stream = stream
        self._it = iter(stream)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return next(self._it)

    def close(self) -> None:
        self.stream.close()


def create_video_dataloader(
    url: str,
    batch_size: int,
    frames: int,
    size: int,
    num_workers: int = 4,
    do_shuffle: bool = True,
    seed: int = 0,
    loop: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> ClipStream:
    """Batches (batch_size, frames, size, size, 3) float32 in [-1, 1] from
    the clip shards of ``url`` (brace ranges expand); this process reads the
    shards ``split_shards`` gives ``process_index`` of ``process_count``."""
    shards = split_shards(expand_braces(url), process_index, process_count)
    stream = TarImageStream(
        shards,
        video_transform(frames, size, train=do_shuffle, seed=seed),
        batch_size=batch_size,
        num_workers=num_workers,
        do_shuffle=do_shuffle,
        seed=seed,
        loop=loop,
        exts=CLIP_EXTS,
        decoder=decode_clip,
    )
    return ClipStream(stream)
