"""Webdataset-style tar shard streaming (a copy of
``vqgan_tpu/data/tar_stream.py``).

The reference streams `{00000..02048}.tar` shards with webdataset
(vae_trainer.py:119-140): shard-level split across ranks (split_by_node) and
workers (split_by_worker), sample shuffle buffer of 1000, jpg/png decode,
per-sample transform. This module implements the same contract:

  - brace expansion of `{AAAAA..BBBBB}.tar` URL patterns,
  - shard assignment: round-robin over processes (the data-parallel ranks),
    then over decode workers,
  - a thread pool of decode workers (cv2/PIL decode releases the GIL),
  - a shuffle buffer, then batch assembly into numpy arrays that
    ``loader.device_prefetch`` pins and copies to the card.

The decoder is cv2, then PIL, as in the JAX package, unless the transform
takes the member's bytes itself (``wants_bytes``: the native pipeline,
``data/native``, which the stream logs as its ``decoder_name``). Unlike the
JAX package, a stream that decodes images finds out at construction which
of them import, says so, and raises at once where neither does (the JAX
reader would drop every sample as undecodable and wait on an empty queue).
"""

from __future__ import annotations

import io
import logging
import queue
import re
import tarfile
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

_IMG_EXTS = (".jpg", ".jpeg", ".png")


def expand_braces(url: str) -> List[str]:
    """Expand one `{00000..00042}` range (webdataset brace convention)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", url)
    if not m:
        return [url]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [
        url[: m.start()] + str(i).zfill(width) + url[m.end():]
        for i in range(int(lo), int(hi) + 1)
    ]


def split_shards(
    shards: Sequence[str], process_index: int, process_count: int
) -> List[str]:
    """Disjoint per-process shard assignment (== wds.split_by_node)."""
    return list(shards[process_index::process_count])


def image_decoders() -> tuple[str, ...]:
    """The image decoders that import here, in the order ``_decode_image``
    tries them: "cv2", then "PIL". Raises where neither does."""
    found = []
    for name in ("cv2", "PIL"):
        try:
            __import__(name)
            found.append(name)
        except ImportError:
            pass
    if not found:
        raise RuntimeError(
            "no image decoder: neither cv2 (opencv-python) nor PIL (Pillow) imports "
            "here, so no jpg/png sample can be read; train on --synthetic_data true "
            "or install one of them")
    return tuple(found)


def _decode_image(data: bytes) -> Optional[np.ndarray]:
    """Decode to HWC uint8 RGB. cv2 first (fast, releases GIL), PIL fallback."""
    try:
        import cv2

        arr = np.frombuffer(data, np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
        if img is not None:
            return img[..., ::-1]  # BGR → RGB
    except Exception:
        pass
    try:
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def _iter_tar_samples(
    path: str,
    raw_bytes: bool = False,
    exts: Sequence[str] = _IMG_EXTS,
    decoder: Callable[[bytes], Optional[np.ndarray]] = _decode_image,
) -> Iterator[np.ndarray]:
    """Yield decoded samples (or raw bytes when the transform owns decoding —
    the native C++ pipeline path) from one tar shard; sequential read — tar
    streaming is IO-friendly by construction. ``exts``/``decoder`` let other
    modalities reuse the same shard contract (data/video.py streams .npy
    clips through here)."""
    try:
        with tarfile.open(path, "r|*") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name.lower()
                if not name.endswith(tuple(exts)):
                    continue
                f = tf.extractfile(member)
                if f is None:
                    continue
                data = f.read()
                if raw_bytes:
                    yield data
                    continue
                img = decoder(data)
                if img is not None:
                    yield img
    except (tarfile.TarError, OSError):
        return  # skip unreadable shards, matching webdataset's resilience


class TarImageStream:
    """Multi-worker shard reader with shuffle buffer.

    Workers each own a disjoint shard subset and push transformed samples
    into a bounded queue; the consumer maintains a shuffle buffer (size 1000,
    matching wds .shuffle(1000), vae_trainer.py:123) and yields batches.
    """

    def __init__(
        self,
        shards: Sequence[str],
        transform: Callable[[np.ndarray], np.ndarray],
        batch_size: int,
        num_workers: int = 4,
        shuffle_buffer: int = 1000,
        do_shuffle: bool = True,
        seed: int = 0,
        loop: bool = True,
        exts: Sequence[str] = _IMG_EXTS,
        decoder: Callable[[bytes], Optional[np.ndarray]] = _decode_image,
    ):
        self.shards = list(shards)
        self.transform = transform
        self.exts = tuple(exts)
        self.decoder = decoder
        # which decoder reads the samples, stated at construction; where the
        # transform decodes the bytes itself ("native": data/native), the
        # decoder is not used
        if getattr(transform, "wants_bytes", False):
            self.decoders: tuple[str, ...] = (getattr(transform, "decoder_name", "transform"),)
        elif decoder is _decode_image:
            self.decoders = image_decoders()
        else:
            self.decoders = (getattr(decoder, "__name__", "custom"),)
        logging.getLogger("vqgan_tpu_torch").info(
            "TarImageStream: %d shard(s), decoder %s", len(self.shards),
            " then ".join(self.decoders))
        self.batch_size = batch_size
        self.num_workers = max(1, min(num_workers, len(self.shards) or 1))
        self.shuffle_buffer = shuffle_buffer if do_shuffle else 0
        # webdataset's shuffle(bufsize=1000) starts yielding once `initial`
        # samples are buffered, then grows the buffer toward bufsize while
        # streaming (vae_trainer.py:123 contract)
        self.shuffle_initial = min(100, self.shuffle_buffer)
        self.do_shuffle = do_shuffle
        self.seed = seed
        self.loop = loop
        self._q: queue.Queue = queue.Queue(maxsize=4 * batch_size)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._live_workers = 0
        self._lock = threading.Lock()

    def _worker(self, worker_id: int):
        rng = np.random.default_rng(self.seed + worker_id)
        my_shards = self.shards[worker_id :: self.num_workers]
        raw = bool(getattr(self.transform, "wants_bytes", False))
        epoch = 0
        n_ok = n_failed = 0
        try:
            while not self._stop.is_set():
                order = list(my_shards)
                if self.do_shuffle:
                    rng.shuffle(order)
                for shard in order:
                    for img in _iter_tar_samples(
                        shard, raw_bytes=raw, exts=self.exts,
                        decoder=self.decoder,
                    ):
                        if self._stop.is_set():
                            return
                        try:
                            sample = self.transform(img)
                            n_ok += 1
                        except Exception as e:
                            # per-sample resilience (webdataset contract) —
                            # but surface a dataset-wide failure instead of
                            # hanging the consumer forever on an empty queue
                            n_failed += 1
                            if n_ok == 0 and n_failed in (50, 1000):
                                logging.getLogger("vqgan_tpu_torch").error(
                                    f"data worker {worker_id}: first "
                                    f"{n_failed} samples ALL failed the "
                                    f"transform (last: {e!r}) — the dataset "
                                    f"likely mismatches the config (e.g. "
                                    f"clips smaller than the target size)"
                                )
                            continue
                        while not self._stop.is_set():
                            try:
                                self._q.put(sample, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                epoch += 1
                if not self.loop:
                    return
        finally:
            with self._lock:
                self._live_workers -= 1

    def __iter__(self) -> Iterator[np.ndarray]:
        self._stop.clear()
        self._live_workers = self.num_workers
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()
        rng = np.random.default_rng(self.seed + 7777)
        buf: List[np.ndarray] = []
        batch: List[np.ndarray] = []
        while True:
            with self._lock:
                live = self._live_workers
            try:
                sample = self._q.get(timeout=0.5)
            except queue.Empty:
                if live == 0 and self._q.empty():
                    break
                continue
            if self.shuffle_buffer > 0:
                buf.append(sample)
                if len(buf) < self.shuffle_buffer:
                    if len(buf) < self.shuffle_initial:
                        continue  # initial fill before the first yield
                    # grow toward the full buffer without stalling the
                    # consumer: opportunistically take one extra sample
                    try:
                        buf.append(self._q.get_nowait())
                    except queue.Empty:
                        pass
                idx = int(rng.integers(len(buf)))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                sample = buf.pop()
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield np.stack(batch)
                batch = []
        # drain remaining buffered samples (in random order) into final batches
        while buf:
            idx = int(rng.integers(len(buf)))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            batch.append(buf.pop())
            if len(batch) == self.batch_size:
                yield np.stack(batch)
                batch = []

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
