"""Indexed tar dataset: sample-exact deterministic data order and resume (a
copy of ``vqgan_tpu/data/indexed.py``).

The streaming reader (tar_stream.py) matches webdataset semantics, but its
exact sample order depends on worker and queue timing, so a resumed run can
only continue on a fresh order (the trainer's step-seeded reseed). This
module is the default for training runs:

  - a one-pass index of every member's (shard, data offset, size) — tar
    headers only, ~ms per shard,
  - a per-epoch global permutation that is a pure function of (seed, epoch)
    — a perfect shuffle,
  - batch assembly by position: the batch at step S is the same batch on
    every run, so resume is sample-exact with no saved iterator state
    (global sample index = step · global_batch + slot).

As the streaming reader, a dataset that decodes images states its decoder at
construction and raises where none imports.
"""

from __future__ import annotations

import concurrent.futures
import logging
import tarfile
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from vqgan_tpu_torch.data.tar_stream import _IMG_EXTS, _decode_image, image_decoders

logger = logging.getLogger("vqgan_tpu_torch")

IndexEntry = Tuple[str, int, int]  # (shard path, data offset, size)


def build_tar_index(shards: Sequence[str]) -> List[IndexEntry]:
    """Enumerate image members of each shard as (path, offset, size).

    Reads tar headers only. Unreadable shards are skipped (webdataset
    resilience, matching tar_stream._iter_tar_samples); member order is the
    deterministic on-disk order, so every process builds the same index.
    """
    index: List[IndexEntry] = []
    for path in shards:
        try:
            with tarfile.open(path, "r") as tf:
                for m in tf.getmembers():
                    if m.isfile() and m.name.lower().endswith(_IMG_EXTS):
                        index.append((path, m.offset_data, m.size))
        except (tarfile.TarError, OSError):
            continue
    return index


class IndexedTarDataset:
    """Deterministic, position-addressable view over tar shards.

    ``batch_at(step)`` returns the host-local slice of global batch ``step``;
    iteration starts at ``start_step``. All hosts share the one global index
    and permutation; host ``p`` of ``P`` owns slots
    ``[p·B/P, (p+1)·B/P)`` of every global batch — the same per-host split
    contract as the streaming path (wds.split_by_node equivalent).
    """

    def __init__(
        self,
        shards: Sequence[str],
        transform: Callable[[np.ndarray], np.ndarray],
        global_batch: int,
        *,
        seed: int = 0,
        start_step: int = 0,
        num_workers: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        do_shuffle: bool = True,
    ):
        if global_batch % process_count:
            raise ValueError(
                f"global batch {global_batch} must divide by {process_count} hosts"
            )
        self.index = build_tar_index(shards)
        if not self.index:
            raise ValueError(f"no decodable image members in shards {list(shards)[:3]}...")
        self.transform = transform
        self.global_batch = global_batch
        self.seed = seed
        self.start_step = start_step
        self.num_workers = max(1, num_workers)
        self.local_batch = global_batch // process_count
        self.slot_lo = process_index * self.local_batch
        self.do_shuffle = do_shuffle
        self._perm_cache: dict = {}
        # batch_at's thread pool calls _perm concurrently; an unguarded
        # check-then-clear lets one thread evict the entry another thread
        # just validated (KeyError mid-training, likeliest when batches
        # straddle epoch boundaries on small datasets)
        self._perm_lock = threading.Lock()
        self._wants_bytes = bool(getattr(transform, "wants_bytes", False))
        self.decoders = ("transform",) if self._wants_bytes else image_decoders()
        logger.info("IndexedTarDataset: %d samples, decoder %s", len(self.index),
                    " then ".join(self.decoders))
        # per-position augmentation rng: transform randomness must be a pure
        # function of (seed, position), not of worker-thread draw order —
        # otherwise batch_at(S) is not reproducible across runs
        self._accepts_rng = bool(getattr(transform, "accepts_rng", False))

    def __len__(self) -> int:
        return len(self.index)

    def _perm(self, epoch: int) -> np.ndarray:
        with self._perm_lock:
            p = self._perm_cache.get(epoch)
            if p is None:
                if len(self._perm_cache) > 2:  # keep the working set tiny
                    # evict only OTHER epochs — never an entry a concurrent
                    # reader may be about to index
                    for k in [k for k in self._perm_cache if k != epoch]:
                        del self._perm_cache[k]
                if self.do_shuffle:
                    rng = np.random.default_rng((self.seed, epoch))
                    p = rng.permutation(len(self.index))
                else:
                    p = np.arange(len(self.index))
                self._perm_cache[epoch] = p
            return p

    _MAX_SKIPS = 64  # consecutive bad members before the run is declared dead

    def _read_one(self, global_pos: int) -> Optional[np.ndarray]:
        """One position, no fallback: None for an undecodable image,
        exceptions propagate to the resilience loop."""
        n = len(self.index)
        epoch, pos = divmod(global_pos, n)
        path, offset, size = self.index[self._perm(epoch)[pos]]
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(size)
        kw = (
            {"rng": np.random.default_rng((self.seed, global_pos))}
            if self._accepts_rng
            else {}
        )
        if self._wants_bytes:
            return self.transform(data, **kw)
        img = _decode_image(data)
        if img is None:
            return None
        return self.transform(img, **kw)

    def _read_sample(self, global_pos: int) -> np.ndarray:
        """Deterministic resilient read: a corrupt member or a failing
        transform (undecodable bytes, image smaller than the crop, ...)
        falls through to the NEXT index position — the per-sample
        resilience the streaming path has (tar_stream), as a bounded loop
        (a long run of bad members must error, not recurse or spin). The
        substitution is logged: it duplicates a neighboring slot's sample,
        which the operator should know about."""
        for attempt in range(self._MAX_SKIPS):
            pos = global_pos + attempt
            try:
                sample = self._read_one(pos)
            except Exception as e:  # per-sample resilience, like tar_stream
                logger.warning(
                    "indexed read failed at position %d (%s); substituting "
                    "the next position", pos, e,
                )
                sample = None
            if sample is not None:
                if attempt:
                    logger.warning(
                        "indexed position %d substituted by position %d "
                        "after %d bad member(s)", global_pos, pos, attempt,
                    )
                return sample
        raise RuntimeError(
            f"{self._MAX_SKIPS} consecutive unreadable samples starting at "
            f"global position {global_pos} — dataset looks corrupt"
        )

    def batch_at(self, step: int) -> np.ndarray:
        """Host-local slice of global batch ``step`` — identical across runs."""
        base = step * self.global_batch + self.slot_lo
        positions = range(base, base + self.local_batch)
        if self.num_workers == 1:
            samples = [self._read_sample(p) for p in positions]
        else:
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
                samples = list(ex.map(self._read_sample, positions))
        return np.stack(samples)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = self.start_step
        while True:
            yield self.batch_at(step)
            step += 1
