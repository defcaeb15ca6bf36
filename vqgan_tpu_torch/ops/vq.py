"""Plain PyTorch versions of the vector-quantizer's two kernels: the
nearest-code search and the per-code statistics (counterparts of the XLA
formulations in ``vqgan_tpu/ops/pallas/vq.py``).

The CPU takes these; on the card ``chip_smoke.py`` and the card tests hold
the CUDA kernels (``csrc/vq.cu``, ``ops/vq_cuda.py``) against them. Both form
an (N, K) matrix, distances or a one-hot, which the kernels never write.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def nearest_codes_plain(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k ‖z − E_k‖² for (N, D) tokens against (K, D) codes, as
    ``‖z‖² − 2·z·Eᵀ + ‖E‖²`` in fp32 (``vq.py:144-152``); the first index
    wins an exact tie. Returns (N,) int32."""
    zf = flat.float()
    cb = codebook.float()
    z_sq = (zf * zf).sum(-1, keepdim=True)
    e_sq = (cb * cb).sum(-1)
    dists = z_sq - 2.0 * (zf @ cb.T) + e_sq[None, :]
    return dists.argmin(-1).to(torch.int32)


def code_stats_plain(
    codes: torch.Tensor, flat: torch.Tensor, codebook_size: int, with_sums: bool
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(counts, sums): counts[k] = |{n: codes[n] = k}| as fp32 (K,), and,
    when ``with_sums``, sums[k] = Σ_{codes[n]=k} flat[n] as fp32 (K, D); the
    one-hot formulation of ``vq.py:283-294``. sums is None otherwise."""
    one_hot = F.one_hot(codes.long(), codebook_size).float()
    counts = one_hot.sum(0)
    sums = one_hot.T @ flat.float() if with_sums else None
    return counts, sums
