"""Vector-quantized latent layer: codebook, straight-through estimator, EMA
codebook statistics (counterpart of ``vqgan_tpu/models/quant.py``).

The nearest-code search goes through the operator
``vqgan_tpu_torch::nearest_codes`` (``ops/custom_ops.py``) and the per-code
statistics through ``ops/vq_cuda.py``: the hand-written CUDA kernels for a
CUDA tensor, their plain versions for a CPU tensor. The EMA statistics are not module state:
the JAX package keeps them in a mutable ``vq_ema`` collection, the port in
``TrainState.vq_ema``, and ``forward`` takes the old ones and returns the new
ones. So a serving state dict holds the codebook alone (``reg.codebook``).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn as nn

from vqgan_tpu_torch.ops import custom_ops
from vqgan_tpu_torch.ops.vq_cuda import code_stats
from vqgan_tpu_torch.parallel.mesh import all_reduce_


class VectorQuantizer(nn.Module):
    """Codebook (K, D) under the state-dict key ``codebook``. ``ema_decay``
    0 trains the codebook by its gradient (codebook + β·commitment loss);
    above 0 the train step folds the EMA statistics into it and the loss is
    β·commitment alone."""

    def __init__(self, codebook_size: int = 16384, embedding_dim: int = 16,
                 beta: float = 0.25, ema_decay: float = 0.99, ema_eps: float = 1e-5):
        super().__init__()
        self.codebook_size = codebook_size
        self.embedding_dim = embedding_dim
        self.beta = beta
        self.ema_decay = ema_decay
        self.ema_eps = ema_eps
        self.codebook = nn.Parameter(torch.empty(codebook_size, embedding_dim))

    @torch.no_grad()
    def init_codebook_(self, generator: torch.Generator) -> None:
        """flax's ``variance_scaling(1.0, "fan_in", "uniform")`` for a (K, D)
        shape, whose fan_in is K: U(±√(3/K))."""
        limit = math.sqrt(3.0 / self.codebook_size)
        self.codebook.uniform_(-limit, limit, generator=generator)

    def init_ema(self) -> dict[str, torch.Tensor]:
        """The EMA statistics of a fresh run (``quant.py:93-98``): counts 1,
        sums the codebook."""
        return {"counts": torch.ones(self.codebook_size, device=self.codebook.device),
                "sums": self.codebook.detach().float().clone()}

    def _search(self, z: torch.Tensor):
        d = z.shape[-1]
        if d != self.embedding_dim:
            raise ValueError(f"z has {d} channels, the codebook {self.embedding_dim}")
        zf = z.float()
        flat = zf.reshape(-1, d).contiguous()  # (N, D); a view for an NHWC z
        # (N,) int32 through the operator; the codes carry no gradient
        codes = custom_ops.nearest_codes(flat.detach(), self.codebook.detach())
        z_q = self.codebook.index_select(0, codes).reshape(zf.shape)
        return zf, flat, codes, z_q

    @staticmethod
    def _straight_through(z: torch.Tensor, zf: torch.Tensor, z_q: torch.Tensor) -> torch.Tensor:
        return (zf + (z_q - zf).detach()).to(z.dtype)

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """z (..., D) → the straight-through z_q in z's dtype: the search and
        the gather, with none of ``forward``'s losses and statistics (the
        serving path, where the JAX package's jit drops them)."""
        zf, _, _, z_q = self._search(z)
        return self._straight_through(z, zf, z_q)

    def forward(self, z: torch.Tensor, ema_state: Optional[dict] = None,
                update_stats: bool = False, group=None
                ) -> tuple[torch.Tensor, dict[str, Any], Optional[dict]]:
        """z (..., D) → ``(z_q_ste, aux, new_ema)`` as ``quant.py:60-117``.

        ``new_ema`` is None unless EMA is on and ``update_stats``: then it is
        decay·``ema_state`` + (1 − decay)·(counts, sums) of this batch.
        ``group``: a process group whose ranks hold the rest of the batch;
        the counts and sums (and so the perplexity, the usage and the new
        statistics) are summed across it, the global batch's."""
        zf, flat, codes, z_q = self._search(z)
        commitment = (zf - z_q.detach()).square().mean()
        codebook_loss = (zf.detach() - z_q).square().mean()
        if self.ema_decay > 0:
            vq_loss = self.beta * commitment
        else:
            vq_loss = codebook_loss + self.beta * commitment

        need_sums = self.ema_decay > 0 and update_stats
        if need_sums and ema_state is None:
            raise ValueError("update_stats with EMA needs the old statistics (ema_state)")
        counts, sums = code_stats(codes, flat, self.codebook_size, with_sums=need_sums)
        # integer counts: their sum over the ranks is exact
        all_reduce_([counts] if sums is None else [counts, sums], group)
        probs = counts / counts.sum().clamp_min(1.0)
        perplexity = torch.exp(-(probs * torch.log(probs + 1e-10)).sum())

        new_ema = None
        if need_sums:
            d = self.ema_decay
            new_ema = {"counts": d * ema_state["counts"] + (1 - d) * counts,
                       "sums": d * ema_state["sums"] + (1 - d) * sums}
        aux = {
            "vq_loss": vq_loss,
            "commitment_loss": commitment,
            "codebook_loss": codebook_loss,
            "perplexity": perplexity,
            "codes": codes.reshape(zf.shape[:-1]),
            "usage": (counts > 0).float().mean(),
        }
        return self._straight_through(z, zf, z_q), aux, new_ema


def revive_dead_codes(codebook: torch.Tensor, counts: torch.Tensor, z_samples: torch.Tensor,
                      idx: torch.Tensor, threshold: float = 1.0) -> torch.Tensor:
    """Codes whose EMA count is below ``threshold`` take the rows ``idx``
    (K,) of ``z_samples`` (N, D), the batch's flat encoder outputs
    (``quant.py:120-138``; the JAX package draws ``idx`` as
    ``jax.random.randint(key, (K,), 0, N)``)."""
    replacements = z_samples.index_select(0, idx)
    dead = (counts < threshold)[:, None]
    return torch.where(dead, replacements, codebook)


def apply_ema_codebook_update(codebook: torch.Tensor, counts: torch.Tensor,
                              sums: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The codebook folded from the EMA statistics (``quant.py:141-153``):
    sums_k over Laplace-smoothed counts_k. Returns a new tensor in the
    codebook's dtype."""
    n = counts.sum()
    smoothed = (counts + eps) / (n + counts.shape[0] * eps) * n
    return (sums / smoothed[:, None]).to(codebook.dtype)
