"""Ring attention: exact attention over a token sequence split in contiguous
blocks over the ranks of a context group (counterpart of
``vqgan_tpu/ops/ring_attention.py``, which ``AttnBlock3D`` runs under
``shard_map`` over the ``context`` mesh axis).

Each rank holds its block of q, k and v, (B, N_local, H, D). The k/v blocks
rotate around the ring (``parallel/context.py::ring_shift``):

  - forward: C steps; each runs kernel #3's forward (``attention_forward``:
    the kernel on a CUDA tensor, the chunked plain version on the CPU) of the
    local q against the visiting k/v block, giving that block's (out, lse)
    with out in fp32 (a bf16 call's out stored uncast), and merges them into
    the running (out, lse) by logsumexp in fp32; out is cast to q's dtype
    once, at the end, as JAX keeps o, m and l in fp32 across the ring. The
    C - 1 rotations of JAX's ``_forward`` (the last block is not sent on).
  - backward: C steps; each runs kernel #3's backward (``attention_backward``)
    of the local q against the visiting block with the merged out and lse.
    That is JAX's ``_bwd_rule`` step exactly: the kernel recomputes P = exp(S
    − lse) from the global lse and takes delta = rowsum(dO·O) from the global
    out. Each step's dq, dk and dv come out of the kernel in fp32 (uncast);
    dq accumulates here in fp32; the visiting block's dk and dv accumulate
    in fp32 on buffers that rotate with it, and after C rotations they are
    home; each is cast to its input's dtype once, at the end.

Only the (B, N_local, N_local) scores of one step exist at once inside the
kernel, as in JAX. The blocks move as bytes through one broadcast per owner
(gloo's collectives on CUDA tensors): each rotation costs C broadcasts of a
block, where NCCL's send/recv would move one.

Launch counts (``fwd_launches``, ``bwd_launches``): kernel #3's calls that
the ring made on CUDA tensors (C a forward or backward), so a run can tell
the ring's calls of #3 from the AttnBlock's single calls; ``attention_cuda``
counts the same calls among all of #3's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from vqgan_tpu_torch.ops.attention_cuda import attention_backward, attention_forward
from vqgan_tpu_torch.parallel.context import ring_shift
from vqgan_tpu_torch.parallel.mesh import group_size

fwd_launches = 0
bwd_launches = 0


def _count(x: torch.Tensor, backward: bool) -> None:
    global fwd_launches, bwd_launches
    if x.is_cuda:
        if backward:
            bwd_launches += 1
        else:
            fwd_launches += 1


def merge(out: Optional[torch.Tensor], lse: Optional[torch.Tensor], out_b: torch.Tensor,
          lse_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two partial attentions over disjoint key blocks, (out (B, N, H, D),
    lse (B, H, N)), all fp32, merged by their logsumexp: out fp32, lse
    fp32."""
    if out is None:
        return out_b, lse_b
    new = torch.logaddexp(lse, lse_b)
    w_a = torch.exp(lse - new).transpose(1, 2).unsqueeze(-1)  # (B, N, H, 1)
    w_b = torch.exp(lse_b - new).transpose(1, 2).unsqueeze(-1)
    return out * w_a + out_b * w_b, new


def ring_attention_forward(q, k, v, group: dist.ProcessGroup, chunk: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of the local queries against every rank's keys: out
    (B, N_local, H, D) in q's dtype, lse the fp32 (B, H, N_local)."""
    n = group_size(group)
    out = lse = None
    kb, vb = k, v
    for step in range(n):
        o_b, lse_b = attention_forward(q, kb, vb, chunk, out_dtype=torch.float32)
        _count(q, backward=False)
        out, lse = merge(out, lse, o_b, lse_b)
        if step < n - 1:
            kb, vb = ring_shift([kb.contiguous(), vb.contiguous()], group)
    return out.to(q.dtype), lse


def ring_attention_backward(q, k, v, out, lse, g, group: dist.ProcessGroup, chunk: int
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the local blocks for the incoming gradient g of
    the local out, given the merged out and lse; each in its input's
    dtype."""
    n = group_size(group)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb = k.contiguous(), v.contiguous()
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros_like(dkb)
    for step in range(n):
        dq_b, dk_b, dv_b = attention_backward(q, kb, vb, out, lse, g, chunk,
                                              grad_dtype=torch.float32)
        _count(q, backward=True)
        dq += dq_b
        dkb += dk_b
        dvb += dv_b
        # the gradients ride with their block; after n rotations they are home
        if step < n - 1:
            kb, vb = ring_shift([kb, vb], group)
        dkb, dvb = ring_shift([dkb, dvb], group)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """Ring attention forward and backward over ``group`` (the
    ``FlashAttention`` of a T-split clip); saves q, k, v, the merged out
    and lse, O(N_local·D) a rank."""

    @staticmethod
    def forward(ctx, q, k, v, group, chunk):
        out, lse = ring_attention_forward(q, k, v, group, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.chunk = group, chunk
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_attention_backward(q, k, v, out, lse, g.contiguous(), ctx.group,
                                             ctx.chunk)
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: dist.ProcessGroup, chunk: int = 0) -> torch.Tensor:
    """Exact attention of the local (B, N_local, H, D) q, k, v blocks of a
    sequence split over ``group``, differentiable; collective. ``chunk``:
    the k/v chunk of the CPU's plain version (0 or one that does not divide
    N_local: the whole block); the kernel chooses its own tiles."""
    n_local = q.shape[1]
    if chunk <= 0 or n_local % chunk:
        chunk = n_local
    return RingAttention.apply(q, k, v, group, chunk)
