"""The ``context`` mesh axis's collectives: a clip's T frames split in
contiguous blocks over the ranks of one data index (``Mesh.context_group``;
the 3D job's counterpart of JAX ``batch_sharding``'s T sharding, whose halos,
GroupNorm sums and ring rotations XLA and ``shard_map`` insert).

Only ``broadcast`` and ``all_reduce`` move tensors (gloo takes no other
collective on CUDA tensors, which is how the ranks share one card;
``parallel/mesh.py``): ``owned_blocks`` is an all-gather made of one
broadcast per owner, as ``parallel/fsdp.py`` gathers, and the halo exchange
and the ring rotation are built on it.

  - ``halo_t(x, before, after, group)``: x's T block with ``before`` frames
    of the previous rank's block prepended and ``after`` frames of the next
    rank's appended, zeros at the clip's ends (``swap_edges``: each rank
    sends only the edges a neighbour needs); its backward sends each halo's
    gradient back to its owner, which adds it to its edge frames.
  - ``ring_shift(tensors, group)``: the previous rank's tensors (the ring
    attention's k/v rotation, ``ops/ring_attention.py``).
  - ``FrameSubset``: the step's strided frame subset (JAX ``_frame_subset``:
    global frame floor((i + u)·T/k)), each rank taking the chosen frames of
    its block (possibly none), and ``gather``, which hands every rank of the
    group the whole (B, k) subset in frame order; its backward keeps this
    rank's frames of the incoming gradient. The loss head (LPIPS, D) then
    runs on the whole subset on each rank of the group, as one process
    runs it on its clips, with the same values on every rank of the group.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from vqgan_tpu_torch.parallel.mesh import group_rank, group_size


def owned_blocks(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup
                 ) -> list[list[torch.Tensor]]:
    """Every rank's ``tensors`` (the same shapes and one dtype on each rank
    of ``group``), by rank in the group: one broadcast per owner of its
    tensors flattened into one buffer, moved as bytes (gloo takes uint8 on
    either device), bit for bit."""
    n, me = group_size(group), group_rank(group)
    sizes = [t.numel() for t in tensors]
    mine = torch.cat([t.reshape(-1) for t in tensors])
    out = []
    for owner in range(n):
        buf = mine if owner == me else torch.empty_like(mine)
        dist.broadcast(buf.view(torch.uint8), dist.get_global_rank(group, owner), group=group)
        out.append([part.view(t.shape) for part, t in zip(buf.split(sizes), tensors)])
    return out


def ring_shift(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup
               ) -> list[torch.Tensor]:
    """The previous rank's ``tensors`` (rank 0 takes the last rank's): one
    step of the ring."""
    n, me = group_size(group), group_rank(group)
    return owned_blocks(tensors, group)[(me - 1) % n]


def swap_edges(lo: torch.Tensor, hi: torch.Tensor, group: dist.ProcessGroup
               ) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """This rank's ``lo`` to the previous rank and its ``hi`` to the next
    (each tensor the same shape and dtype on every rank of ``group``, maybe
    empty): returns the previous rank's ``hi`` and the next rank's ``lo``,
    None past the first or last rank. One broadcast per owner of what some
    rank needs (bytes, bit for bit): the first rank sends no ``lo``, the last
    no ``hi``."""
    n, me = group_size(group), group_rank(group)
    prev_hi = next_lo = None
    for owner in range(n):
        sizes = (lo.numel() if owner > 0 else 0, hi.numel() if owner < n - 1 else 0)
        if not any(sizes):
            continue
        if owner == me:
            buf = torch.cat([t.reshape(-1) for t, size in zip((lo, hi), sizes) if size])
        else:
            buf = lo.new_empty(sum(sizes))
        dist.broadcast(buf.view(torch.uint8), dist.get_global_rank(group, owner), group=group)
        if owner == me - 1:
            prev_hi = buf[sizes[0]:].view(hi.shape)
        elif owner == me + 1:
            next_lo = buf[:sizes[0]].view(lo.shape)
    return prev_hi, next_lo


class HaloT(torch.autograd.Function):
    """``halo_t``'s autograd: (B, C, T, H, W) → (B, C, before + T + after,
    H, W), channels_last_3d."""

    @staticmethod
    def forward(ctx, x, before, after, group):
        ctx.before, ctx.after, ctx.group = before, after, group
        t = x.shape[2]
        # a rank's first `after` frames are the previous rank's after-halo,
        # its last `before` frames the next rank's before-halo
        prev_last, next_first = swap_edges(x[:, :, :after], x[:, :, t - before:], group)
        parts = []
        if before:
            parts.append(prev_last if prev_last is not None
                         else x.new_zeros(()).expand_as(x[:, :, :before]))
        parts.append(x)
        if after:
            parts.append(next_first if next_first is not None
                         else x.new_zeros(()).expand_as(x[:, :, :after]))
        return torch.cat(parts, dim=2).contiguous(memory_format=torch.channels_last_3d)

    @staticmethod
    def backward(ctx, g):
        before, after, group = ctx.before, ctx.after, ctx.group
        t = g.shape[2] - before - after
        dx = g[:, :, before:before + t].clone(memory_format=torch.channels_last_3d)
        # this rank's halo gradients go home: the before-halo's to the
        # previous rank's last frames, the after-halo's to the next rank's
        # first frames
        prev_after, next_before = swap_edges(g[:, :, :before], g[:, :, before + t:], group)
        if prev_after is not None:
            dx[:, :, :after] += prev_after
        if next_before is not None:
            dx[:, :, t - before:] += next_before
        return dx, None, None, None


def halo_t(x: torch.Tensor, before: int, after: int, group: dist.ProcessGroup) -> torch.Tensor:
    """x (B, C, T, H, W), this rank's T block of a clip split over
    ``group``, with ``before`` frames of the previous block before it and
    ``after`` frames of the next block after it; zeros stand for the frames
    before the clip's first and after its last. Differentiable; collective."""
    return HaloT.apply(x, before, after, group)


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, subset):
        ctx.subset = subset
        return subset._gather(x)

    @staticmethod
    def backward(ctx, g):
        s = ctx.subset
        return g.index_select(1, s.positions[s.index]).contiguous(), None


class FrameSubset:
    """The step's ``k`` frames of clips whose T frames (``frames``) are split
    in ``group_size(group)`` equal blocks over ``group`` (None: one block):
    frame floor((i + u)·T/k) for i < k, in fp32 as JAX's ``_frame_subset``
    computes it; k <= 0 or k >= T keeps every frame. ``local(x)``: the chosen
    frames of this rank's block of x (B, T/n, ...), in order; ``gather``:
    every block's chosen frames as one (B, k, ...) tensor in frame order."""

    def __init__(self, frames: int, k: int, u, group: Optional[dist.ProcessGroup],
                 device: torch.device):
        self.group = group
        self.n = group_size(group)
        self.index = group_rank(group)
        self.every = k <= 0 or k >= frames
        self.t_local = frames // self.n
        if self.every:
            idx = torch.arange(frames, device=device)
        else:
            u = torch.as_tensor(u, dtype=torch.float32, device=device)
            idx = ((torch.arange(k, device=device) + u) * (frames / k)).floor().long()
        owner = idx // self.t_local
        # each block's frames: local indices, and their positions in the subset
        self.local_idx = [idx[owner == r] - r * self.t_local for r in range(self.n)]
        self.positions = [torch.nonzero(owner == r).flatten() for r in range(self.n)]
        self.k = idx.numel()

    def local(self, x: torch.Tensor) -> torch.Tensor:
        if self.every:
            return x
        return x.index_select(1, self.local_idx[self.index])

    def gather(self, x_local: torch.Tensor) -> torch.Tensor:
        """The whole subset from each rank's ``local`` frames; its backward
        keeps this rank's frames of the gradient (every rank of the group
        computes the same loss of the whole subset)."""
        if self.group is None:
            return x_local
        return _GatherFrames.apply(x_local, self)

    def _gather(self, x_local: torch.Tensor) -> torch.Tensor:
        counts = [int(p.numel()) for p in self.positions]
        rest = tuple(x_local.shape[2:])
        b = x_local.shape[0]
        # blocks of unequal frame counts: each owner's frames padded to the
        # most any block holds
        most = max(counts)
        mine = x_local.new_zeros((b, most) + rest)
        mine[:, :x_local.shape[1]] = x_local
        out = x_local.new_empty((b, self.k) + rest)
        for r, (block,) in enumerate(owned_blocks([mine], self.group)):
            out[:, self.positions[r]] = block[:, :counts[r]]
        return out
