"""The ``context`` mesh axis's collectives: a clip's T frames (the 3D job)
or an image's H rows (the 2D job) split in contiguous blocks over the ranks
of one data index (``Mesh.context_group``; the counterpart of JAX
``batch_sharding``'s dim-1 sharding, whose halos, GroupNorm sums and ring
rotations XLA and ``shard_map`` insert).

Only ``broadcast`` and ``all_reduce`` move tensors (gloo takes no other
collective on CUDA tensors, which is how the ranks share one card;
``parallel/mesh.py``): ``owned_blocks`` is an all-gather made of one
broadcast per owner, as ``parallel/fsdp.py`` gathers, and the halo exchange
and the ring rotation are built on it.

  - ``halo(x, before, after, group)``: x's T (or H) block with ``before``
    frames (rows) of the previous rank's block prepended and ``after`` of
    the next rank's appended, zeros at the clip's (image's) ends
    (``swap_edges``: each rank sends only the edges a neighbour needs); its
    backward sends each halo's gradient back to its owner, which adds it to
    its edge frames (rows).
  - ``gather_blocks``: the whole tensor on every rank of the group (its
    backward sums the ranks' gradients and keeps this rank's block);
    ``reverse_blocks``: the whole tensor's flip, a block a rank (the latent
    H flip); ``window_blocks``: a window of the whole tensor at an offset,
    split again in equal blocks (the latent crop); ``all_sum``: a sum over
    the group that autograd sees (LPIPS's spatial mean).
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


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the channels-last format of its rank (a 4-D or 5-D tensor)."""
    return t.contiguous(memory_format=torch.channels_last_3d if t.ndim == 5
                        else torch.channels_last)


class Halo(torch.autograd.Function):
    """``halo``'s autograd: x → x with ``before`` slices of the previous
    rank's block and ``after`` of the next rank's joined along dim 2, in
    the channels-last format of its rank."""

    @staticmethod
    def forward(ctx, x, before, after, group):
        ctx.before, ctx.after, ctx.group = before, after, group
        n = x.shape[2]
        # a rank's first `after` slices are the previous rank's after-halo,
        # its last `before` slices the next rank's before-halo
        prev_last, next_first = swap_edges(x[:, :, :after], x[:, :, n - before:], group)
        parts = []
        if before:
            parts.append(prev_last if prev_last is not None
                         else x.new_zeros(()).expand_as(x[:, :, :before]))
        parts.append(x)
        if after:
            parts.append(next_first if next_first is not None
                         else x.new_zeros(()).expand_as(x[:, :, :after]))
        return _channels_last(torch.cat(parts, dim=2))

    @staticmethod
    def backward(ctx, g):
        before, after, group = ctx.before, ctx.after, ctx.group
        n = g.shape[2] - before - after
        dx = _channels_last(g[:, :, before:before + n].clone())
        # this rank's halo gradients go home: the before-halo's to the
        # previous rank's last slices, the after-halo's to the next rank's
        # first slices
        prev_after, next_before = swap_edges(g[:, :, :before], g[:, :, before + n:], group)
        if prev_after is not None:
            dx[:, :, :after] += prev_after
        if next_before is not None:
            dx[:, :, n - before:] += next_before
        return dx, None, None, None


def halo(x: torch.Tensor, before: int, after: int, group: dist.ProcessGroup) -> torch.Tensor:
    """x channels-last, this rank's block along dim 2 of a tensor split over
    ``group`` (the T frames of a (B, C, T, H, W) clip, or the H rows of a
    (B, C, H, W) image), with ``before`` slices of the previous block before
    it and ``after`` slices of the next block after it; zeros stand for the
    slices before the tensor's first and after its last. Differentiable;
    collective."""
    return Halo.apply(x, before, after, group)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return torch.cat([b for (b,) in owned_blocks([x.contiguous()], group)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        # every rank's use of the whole tensor reaches this rank's rows: the
        # ranks' gradients summed (in fp32), then this rank's block
        total = g.float().contiguous()
        dist.all_reduce(total, group=ctx.group)
        me = group_rank(ctx.group)
        return total.narrow(ctx.dim, me * ctx.size, ctx.size).to(g.dtype), None, None


def gather_blocks(x: torch.Tensor, dim: int, group: Optional[dist.ProcessGroup]
                  ) -> torch.Tensor:
    """The whole tensor of which x is this rank's block along ``dim`` (every
    rank of ``group`` holding an equal block, in rank order), on every rank.
    Its backward sums the ranks' gradients of the whole tensor and keeps
    this rank's block: where every rank of the group computes the same loss
    of the whole tensor, each block's gradient is the group's count times
    that loss's. Differentiable; collective; x itself without a group."""
    if group is None:
        return x
    return _GatherBlocks.apply(x, dim, group)


class _ReverseBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _mirror_block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _mirror_block(g, ctx.dim, ctx.group), None, None


def _mirror_block(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The mirror rank's block (rank n - 1 - r's for rank r), flipped along
    ``dim``."""
    n, me = group_size(group), group_rank(group)
    (mirror,) = owned_blocks([x.contiguous()], group)[n - 1 - me]
    return mirror.flip(dim)


def reverse_blocks(x: torch.Tensor, dim: int, group: Optional[dist.ProcessGroup]
                   ) -> torch.Tensor:
    """This rank's block of the whole tensor flipped along ``dim``, for x
    this rank's block of a tensor split along ``dim`` in equal blocks over
    ``group``: rank r's block is the flip of rank n - 1 - r's. Its backward
    is the same reversal of the gradient. Differentiable; collective;
    ``x.flip(dim)`` without a group."""
    if group is None:
        return x.flip(dim)
    return _ReverseBlocks.apply(x, dim, group)


def window_blocks(x: torch.Tensor, dim: int, start, size: int,
                  group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The window [start, start + size) along ``dim`` of the whole tensor of
    which x is this rank's block, split again in equal blocks over
    ``group``: this rank's block of the window (``start`` an int or a 0-d
    tensor on x's device). ``size`` must divide by the group's size.
    Differentiable; collective."""
    n, me = group_size(group), group_rank(group)
    if size % n:
        raise ValueError(f"a window of {size} does not split in equal blocks over {n} ranks")
    whole = gather_blocks(x, dim, group)
    rows = torch.arange(size, device=x.device) + start
    return whole.index_select(dim, rows).narrow(dim, me * (size // n), size // n)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """x summed over ``group``'s ranks, on every rank; the backward sums the
    ranks' gradients likewise (each rank's x reaches every rank's sum).
    Differentiable; collective; x itself without a group."""
    if group is None:
        return x
    return _AllSum.apply(x, group)


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
