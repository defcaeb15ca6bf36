"""Distributed runtime: the process group under torchrun, the mesh's axes,
and the collectives the data-parallel train steps use (counterpart of
``vqgan_tpu/parallel/mesh.py``; the reference's torchrun + DDP/NCCL,
vae_trainer.py:391-397).

The JAX package declares a mesh and lets XLA insert the collectives: under
``jit`` the batch is one global array sharded over the ``data`` and
``fsdp`` axes (``_data_axes``), and every loss, norm and statistic is taken
over the global batch. The port runs one process per rank (``torchrun
--nproc_per_node N``), each holding ``batch_size / N`` samples, and makes
the same step by hand:

  - each rank's loss is its local mean over ``N`` (its share of the global
    mean), and the parameters' gradients are summed across the ranks;
  - GradNorm's norm is reduced across the ranks inside its backward
    (``ops/gradnorm.py``);
  - batch statistics (the LeCam anchors' mean logits, the VQ code counts
    and sums, the z statistics and every logged metric) are reduced across
    the ranks before they are used.

So a step on N ranks is the step on the concatenation of their batches.
The ranks are laid out as JAX orders the axes (``AXES``), the later the
faster: with ``fsdp`` F rank r is data index r // F and fsdp index r % F;
with ``context`` C rank r is data index r // C and context index r % C.
With ``fsdp`` F > 1 the ranks of one data index (``Mesh.fsdp_group``) each
hold at rest only their block of every train-state tensor that
``param_spec`` shards, as JAX's ``state_shardings`` lays the state out
(``parallel/fsdp.py``); the ranks of one fsdp index (``Mesh.replica_group``)
hold the same blocks. With ``context`` C > 1 the C ranks of one data index
(``Mesh.context_group``) hold the same clips or images, each a contiguous
block of dim 1, their T frames or H rows (``batch_block``, JAX
``process_batch_block``); the model exchanges T or H halos, rotates the
ring attention's k/v and reduces its GroupNorm sums across that group
(``parallel/context.py``), and the gradients are summed over every rank, as
the context ranks hold partial gradients of the same clips or images.

Only ``all_reduce`` and ``broadcast`` move tensors: gloo takes both on CUDA
tensors, which is how several ranks share one card; a gather of rows is an
``all_reduce`` of a zero-padded buffer whose bits are summed as integers,
and a gather of shards a broadcast from each owner.

The ``data``, ``fsdp`` and ``context`` axes are ported. ``tensor`` above 1,
and ``fsdp`` with ``context`` both above 1, raise ``NotImplementedError``
naming their ROADMAP.md items; the JAX ``split_dcn_axes`` (multi-node) is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor", "context")

# the ROADMAP.md items that port the rest: the ``tensor`` axis, and the two
# sharded axes together
TENSOR_AXIS = "ROADMAP.md, Queue 1: tensor sharding"
FSDP_X_CONTEXT = "ROADMAP.md, Queue 1: fsdp x context"

# gradients and parameters move in buckets of at most this many bytes
BUCKET_BYTES = 64 << 20

_log = logging.getLogger("vqgan_tpu_torch")


@dataclasses.dataclass
class Mesh:
    """The axis extents, this process's rank and the world size. ``group``
    is the batch's process group, the ranks the global batch is split over
    (every rank: data x fsdp), None for one process without
    ``torch.distributed``; ``control`` a gloo group of the same ranks for
    host-side flags and barriers (the group itself where its backend is
    gloo). With ``fsdp`` > 1, ``fsdp_group`` holds the ranks of this rank's
    data index, which share out the train state, and ``replica_group`` the
    ranks of its fsdp index, which hold the same shards (None for a lone
    rank); with ``fsdp`` 1 both are None and every rank holds everything.
    With ``context`` > 1, ``context_group`` holds the ranks of this rank's
    data index, which split its clips' frames or its images' rows (None
    otherwise)."""

    shape: dict[str, int]
    rank: int = 0
    world_size: int = 1
    group: Optional[dist.ProcessGroup] = None
    control: Optional[dist.ProcessGroup] = None
    fsdp_group: Optional[dist.ProcessGroup] = None
    replica_group: Optional[dist.ProcessGroup] = None
    context_group: Optional[dist.ProcessGroup] = None

    @property
    def n_data(self) -> int:
        """The data-parallel extent: the ranks a global batch is split over,
        data x fsdp (JAX ``_data_axes``)."""
        return self.shape.get("data", 1) * self.shape.get("fsdp", 1)

    @property
    def n_context(self) -> int:
        return self.shape.get("context", 1)

    @property
    def data_index(self) -> int:
        """Which of the ``n_data`` blocks of the global batch this rank's
        clips or images are."""
        return self.rank // self.n_context

    @property
    def context_index(self) -> int:
        """Which block of its clips' frames or its images' rows this rank
        holds."""
        return self.rank % self.n_context

    def batch_block(self, global_shape: Sequence[int]) -> list[tuple[int, int]]:
        """This rank's (start, stop) of each dim of the global batch
        (``batch_block``)."""
        return batch_block(self.shape, self.rank, global_shape)

    @property
    def n_fsdp(self) -> int:
        return self.shape.get("fsdp", 1)

    @property
    def fsdp_index(self) -> int:
        """This rank's index on the fsdp axis: which block of a sharded
        tensor it holds."""
        return self.rank % self.n_fsdp

    def fsdp_ranks(self) -> list[int]:
        """The global ranks of this rank's fsdp group, in fsdp index order."""
        first = self.rank - self.fsdp_index
        return list(range(first, first + self.n_fsdp))

    @property
    def is_master(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if self.control is not None:
            dist.barrier(group=self.control)

    def any(self, flag: bool) -> bool:
        """True on every rank where ``flag`` is true on any rank (a preemption
        signal that reached some ranks only)."""
        if self.control is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())


_MESH: Optional[Mesh] = None


def init_distributed(device: str | torch.device = "cuda") -> torch.device:
    """The torchrun contract: with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
    and ``MASTER_ADDR``/``MASTER_PORT`` in the environment, join the process
    group (once; a second call keeps it) and return this rank's device of
    ``device``'s type. Without them, do nothing and return ``device``, as
    JAX's ``init_distributed`` does on one host.

    The backend: gloo for the CPU; NCCL where each rank of this node has a
    card of its own (``cuda:LOCAL_RANK``); gloo over CUDA tensors where
    several ranks share a card (NCCL refuses two ranks on one device), each
    on ``cuda:LOCAL_RANK % device_count``. The choice is logged."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible to torch; pass device='cpu' "
                               "(--device cpu) to train on the CPU")
        count = torch.cuda.device_count()
        backend = "nccl" if count >= local_world else "gloo"
        device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world,
                                device_id=device if backend == "nccl" else None)
        why = ("one card a rank" if backend == "nccl" else
               f"{local_world} ranks on {torch.cuda.device_count()} card(s)"
               if device.type == "cuda" else "CPU tensors")
        _log.info(f"torch.distributed: rank {dist.get_rank()} of {world}, backend {backend} "
                  f"({why}), device {device}")
    return device


def mesh_extents(shape: Optional[dict[str, int]], n: int) -> dict[str, int]:
    """JAX ``create_mesh``'s rules for an axis dict over ``n`` devices (here
    ranks): the first -1 axis absorbs the remaining ranks and any further
    -1 axes get 1; the product must be ``n``. The same errors."""
    shape = dict(shape or {"data": -1})
    unknown = [k for k in shape if k not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are {AXES}")
    fixed = math.prod(v for v in shape.values() if v > 0)
    wildcards = [k for k, v in shape.items() if v < 0]
    if wildcards:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by {fixed}")
        shape[wildcards[0]] = n // fixed
        for k in wildcards[1:]:
            shape[k] = 1
    if math.prod(shape.values()) != n:
        raise ValueError(
            f"mesh axes {shape} multiply to {math.prod(shape.values())} "
            f"but {n} device(s) are available"
        )
    return shape


def batch_block(extents: dict[str, int], rank: int,
                global_shape: Sequence[int]) -> list[tuple[int, int]]:
    """The (start, stop) of each dim of a global batch that rank ``rank``
    of a mesh of ``extents`` holds: dim 0 split over data x fsdp, and dim 1
    (a clip's T, an image's H) over ``context``, the other dims whole (JAX
    ``process_batch_block`` of ``batch_sharding(mesh, ndim)``, which splits
    dim 1 of a batch of 3 dims or more). Raises where an extent does not
    divide its dim."""
    n_ctx = extents.get("context", 1)
    n_data = extents.get("data", 1) * extents.get("fsdp", 1)
    out = [(0, n) for n in global_shape]
    for dim, n, index in ((0, n_data, rank // n_ctx), (1, n_ctx, rank % n_ctx)):
        if n == 1 or (dim == 1 and len(global_shape) < 3):
            continue
        size = global_shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of the global batch {tuple(global_shape)} does not "
                             f"divide by its {n} ranks")
        out[dim] = (index * size // n, (index + 1) * size // n)
    return out


def create_mesh(shape: Optional[dict[str, int]] = None) -> Mesh:
    """The mesh of this job's ranks (one rank without ``torch.distributed``)
    for an axis dict like ``{"data": -1}`` or ``{"data": 1, "fsdp": -1}``
    (``mesh_extents``). ``tensor`` above 1 raises NotImplementedError, and
    so does ``context`` above 1 with ``fsdp`` above 1. Its group is what
    ``axis_name="data"`` names (``data_group``). Collective where the
    process group is up: every rank calls it."""
    global _MESH
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1

    def refuse_unported(axes: dict) -> None:
        if axes.get("tensor", 1) > 1:
            raise NotImplementedError(
                f"tensor={axes['tensor']} needs several devices on the tensor axis, which is "
                f"not ported yet ({TENSOR_AXIS}); the data, fsdp and context axes are")
        if axes.get("context", 1) > 1 and axes.get("fsdp", 1) > 1:
            raise NotImplementedError(
                f"fsdp={axes['fsdp']} with context={axes['context']}: the train state sharded "
                f"over the ranks that split a clip's frames or an image's rows is not ported "
                f"yet ({FSDP_X_CONTEXT})")

    refuse_unported(dict(shape or {}))
    try:
        extents = mesh_extents(shape, world)
    except ValueError as e:
        if up:
            raise
        raise ValueError(f"{e}: one process without torch.distributed is one rank; launch "
                         f"several with torchrun --nproc_per_node N") from None
    refuse_unported(extents)
    group = control = fsdp_group = replica_group = context_group = None
    rank = dist.get_rank() if up else 0
    if up:
        group = dist.group.WORLD
        control = group if dist.get_backend(group) == "gloo" else dist.new_group(backend="gloo")
        n_fsdp, n_rep = extents.get("fsdp", 1), world // extents.get("fsdp", 1)
        if n_fsdp > 1:
            # every rank makes every group, in one order
            fsdp_group = group if n_rep == 1 else _member_group(
                [list(range(d * n_fsdp, (d + 1) * n_fsdp)) for d in range(n_rep)], rank)
            if n_rep > 1:
                replica_group = _member_group(
                    [list(range(f, world, n_fsdp)) for f in range(n_fsdp)], rank)
        n_ctx = extents.get("context", 1)
        if n_ctx > 1:
            context_group = group if n_ctx == world else _member_group(
                [list(range(d * n_ctx, (d + 1) * n_ctx)) for d in range(world // n_ctx)], rank)
    _MESH = Mesh(extents, rank, world, group, control, fsdp_group, replica_group, context_group)
    return _MESH


def _member_group(partition: list[list[int]], rank: int) -> dist.ProcessGroup:
    """The group of ``rank``'s part of ``partition``; every rank makes
    every part's group (``new_group`` is collective)."""
    mine = None
    for ranks in partition:
        made = dist.new_group(ranks)
        if rank in ranks:
            mine = made
    return mine


def param_spec(shape: Sequence[int], extents: dict[str, int],
               rows: bool = False) -> tuple[Optional[str], ...]:
    """The mesh axis each dim of a train-state tensor of ``shape`` is split
    over, None where it is whole: JAX ``_param_spec``
    (``vqgan_tpu/parallel/mesh.py:207-224``) in the port's layouts. JAX
    splits a kernel's input dim (-2 of HWIO, DHWIO, a Dense (in, out)) over
    ``fsdp`` and its output dim (-1) over ``tensor``, each where the extent
    divides it and it is at least twice the extent; 1-D tensors stay whole.
    A torch weight (OIHW, OIDHW, (out, in)) has them at dims 1 and 0;
    ``rows`` tensors (the codebook and the VQ sums, (K, D) in both
    packages) keep JAX's layout, K at dim 0 for ``fsdp``."""
    nd = len(shape)
    spec: list[Optional[str]] = [None] * nd
    if nd < 2:
        return tuple(spec)
    out_dim, in_dim = (nd - 1, nd - 2) if rows else (0, 1)
    for axis, dim in (("tensor", out_dim), ("fsdp", in_dim)):
        n = extents.get(axis, 1)
        if n > 1 and shape[dim] % n == 0 and shape[dim] >= 2 * n:
            spec[dim] = axis
    return tuple(spec)


def rows_layout(name: str) -> bool:
    """Whether the train-state tensor ``name`` (a parameter's or an EMA
    statistic's) is laid out as JAX lays it out: the VQ codebook (K, D)."""
    return name.rsplit(".", 1)[-1] in ("codebook", "sums")


def data_group(axis_name) -> dist.ProcessGroup:
    """A process group as given, or for ``"data"`` the current mesh's."""
    if axis_name == "data":
        if _MESH is None or _MESH.group is None:
            raise RuntimeError("axis_name 'data': no process group; run under torchrun and "
                               "call init_distributed() and create_mesh() first")
        return _MESH.group
    if isinstance(axis_name, str):
        raise ValueError(f"axis_name {axis_name!r}: only the data axis is ported")
    return axis_name


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterable[list[torch.Tensor]]:
    """``tensors`` in runs of one dtype and device, each at most
    ``BUCKET_BYTES`` (a larger tensor alone), in their order."""
    run: list[torch.Tensor] = []
    size = 0
    for t in tensors:
        n = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + n > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += n
    if run:
        yield run


def _on_backend(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``t`` where ``group``'s backend takes it: NCCL takes CUDA tensors
    only, so a CPU tensor (AdamW's step counts, a generator's state) goes
    through the current card."""
    if t.device.type == "cpu" and dist.get_backend(group) == "nccl":
        return t.to("cuda")
    return t


def _bucketed(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup, collective) -> None:
    """Run ``collective`` on each bucket flattened, then copy it back where
    the flat tensor is a copy."""
    for run in _buckets(tensors):
        single = len(run) == 1 and run[0].is_contiguous()
        flat = run[0].view(-1) if single else torch.cat([t.reshape(-1) for t in run])
        staged = _on_backend(flat, group)
        collective(staged)
        if single and staged is flat:
            continue
        for t, part in zip(run, staged.split([t.numel() for t in run])):
            t.copy_(part.view_as(t))


def all_reduce_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]) -> None:
    """Sum each tensor across ``group`` in place, in buckets; nothing for
    no group."""
    if group is not None:
        _bucketed(tensors, group, lambda flat: dist.all_reduce(flat, group=group))


def reduce_gradients(params: Iterable[torch.Tensor],
                     group: Optional[dist.ProcessGroup]) -> None:
    """Sum the parameters' gradients across ``group`` (those that have one)."""
    all_reduce_([p.grad for p in params if p.grad is not None], group)


def broadcast_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup],
               src: int = 0) -> None:
    """Every rank's tensors take the values of ``group``'s member ``src``
    (its rank in the group), in buckets."""
    if group is not None:
        root = dist.get_global_rank(group, src)
        _bucketed(tensors, group, lambda flat: dist.broadcast(flat, root, group=group))


def mean_across(values: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The mean of ``values`` over the ranks (a new tensor)."""
    if group is None:
        return values
    out = values.clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather_rows(local: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The ranks' ``local`` tensors (one shape and dtype on every rank, 4 or
    8 bytes an element) concatenated along dim 0 in rank order, bitwise: a
    zero buffer with this rank's block filled, summed across the ranks as
    integers."""
    if group is None:
        return local
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if local.element_size() not in (4, 8):
        raise ValueError(f"gather_rows takes 4- or 8-byte elements, got {local.dtype}")
    bits = _BITS[local.element_size()]
    buf = torch.zeros((n * local.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    rows = local.shape[0]
    buf[rank * rows:(rank + 1) * rows] = local
    dist.all_reduce(buf.view(bits), group=group)
    return buf


def replicas_equal(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]) -> bool:
    """Whether every rank of ``group`` holds its first member's tensors bit
    for bit (the same answer on every rank of the group)."""
    if group is None:
        return True
    # ``broadcast`` takes a global rank: the first member of a replica group
    # (the ranks of one fsdp index) is rank 0 only in the first group
    root = dist.get_global_rank(group, 0)
    mismatched = 0
    for run in _buckets([t.detach() for t in tensors]):
        mine = _on_backend(torch.cat([t.reshape(-1) for t in run]), group)
        theirs = mine.clone()
        dist.broadcast(theirs, root, group=group)
        bits = _BITS[mine.element_size()]  # compare bits: NaN == NaN, -0.0 != 0.0
        mismatched += int(not torch.equal(mine.view(bits), theirs.view(bits)))
    # the count of mismatched buckets over the ranks: SUM, which every
    # backend takes for int32 on either device
    flag = _on_backend(torch.tensor([mismatched], dtype=torch.int32), group)
    dist.all_reduce(flag, group=group)
    return int(flag.item()) == 0
