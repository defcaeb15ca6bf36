"""Fused fp32 GroupNorm (+ optional swish), forward and backward: the
hand-written CUDA kernels for Hopper, the ``torch.autograd.Function`` that
joins them, and the dispatch the model calls.

Replaces ``vqgan_tpu/ops/pallas/groupnorm.py``: the forward
``fused_group_norm`` (the Pallas TPU kernels ``_stats_kernel`` and
``_apply_kernel``) and the backward ``_pallas_gn_bwd`` (``_bwd_stats_kernel``
and ``_bwd_dx_kernel``), which ``_fused_gn_vjp`` joins. The kernels are
``csrc/groupnorm.cu``, built by ``nvcc`` for ``sm_90a`` at first use and bound
with ctypes.

What bounds them on an H100: device-memory bandwidth, against a few flops
per element (about 3.35 TB/s on an H100 SXM). Both directions walk the call
in units (a sample and a slice of whole groups over all rows), the slices
from one rule (``slice_widths``). The forward is one launch of thread-block
clusters, as many as the device holds, each taking a unit at a time: each
block loads its rows of the unit into shared memory (in rounds where they
do not fit at once, the earlier rounds read again after the barrier), the
blocks fold their sums through distributed shared memory in block order,
and every block writes its rows of y, so x is read from device memory once
(the rounds again, from L2 where they still sit there) and y written once.
``forward_plan`` (pure Python) picks the slice, the blocks of a cluster and
the packs a thread holds. The backward is
one persistent cooperative launch: teams of blocks share a unit and meet at
one barrier per unit, an integer counter. On the "on-chip" route a unit
fits in the team's shared memory (x, g) and registers (dŷ), so x and the
incoming gradient are read once and dx written once, and the next unit's
loads are in flight across the barrier; where a unit would fit only as
narrow row slices, the "re-read" route streams whole row slices twice.
``backward_plan`` (pure Python) picks the route, the slice (any whole
number of 16-byte packs; a group wider than a block splits over column
blocks) and the teams. No float atomics: the outputs are deterministic.

The two-pass form (``ContextGroupNorm``) takes a GroupNorm whose rows are
split over the ranks of a context group (a clip's frames, ``parallel/
context.py``): kernel #1 as two launches, the partial sums of this rank's
rows, then (after one ``all_reduce`` of the (B, 2, G) sums across the group)
the normalisation from the stats; kernel #2 the same way (partial Σγ·dŷ and
Σγ·dŷ·x̂ with this rank's dγ, dβ; the ``all_reduce``; dx). That seam is the
Pallas kernels' own (``groupnorm.py:112``/``:131`` and ``:218``/``:244``);
the one-launch kernels stay the path without a group. Each launch counts on
its own route (``ctx_sums_launches``, ``ctx_apply_launches``,
``ctx_bwd_sums_launches``, ``ctx_dx_launches``).

``FusedGroupNorm`` saves only the input in its own dtype, the (B, 2, G)
statistics the forward kernel wrote, and γ, β: no full-size fp32 tensor (the
JAX package's contract, ``vqgan_tpu/ops/normalization.py``). Its backward
recomputes ŷ from x.

``fused_group_norm`` takes (B, C, H, W) tensors in ``torch.channels_last``
memory format, which are physically (B, H·W, C), or (B, C, T, H, W) tensors
in ``torch.channels_last_3d``, physically (B, T·H·W, C), and is
differentiable. A
tensor on the CPU goes to the plain versions (``ops/normalization.py``); a
CUDA tensor launches the kernels, or raises. There is no fallback between the
two. The forward goes through the operator ``vqgan_tpu_torch::gn_forward``
(``ops/custom_ops.py``), whose dispatcher makes that choice by device, so
``torch.export`` traces it; the backward is a plain call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

import torch.distributed as dist

from vqgan_tpu_torch.ops import normalization as plain
from vqgan_tpu_torch.ops.cuda_build import load_library, num_sms
from vqgan_tpu_torch.ops.normalization import group_norm_fp32_backward

# Kernel launches since the count was last set to 0: one per forward
# (``launches``) or backward (``bwd_launches``) call that reached the CUDA
# kernels; calls on CPU tensors do not count. ``grad_copies``: the incoming
# gradients ``FusedGroupNorm.backward`` had to copy into channels-last
# memory first.
launches = 0
bwd_launches = 0
grad_copies = 0
# the two-pass form's launches, one a call of each wrapper on a CUDA tensor:
# forward sums, forward apply, backward sums, dx
ctx_sums_launches = 0
ctx_apply_launches = 0
ctx_bwd_sums_launches = 0
ctx_dx_launches = 0
# the two-pass kernels' block (csrc/groupnorm.cu kCtxThreads), and the
# blocks a launch aims at: this many an SM
CTX_THREADS = 256
CTX_BLOCKS_PER_SM = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_PER_BLOCK = 232_448  # an H100's opt-in limit (227 KB)
SM_SMEM_BYTES = 233_472  # an H100 SM's shared memory, 1 KB of it reserved a block
_MAX_GROUPS = 1024
# the forward's block (csrc/groupnorm.cu kFwdThreads, kFwdMaxCluster; the
# library is checked against them when it loads)
FWD_THREADS = 256
FWD_CLUSTERS = (1, 2, 4, 8, 16)  # blocks of a cluster (above 8: non-portable)
FWD_MAX_BLOCKS_PER_SM = 2  # its launch bounds
# forward_plan's rule, fitted to every candidate's device time at the path
# shapes (tools/sweep_gn_bwd.py --forward): row slices of at most this many
# bytes (the widest whole-group one under it), narrower while a call has
# fewer units than FWD_MIN_UNITS; the smallest cluster whose blocks take at
# most FWD_ROUND_PACKS rows a thread (at most 16 blocks); packs held for two
# blocks an SM
FWD_ROW_BYTES = 128
FWD_MIN_UNITS = 4
FWD_ROUND_PACKS = 16
# the backward kernel's block (csrc/groupnorm.cu kBwdThreads, kBwdPacks,
# kBwdMaxSlicePacks; the library is checked against them when it loads)
BWD_THREADS = 256
BWD_PACKS = 8  # 16-byte packs of a unit's x, g and dŷ that a thread holds
BWD_SLICE_PACKS = 40  # 16-byte packs of a row slice one block takes, at most
# a unit's slice is at most this many packs where its groups allow one that
# narrow, else the narrowest whole-group slice (split over column blocks
# where it is wider than BWD_SLICE_PACKS)
PREFERRED_SLICE_PACKS = 16
# backward_plan's cost model, per unit: the HBM rate a block gets (its share
# of 3.35 TB/s among the launched blocks, at this fraction for a row slice of
# 16, 32, 64 or >= 128 bytes), the barrier's fixed cost, and for the re-read
# route a wait for each chunk's loads; checked against every candidate by
# tools/sweep_gn_bwd.py
HBM_BYTES_PER_S = 3.35e12
SLICE_EFFICIENCY = {16: 0.15, 32: 0.3, 64: 0.75, 128: 1.0}
BARRIER_S = 3e-6
CHUNK_S = 1e-6


@functools.cache
def library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built kernel library (built on the first call), with the extra
    ``-D`` flags ``defines`` (``("-DGN_BWD_TRACE",)``, ``("-DGN_FWD_TRACE",)``:
    the backward's or the forward's phase clock, ``tools/trace_gn_bwd.py``,
    ``tools/trace_gn_fwd.py``)."""
    lib = load_library("groupnorm", defines)
    lib.gn_forward.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    lib.gn_forward.restype = ctypes.c_int
    lib.gn_forward_setup.argtypes = [ctypes.c_int]
    lib.gn_forward_setup.restype = ctypes.c_int
    lib.gn_forward_max_clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.gn_forward_max_clusters.restype = ctypes.c_int
    lib.gn_forward_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.gn_forward_limits.restype = None
    lib.gn_backward.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 14
        + [ctypes.c_void_p]
    )
    lib.gn_backward.restype = ctypes.c_int
    lib.gn_backward_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.gn_backward_occupancy.restype = ctypes.c_int
    lib.gn_backward_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.gn_backward_limits.restype = None
    lib.gn_ctx_sums.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.gn_ctx_sums.restype = ctypes.c_int
    lib.gn_ctx_apply.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float]
                                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.gn_ctx_apply.restype = ctypes.c_int
    lib.gn_error_string.argtypes = [ctypes.c_int]
    lib.gn_error_string.restype = ctypes.c_char_p
    limits = [ctypes.c_int(0) for _ in range(3)]
    lib.gn_backward_limits(*(ctypes.byref(v) for v in limits))
    if tuple(v.value for v in limits) != (BWD_THREADS, BWD_PACKS, BWD_SLICE_PACKS):
        raise RuntimeError(f"csrc/groupnorm.cu's backward block {[v.value for v in limits]} "
                           f"differs from the plan's {[BWD_THREADS, BWD_PACKS, BWD_SLICE_PACKS]}")
    fwd = [ctypes.c_int(0) for _ in range(2)]
    lib.gn_forward_limits(*(ctypes.byref(v) for v in fwd))
    if (fwd[0].value, fwd[1].value) != (FWD_THREADS, max(FWD_CLUSTERS)):
        raise RuntimeError(f"csrc/groupnorm.cu's forward block {[v.value for v in fwd]} "
                           f"differs from the plan's {[FWD_THREADS, max(FWD_CLUSTERS)]}")
    return lib


def backward_smem_bytes(element_size: int) -> int:
    """The backward block's dynamic shared memory: x twice and g once, a
    16-byte slot per pack (``BWD_PACKS`` a thread), the sums' scratch (a
    float per thread's pack channel and one row of the widest slice) and
    five parameters of each channel of the widest slice."""
    pack = 16 // element_size
    return (3 * BWD_PACKS * BWD_THREADS * 16
            + ((BWD_THREADS + BWD_SLICE_PACKS) * pack + 5 * BWD_SLICE_PACKS * pack) * 4)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How one backward call walks its units. A unit is one sample and a
    slice of ``width`` channels (whole groups) over all S rows; ``teams``
    teams of ``team_blocks`` blocks take units team, team + teams, ...; a
    team's blocks split a unit into ``team_blocks / col_blocks`` row ranges
    of ``rows_per_block`` rows times ``col_blocks`` column slices of
    ``block_width`` channels (the last may be narrower). The "on-chip" route
    holds a block's part of a unit on chip (x and g in shared memory, dŷ in
    registers) and reads x and g once; the "re-read" route streams them in
    chunks for the sums and again for dx, for units that do not fit on chip
    at a useful slice width."""

    width: int
    teams: int
    team_blocks: int
    rows_per_block: int
    units: int
    smem_bytes: int
    route: str = "on-chip"
    col_blocks: int = 1
    block_width: int = 0  # channels of a column block; 0: the whole slice

    @property
    def grid(self) -> int:
        return self.teams * self.team_blocks

    @property
    def block_channels(self) -> int:
        return self.block_width or self.width

    def workspace_words(self, batch: int, channels: int, groups: int) -> int:
        """fp32 words of the call's one workspace: the barriers' counters
        (rounded to 4), each block's per-group and per-channel partials of
        each unit, and the per-batch dγ, dβ terms (csrc/groupnorm.cu,
        ``gn_backward``)."""
        sync = (self.teams + 2 + 3) // 4 * 4
        per_unit = self.team_blocks * 2 * (self.width // (channels // groups) + self.width)
        return sync + self.units * per_unit + batch * 2 * channels

    def describe(self) -> str:
        cols = (f" in {self.col_blocks} column blocks of {self.block_channels}"
                if self.col_blocks > 1 else "")
        return (f"{self.units} units of {self.width} channels{cols}, {self.teams} teams of "
                f"{self.team_blocks} blocks (grid {self.grid}), {self.rows_per_block} rows a "
                f"block, {self.route}")


def _slice_efficiency(row_bytes: int) -> float:
    return max(v for k, v in SLICE_EFFICIENCY.items() if row_bytes >= k)


def slice_widths(channels: int, groups: int, element_size: int,
                 min_bytes: int = 32) -> list[int]:
    """The slices of channels a unit may take, narrowest first, in both
    directions: whole groups and whole 16-byte packs that divide C, at most
    ``PREFERRED_SLICE_PACKS`` packs unless the narrowest is wider (then that
    one alone), and none narrower than ``min_bytes`` of a row where a wider
    one exists."""
    pack = 16 // element_size
    if channels % pack:
        raise ValueError(f"channels {channels} must be a multiple of {pack}")
    if channels % groups:
        raise ValueError(f"channels {channels} not divisible by num_groups {groups}")
    step = math.lcm(channels // groups, pack)
    widths = [w for w in range(step, channels + 1, step) if channels % w == 0]
    widths = [w for w in widths if w * element_size >= min_bytes] or widths
    cap = max(PREFERRED_SLICE_PACKS, widths[0] // pack)
    return [w for w in widths if w // pack <= cap]


def backward_candidates(
    batch: int, spatial: int, channels: int, groups: int, element_size: int, num_sms: int,
    smem_per_block: int = MAX_SMEM_PER_BLOCK, blocks_per_sm: int = 2,
) -> list[tuple[BackwardPlan, float]]:
    """Every plan for one backward call, each with its modelled seconds
    (``backward_plan`` takes the least).

    Candidate slices are ``width`` channels that divide C, hold whole groups
    and whole 16-byte packs, at most ``PREFERRED_SLICE_PACKS`` packs where
    the narrowest such slice is no wider, else that slice alone; slices
    under one 32-byte sector of a row only where no wider one exists. A
    slice wider than ``BWD_SLICE_PACKS`` packs is split over column blocks.
    Candidate teams split the ``num_sms * blocks_per_sm`` resident blocks
    evenly. An on-chip candidate needs a block's rows of a unit to fill at
    most its ``BWD_PACKS`` packs a thread; a re-read candidate takes any
    number of rows, in chunks of that size. The model: units a team walks,
    times each block's bytes of a unit (x, g and dx once on chip; x and g
    twice when re-read) at the block's share of the HBM rate (lower for
    narrow row slices, ``SLICE_EFFICIENCY``), plus its barrier
    (``BARRIER_S``) and, re-read, ``CHUNK_S`` a chunk a pass."""
    pack = 16 // element_size
    smem = backward_smem_bytes(element_size)
    if smem > smem_per_block:
        raise ValueError(f"the backward block takes {smem} bytes of shared memory, "
                         f"more than {smem_per_block}")
    grid = num_sms * blocks_per_sm
    out = []
    for width in slice_widths(channels, groups, element_size):
        packs = width // pack
        block_packs = math.ceil(packs / math.ceil(packs / BWD_SLICE_PACKS))
        col_blocks = math.ceil(packs / block_packs)
        rows_fit = BWD_PACKS * (BWD_THREADS // block_packs)
        units = batch * (channels // width)
        eff = _slice_efficiency(block_packs * 16)
        for teams in range(1, min(units, grid) + 1):
            row_blocks = grid // teams // col_blocks
            if row_blocks == 0:
                break
            team_blocks = row_blocks * col_blocks
            rows = math.ceil(spatial / row_blocks)
            share = HBM_BYTES_PER_S / (teams * team_blocks)  # a block's, of the launched
            block_bytes = rows * block_packs * 16
            waves = math.ceil(units / teams)
            plan = BackwardPlan(width, teams, team_blocks, rows, units, smem,
                                col_blocks=col_blocks,
                                block_width=block_packs * pack if col_blocks > 1 else 0)
            if rows <= rows_fit:
                out.append((plan, waves * (3 * block_bytes / share / eff + BARRIER_S)))
            chunks = math.ceil(rows / rows_fit)
            out.append((dataclasses.replace(plan, route="re-read"),
                        waves * (5 * block_bytes / share / eff + BARRIER_S
                                 + 2 * chunks * CHUNK_S)))
    return out


@functools.lru_cache(maxsize=None)
def backward_plan(
    batch: int, spatial: int, channels: int, groups: int, element_size: int, num_sms: int,
    smem_per_block: int = MAX_SMEM_PER_BLOCK, blocks_per_sm: int = 2,
) -> BackwardPlan:
    """The backward's route, units, teams and grid for one call (pure
    Python): the candidate of ``backward_candidates`` with the least
    modelled time, the first of equals. Every shape the wrappers take has at
    least one."""
    cands = backward_candidates(batch, spatial, channels, groups, element_size, num_sms,
                                smem_per_block, blocks_per_sm)
    return min(cands, key=lambda pc: pc[1])[0]


def forward_red_floats(width: int, packs: int) -> int:
    """The floats of a forward block's sums' scratch (csrc/groupnorm.cu
    ``forward_red_floats``): eight warps' rows of both sums where a row's
    packs are a power of two up to 16, else one row of each in flight plus
    one."""
    if packs <= 16 and packs & (packs - 1) == 0:
        return 16 * width
    return (FWD_THREADS // packs + 1) * width


def forward_smem_bytes(width: int, groups_in_slice: int, element_size: int, slots: int,
                       cluster: int, halves: int = 1) -> int:
    """A forward block's dynamic shared memory: ``halves`` times ``slots``
    16-byte packs a thread, the sums' scratch, two copies of the block's
    sums of each group of the slice (which the cluster reads), the
    cluster's sums and two coefficients a channel."""
    packs = width * element_size // 16
    return (halves * slots * FWD_THREADS * 16
            + 4 * (forward_red_floats(width, packs) + (4 + 2 * cluster) * groups_in_slice
                   + 2 * width))


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """How one forward call walks its units. A unit is one sample and a
    slice of ``width`` channels (whole groups) over all S rows; as many
    clusters of ``cluster`` blocks as the device holds at once walk the
    units, block r of a cluster the rows [r·rows_per_block, (r +
    1)·rows_per_block) of each. A thread takes its rows of a unit in rounds
    of up to ``slots`` 16-byte packs in shared memory: one round where they
    fit (``halves`` 1), else rounds in two halves of slots, each loading
    while the other is used; the rounds before the last two are read twice
    (the second time from L2)."""

    width: int
    cluster: int
    rows_per_block: int
    slots: int
    units: int
    smem_bytes: int
    halves: int = 1

    @property
    def blocks_per_sm(self) -> int:
        return min(FWD_MAX_BLOCKS_PER_SM, SM_SMEM_BYTES // (self.smem_bytes + 1024))

    def rows_in_flight(self, element_size: int) -> int:
        return FWD_THREADS // (self.width * element_size // 16)

    def rounds(self, element_size: int) -> int:
        """Rounds a thread with the most rows takes."""
        return math.ceil(math.ceil(self.rows_per_block / self.rows_in_flight(element_size))
                         / self.slots)

    def held_rows(self, spatial: int, element_size: int) -> int:
        """The rows of a unit its cluster holds in shared memory at once."""
        cap = self.halves * self.slots * self.rows_in_flight(element_size)
        return sum(min(cap, max(0, min(spatial, (r + 1) * self.rows_per_block)
                                - r * self.rows_per_block))
                   for r in range(self.cluster))

    def describe(self) -> str:
        held = f"{self.slots} packs" if self.halves == 1 else f"rounds of {self.slots} packs"
        return (f"{self.units} units of {self.width} channels, clusters of {self.cluster}, "
                f"{self.rows_per_block} rows a block, {held} a thread, "
                f"{self.blocks_per_sm} blocks an SM")


def _forward_slots(width: int, cluster: int, spatial: int, groups_in_slice: int,
                   element_size: int, smem_per_block: int, per_sm: int) -> ForwardPlan | None:
    """The plan (less its units) of ``width`` and ``cluster`` whose blocks
    fit ``per_sm`` to an SM: each thread holds all its rows of a unit where
    they fit (one round), else rounds of half the packs that fit; None where
    not even that fits."""
    rows = math.ceil(spatial / cluster)
    need = math.ceil(rows / (FWD_THREADS // (width * element_size // 16)))
    base = forward_smem_bytes(width, groups_in_slice, element_size, 0, cluster)
    room = (min(smem_per_block, SM_SMEM_BYTES // per_sm - 1024) - base) // (16 * FWD_THREADS)
    if need <= room:
        slots, halves = need, 1
    elif room >= 2:
        slots, halves = room // 2, 2
    else:
        return None
    return ForwardPlan(width, cluster, rows, slots, 0, forward_smem_bytes(
        width, groups_in_slice, element_size, slots, cluster, halves), halves)


def _forward_widths(channels: int, groups: int, element_size: int) -> list[int]:
    pack = 16 // element_size
    widths = [w for w in slice_widths(channels, groups, element_size, min_bytes=16)
              if w // pack <= FWD_THREADS]
    if not widths:
        raise ValueError(f"no forward plan: a slice of whole groups of {channels // groups} "
                         f"channels is wider than {FWD_THREADS} packs")
    return widths


def forward_candidates(
    batch: int, spatial: int, channels: int, groups: int, element_size: int,
    smem_per_block: int = MAX_SMEM_PER_BLOCK,
) -> list[ForwardPlan]:
    """Every plan for one forward call, for ``forward_plan``'s rule to be
    checked against (``tools/sweep_gn_bwd.py --forward``): every slice of
    ``slice_widths`` (16-byte ones too) of at most ``FWD_THREADS`` packs,
    every cluster of ``FWD_CLUSTERS`` whose every block has rows, with the
    packs held for two blocks an SM and for one."""
    out = []
    for width in _forward_widths(channels, groups, element_size):
        for cluster in FWD_CLUSTERS:
            if (cluster - 1) * math.ceil(spatial / cluster) >= spatial:
                break  # a block of the cluster would have no rows
            for per_sm in (2, 1):
                plan = _forward_slots(width, cluster, spatial, width // (channels // groups),
                                      element_size, smem_per_block, per_sm)
                if plan is not None and plan not in out:
                    out.append(plan)
    return [dataclasses.replace(p, units=batch * (channels // p.width)) for p in out]


@functools.lru_cache(maxsize=None)
def forward_plan(
    batch: int, spatial: int, channels: int, groups: int, element_size: int,
    smem_per_block: int = MAX_SMEM_PER_BLOCK,
) -> ForwardPlan:
    """The forward's slice, cluster and held packs for one call (pure
    Python): the widest slice of ``_forward_widths`` of at most
    ``FWD_ROW_BYTES`` of a row (the narrowest where none is), narrower while
    the call has fewer than ``FWD_MIN_UNITS`` units; the smallest cluster of
    ``FWD_CLUSTERS`` whose blocks take at most ``FWD_ROUND_PACKS`` rows a
    thread, else the largest; the packs held for two blocks an SM, else one.
    Raises where there is none."""
    widths = _forward_widths(channels, groups, element_size)
    narrow = [w for w in widths if w * element_size <= FWD_ROW_BYTES] or widths[:1]
    width = next((w for w in reversed(narrow) if batch * (channels // w) >= FWD_MIN_UNITS),
                 narrow[0])
    rows_in_flight = FWD_THREADS // (width * element_size // 16)
    cluster = next((k for k in FWD_CLUSTERS
                    if math.ceil(math.ceil(spatial / k) / rows_in_flight) <= FWD_ROUND_PACKS),
                   FWD_CLUSTERS[-1])
    for per_sm in (2, 1):
        plan = _forward_slots(width, cluster, spatial, width // (channels // groups),
                              element_size, smem_per_block, per_sm)
        if plan is not None:
            return dataclasses.replace(plan, units=batch * (channels // width))
    raise ValueError(f"no forward plan: a block of the slice of {width} channels does not "
                     f"fit in {smem_per_block} bytes of shared memory")


def channels_last_format(x: torch.Tensor) -> torch.memory_format:
    """The channels-last memory format of a 4-D or 5-D tensor."""
    if x.ndim == 4:
        return torch.channels_last
    if x.ndim == 5:
        return torch.channels_last_3d
    raise ValueError(f"expected (B, C, H, W) or (B, C, T, H, W), got shape {tuple(x.shape)}")


def check_layout(x: torch.Tensor) -> None:
    """Raises unless x is channels-last: (B, C, H, W) in channels_last or
    (B, C, T, H, W) in channels_last_3d."""
    if not x.is_contiguous(memory_format=channels_last_format(x)):
        raise ValueError(
            "fused_group_norm needs a torch.channels_last-contiguous input "
            "(channels_last_3d for 5-D; physically (B, ..., C)); convert it "
            "once where it is made"
        )


def check_operands(x, weight, bias, num_groups) -> None:
    """Raises unless x is fp32 or bf16 on the CPU or a CUDA device, its
    channels split into ``num_groups`` groups, and weight and bias are
    contiguous fp32 (C,) tensors on its device."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_group_norm takes float32 or bfloat16, not {x.dtype}")
    c = x.shape[1]
    if c % num_groups or num_groups > _MAX_GROUPS:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups} "
                         f"(at most {_MAX_GROUPS} groups)")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or tuple(p.shape) != (c,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_group_norm runs on cpu or cuda, not {x.device}")


def check_inputs(x, weight, bias, num_groups) -> None:
    """``check_layout`` and ``check_operands``."""
    check_layout(x)
    check_operands(x, weight, bias, num_groups)


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        raise RuntimeError(
            f"groupnorm {what} kernel launch failed: {lib.gn_error_string(err).decode()}"
        )


@functools.cache
def backward_blocks_per_sm(device_index: int, dtype: torch.dtype, with_swish: bool,
                           defines: tuple[str, ...] = ()) -> int:
    """Allows the backward kernels (both routes) their shared memory on the
    device (once) and returns how many blocks an SM holds of the route that
    holds fewer (the occupancy API): the cooperative launch's grid is at
    most that many times the SMs."""
    lib = library(defines)
    smem = backward_smem_bytes(torch.empty((), dtype=dtype).element_size())
    per_sm = []
    for reread in (0, 1):
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            err = lib.gn_backward_occupancy(_DTYPE_CODES[dtype], int(with_swish), reread, smem,
                                            ctypes.byref(blocks))
        _raise_on(err, lib, "backward occupancy")
        per_sm.append(blocks.value)
    if min(per_sm) < 1:
        raise RuntimeError("the GroupNorm backward block does not fit on an SM")
    return min(per_sm)


def group_norm_forward(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    with_swish: bool = False,
    plan: ForwardPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward, outside autograd: ``(y, stats)``, y in x's dtype and
    channels-last layout, stats the fp32 (B, 2, G) mean and rstd, through the
    operator ``vqgan_tpu_torch::gn_forward`` (``ops/custom_ops.py``): a CUDA
    tensor launches kernel #1 with ``forward_plan``'s plan (and counts it in
    ``launches``), a CPU tensor runs the plain version. A ``plan`` (CUDA
    only; the tools that time candidate plans) launches the kernel with that
    plan instead, outside the operator."""
    if plan is None:
        return custom_ops.gn_forward(x, weight, bias, num_groups, eps, with_swish)
    check_inputs(x, weight, bias, num_groups)
    if x.device.type != "cuda":
        raise ValueError(f"a forward plan is for kernel #1 on a CUDA device, not {x.device}")
    return _launch_forward(x, weight, bias, num_groups, eps, with_swish, plan)


@functools.cache
def forward_max_clusters(device_index: int, dtype: torch.dtype, with_swish: bool,
                         cluster: int, smem: int, defines: tuple[str, ...] = ()) -> int:
    """Allows the forward kernels their shared memory and clusters of up to
    16 blocks on the device (once), and returns how many clusters of
    ``cluster`` blocks of ``smem`` bytes it holds at once (the occupancy
    API; 0: such a launch cannot run)."""
    lib = library(defines)
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _raise_on(lib.gn_forward_setup(MAX_SMEM_PER_BLOCK), lib, "forward setup")
        err = lib.gn_forward_max_clusters(_DTYPE_CODES[dtype], int(with_swish), cluster, smem,
                                          ctypes.byref(count))
    _raise_on(err, lib, "forward occupancy")
    return count.value


def _launch_forward(x, weight, bias, num_groups, eps, with_swish, plan,
                    defines: tuple[str, ...] = ()):
    global launches
    b, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    if x.data_ptr() % 16:
        raise ValueError("fused_group_norm needs a 16-byte aligned input")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if plan is None:
        plan = forward_plan(b, s, c, num_groups, x.element_size())
    if plan.halves < 2 and plan.rounds(x.element_size()) > 1:
        raise ValueError(f"a plan of several rounds needs two halves of slots: {plan}")
    fit = forward_max_clusters(dev, x.dtype, with_swish, plan.cluster, plan.smem_bytes, defines)
    if fit < 1:
        raise RuntimeError(f"the GroupNorm forward's clusters ({plan.describe()}) do not fit "
                           f"on the device")
    clusters = min(plan.units, fit)
    lib = library(defines)
    y = torch.empty_like(x, memory_format=channels_last_format(x))
    stats = torch.empty((b, 2, num_groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gn_forward(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), stats.data_ptr(),
            b, s, c, num_groups, plan.width, plan.cluster, clusters, plan.rows_per_block,
            plan.slots, plan.halves, plan.smem_bytes, eps, int(with_swish),
            _DTYPE_CODES[x.dtype], stream,
        )
    _raise_on(err, lib, "forward")
    launches += 1
    return y, stats


def group_norm_backward(
    x: torch.Tensor,
    g: torch.Tensor,
    stats: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    with_swish: bool = False,
    plan: BackwardPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward, outside autograd: ``(dx, dγ, dβ)`` for the incoming
    gradient g at x, given the forward's (B, 2, G) stats. g must have x's
    shape, dtype and channels-last layout. A CUDA tensor launches kernel #2
    (and counts it in ``bwd_launches``) with ``plan``, by default
    ``backward_plan``'s; a CPU tensor runs the plain version."""
    check_inputs(x, weight, bias, num_groups)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"gradient {tuple(g.shape)} {g.dtype} on {g.device} does not match "
            f"the input {tuple(x.shape)} {x.dtype} on {x.device}"
        )
    if not g.is_contiguous(memory_format=channels_last_format(x)):
        raise ValueError("the GroupNorm backward needs a channels_last-contiguous gradient")
    b = x.shape[0]
    if (stats.dtype != torch.float32 or tuple(stats.shape) != (b, 2, num_groups)
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"stats must be a contiguous float32 ({b}, 2, {num_groups}) "
                         f"tensor on {x.device}")
    if x.device.type == "cpu":
        return group_norm_fp32_backward(x, g, stats[:, 0], stats[:, 1], weight, bias,
                                        num_groups, with_swish)
    return _launch_backward(x, g, stats, weight, bias, num_groups, with_swish, plan)


def _launch_backward(x, g, stats, weight, bias, num_groups, with_swish, plan,
                     defines: tuple[str, ...] = ()):
    global bwd_launches
    b, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("the GroupNorm backward needs 16-byte aligned x and gradient")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    per_sm = backward_blocks_per_sm(dev, x.dtype, with_swish, defines)
    if plan is None:
        plan = backward_plan(b, s, c, num_groups, x.element_size(), num_sms(dev),
                             blocks_per_sm=per_sm)
    lib = library(defines)
    dx = torch.empty_like(x, memory_format=channels_last_format(x))
    dgamma_dbeta = torch.empty((2, c), dtype=torch.float32, device=x.device)
    workspace = torch.empty(plan.workspace_words(b, c, num_groups), dtype=torch.float32,
                            device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gn_backward(
            x.data_ptr(), g.data_ptr(), stats.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), dx.data_ptr(), dgamma_dbeta.data_ptr(), workspace.data_ptr(),
            b, s, c, num_groups, plan.width, plan.team_blocks, plan.teams,
            plan.rows_per_block, plan.col_blocks, plan.block_channels,
            int(plan.route == "re-read"), plan.smem_bytes, int(with_swish),
            _DTYPE_CODES[x.dtype], stream,
        )
    _raise_on(err, lib, "backward")
    bwd_launches += 1
    return dx, dgamma_dbeta[0], dgamma_dbeta[1]


class FusedGroupNorm(torch.autograd.Function):
    """GroupNorm(+swish) with the kernels (CUDA) or the plain versions (CPU)
    forward and backward; the counterpart of ``_fused_gn_vjp``."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, with_swish):
        y, stats = group_norm_forward(x, weight, bias, num_groups, eps, with_swish)
        ctx.save_for_backward(x, stats, weight, bias)
        ctx.num_groups = num_groups
        ctx.with_swish = with_swish
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        global grad_copies
        x, stats, weight, bias = ctx.saved_tensors
        # a flip or a slice downstream can hand back another layout
        fmt = channels_last_format(g)
        if not g.is_contiguous(memory_format=fmt):
            grad_copies += 1
            g = g.contiguous(memory_format=fmt)
        dx, dgamma, dbeta = group_norm_backward(
            x, g, stats, weight, bias, ctx.num_groups, ctx.with_swish
        )
        return dx, dgamma, dbeta, None, None, None


def fused_group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    with_swish: bool = False,
) -> torch.Tensor:
    """GroupNorm(+swish) of a channels_last (B, C, H, W) or channels_last_3d
    (B, C, T, H, W) tensor with fp32 statistics and arithmetic; returns x's
    dtype and layout, and is differentiable in x, weight and bias."""
    return FusedGroupNorm.apply(x, weight, bias, num_groups, eps, with_swish)


# ---------------------------------------------------------------------------
# the two-pass form


def _ctx_check(x, weight, bias, num_groups) -> None:
    check_inputs(x, weight, bias, num_groups)
    if x.device.type == "cuda":
        if x.data_ptr() % 16:
            raise ValueError("the two-pass GroupNorm needs a 16-byte aligned input")
        if x.shape[1] * x.element_size() % 16:
            raise ValueError(f"the two-pass GroupNorm needs C·itemsize a multiple of 16 bytes, "
                             f"not {x.shape[1]} x {x.element_size()}")


def _ctx_grid(x) -> tuple[int, int, int, int, int]:
    """(B, S, C, the sums' blocks a sample, the apply's blocks a sample) of
    a two-pass launch on x: about CTX_BLOCKS_PER_SM blocks an SM over the
    call (a sums block at least 64 rows, an apply thread at least one
    16-byte pack)."""
    b, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    want = -(-CTX_BLOCKS_PER_SM * num_sms(dev) // b)
    packs = s * c * x.element_size() // 16
    return (b, s, c, max(1, min(want, -(-s // 64))),
            max(1, min(want, -(-packs // CTX_THREADS))))


def _ctx_stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def group_norm_partial_sums(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """The two-pass forward's first pass: fp32 (B, 2, G) Σx, Σx² of x's
    rows per (batch, group). A CUDA tensor launches ``gn_ctx_sums_kernel``
    (counted in ``ctx_sums_launches``); a CPU tensor runs the plain
    version."""
    global ctx_sums_launches
    if x.device.type == "cpu":
        return plain.group_norm_partial_sums(x, num_groups)
    ones = torch.ones(x.shape[1], device=x.device)
    _ctx_check(x, ones, ones, num_groups)
    b, s, c, splits, _ = _ctx_grid(x)
    out = torch.empty((b, 2, num_groups), dtype=torch.float32, device=x.device)
    workspace = torch.empty(4 + b * splits * 2 * num_groups, dtype=torch.float32,
                            device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.gn_ctx_sums(x.data_ptr(), None, None, None, None, out.data_ptr(),
                              workspace.data_ptr(), b, s, c, num_groups, splits, 0, 0,
                              _DTYPE_CODES[x.dtype], _ctx_stream(x))
    _raise_on(err, lib, "two-pass forward sums")
    ctx_sums_launches += 1
    return out


def group_norm_apply(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_groups: int = 32,
                     with_swish: bool = False) -> torch.Tensor:
    """The two-pass forward's second pass: y (x's dtype and channels-last
    layout) from the (B, 2, G) mean and rstd. A CUDA tensor launches
    ``gn_ctx_apply_kernel`` (``ctx_apply_launches``); a CPU tensor the plain
    version."""
    global ctx_apply_launches
    if x.device.type == "cpu":
        return plain.group_norm_apply(x, stats, weight, bias, num_groups, with_swish)
    _ctx_check(x, weight, bias, num_groups)
    b, s, c, _, blocks = _ctx_grid(x)
    y = torch.empty_like(x, memory_format=channels_last_format(x))
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.gn_ctx_apply(x.data_ptr(), None, stats.contiguous().data_ptr(), None,
                               weight.data_ptr(), bias.data_ptr(), y.data_ptr(), b, s, c,
                               num_groups, blocks, 0.0, 0, int(with_swish),
                               _DTYPE_CODES[x.dtype], _ctx_stream(x))
    _raise_on(err, lib, "two-pass forward apply")
    ctx_apply_launches += 1
    return y


def group_norm_backward_partial(x, g, stats, weight, bias, num_groups: int = 32,
                                with_swish: bool = False):
    """The two-pass backward's first pass: ``(gsums, dγ, dβ)``, gsums the
    fp32 (B, 2, G) Σγ·dŷ and Σγ·dŷ·x̂ of x's rows, dγ and dβ this rank's
    fp32 (C,). A CUDA tensor launches ``gn_ctx_bwd_sums_kernel``
    (``ctx_bwd_sums_launches``); a CPU tensor the plain version."""
    global ctx_bwd_sums_launches
    if x.device.type == "cpu":
        return plain.group_norm_backward_partial(x, g, stats, weight, bias, num_groups,
                                                 with_swish)
    _ctx_check(x, weight, bias, num_groups)
    b, s, c, splits, _ = _ctx_grid(x)
    out = torch.empty(b * 2 * num_groups + 2 * c, dtype=torch.float32, device=x.device)
    workspace = torch.empty(4 + b * splits * 2 * c, dtype=torch.float32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.gn_ctx_sums(x.data_ptr(), g.data_ptr(), stats.contiguous().data_ptr(),
                              weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                              workspace.data_ptr(), b, s, c, num_groups, splits, 1,
                              int(with_swish), _DTYPE_CODES[x.dtype], _ctx_stream(x))
    _raise_on(err, lib, "two-pass backward sums")
    ctx_bwd_sums_launches += 1
    gsums = out[:b * 2 * num_groups].view(b, 2, num_groups)
    dgdb = out[b * 2 * num_groups:].view(2, c)
    return gsums, dgdb[0], dgdb[1]


def group_norm_backward_dx(x, g, stats, gsums, count: int, weight, bias,
                           num_groups: int = 32, with_swish: bool = False) -> torch.Tensor:
    """The two-pass backward's second pass: dx (x's dtype and channels-last
    layout) from the (B, 2, G) gsums summed over the ranks, ``count``
    elements a group over every rank. A CUDA tensor launches
    ``gn_ctx_dx_kernel`` (``ctx_dx_launches``); a CPU tensor the plain
    version."""
    global ctx_dx_launches
    if x.device.type == "cpu":
        return plain.group_norm_backward_dx(x, g, stats, gsums, count, weight, bias,
                                            num_groups, with_swish)
    _ctx_check(x, weight, bias, num_groups)
    b, s, c, _, blocks = _ctx_grid(x)
    dx = torch.empty_like(x, memory_format=channels_last_format(x))
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.gn_ctx_apply(x.data_ptr(), g.data_ptr(), stats.contiguous().data_ptr(),
                               gsums.contiguous().data_ptr(), weight.data_ptr(),
                               bias.data_ptr(), dx.data_ptr(), b, s, c, num_groups, blocks,
                               float(count), 1, int(with_swish), _DTYPE_CODES[x.dtype],
                               _ctx_stream(x))
    _raise_on(err, lib, "two-pass dx")
    ctx_dx_launches += 1
    return dx


class ContextGroupNorm(torch.autograd.Function):
    """GroupNorm(+swish) of a tensor whose rows (a clip's T·H·W) are split
    over ``group``'s ranks, each holding its block, in the two-pass form:
    the statistics and the backward's group sums are the whole tensor's
    (one ``all_reduce`` of a (B, 2, G) buffer each way); dγ and dβ are this
    rank's shares (the step sums the gradients across the ranks). No group:
    the two-pass form on one rank."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, with_swish, group):
        check_layout(x)
        sums = group_norm_partial_sums(x, num_groups)
        if group is not None:
            dist.all_reduce(sums, group=group)
        count = math.prod(x.shape[2:]) * (x.shape[1] // num_groups) * (
            1 if group is None else dist.get_world_size(group))
        stats = plain.group_norm_stats_from_sums(sums, count, eps)
        y = group_norm_apply(x, stats, weight, bias, num_groups, with_swish)
        ctx.save_for_backward(x, stats, weight, bias)
        ctx.num_groups, ctx.with_swish, ctx.group, ctx.count = (num_groups, with_swish, group,
                                                                count)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        global grad_copies
        x, stats, weight, bias = ctx.saved_tensors
        fmt = channels_last_format(g)
        if not g.is_contiguous(memory_format=fmt):
            grad_copies += 1
            g = g.contiguous(memory_format=fmt)
        gsums, dgamma, dbeta = group_norm_backward_partial(x, g, stats, weight, bias,
                                                           ctx.num_groups, ctx.with_swish)
        if ctx.group is not None:
            gsums = gsums.contiguous()
            dist.all_reduce(gsums, group=ctx.group)
        dx = group_norm_backward_dx(x, g, stats, gsums, ctx.count, weight, bias,
                                    ctx.num_groups, ctx.with_swish)
        return dx, dgamma, dbeta, None, None, None, None


def context_group_norm(x, weight, bias, num_groups: int = 32, eps: float = 1e-6,
                       with_swish: bool = False, group=None) -> torch.Tensor:
    """GroupNorm(+swish) over the rows of x and of the other ranks of
    ``group`` (``ContextGroupNorm``); differentiable, collective."""
    return ContextGroupNorm.apply(x, weight, bias, num_groups, eps, with_swish, group)


# the operator that the forward goes through; it binds this module's launch
# and checks, so it is imported once they are defined
from vqgan_tpu_torch.ops import custom_ops  # noqa: E402
