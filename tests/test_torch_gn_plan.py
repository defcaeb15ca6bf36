"""The GroupNorm backward's and forward's launch plans
(``ops/groupnorm_cuda.py::backward_plan``, ``forward_plan``), on the CPU:
pure Python, no card.

At every GroupNorm shape of the flagship training step (batch 8)
and of the 3D training steps (batch 2, 16 frames x 128 px), in both dtypes,
and for every channel count the forward takes (every multiple of 32 up to
1,280 at 32 groups, 48 in 16, one group wider than a block), the plan's
units cover every (sample, channel) exactly once in whole groups, each slice
spans at least one 32-byte sector of a row where its groups allow, a block's
column slice fits its threads, an on-chip plan's rows of a unit fit a
block's packs, the blocks of a team cover every row and channel of a unit,
the grid fits the resident blocks the plan was given, and the workspace
holds every partial. The forward's plan at the same shapes: units of whole
groups that cover every (sample, channel) once, from the same slice rule,
clusters whose blocks each take rows and together every row, rounds of held
packs, shared memory for two blocks an SM, and the rule's slice and
cluster (row slices of at most 128 bytes, at least four units; the
smallest cluster whose threads take at most 16 rows).
"""

import math

import numpy as np
import pytest

from vqgan_tpu_torch.ops.groupnorm_cuda import (
    BWD_PACKS,
    BWD_SLICE_PACKS,
    BWD_THREADS,
    FWD_CLUSTERS,
    FWD_MIN_UNITS,
    FWD_ROUND_PACKS,
    FWD_ROW_BYTES,
    FWD_THREADS,
    MAX_SMEM_PER_BLOCK,
    PREFERRED_SLICE_PACKS,
    backward_candidates,
    backward_plan,
    backward_smem_bytes,
    forward_candidates,
    forward_plan,
    forward_smem_bytes,
    slice_widths,
)

NUM_SMS, BLOCKS_PER_SM = 132, 2  # an H100 SXM, two backward blocks an SM
SM_SMEM = 233_472  # an H100 SM's shared memory
# (B, S, C): the flagship step's calls at batch 8, the 3D steps' at batch 2
FLAGSHIP = [(8, s, c) for s, c in [(65536, 256), (65536, 512), (16384, 1024), (16384, 512),
                                   (16384, 256), (4096, 1024), (4096, 512), (1024, 1024)]]
STEP3D = [(2, 16 * 128 * 128, 64), (2, 16 * 128 * 128, 128), (2, 8 * 64 * 64, 128),
          (2, 8 * 64 * 64, 256), (2, 4 * 32 * 32, 256)]


def _check(plan, b, s, c, groups, element_size):
    pack = 16 // element_size
    cg = c // groups
    # units: every (sample, channel) once, whole groups
    assert plan.width % cg == 0 and c % plan.width == 0 and plan.width % pack == 0
    assert plan.units == b * (c // plan.width)
    covered = np.zeros((b, c), dtype=np.int64)
    for u in range(plan.units):
        b_, c0 = divmod(u, c // plan.width)
        covered[b_, c0 * plan.width:(c0 + 1) * plan.width] += 1
    assert (covered == 1).all()
    # a slice: at least one sector of a row where the groups allow one; no
    # wider than the preferred packs unless it is the narrowest whole-group
    # slice
    narrowest = math.lcm(cg, pack)
    if any(w * element_size >= 32 for w in range(narrowest, c + 1, narrowest) if c % w == 0):
        assert plan.width * element_size >= 32
    packs = plan.width // pack
    assert packs <= PREFERRED_SLICE_PACKS or plan.width == narrowest
    # column blocks: each at most BWD_SLICE_PACKS packs, the last not empty
    bw = plan.block_channels
    assert bw % pack == 0 and bw // pack <= BWD_SLICE_PACKS
    assert plan.col_blocks == math.ceil(plan.width / bw)
    assert (plan.col_blocks == 1) == (packs <= BWD_SLICE_PACKS)
    assert plan.team_blocks % plan.col_blocks == 0
    # on chip, a block's rows fit its threads' packs; the team covers every row
    assert plan.route in ("on-chip", "re-read")
    if plan.route == "on-chip":
        assert plan.rows_per_block <= BWD_PACKS * (BWD_THREADS // (bw // pack))
    assert plan.team_blocks // plan.col_blocks * plan.rows_per_block >= s
    # the grid fits the resident blocks; no team without a unit
    assert plan.grid <= NUM_SMS * BLOCKS_PER_SM
    assert 1 <= plan.teams <= plan.units
    assert plan.smem_bytes == backward_smem_bytes(element_size) <= MAX_SMEM_PER_BLOCK
    assert BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= SM_SMEM
    # the workspace: counters, then each block's partials of each unit
    gw = plan.width // cg
    want = (math.ceil((plan.teams + 2) / 4) * 4
            + plan.units * plan.team_blocks * 2 * (gw + plan.width) + b * 2 * c)
    assert plan.workspace_words(b, c, groups) == want


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,s,c", FLAGSHIP + STEP3D,
                         ids=[f"B{b}-S{s}-C{c}" for b, s, c in FLAGSHIP + STEP3D])
def test_plan_covers_the_call(b, s, c, element_size):
    """Every path shape reads x and g once, on chip, except the 3D steps'
    262,144-row calls, whose on-chip slices would be one 32-byte sector a
    row: they re-read whole 128-byte row slices."""
    plan = backward_plan(b, s, c, 32, element_size, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    _check(plan, b, s, c, 32, element_size)
    assert plan.route == ("re-read" if s == 16 * 128 * 128 else "on-chip")
    if plan.route == "re-read":
        assert plan.width * element_size >= 128


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
def test_every_width_has_a_plan(element_size):
    """Every C that is a multiple of 32 up to 1,280 at 32 groups, and 48
    channels in 16 groups, at every 2D flagship and 3D path shape: a
    backward plan, never a raise (the forward takes them all)."""
    cases = [(c, 32) for c in range(32, 1281, 32)] + [(48, 16)]
    for c, groups in cases:
        for b, s, _ in FLAGSHIP + STEP3D:
            plan = backward_plan(b, s, c, groups, element_size, NUM_SMS,
                                 blocks_per_sm=BLOCKS_PER_SM)
            _check(plan, b, s, c, groups, element_size)
            assert plan.col_blocks == 1


def test_power_of_two_widths_keep_their_slices():
    """C = 96 and 192 take slices of 3 and 6 bf16 packs (12 and 24 fp32),
    which no power-of-two rule allowed; the flagship widths keep slices of a
    power of two of packs, at most 16."""
    plan = backward_plan(8, 4096, 96, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    assert plan.width in (24, 48, 96) and plan.route == "on-chip"
    for b, s, c in FLAGSHIP:
        for es in (2, 4):
            plan = backward_plan(b, s, c, 32, es, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
            packs = plan.width * es // 16
            assert packs & (packs - 1) == 0 and packs <= PREFERRED_SLICE_PACKS


@pytest.mark.parametrize("c,groups", [(64, 32), (128, 16), (256, 32), (512, 32), (1024, 32),
                                      (32, 32), (96, 32), (192, 32), (48, 16), (328, 1),
                                      (6144, 1)])
def test_every_candidate_is_a_valid_plan(c, groups):
    """Every candidate the rule weighs, at small and ragged sizes too; slices
    wider than a block split over column blocks."""
    for b, s in [(1, 1), (3, 63), (2, 4096)]:
        for element_size in (2, 4):
            if c % (16 // element_size):
                continue
            cands = backward_candidates(b, s, c, groups, element_size, NUM_SMS,
                                        blocks_per_sm=BLOCKS_PER_SM)
            assert cands
            for plan, seconds in cands:
                _check(plan, b, s, c, groups, element_size)
                assert seconds > 0


def test_the_rule_takes_the_least_modelled_time():
    cands = backward_candidates(8, 4096, 1024, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    best = min(cands, key=lambda pc: pc[1])[0]
    assert backward_plan(8, 4096, 1024, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM) == best
    assert len(cands) > 1


def test_a_call_too_large_for_the_chip_re_reads_and_odd_groups_raise():
    """More rows a sample than the resident blocks hold at the narrowest
    slice: only re-read plans. Channels whose whole-group slices are no
    power of two of packs (48 in 16 groups: 3 bf16 packs) and a group wider
    than a block (328 channels in 1: 41 packs, two column blocks) now have
    plans too."""
    rows = NUM_SMS * BLOCKS_PER_SM * BWD_PACKS * (BWD_THREADS // 2) + 1
    cands = backward_candidates(1, rows, 64, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    assert cands and all(p.route == "re-read" for p, _ in cands)
    _check(backward_plan(1, rows, 64, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM),
           1, rows, 64, 32, 2)
    plan = backward_plan(2, 64, 48, 16, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    _check(plan, 2, 64, 48, 16, 2)
    assert plan.width == 48
    wide = backward_plan(2, 4096, 328, 1, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    _check(wide, 2, 4096, 328, 1, 2)
    assert wide.col_blocks == 2 and wide.block_channels == 168


def test_workspace_words_hold_every_partial():
    plan = backward_plan(8, 65536, 512, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    groups_per_slice = plan.width // (512 // 32)
    want = (math.ceil((plan.teams + 2) / 4) * 4
            + plan.units * plan.team_blocks * 2 * (groups_per_slice + plan.width) + 8 * 2 * 512)
    assert plan.workspace_words(8, 512, 32) == want


def _check_forward(plan, b, s, c, groups, element_size):
    pack = 16 // element_size
    cg = c // groups
    # units: every (sample, channel) once, whole groups and packs, from the
    # slice rule both directions share (16-byte slices allowed)
    assert plan.width in slice_widths(c, groups, element_size, min_bytes=16)
    assert plan.width % cg == 0 and c % plan.width == 0 and plan.width % pack == 0
    assert plan.width // pack <= FWD_THREADS
    assert plan.units == b * (c // plan.width)
    # the cluster's blocks each take rows, and together every row once
    assert plan.cluster in FWD_CLUSTERS
    assert plan.cluster == 1 or (plan.cluster - 1) * plan.rows_per_block < s
    assert plan.cluster * plan.rows_per_block >= s
    assert plan.slots >= 1 and 0 < plan.held_rows(s, element_size) <= s
    # rounds: as many as a thread's rows need at its held packs
    rows_in_flight = FWD_THREADS // (plan.width // pack)
    assert plan.rounds(element_size) == math.ceil(
        math.ceil(plan.rows_per_block / rows_in_flight) / plan.slots)
    # shared memory: the slots, scratch, group sums, the cluster's sums,
    # coefficients
    assert plan.halves == (2 if math.ceil(plan.rows_per_block / rows_in_flight) > plan.slots
                           else 1)
    assert plan.smem_bytes == forward_smem_bytes(plan.width, plan.width // cg, element_size,
                                                 plan.slots, plan.cluster,
                                                 plan.halves) <= MAX_SMEM_PER_BLOCK
    assert plan.blocks_per_sm in (1, 2)
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SM_SMEM


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,s,c", FLAGSHIP + STEP3D,
                         ids=[f"B{b}-S{s}-C{c}" for b, s, c in FLAGSHIP + STEP3D])
def test_forward_plan_covers_the_call(b, s, c, element_size):
    """Every path shape: a valid forward plan by the rule the sweep fitted
    (``tools/sweep_gn_bwd.py --forward``): the widest row slice of at most
    128 bytes that leaves four units (16- and 32-byte slices lost to it at
    every path shape), the smallest cluster whose threads take at most 16
    rows, two blocks an SM."""
    plan = forward_plan(b, s, c, 32, element_size)
    _check_forward(plan, b, s, c, 32, element_size)
    widths = slice_widths(c, 32, element_size, min_bytes=16)
    wider = [w for w in widths if plan.width < w and w * element_size <= FWD_ROW_BYTES]
    assert plan.width * element_size <= FWD_ROW_BYTES
    assert plan.units >= FWD_MIN_UNITS
    assert all(b * c // w < FWD_MIN_UNITS for w in wider)
    rows_in_flight = FWD_THREADS // (plan.width * element_size // 16)
    per_thread = math.ceil(plan.rows_per_block / rows_in_flight)
    assert per_thread <= FWD_ROUND_PACKS or plan.cluster == max(FWD_CLUSTERS)
    if plan.cluster > 1:
        half = math.ceil(math.ceil(s / (plan.cluster // 2)) / rows_in_flight)
        assert half > FWD_ROUND_PACKS
    assert plan.blocks_per_sm == 2


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
def test_every_width_has_a_forward_plan(element_size):
    """Every C that is a multiple of 32 up to 1,280 at 32 groups, 48 in 16
    and 328 in one group (41 bf16 packs), at every path shape and at tiny
    and ragged ones: a valid forward plan. A group wider than a block's
    threads (6,144 channels in one) has none, and raises."""
    cases = [(c, 32) for c in range(32, 1281, 32)] + [(48, 16), (328, 1)]
    for c, groups in cases:
        for b, s, _ in FLAGSHIP + STEP3D + [(1, 1, 0), (3, 63, 0)]:
            _check_forward(forward_plan(b, s, c, groups, element_size), b, s, c,
                           groups, element_size)
    with pytest.raises(ValueError, match="no forward plan"):
        forward_plan(2, 64, 6144, 1, element_size)


@pytest.mark.parametrize("c,groups", [(64, 32), (256, 32), (1024, 32), (96, 32), (48, 16),
                                      (328, 1)])
def test_every_forward_candidate_is_a_valid_plan(c, groups):
    for b, s in [(1, 1), (3, 63), (2, 4096), (2, 262144)]:
        for element_size in (2, 4):
            cands = forward_candidates(b, s, c, groups, element_size)
            assert cands and len(set(cands)) == len(cands)
            for plan in cands:
                _check_forward(plan, b, s, c, groups, element_size)
            assert forward_plan(b, s, c, groups, element_size) in cands


def test_the_forward_rule_is_a_candidate_at_every_path_shape():
    """What the sweep times includes what the rule picks."""
    for b, s, c in FLAGSHIP + STEP3D:
        for element_size in (2, 4):
            cands = forward_candidates(b, s, c, 32, element_size)
            assert forward_plan(b, s, c, 32, element_size) in cands and len(cands) > 1


# (B, S, C) of the HDR recipe's job (tools/launch_hdr.sh): the HR decoder's
# 512 px level (C = 256) at its microbatches of 8 and 16 and at its eval's
# batch of 32, which holds 2^31 elements, one past the largest 32-bit index
# (the kernels form element offsets in 64 bits); its 256 px level (C = 512)
HDR = [(8, 512 * 512, 256), (16, 512 * 512, 256), (32, 512 * 512, 256), (8, 256 * 256, 512)]


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,s,c", HDR, ids=[f"B{b}-S{s}-C{c}" for b, s, c in HDR])
def test_hdr_shapes_have_plans(b, s, c, element_size):
    assert b * s * c <= 2**31
    _check(backward_plan(b, s, c, 32, element_size, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM),
           b, s, c, 32, element_size)
    _check_forward(forward_plan(b, s, c, 32, element_size), b, s, c, 32, element_size)
