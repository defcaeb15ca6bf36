"""The GroupNorm backward's launch plan (``ops/groupnorm_cuda.py::
backward_plan``), on the CPU: pure Python, no card.

At every GroupNorm shape of the flagship training step (batch 8) and of the
3D training steps (batch 2, 16 frames x 128 px), in both dtypes, the plan's
units cover every (sample, channel) exactly once in whole groups, each slice
spans at least one 32-byte sector of a row in a power of two of 16-byte
packs, an on-chip plan's rows of a unit fit a block's packs, the blocks of a
team cover every row, and the grid fits the resident blocks the plan was
given.
"""

import math

import pytest

from vqgan_tpu_torch.ops.groupnorm_cuda import (
    BWD_PACKS,
    BWD_SLICE_PACKS,
    BWD_THREADS,
    MAX_SMEM_PER_BLOCK,
    backward_candidates,
    backward_plan,
    backward_smem_bytes,
)

NUM_SMS, BLOCKS_PER_SM = 132, 2  # an H100 SXM, two backward blocks an SM
# (B, S, C): the flagship step's calls at batch 8, the 3D steps' at batch 2
FLAGSHIP = [(8, s, c) for s, c in [(65536, 256), (65536, 512), (16384, 1024), (16384, 512),
                                   (16384, 256), (4096, 1024), (4096, 512), (1024, 1024)]]
STEP3D = [(2, 16 * 128 * 128, 64), (2, 16 * 128 * 128, 128), (2, 8 * 64 * 64, 128),
          (2, 8 * 64 * 64, 256), (2, 4 * 32 * 32, 256)]


def _check(plan, b, s, c, groups, element_size):
    pack = 16 // element_size
    cg = c // groups
    # units: every (sample, channel) once, whole groups
    covered = []
    for u in range(plan.units):
        b_, c0 = divmod(u, c // plan.width)
        covered += [(b_, c0 * plan.width + k) for k in range(plan.width)]
    assert sorted(covered) == [(i, k) for i in range(b) for k in range(c)]
    assert plan.width % cg == 0 and c % plan.width == 0
    # a slice: at least one sector of a row, a power of two of packs
    assert plan.width * element_size >= 32
    packs = plan.width // pack
    assert plan.width % pack == 0 and packs <= BWD_SLICE_PACKS and packs & (packs - 1) == 0
    # on chip, a block's rows fit its threads' packs; the team covers every row
    assert plan.route in ("on-chip", "re-read")
    if plan.route == "on-chip":
        assert plan.rows_per_block <= BWD_PACKS * (BWD_THREADS // packs)
    assert plan.team_blocks * plan.rows_per_block >= s
    # the grid fits the resident blocks; no team without a unit
    assert plan.grid <= NUM_SMS * BLOCKS_PER_SM
    assert 1 <= plan.teams <= plan.units
    assert plan.smem_bytes == backward_smem_bytes(element_size) <= MAX_SMEM_PER_BLOCK
    assert BLOCKS_PER_SM * plan.smem_bytes <= 2 * MAX_SMEM_PER_BLOCK


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


@pytest.mark.parametrize("c,groups", [(64, 32), (128, 16), (256, 32), (512, 32), (1024, 32),
                                      (32, 32)])
def test_every_candidate_is_a_valid_plan(c, groups):
    """Every candidate the rule weighs, at small and ragged sizes too."""
    for b, s in [(1, 1), (3, 63), (2, 4096)]:
        for element_size in (2, 4):
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
    power of two of packs: no plan, and the wrapper raises rather than run
    another kernel."""
    rows = NUM_SMS * BLOCKS_PER_SM * BWD_PACKS * (BWD_THREADS // 2) + 1
    cands = backward_candidates(1, rows, 64, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    assert cands and all(p.route == "re-read" for p, _ in cands)
    _check(backward_plan(1, rows, 64, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM),
           1, rows, 64, 32, 2)
    with pytest.raises(ValueError, match="do not fit"):
        backward_plan(2, 64, 48, 16, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)


def test_workspace_words_hold_every_partial():
    plan = backward_plan(8, 65536, 512, 32, 2, NUM_SMS, blocks_per_sm=BLOCKS_PER_SM)
    groups_per_slice = plan.width // (512 // 32)
    want = (math.ceil((plan.teams + 2) / 4) * 4
            + plan.units * plan.team_blocks * 2 * (groups_per_slice + plan.width) + 8 * 2 * 512)
    assert plan.workspace_words(8, 512, 32) == want
