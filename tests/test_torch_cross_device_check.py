"""The cross-device training checks of ``chip_smoke.py`` (phases 8, 12, 17
and 25: one step on the CPU and on the card, losses and gradients within
stated bounds), on the CPU alone, at a reduced config (ch=32, ch_mult 1,2,
16 px, batch 2), in one thread (the step is small; the file shares the
machine with other test workers).

The card's step replays the CPU's discrete decisions of the loss head
(``chip_smoke.DecisionTape``: the ReLU masks and max-pool argmaxes of the
VGG16 towers of LPIPS and D and of D's heads), so that the check sees
rounding alone. Here: a replay of the same step is bitwise the recorded
run; a change of the GroupNorm by rounding alone (statistics summed in
float64, the kernels' swish formula) uses at most half the bound; and
faults in the GroupNorm forward and backward pass it, under the check
without replay and with it (``vqgan_tpu_torch/tools/cross_device_spread.py``).
"""

import pytest
import torch

from vqgan_tpu_torch.tools import cross_device_spread as spread

ROUNDING = ["float64 statistics", "float64 statistics + the kernels' swish"]
FAULTS = ["fault: one group's mean + 1e-3 std",
          "fault: swish derivative without (1 + ŷ(1 − s))",
          "fault: dγ of two channels swapped"]


@pytest.fixture(scope="module")
def ctx():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield spread.reference_step(small=True)
    torch.set_num_threads(threads)


def test_replay_of_the_recorded_step_is_bitwise(ctx):
    """Recording changes nothing, and replaying the recorded decisions on
    the same device gives the same step bit for bit: a ReLU as x·mask, a
    max-pool as the pool of x with -inf off the recorded argmaxes, forward
    and backward."""
    run, _, _, tape, recorded, _ = ctx
    assert len(tape.calls) == 37  # 2 x 13 VGG16 ReLUs, 2 x 4 max-pools, D's 3 head ReLUs
    replayed, _ = run("replay", tape)
    assert recorded[0] == replayed[0]
    for side in ("G", "D"):
        assert recorded[1][side].keys() == replayed[1][side].keys()
        for name, t in recorded[1][side].items():
            assert torch.equal(t, replayed[1][side][name]), (side, name)


def test_replay_raises_where_the_calls_differ(ctx):
    """A replay that is not the recorded step's (fewer calls) raises."""
    run, _, _, tape, _, _ = ctx
    key = next(iter(tape.calls))
    tape.calls[key].append(tape.calls[key][0])
    try:
        with pytest.raises(AssertionError, match="left unused"):
            run("replay", tape)
    finally:
        tape.calls[key].pop()


@pytest.mark.parametrize("name", ROUNDING)
def test_rounding_uses_at_most_half_the_bound(ctx, name):
    shares = spread.measure_variant(ctx, name, checks=("new",))
    assert max(shares["new"]) <= spread.ROUNDING_LIMIT, shares


@pytest.mark.parametrize("name", FAULTS)
def test_faults_pass_the_bound_with_and_without_replay(ctx, name):
    shares = spread.measure_variant(ctx, name)
    assert max(shares["old"]) > 1, shares
    assert max(shares["new"]) > 1, shares
