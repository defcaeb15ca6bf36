"""How far one training step's losses and gradients move, by the bounds of
``chip_smoke.py``'s phase 8 (one step on the CPU and on the card), when the
GroupNorm changes by rounding alone and when it is wrong: the check's
power to tell a new order of sums from a fault.

    python -m vqgan_tpu_torch.tools.cross_device_spread   # from the repo root

Runs phase 8's step (ch=64, ch_mult 1,2,4, 64 px, batch 2, fp32, GAN with
LPIPS, hinge + LeCam, D's lr 1e-8) on the CPU: once as the reference, with
the loss head's discrete decisions recorded (``chip_smoke.DecisionTape``:
the ReLU masks and max-pool argmaxes of the VGG16 towers of LPIPS and D and
of D's heads), then once for each variant of the GroupNorm below, with its
own decisions (phase 8's old check) and with the reference's replayed (the
check phases 8, 12, 17 and 25 make now). Variants, rounding alone:
  - the statistics summed in float64 (at most one ulp from the plain ones);
  - the same with the swish written as t·(1/(1 + e^−t)), as the kernels do;
and faults, which the check must catch:
  - the mean of one group (the first) shifted by 1e-3 of its std;
  - rstd without eps;
  - the backward's swish derivative without its (1 + ŷ(1 − s)) factor;
  - dγ of two channels (the first two) swapped.
Prints one line a variant (the worst loss's share of its bound, and G's and
D's worst gradient tensor's, under the old check and under the new; the
ReLU masks, argmaxes, hinge terms and clamped latents that moved) and the
table at the end. A rounding variant must stay at or under 0.5 of the bound
under the new check, a fault must pass 1 under both: exit 1 otherwise.
``--small``: the test file's reduced config (ch=32, ch_mult 1,2, 16 px).
Needs no card.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

import chip_smoke
from vqgan_tpu_torch.ops import custom_ops, groupnorm_cuda
from vqgan_tpu_torch.ops.normalization import (
    group_norm_fp32_backward,
    group_norm_fp32_forward,
)

ROUNDING_LIMIT = 0.5  # of the bound, for a change of rounding alone


def _apply(x, weight, bias, mean, rstd, num_groups, with_swish, swish_formula=False):
    """y = GroupNorm(+swish) of x from the given (B, G) fp32 mean and rstd,
    with the plain version's roundings."""
    b, c = x.shape[:2]
    cg = c // num_groups
    a = rstd.repeat_interleave(cg, dim=-1) * weight.float()
    bb = bias.float() - mean.repeat_interleave(cg, dim=-1) * a
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    y = x.float().movedim(1, -1) * a.view(shape) + bb.view(shape)
    if with_swish:
        y = y * (1.0 / (1.0 + torch.exp(-y))) if swish_formula else y * torch.sigmoid(y)
    return y.to(x.dtype).movedim(-1, 1)


def _group_moments(x, num_groups, dtype):
    """Per (batch, group) E[x] and E[x²] in ``dtype``."""
    b, c = x.shape[:2]
    xg = x.to(dtype).movedim(1, -1).reshape(b, -1, num_groups, c // num_groups)
    return xg.mean(dim=(1, 3)), xg.square().mean(dim=(1, 3))


def float64_statistics(swish_formula: bool):
    """The plain forward with its mean and E[x²] summed in float64 and rounded
    to fp32 (and optionally the kernels' swish formula)."""
    def forward(x, weight, bias, num_groups=32, eps=1e-6, with_swish=False):
        mean, ex2 = _group_moments(x, num_groups, torch.float64)
        mean, rstd = mean.float(), torch.rsqrt(ex2 - mean.square() + eps).float()
        return _apply(x, weight, bias, mean, rstd, num_groups, with_swish, swish_formula), \
            mean, rstd
    return forward


def shifted_mean(x, weight, bias, num_groups=32, eps=1e-6, with_swish=False):
    """Fault: the first group's mean off by 1e-3 of its std (in y and in the
    statistics the backward takes)."""
    _, mean, rstd = group_norm_fp32_forward(x, weight, bias, num_groups, eps, with_swish)
    mean = mean.clone()
    mean[:, 0] += 1e-3 / rstd[:, 0]
    return _apply(x, weight, bias, mean, rstd, num_groups, with_swish), mean, rstd


# the largest relative change of rstd that leaving eps out made in a run
EPS_EFFECT = [0.0]


def rstd_without_eps(x, weight, bias, num_groups=32, eps=1e-6, with_swish=False):
    """Fault: rstd = rsqrt(var), eps left out (``EPS_EFFECT``: the largest
    relative change of rstd it made, eps / 2·var)."""
    mean, ex2 = _group_moments(x, num_groups, torch.float32)
    var = ex2 - mean.square()
    EPS_EFFECT[0] = max(EPS_EFFECT[0], float((eps / (2 * var)).max()))
    rstd = torch.rsqrt(var)
    return _apply(x, weight, bias, mean, rstd, num_groups, with_swish), mean, rstd


def swish_derivative_without_factor(x, g, mean, rstd, weight, bias, num_groups=32,
                                    with_swish=False):
    """Fault: the backward's dŷ = g·s instead of g·s·(1 + ŷ(1 − s)); the
    rest of the backward as the plain version's, from that dŷ."""
    if not with_swish:
        return group_norm_fp32_backward(x, g, mean, rstd, weight, bias, num_groups, False)
    y_hat = _apply(x, weight, bias, mean, rstd, num_groups, False).float()
    dy = (g.float() * torch.sigmoid(y_hat)).to(g.dtype)
    return group_norm_fp32_backward(x, dy, mean, rstd, weight, bias, num_groups, False)


def swapped_dgamma(x, g, mean, rstd, weight, bias, num_groups=32, with_swish=False):
    """Fault: dγ of channels 0 and 1 swapped."""
    dx, dgamma, dbeta = group_norm_fp32_backward(x, g, mean, rstd, weight, bias, num_groups,
                                                 with_swish)
    return dx, dgamma[[1, 0, *range(2, dgamma.numel())]], dbeta


VARIANTS = {  # name -> (forward, backward, a fault?)
    "float64 statistics": (float64_statistics(False), None, False),
    "float64 statistics + the kernels' swish": (float64_statistics(True), None, False),
    "fault: one group's mean + 1e-3 std": (shifted_mean, None, True),
    "fault: rstd without eps": (rstd_without_eps, None, True),
    "fault: swish derivative without (1 + ŷ(1 − s))": (
        None, swish_derivative_without_factor, True),
    "fault: dγ of two channels swapped": (None, swapped_dgamma, True),
}


def build_step(small: bool):
    """Phase 8's step on the CPU (``small``: ch=32, ch_mult 1,2, 16 px):
    returns ``run(tape_mode, tape)`` -> ((metrics, AdamW first moments of G
    and D, {}), {"logits": D's outputs in call order, "z": the latents
    before the clamp}), the logits a step's D loss sees, and the clamp."""
    from vqgan_tpu_torch.config import TrainConfig, VAEConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import StepDraws, make_train_step

    res, ch, mult = (16, 32, (1, 2)) if small else (64, 64, (1, 2, 4))
    vae_cfg = VAEConfig(resolution=res, ch=ch, ch_mult=mult, num_res_blocks=2,
                        z_channels=16, enc_dtype="float32", dec_dtype="float32")
    cfg = TrainConfig(batch_size=2, image_size=res, max_steps=10_000, do_ganloss=True,
                      disc_type="hinge", use_lecam=True, do_clamp=True,
                      flip_invariance=True, learning_rate_disc=1e-8)
    sd_vae = chip_smoke._perturbed_state_dict(vae_cfg, seed=2)
    gen = torch.Generator().manual_seed(3)
    disc_ref = PatchDiscriminator()
    init_discriminator_(disc_ref, gen)
    with torch.no_grad():
        for k in range(1, 6):
            getattr(disc_ref, f"binary_classifier{k}")[-1].weight.normal_(0.0, 0.05,
                                                                          generator=gen)
    lpips_ref = LPIPS()
    init_lpips_(lpips_ref, gen)
    images = torch.from_numpy(
        np.random.RandomState(3).uniform(-1, 1, (2, res, res, 3)).astype(np.float32))
    draws = StepDraws(flip_in=True, flip_w=True, flip_h=False, crop_h=0, crop_w=0,
                      aug_lpips_w=False, aug_lpips_h=False, revive_idx=None)

    def run(tape_mode: str | None, tape: chip_smoke.DecisionTape):
        vae, disc, lpips = VAE(vae_cfg), PatchDiscriminator(), LPIPS()
        vae.load_state_dict(sd_vae, strict=True)
        disc.load_state_dict(disc_ref.state_dict(), strict=True)
        lpips.load_state_dict(lpips_ref.state_dict(), strict=True)
        seen = {"logits": [], "z": []}
        disc.register_forward_hook(lambda m, i, o: seen["logits"].append(o.detach().clone()))
        encode = vae.encode
        vae.encode = lambda x: seen["z"].append(encode(x)) or seen["z"][-1]
        state = create_train_state(cfg, vae, disc, vae_cfg.ch)
        step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
        head = {"lpips": lpips, "disc": disc}
        with (tape.recording(head) if tape_mode == "record" else
              tape.replaying(head) if tape_mode == "replay" else contextlib.nullcontext()):
            state, metrics = step(state, images, 0, draws)
        moments = {side: {n: opt.state[p]["exp_avg"].clone()
                          for n, p in model.named_parameters() if p in opt.state}
                   for side, model, opt in (("G", vae, state.g_opt), ("D", disc, state.d_opt))}
        seen["z"] = [z.detach() for z in seen["z"]]
        return ({k: float(v) for k, v in metrics.items()}, moments, {}), seen

    n_logits = 2 * 2 * (res // 16) ** 2  # real and fake, batch 2, the patch grid
    return run, n_logits, cfg.clamp_th


@contextlib.contextmanager
def patched(forward, backward):
    """The plain forward of the GroupNorm operator's CPU implementation
    (``ops/custom_ops.py``) and the CPU wrapper's plain backward replaced,
    for one run."""
    saved = custom_ops.group_norm_fp32_forward, groupnorm_cuda.group_norm_fp32_backward
    if forward is not None:
        custom_ops.group_norm_fp32_forward = forward
    if backward is not None:
        groupnorm_cuda.group_norm_fp32_backward = backward
    try:
        yield
    finally:
        custom_ops.group_norm_fp32_forward, groupnorm_cuda.group_norm_fp32_backward = saved


def flips(ref_tape, tape, ref_seen, seen, clamp: float) -> str:
    """What moved between two runs' discrete decisions: ReLU masks and
    max-pool argmaxes (elements), the hinge terms (logits on the other side
    of ±1) and the clamp (latents on the other side of ±clamp)."""
    relu = pool = 0
    for key, calls in ref_tape.calls.items():
        for a, b in zip(calls, tape.calls[key]):
            n = int((a != b).sum())
            if a.dtype == torch.bool:
                relu += n
            else:
                pool += n
    hinge = sum(int(((a > 1) != (b > 1)).sum() + ((a > -1) != (b > -1)).sum())
                for a, b in zip(ref_seen["logits"], seen["logits"]))
    clamped = sum(int(((a.abs() > clamp) != (b.abs() > clamp)).sum())
                  for a, b in zip(ref_seen["z"], seen["z"]))
    return (f"{relu} ReLU mask elements, {pool} max-pool argmaxes, {hinge} hinge terms, "
            f"{clamped} clamped latents moved")


def reference_step(small: bool = False) -> tuple:
    """Phase 8's step (``small``: the test config) built, and its reference
    run with its decisions recorded: (run, n_logits, clamp, the tape, the
    run's result, what it saw)."""
    torch.backends.cudnn.allow_tf32 = False
    run, n_logits, clamp = build_step(small)
    tape = chip_smoke.DecisionTape()
    reference, seen = run("record", tape)
    print(f"reference step: {tape.describe()}; overall_vae_loss "
          f"{reference[0]['overall_vae_loss']:.6f}", flush=True)
    return run, n_logits, clamp, tape, reference, seen


def measure_variant(ctx: tuple, name: str, checks=("old", "new")) -> dict:
    """{check: (loss, G, D shares of phase 8's bound)} of variant ``name``
    against the reference of ``ctx`` (``reference_step``): "old" the
    variant's step with its own decisions, "new" with the reference's
    replayed. Prints a line."""
    run, n_logits, clamp, ref_tape, reference, ref_seen = ctx
    forward, backward, _ = VARIANTS[name]
    runs, own_tape, seen = {}, chip_smoke.DecisionTape(), None
    with patched(forward, backward):
        if "old" in checks:
            runs["old"], seen = run("record", own_tape)
        if "new" in checks:
            runs["new"], _ = run("replay", ref_tape)
    shares = {}
    for check, got in runs.items():
        loss, worst, _, _ = chip_smoke.step_bound_shares(reference, got, n_logits)
        shares[check] = (loss, worst["G"][1], worst["D"][1])
    extra = (f"; rstd moved by at most {EPS_EFFECT[0]:.2e} of itself"
             if forward is rstd_without_eps else "")
    moved = f"; {flips(ref_tape, own_tape, ref_seen, seen, clamp)}" if seen else ""
    print(f"{name}: " + ", ".join(f"{check} check loss/G/D "
                                  f"{'/'.join(f'{v:.3f}' for v in shares[check])}"
                                  for check in shares) + moved + extra, flush=True)
    return shares


def measure(small: bool = False, names=None) -> dict:
    """{variant: {"old": (loss, G, D shares), "new": (...)}} for the
    variants ``names`` (default all), printing a line for each."""
    ctx = reference_step(small)
    return {name: measure_variant(ctx, name) for name in names or VARIANTS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    out = measure(args.small)
    print("\n| variant | old check (max of loss, G, D) | new check | required |")
    print("|---|---|---|---|")
    ok = True
    for name, shares in out.items():
        fault = VARIANTS[name][2]
        old, new = max(shares["old"]), max(shares["new"])
        good = (old > 1 and new > 1) if fault else new <= ROUNDING_LIMIT
        ok = ok and good
        need = "> 1 under both" if fault else f"<= {ROUNDING_LIMIT} under the new"
        print(f"| {name} | {old:.3f} | {new:.3f} | {need}: {'met' if good else 'NOT MET'} |")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
