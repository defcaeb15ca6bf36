"""Where a bf16 TVAE's run on two clips and its runs on each clip alone part,
module by module, and whether the gap is the ops' own bf16 rounding or a
fault at one batch: not a test, a script that prints it (PERF.md §7's
witness of the bf16 steps across ranks).

    python tests/locate_batch_gap.py [--step] [--out FILE]   # on the card

The model is the data-parallel 3D case of ``chip_smoke.py`` (``TVAEConfig()``'s
width, 16 frames x 128 px, the mid-block attention chunked at 256 so that
kernel #3 runs), weights seeded 0, two synthetic clips (seed 0). One pass:
encode, the Gaussian sample with a fixed ε, decode, and the fixed linear
loss sum(recon · R) (R a seeded normal), backward. It runs

  - A: bf16 on both clips (one rank's batch);
  - B: bf16 on each clip alone, the two runs' tensors joined along the batch
    and their parameter gradients summed (two ranks' batches);
  - F: fp32 on both clips, TF32 off (the exact function, to rounding).

Each encoder module's output, the gradient reaching it, z, z's gradient and
every parameter's gradient are compared: ``gap`` = max|A − B|, ``err_a`` =
max|A − F|, ``err_b`` = max|B − F|, each over max|F|. A and B are two bf16
roundings of one function: where both are the ops' own rounding, err_a and
err_b are of one size and gap is at most their sum; a fault at one batch
shows as err_b (or err_a) several times the other. A parameter gradient's
``share`` is phase 8's: max|A − B| over 1e-2 of max|A| + 1e-6 of the largest
gradient entry of any tensor.

Variants hold the suspects fixed in both A and B: "gn plain" (the plain
GroupNorm forward and backward on the card, which has no plan), "cudnn
deterministic" (``cudnn.deterministic``, benchmark off), "conv3d direct"
(cuDNN's Conv3d instead of kernel #6), and "all three". Prints one line a
variant and writes every number to ``--out`` (JSON).

``--step``: phase 40's own "3d gan" case instead, in bf16 (``chip_smoke.py``'s
``dp_case``, ``dp_run_case``, its ``--dp-ranks`` torchrun launch of two ranks
sharing the card over gloo, and ``step_bound_shares``): the one-rank step on
both clips recording the loss head's decisions, then two ranks on a clip
each replaying them; step 1's worst loss and G's and D's worst gradient
tensors as shares of phase 8's bound, and every G tensor's share. Its
variants: the one-rank run as is or with cuDNN deterministic as the ranks
run, and both with ``conv3d_impl="direct"``. The ranks' files go to a new
temporary folder.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

VARIANTS = ("as is", "gn plain", "cudnn deterministic", "conv3d direct", "all three")
CLIPS, FRAMES, RES, ATTN_CHUNK = 2, 16, 128, 256
GRAD_RTOL, GRAD_FLOOR = 1e-2, 1e-6  # phase 8's


class _PlainGroupNorm(torch.autograd.Function):
    """The plain fp32 GroupNorm forward and backward, on any device."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, with_swish):
        from vqgan_tpu_torch.ops.normalization import group_norm_fp32_forward

        y, mean, rstd = group_norm_fp32_forward(x, weight, bias, num_groups, eps, with_swish)
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        ctx.num_groups, ctx.with_swish = num_groups, with_swish
        return y

    @staticmethod
    def backward(ctx, g):
        from vqgan_tpu_torch.ops.normalization import group_norm_fp32_backward

        x, mean, rstd, weight, bias = ctx.saved_tensors
        dx, dg, db = group_norm_fp32_backward(x, g.contiguous(memory_format=_fmt(g)), mean,
                                              rstd, weight, bias, ctx.num_groups,
                                              ctx.with_swish)
        return dx, dg, db, None, None, None


def _fmt(t: torch.Tensor) -> torch.memory_format:
    return torch.channels_last_3d if t.ndim == 5 else torch.channels_last


@contextlib.contextmanager
def variant(name: str):
    """The suspects held fixed for ``name``; restored after."""
    from vqgan_tpu_torch.ops import groupnorm_cuda

    saved = (groupnorm_cuda.FusedGroupNorm.apply, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    if name in ("gn plain", "all three"):
        groupnorm_cuda.FusedGroupNorm.apply = _PlainGroupNorm.apply
    if name in ("cudnn deterministic", "all three"):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (groupnorm_cuda.FusedGroupNorm.apply, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def build(dtype: str, impl: str):
    from vqgan_tpu_torch.config import TVAEConfig
    from vqgan_tpu_torch.models import tae

    cfg = TVAEConfig(compute_dtype=dtype, conv3d_impl=impl, resolution=RES,
                     attn_chunk=ATTN_CHUNK)
    with torch.device("cuda"):
        model = tae.TVAE(cfg)
    tae.init_weights_(model, torch.Generator("cuda").manual_seed(0))
    return model


def run(model, clips: torch.Tensor, eps: torch.Tensor, r: torch.Tensor) -> dict:
    """One pass of ``model`` on ``clips``: each encoder module's output and
    the gradient reaching it (by name, as stored), z and its gradient, and
    every parameter's gradient (fp32)."""
    acts, grads, handles = {}, {}, []

    def hook(name):
        def fn(_, __, out):
            if not isinstance(out, torch.Tensor):
                return
            acts[name] = out.detach()
            if out.requires_grad:
                out.register_hook(lambda g: grads.__setitem__(name, g.detach()))
        return fn

    for name, m in model.encoder.named_modules():
        if name:
            handles.append(m.register_forward_hook(hook(f"encoder.{name}")))
    model.zero_grad(set_to_none=True)
    try:
        z = model.encode(clips)
        z.register_hook(lambda g: grads.__setitem__("z", g.detach()))
        acts["z"] = z.detach()
        mean, logvar = z.float().chunk(2, dim=-1)
        z_s = (mean + torch.exp(0.5 * logvar.clamp(min=-3.0)) * eps).to(z.dtype)
        recon = model.decode(z_s)
        (recon.float() * r).sum().backward()
    finally:
        for h in handles:
            h.remove()
    params = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
              if p.grad is not None}
    return {"acts": acts, "grads": grads, "params": params}


def _joined(runs: list[dict], kind: str) -> dict:
    """The per-clip runs' tensors joined along the batch (dim 0)."""
    return {k: torch.cat([r[kind][k] for r in runs]) for k in runs[0][kind]}


def _rel(a: torch.Tensor, b: torch.Tensor, scale: float) -> float:
    return float((a.float() - b.float()).abs().max()) / max(scale, 1e-30)


def compare(a: dict, b: dict, f: dict) -> dict:
    out = {}
    for kind in ("acts", "grads"):
        rows = []
        # the forward's order, and the backward's for the gradients
        for n in [n for n in f[kind] if n in a[kind] and n in b[kind]]:
            scale = float(f[kind][n].float().abs().max())
            rows.append({"name": n, "shape": list(f[kind][n].shape),
                         "gap": _rel(a[kind][n], b[kind][n], scale),
                         "err_a": _rel(a[kind][n], f[kind][n], scale),
                         "err_b": _rel(b[kind][n], f[kind][n], scale)})
        out[kind] = rows
    floor = GRAD_FLOOR * max(float(t.abs().max()) for t in a["params"].values())
    prow = []
    for n, ga in a["params"].items():
        gb, gf = b["params"][n], f["params"][n]
        bound = GRAD_RTOL * float(ga.abs().max()) + floor
        scale = float(gf.abs().max())
        prow.append({"name": n, "share": float((ga - gb).abs().max()) / bound,
                     "share_a_vs_f": float((ga - gf).abs().max()) / bound,
                     "gap": _rel(ga, gb, scale), "err_a": _rel(ga, gf, scale),
                     "err_b": _rel(gb, gf, scale)})
    out["params"] = sorted(prow, key=lambda r: -r["share"])
    return out


def first_apart(rows: list[dict], ratio: float = 4.0) -> dict | None:
    """The first row where one batch's distance from fp32 is ``ratio``
    times the other's (past a floor of 2^-12 of the tensor's scale)."""
    for row in rows:
        lo, hi = sorted((row["err_a"], row["err_b"]))
        if hi > 2.0 ** -12 and hi > ratio * max(lo, 1e-30):
            return row
    return None


STEP_VARIANTS = (("as is", False, "auto"), ("cudnn deterministic", True, "auto"),
                 ("conv3d direct", True, "direct"))


def step_mode() -> dict:
    """Phase 40's bf16 "3d gan" case at one rank and at two (module
    docstring); returns each variant's shares."""
    import chip_smoke as cs

    out_dir = tempfile.mkdtemp(prefix="locate_batch_gap_")

    cs.set_tf32(True)
    result = {}
    for name, deterministic, impl in STEP_VARIANTS:
        models = cs.dp_models()
        models["tvae"] = {**models["tvae"], "compute_dtype": "bfloat16", "conv3d_impl": impl}
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = False
        case = cs.dp_case("3d gan", "cuda", models=models)
        tape = cs.DecisionTape()
        ref = cs.dp_run_case(case, slice(None), tape, record=True)
        del case
        torch.cuda.empty_cache()
        torch.save(tape.calls, os.path.join(out_dir, "tape_3d_gan.pt"))
        spec = {"cases": ["3d gan"], "dir": out_dir, "tf32": True, "models": models}
        spec_path = os.path.join(out_dir, "gap_spec.json")
        with open(spec_path, "w") as fh:
            json.dump(spec, fh)
        env = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
        try:
            cs.dp_launch([os.path.abspath(cs.__file__), "--dp-ranks", spec_path], 2,
                         os.path.join(out_dir, "gap_ranks.log"))
        finally:
            if env is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES")
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = env
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        got = ranks[0]["cases"]["3d gan"]
        worst_loss, worst, bad_loss, bad_grad = cs.step_bound_shares(
            (ref["metrics"][0], ref["moments"]), (got["metrics"][0], got["moments"]),
            cs.DP_CASES["3d gan"])
        g_ref, g_got = ref["moments"]["G"], got["moments"]["G"]
        floor = GRAD_FLOOR * max(float(t.abs().max()) for t in g_ref.values())
        shares = sorted(((float((g_got[n] - t).abs().max()) / (GRAD_RTOL * float(t.abs().max())
                                                                 + floor), n)
                         for n, t in g_ref.items()), reverse=True)
        result[name] = {"worst_loss": worst_loss, "worst": worst,
                        "bad_loss": [list(map(str, b)) for b in bad_loss],
                        "g_shares": [[n, s] for s, n in shares],
                        "launches_one": ref["launches"][0], "launches_rank": got["launches"][0],
                        "ranks_equal": got["replicas_equal"]}
        print(f"step {name}: worst loss {worst_loss:.3f} of its bound; G {worst['G'][0]} "
              f"{worst['G'][1]:.3f}, D {worst['D'][0]} {worst['D'][1]:.3f}; G tensors past "
              f"the bound {sum(s > 1 for s, _ in shares)} of {len(shares)}; the ten worst "
              + ", ".join(f"{n} {s:.2f}" for s, n in shares[:10]), flush=True)
        sys.stdout.flush()
    return result


def main(argv=None) -> int:
    from vqgan_tpu_torch.train.trainer3d import synthetic_video_batches

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="")
    p.add_argument("--step", action="store_true", help="phase 40's case (module docstring)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("locate_batch_gap needs a CUDA device")
    if args.step:
        got = step_mode()
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(got, fh, indent=1)
        return 0
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clips = torch.from_numpy(next(synthetic_video_batches(CLIPS, FRAMES, RES, seed=0))).to(dev)
    gen = torch.Generator(dev).manual_seed(1)
    t0 = time.perf_counter()
    result = {"device": torch.cuda.get_device_name(0), "variants": {}}
    ref = None
    for name in VARIANTS:
        impl = "direct" if name in ("conv3d direct", "all three") else "auto"
        with variant(name):
            if ref is None or impl != ref[0]:
                model = build("float32", impl)
                with torch.no_grad():
                    z_shape = model.encode(clips[:1]).shape
                eps = torch.randn((CLIPS,) + tuple(z_shape[1:-1]) + (z_shape[-1] // 2,),
                                  generator=gen, device=dev)
                r = torch.randn(clips.shape, generator=gen, device=dev)
                f = run(model, clips, eps, r)
                ref = (impl, f, eps, r)
                del model
            _, f, eps, r = ref
            model = build("bfloat16", impl)
            a = run(model, clips, eps, r)
            singles = [run(model, clips[i:i + 1], eps[i:i + 1], r[i:i + 1])
                       for i in range(CLIPS)]
        b = {"acts": _joined(singles, "acts"), "grads": _joined(singles, "grads"),
             "params": {n: sum(s["params"][n] for s in singles) for n in singles[0]["params"]}}
        del singles, model
        got = compare(a, b, f)
        del a, b
        torch.cuda.empty_cache()
        fa, ga = first_apart(got["acts"]), first_apart(got["grads"])
        top = got["params"][0]
        worst_a = max(got["acts"], key=lambda row: row["gap"])
        print(f"{name}: parameter gradients, batch 2 vs 1 + 1: worst {top['name']} share "
              f"{top['share']:.3f} of phase 8's bound (bf16 batch 2 vs fp32 "
              f"{top['share_a_vs_f']:.3f}; gap {top['gap']:.3e}, err_a {top['err_a']:.3e}, "
              f"err_b {top['err_b']:.3e}); activations' largest gap {worst_a['name']} "
              f"{worst_a['gap']:.3e} (err_a {worst_a['err_a']:.3e}, err_b "
              f"{worst_a['err_b']:.3e}); first tensor with one batch 4x farther from fp32: "
              f"forward {fa and fa['name']}, backward {ga and ga['name']}", flush=True)
        got["first_apart"] = {"acts": fa, "grads": ga}
        result["variants"][name] = got
    result["seconds"] = time.perf_counter() - t0
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
