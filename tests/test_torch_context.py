"""The port's context mesh axis for the 3D job on the CPU: the clip's T
frames split in blocks over gloo ranks under torchrun, against one process
on the whole clips and against the JAX package.

One torchrun launch of tests/torch_dp_worker.py (4 ranks at
``data=2,context=2``, one thread each; the ranks of one data index form a
context group, (0, 1) and (2, 3)) runs, while this process runs the same
cases on the whole clips:

  - ``halo_t`` over the 4 ranks, forward and backward, against slicing the
    whole zero-padded tensor (exact);
  - the two-pass GroupNorm (plain, which the CPU runs for kernels #1 and #2)
    over the 4 ranks' T blocks, with and without swish, forward and
    backward, against the one-pass plain version and JAX ``group_norm_fp32``
    on the whole tensor;
  - the tiny TVAE (tests/test_torch_data_parallel.py's ``TINY_3D``) at
    ``data=1,context=2`` (each context group alone) and ``data=2,context=2``:
    the forward and the parameter gradients of a fixed loss against one
    process, and against JAX ``TVAE(mesh, ring_axis="context")`` on as many
    host devices (at ``data=2`` its gradients against JAX's TVAE on one
    device: JAX's ring gradients there are off its own model, ROADMAP.md
    Queue 3);
  - the 3D GAN step (frame D and tubelet D, ``video_loss_frames`` 3, 2 and
    off, Gaussian and VQ with revival, both GradNorm modes) at both
    layouts, two steps, replaying the one-process run's loss-head decisions,
    against the one-process step at tests/test_torch_train_step.py's bounds;
    the ranks' states bitwise equal after each step;
  - ``Trainer3D`` at ``data=2,context=2`` (the tubelet GAN, eval and saves
    by rank 0), its last save resumed in one process bitwise.

Without ranks: the rank blocks against JAX ``process_batch_block``'s
``devices_indices_map``, the frames check against JAX ``Trainer3D``'s
message, and the two-pass plain GroupNorm against the one-pass and JAX.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.models.tae import TVAE as JaxTVAE
from vqgan_tpu.ops.normalization import group_norm_fp32 as jax_group_norm
from vqgan_tpu.parallel.mesh import batch_sharding
from vqgan_tpu.parallel.mesh import create_mesh as jax_create_mesh
from vqgan_tpu.train.trainer3d import Trainer3D as JaxTrainer3D
from vqgan_tpu_torch.config import TVAEConfig
from vqgan_tpu_torch.models.tae import TVAE, check_context_frames
from vqgan_tpu_torch.ops import normalization as plain
from vqgan_tpu_torch.ops.groupnorm_cuda import context_group_norm
from vqgan_tpu_torch.parallel.mesh import batch_block
from vqgan_tpu_torch.weights import jax_params_to_state_dict

import torch_dp_worker
from test_torch_data_parallel import (
    FRAMES,
    RES3D,
    TINY_3D,
    TRAIN_3D,
    _check_run,
    _port_loss_params,
    _randomized,
    _with_far_codes,
    same,
)
from torch_parity import randomize_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
RANKS = 4
MESH = {"data": 2, "context": 2}
STEPS = 2
B3D, ZC = 2, 8
LATENT = (B3D, 2, 8, 8)
K = 32
HALO_SHAPE = (1, 4, 8, 3, 2)  # (B, C, T, H, W): 2 frames a rank
GN_SHAPE = (2, 64, 8, 3, 2)
# the TVAE's fp32 forward and gradients against one process and JAX: the
# GroupNorm sums and the ring's merge in other orders
TVAE_RTOL = 1e-4
CASES = ("frame-d1c2", "tubelet-vq-d1c2", "frame-msn-d2c2", "tubelet-d2c2")


def _cases() -> list[dict]:
    """The step cases: (name, layout, train overrides, VQ, tubelet frames)."""
    from vqgan_tpu_torch.losses.discriminator import TubeletDiscriminator

    table = [
        ("frame-d1c2", "d1c2", dict(video_loss_frames=3), False),
        ("tubelet-vq-d1c2", "d1c2", dict(video_loss_frames=0, disc_3d="tubelet"), True),
        ("frame-msn-d2c2", "d2c2", dict(video_loss_frames=3, gradnorm_mode="mean_shard_norm"),
         False),
        ("tubelet-d2c2", "d2c2", dict(video_loss_frames=2, disc_3d="tubelet"), False),
    ]
    d, lp = _port_loss_params()
    cases = []
    for name, layout, train_kw, vq in table:
        model_kw = dict(TINY_3D, **(dict(reg_type="vq", vq_codebook_size=K, vq_ema_decay=0.9,
                                         vq_revive_threshold=0.5) if vq else {}))
        k = train_kw["video_loss_frames"]
        tubelet = min(k, FRAMES) if k > 0 else FRAMES
        g = _randomized(TVAE(TVAEConfig(**model_kw)), 0)
        if vq:
            g = _with_far_codes(g)
        sd = {"g": g, "lpips": lp,
              "d": _randomized(TubeletDiscriminator(tubelet), 1)
              if train_kw.get("disc_3d") == "tubelet" else d}
        rng = np.random.RandomState(5)
        batches = [rng.uniform(-1, 1, (B3D, FRAMES, RES3D, RES3D, 3)).astype(np.float32)
                   for _ in range(STEPS)]
        draws, vq_ema = [], None
        for u in (0.3, 0.8):
            dr = {"frame_u": u}
            if vq:
                dr["revive_idx"] = rng.randint(0, int(np.prod(LATENT)), K).astype(np.int64)
            else:
                dr["eps"] = rng.randn(*LATENT, ZC).astype(np.float32)
            draws.append(dr)
        if vq:
            counts = np.random.RandomState(6).uniform(0.3, 1.3, K).astype(np.float32)
            vq_ema = {"counts": torch.from_numpy(counts),
                      "sums": torch.from_numpy(counts)[:, None] * g["reg.codebook"]}
        cases.append({"name": name, "layout": layout, "kind": "3d", "model": model_kw,
                      "train": {**TRAIN_3D, **train_kw},
                      "gradnorm_shards": 2 if layout == "d2c2" else 1, "sd": sd,
                      "vq_ema": vq_ema, "batches": batches, "draws": draws,
                      "tubelet_frames": tubelet})
    return cases


def _units(rng) -> dict:
    """The pieces' global inputs: halo_t's tensor and its ranks'
    cotangents, the GroupNorm's, the TVAE's params (JAX's, converted),
    clips and loss weights."""
    tl = HALO_SHAPE[2] // RANKS
    halo_g = {(b, a): [rng.randn(*HALO_SHAPE[:2], tl + b + a, *HALO_SHAPE[3:]).astype(np.float32)
                       for _ in range(RANKS)] for b, a in ((1, 1), (0, 1))}
    model_j = JaxTVAE(cfg=JaxTVAEConfig(**TINY_3D))
    params = randomize_params(jax.eval_shape(
        model_j.init, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.zeros((1, FRAMES, RES3D, RES3D, 3)))["params"], 0)
    return {
        "halo_x": rng.randn(*HALO_SHAPE).astype(np.float32), "halo_g": halo_g,
        "gn_x": rng.randn(*GN_SHAPE).astype(np.float32),
        "gn_g": rng.randn(*GN_SHAPE).astype(np.float32),
        "gn_w": (1 + 0.2 * rng.randn(GN_SHAPE[1])).astype(np.float32),
        "gn_b": (0.1 * rng.randn(GN_SHAPE[1])).astype(np.float32),
        "tvae": TINY_3D, "tvae_params": params,
        "tvae_sd": jax_params_to_state_dict(params),
        "tvae_x": rng.uniform(-1, 1, (B3D, FRAMES, RES3D, RES3D, 3)).astype(np.float32),
        "tvae_wy": rng.randn(B3D, FRAMES, RES3D, RES3D, 3).astype(np.float32),
        "tvae_wz": rng.randn(*LATENT, 2 * ZC).astype(np.float32),
    }


def _trainer3d_argv(ckpt: str, mesh: str) -> list[str]:
    return ["train3d", "--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
            "--vae_num_res_blocks", "1", "--vae_z_channels", "4", "--vae_resolution", "16",
            "--frames", "4", "--batch_size", "2", "--max_steps", "2",
            "--evaluate_every_n_steps", "2", "--eval_batches", "1", "--use_wandb", "false",
            "--log_every", "1", "--do_ganloss", "true", "--disc_3d", "tubelet",
            "--video_loss_frames", "2", "--disc_type", "hinge", "--use_lecam", "true",
            "--mesh_shape", mesh, "--ckpt_dir", ckpt, "--run_name", "ctx3d"]


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """(the cases, the one-process runs, each rank's output, the units'
    inputs, the trainer's ckpt dir)."""
    from chip_smoke import DecisionTape

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("ctx")
    cases = _cases()
    units = _units(np.random.RandomState(7))
    ckpt = str(tmp / "ckpt")
    spec = {"mesh": MESH, "context_units": {k: v for k, v in units.items()
                                            if k != "tvae_params"},
            "context_cases": cases, "trainer": [_trainer3d_argv(ckpt, "data=2,context=2")]}
    path = os.path.join(str(tmp), "spec.pt")
    torch.save(spec, path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), WORKER, path, str(tmp)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    one = {}
    for i, case in enumerate(cases):
        tape = DecisionTape()
        one[case["name"]] = torch_dp_worker.run_case(case, tape=tape)
        torch.save(tape.calls, os.path.join(str(tmp), f"ctx_tape{i}.tmp"))
        os.replace(os.path.join(str(tmp), f"ctx_tape{i}.tmp"),
                   os.path.join(str(tmp), f"ctx_tape{i}.pt"))
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-5000:]
    ranks = [torch.load(os.path.join(str(tmp), f"rank{r}.pt"), weights_only=False)
             for r in range(RANKS)]
    return {c["name"]: c for c in cases}, one, ranks, units, ckpt


def _t_joined(parts: list, dim: int) -> torch.Tensor:
    return torch.cat([p.float() for p in parts], dim=dim)


# ---------------------------------------------------------------------------
# the pieces


@pytest.mark.parametrize("before,after", [(1, 1), (0, 1)])
def test_halo_t_matches_slices_of_the_whole(ctx, before, after):
    """Each rank's block with its neighbours' edge frames is the slice of the
    whole zero-padded tensor; the backward adds each halo's cotangent to
    its owner's frames: the whole tensor's, exactly."""
    _, _, ranks, units, _ = ctx
    x = torch.from_numpy(units["halo_x"])
    t, tl = x.shape[2], x.shape[2] // RANKS
    pad = torch.nn.functional.pad(x, (0, 0, 0, 0, before, after))
    dpad = torch.zeros_like(pad)
    for r in range(RANKS):
        got = ranks[r]["context_units"][("halo", before, after)]
        assert torch.equal(got["y"], pad[:, :, r * tl:r * tl + tl + before + after])
        dpad[:, :, r * tl:r * tl + tl + before + after] += torch.from_numpy(
            units["halo_g"][(before, after)][r])
    dx = _t_joined([ranks[r]["context_units"][("halo", before, after)]["dx"]
                    for r in range(RANKS)], 2)
    assert torch.equal(dx, dpad[:, :, before:before + t])


def _gn_references(units: dict, swish: bool) -> tuple[dict, dict]:
    """The one-pass plain GroupNorm and JAX ``group_norm_fp32`` on the whole
    tensor: y, dx, dγ, dβ."""
    x = torch.from_numpy(units["gn_x"]).contiguous(memory_format=torch.channels_last_3d)
    g = torch.from_numpy(units["gn_g"]).contiguous(memory_format=torch.channels_last_3d)
    w, b = torch.from_numpy(units["gn_w"]), torch.from_numpy(units["gn_b"])
    y, mean, rstd = plain.group_norm_fp32_forward(x, w, b, 32, 1e-6, swish)
    dx, dw, db = plain.group_norm_fp32_backward(x, g, mean, rstd, w, b, 32, swish)
    one = {"y": y, "dx": dx, "dw": dw, "db": db}
    xj = jnp.asarray(units["gn_x"].transpose(0, 2, 3, 4, 1))
    yj, vjp = jax.vjp(lambda a, s, c: jax_group_norm(a, s, c, 32, 1e-6, with_swish=swish), xj,
                      jnp.asarray(units["gn_w"]), jnp.asarray(units["gn_b"]))
    dxj, dwj, dbj = vjp(jnp.asarray(units["gn_g"].transpose(0, 2, 3, 4, 1)))
    ncdhw = lambda a: torch.from_numpy(np.asarray(a)).permute(0, 4, 1, 2, 3)  # noqa: E731
    return one, {"y": ncdhw(yj), "dx": ncdhw(dxj), "dw": torch.from_numpy(np.asarray(dwj)),
                 "db": torch.from_numpy(np.asarray(dbj))}


@pytest.mark.parametrize("swish", [False, True])
def test_two_pass_group_norm_across_ranks(ctx, swish):
    """The two-pass GroupNorm over 4 ranks' T blocks (sums all-reduced
    between the passes each way; dγ, dβ summed after) against the one-pass
    plain version and JAX on the whole tensor: fp32 within 1e-5 of each
    output's largest entry."""
    _, _, ranks, units, _ = ctx
    parts = [ranks[r]["context_units"][("gn", swish)] for r in range(RANKS)]
    got = {"y": _t_joined([p["y"] for p in parts], 2), "dx": _t_joined([p["dx"] for p in parts], 2),
           "dw": sum(p["dw"] for p in parts), "db": sum(p["db"] for p in parts)}
    for ref in _gn_references(units, swish):
        for name, want in ref.items():
            err = float((got[name] - want.float()).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (name, err)


@pytest.mark.parametrize("shape", [(2, 64, 6, 5), (2, 96, 3, 4, 5)])
@pytest.mark.parametrize("swish", [False, True])
def test_two_pass_plain_matches_one_pass(shape, swish):
    """In one process (no group) the two-pass form is the one-pass GroupNorm
    (4-D and 5-D, fp32), forward and backward, and the two-pass autograd
    Function takes the plain versions on the CPU."""
    rng = np.random.RandomState(3)
    fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).contiguous(memory_format=fmt)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).contiguous(memory_format=fmt)
    w = torch.from_numpy((1 + 0.2 * rng.randn(shape[1])).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(shape[1])).astype(np.float32))
    y, mean, rstd = plain.group_norm_fp32_forward(x, w, b, 32, 1e-6, swish)
    dx, dw, db = plain.group_norm_fp32_backward(x, g, mean, rstd, w, b, 32, swish)
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    yr = context_group_norm(xr, wr, br, 32, 1e-6, swish, None)
    yr.backward(g)
    for got, want in ((yr, y), (xr.grad, dx), (wr.grad, dw), (br.grad, db)):
        assert got.is_contiguous(memory_format=fmt) or got.ndim == 1
        err = float((got.detach() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("layout", ["d1c2", "d2c2"])
def test_tvae_context_matches_one_process(ctx, layout):
    """The tiny TVAE at ``data=1,context=2`` (each context group alone on
    the 2 clips) and ``data=2,context=2`` (a clip a data index): the
    decoded clips and latents joined over the ranks, and the parameter
    gradients of Σ y·w_y + Σ z·w_z summed over the ranks, against one
    process on the whole clips, within TVAE_RTOL of each tensor's
    largest entry (gradients: of the largest gradient of all, as
    tests/test_torch_train_step.py floors them)."""
    _, _, ranks, units, _ = ctx
    got = _tvae_joined(ranks, layout)
    want = _tvae_one_process(units)
    _tvae_close(got, want)


def _tvae_joined(ranks: list, layout: str) -> dict:
    """The layout's ranks' TVAE outputs: y and z joined along T (and the
    clips along B at data=2), and rank 0's summed gradients."""
    def joined(name, rs):
        return _t_joined([ranks[r]["context_units"][("tvae", layout)][name] for r in rs], 1)

    if layout == "d1c2":
        y, z = joined("y", (0, 1)), joined("z", (0, 1))
    else:
        y = torch.cat([joined("y", (0, 1)), joined("y", (2, 3))])
        z = torch.cat([joined("z", (0, 1)), joined("z", (2, 3))])
    return {"y": y, "z": z, "grads": ranks[0]["context_units"][("tvae", layout)]["grads"]}


def _tvae_one_process(units: dict) -> dict:
    model = TVAE(TVAEConfig(**units["tvae"]))
    model.load_state_dict(units["tvae_sd"], strict=True)
    z = model.encode(torch.from_numpy(units["tvae_x"]))
    y = model.decode(z[..., :z.shape[-1] // 2])
    ((y * torch.from_numpy(units["tvae_wy"])).sum()
     + (z * torch.from_numpy(units["tvae_wz"])).sum()).backward()
    return {"y": y.detach(), "z": z.detach(),
            "grads": {k: p.grad for k, p in model.named_parameters()}}


def _tvae_close(got: dict, want: dict) -> None:
    for name in ("y", "z"):
        err = float((got[name] - want[name]).abs().max())
        assert err <= TVAE_RTOL * float(want[name].abs().max()), (name, err)
    floor = TVAE_RTOL * max(float(g.abs().max()) for g in want["grads"].values())
    for name, g in want["grads"].items():
        err = float((got["grads"][name] - g).abs().max())
        assert err <= TVAE_RTOL * float(g.abs().max()) + floor, (name, err)


@pytest.mark.parametrize("layout", ["d1c2", "d2c2"])
def test_tvae_context_matches_jax_ring_tvae(ctx, layout):
    """The layout against JAX ``TVAE(mesh, ring_axis="context")`` on as
    many host devices (its mid-block attention the JAX ring under
    ``shard_map``): the same decoded clips and latents, and at
    ``data=1,context=2`` the same gradients, at TVAE_RTOL. At
    ``data=2,context=2`` the gradients are held to JAX's TVAE on one
    device: JAX's ring TVAE there gives the right forward but gradients
    up to ~2,000x off its own one-device model's (ROADMAP.md, Queue 3)."""
    _, _, ranks, units, _ = ctx
    shape = {"data": 1, "context": 2} if layout == "d1c2" else {"data": 2, "context": 2}
    mesh = jax_create_mesh(shape, devices=jax.devices()[:shape["data"] * shape["context"]])
    ring = JaxTVAE(cfg=JaxTVAEConfig(**units["tvae"]), mesh=mesh, ring_axis="context")
    x, wy, wz = (jnp.asarray(units[k]) for k in ("tvae_x", "tvae_wy", "tvae_wz"))

    def loss(model, p):
        z = model.apply({"params": p}, x, method=model.encode)
        y = model.apply({"params": p}, z[..., :z.shape[-1] // 2], method=model.decode)
        return (y * wy).sum() + (z * wz).sum(), (y, z)

    grad_model = ring if layout == "d1c2" else JaxTVAE(cfg=JaxTVAEConfig(**units["tvae"]))
    (_, (y, z)), grads = jax.jit(jax.value_and_grad(lambda p: loss(grad_model, p),
                                                    has_aux=True))(units["tvae_params"])
    if layout != "d1c2":
        _, (y, z) = jax.jit(lambda p: loss(ring, p))(units["tvae_params"])
    want = {"y": torch.from_numpy(np.asarray(y)), "z": torch.from_numpy(np.asarray(z)),
            "grads": jax_params_to_state_dict(jax.device_get(grads))}
    _tvae_close(_tvae_joined(ranks, layout), want)


# ---------------------------------------------------------------------------
# the steps


@pytest.mark.parametrize("name", CASES)
def test_context_ranks_stay_bitwise_equal(ctx, name):
    """After every step every rank holds the same train state bit for bit,
    and logs the same global metrics."""
    _, _, ranks, _, _ = ctx
    assert all(r[name]["replicas_equal"] == [True] * STEPS for r in ranks)
    assert all(r[name]["metrics"] == ranks[0][name]["metrics"] for r in ranks)


@pytest.mark.parametrize("name", CASES)
def test_context_step_makes_the_one_process_step(ctx, name):
    """The ranks' step on T blocks is the one-process step on the whole
    clips: the metric curve, step 1's moments of G and D and the VQ
    statistics at tests/test_torch_train_step.py's bounds (the frame subset
    of 3 of 4 frames falls 2 + 1 across the ranks; with
    ``video_loss_frames`` 0 every frame goes to LPIPS and D)."""
    cases, one, ranks, _, _ = ctx
    _check_run(ranks[0][name], one[name], vq=cases[name]["model"].get("reg_type") == "vq")


def test_context_vq_counts_are_summed_exactly(ctx):
    """The code counts over the T blocks, summed across the ranks, are the
    one-process counts exactly; some codes were revived from the global
    latent."""
    _, one, ranks, _, _ = ctx
    got = ranks[0]["tubelet-vq-d1c2"]["vq_ema_steps"][0]
    ref = one["tubelet-vq-d1c2"]["vq_ema_steps"][0]
    assert torch.equal(got["counts"], ref["counts"])
    assert 0 < int((got["counts"] < 0.5).sum()) < K


# ---------------------------------------------------------------------------
# the trainer


def test_trainer3d_context_save_resumes_in_one_process(ctx, tmp_path):
    """``train3d --mesh_shape data=2,context=2`` (the tubelet GAN, a clip a
    data index, 2 frames a rank): every rank ends with the same state; rank
    0 alone logs each step and its evals (the whole clips, no group) and
    saves; the last save, restored by a one-process ``Trainer3D``, is the
    ranks' final state bit for bit."""
    from vqgan_tpu_torch import cli
    from vqgan_tpu_torch.train.checkpoint import state_dict_of
    from vqgan_tpu_torch.train.trainer3d import Trainer3D

    _, _, ranks, _, ckpt = ctx
    runs = [r["trainer"][0] for r in ranks]
    assert [r["mesh"] for r in runs] == [MESH] * RANKS
    assert [r["logs"] for r in runs] == [True, False, False, False]
    assert [r["local_batch"] for r in runs] == [1] * RANKS
    assert all(r["replicas_equal"] for r in runs)
    assert runs[0]["trained"]["step"] == 2
    run_dir = os.path.join(ckpt, "ctx3d")
    assert sorted(os.listdir(os.path.join(run_dir, "state"))) == [
        "step_00000001.pt", "step_00000002.pt"]
    with open(os.path.join(run_dir, "metrics_ctx3d.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [ln["step"] for ln in lines if "loss" in ln] == [0, 1]
    assert [ln["step"] for ln in lines if "eval/psnr" in ln] == [0, 2]
    argv = _trainer3d_argv(ckpt, "data=1")
    kw = vars(cli.build_parser_3d().parse_args(argv[1:]))
    cfg, tvae_cfg = cli.configs_3d(kw)
    trainer = Trainer3D(cfg, tvae_cfg, frames=kw["frames"], device="cpu")
    assert trainer.mesh.n_context == 1
    assert same(state_dict_of(trainer.state), runs[0]["trained"])


# ---------------------------------------------------------------------------
# the layout, without ranks


@pytest.mark.parametrize("shape", [{"data": 2, "context": 4}, {"data": 4, "context": 2},
                                   {"data": 1, "context": 8}, {"data": 2, "fsdp": 4}])
def test_rank_blocks_match_jax(eight_devices, shape):
    """Rank r's (rows, T) block of a (8, 16, 4, 4, 3) clip batch is the
    block JAX's ``batch_sharding`` gives the device at the r-th place of
    the mesh (``devices_indices_map``, what ``process_batch_block``
    reads)."""
    mesh = jax_create_mesh(dict(shape), devices=eight_devices)
    global_shape = (8, 16, 4, 4, 3)
    imap = batch_sharding(mesh, ndim=5).devices_indices_map(global_shape)
    assert isinstance(batch_sharding(mesh, ndim=5), NamedSharding)
    for r, device in enumerate(mesh.devices.flat):
        want = [(s.start or 0, n if s.stop is None else s.stop)
                for s, n in zip(imap[device], global_shape)]
        assert batch_block(dict(mesh.shape), r, global_shape) == want, (shape, r)


def test_frames_check_matches_jax():
    """A clip whose mid-block T does not split over the context ranks
    raises with JAX ``Trainer3D``'s message; one that does passes."""
    jax_cfg = JaxTrainConfig(batch_size=8, mesh_shape="data=-1,context=2", max_steps=1,
                             use_wandb=False)
    with pytest.raises(ValueError) as want:
        JaxTrainer3D(jax_cfg, JaxTVAEConfig(ch_mult=(1, 2, 4)), frames=4)
    with pytest.raises(ValueError) as got:
        check_context_frames(4, (1, 2, 4), 2)
    assert str(got.value) == str(want.value)
    check_context_frames(8, (1, 2, 4), 2)
    with pytest.raises(ValueError, match="does not divide"):
        batch_block({"data": 1, "context": 3}, 0, (2, 8, 4, 4, 3))
