"""The port's data parallelism on the CPU: two gloo ranks under torchrun
against one process, and against the JAX package on the global batch.

The JAX trainer's ``batch_size`` is the global batch: under ``jit`` every
loss, norm and statistic is the global batch's, so a run on N devices is one
step on the concatenated batch. The port's N-rank step must be that step too
(``vqgan_tpu_torch/parallel/mesh.py``), not DDP's mean of per-rank steps.

One torchrun launch of tests/torch_dp_worker.py (2 ranks, one thread each)
runs every case, while this process runs the same cases as one process on
the global batch (``torch_dp_worker.run_case`` without a group):

  - GradNorm's backward in the global and ``mean_shard_norm`` modes, held
    against JAX ``gradnorm`` on the global tensor;
  - the 2D GAN step (tests/test_torch_train_step.py's tiny config, hinge +
    LeCam, clamp, flip invariance, global batch 4 = 2 x 2) with the sampled
    Gaussian latent in both GradNorm modes, and with the VQ latent (K = 32,
    EMA 0.9, revival at 0.5); the 3D GAN step (tests/test_torch_step3d.py's
    tiny TVAE, frame D, global batch 2 = 2 x 1); the Gaussian step at
    ``grad_accum`` 2 (one sample a rank a microbatch). Two steps each.

The ranks replay their rows of the one-process run's loss-head decisions
(``chip_smoke.DecisionTape``), so the two runs differ by rounding alone. The
weights and draws come from numpy. After every step the ranks' whole train
states are bitwise equal, and the two-rank steps are held against the
one-process step at the bounds of tests/test_torch_train_step.py. Marked
slow (one JAX step compile a case, ~25 s each here): the first four cases
again with JAX's params (``jax.eval_shape`` filled by numpy) and the JAX
steps' own draws, against the JAX step on the global batch at the same
bounds; tests/test_torch_train_step.py and its neighbours hold the
one-process step against JAX in tier 1.

A second pair of launches runs a 2-rank ``Trainer`` with eval and save, then
resumes it: only rank 0 writes, and the resumed state is the first run's
last state bit for bit on both ranks.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.losses.discriminator import PatchDiscriminator as JaxDisc
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.models.tae import TVAE as JaxTVAE
from vqgan_tpu.ops.gradnorm import gradnorm as jax_gradnorm
from vqgan_tpu.parallel.mesh import create_mesh as jax_create_mesh
from vqgan_tpu_torch.parallel.mesh import create_mesh, mesh_extents
from vqgan_tpu_torch.weights import (
    jax_disc_params_to_state_dict,
    jax_lpips_params_to_state_dict,
    jax_params_to_state_dict,
    jax_vq_ema_to_torch,
)

import torch_dp_worker
from test_torch_train_step import (
    CURVE_ATOL,
    CURVE_RTOL,
    GRAD_RTOL,
    TINY_VAE,
    TRAIN,
    ZERO_FLOOR,
    _jax_draws,
    _mu_tree,
    jax_eps_sampler,
)
from torch_parity import randomize_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
RANKS = 2
STEPS = 2
B2D, B3D = 4, 2
Z_SIDE = 16  # the tiny 2D VAE's latent side at 32 px
K = 32
VQ = dict(reg_type="vq", vq_codebook_size=K, vq_ema_decay=0.9, vq_revive_threshold=0.5)
TINY_3D = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
               compute_dtype="float32", conv3d_impl="direct")
FRAMES, RES3D = 4, 16
LATENT_3D = (B3D, 2, 8, 8)
TRAIN_3D = dict(batch_size=B3D, image_size=RES3D, max_steps=10, warmup_steps=2,
                learning_rate_vae=0.032, learning_rate_disc=1e-8, do_ganloss=True,
                disc_type="hinge", use_lecam=True, video_loss_frames=3, ema_decay=0.5,
                disc_3d="frame")
# the JAX train state's rng, create_train_state's key as in
# tests/test_torch_train_step.py and tests/test_torch_step3d.py: the draws of
# the JAX comparison derive from it as the JAX steps derive theirs
RNG0 = 3
JAX_CASES = ("2d-global", "2d-mean_shard_norm", "2d-vq", "3d-gan")
CASES = JAX_CASES + ("2d-accum",)


def _launch(spec: dict, tmp, nproc: int = RANKS) -> tuple[subprocess.Popen, str, int]:
    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "spec.pt")
    torch.save(spec, spec_path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), WORKER, spec_path, str(tmp)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, str(tmp), nproc


def _collect(launched) -> list[dict]:
    proc, tmp, nproc = launched
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-5000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(nproc)]


# ---------------------------------------------------------------------------
# the cases: params, batches and draws of the global batch

def _params_2d(vae_kw):
    x0 = jnp.zeros((1, 32, 32, 3))
    vae_j = JaxVAE(cfg=JaxVAEConfig(**vae_kw))
    g = randomize_params(jax.eval_shape(vae_j.init, {"params": jax.random.PRNGKey(0),
                                                     "sample": jax.random.PRNGKey(0)},
                                        x0)["params"], 0)
    return vae_j, g


def _loss_params(x0):
    d = randomize_params(jax.eval_shape(JaxDisc().init, jax.random.PRNGKey(1), x0)["params"], 1)
    lp = randomize_params(jax.eval_shape(JaxLPIPS().init, jax.random.PRNGKey(2), x0, x0)
                          ["params"], 2)
    return d, lp


def _vq_ema(codebook):
    """EMA counts in [0.3, 1.3), sums = counts·codebook: a code unused in
    step 1 falls below the revival threshold where 0.9·c < 0.5."""
    counts = np.random.RandomState(6).uniform(0.3, 1.3, K).astype(np.float32)
    return {"reg": {"counts": counts, "sums": counts[:, None] * np.asarray(codebook)}}


def _with_far_codes(sd: dict) -> dict:
    """The codebook's odd rows moved 50x out, where no z reaches them: those
    codes go unused, so step 1 revives the ones whose count falls below the
    threshold (the numpy draw of the other weights uses every code)."""
    cb = sd["reg.codebook"].clone()
    cb[1::2] *= 50.0
    return {**sd, "reg.codebook": cb}


def _randomized(module: torch.nn.Module, seed: int) -> dict:
    """``module``'s state dict drawn from numpy as ``randomize_params`` draws
    a flax tree: weights of rank >= 2 N(0, 1/fan_in), GroupNorm scales
    1 + N(0, 0.2²), the rest N(0, 0.1²)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        if len(shape) >= 2:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("weight"):
            v = 1.0 + 0.2 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        out[name] = torch.from_numpy(np.asarray(v, np.float32))
    return out


@functools.lru_cache(maxsize=1)
def _port_loss_params() -> tuple[dict, dict]:
    """D's and LPIPS's state dicts from numpy, shared by the cases."""
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator
    from vqgan_tpu_torch.losses.lpips import LPIPS

    return _randomized(PatchDiscriminator(), 1), _randomized(LPIPS(), 2)


def _port_case_params(model: torch.nn.Module) -> tuple[dict, dict]:
    """(state dicts of G, D and LPIPS, the VQ statistics or None) for the
    one-process and two-rank runs, from numpy."""
    d, lp = _port_loss_params()
    return {"g": _randomized(model, 0), "d": d, "lpips": lp}, None


def _global_draws_2d(vq: bool, z_channels: int, jax_side: dict | None) -> list[dict]:
    """Each step's draws for the global batch: the JAX step's own (from
    ``jax_side``'s keys and ε sampler) or, for the port-only checks, numpy's."""
    draws = []
    if jax_side is None:
        rng = np.random.RandomState(9)
        for i in range(STEPS):
            d = dict(flip_in=i == 0, flip_w=True, flip_h=i == 1, crop_h=0, crop_w=0,
                     aug_lpips_w=i == 1, aug_lpips_h=False, revive_idx=None, eps=None)
            if vq:
                d["revive_idx"] = rng.randint(0, B2D * Z_SIDE * Z_SIDE, K).astype(np.int64)
            else:
                d["eps"] = rng.randn(B2D, Z_SIDE, Z_SIDE, z_channels).astype(np.float32)
            draws.append(d)
        return draws
    jrng = jax.random.PRNGKey(RNG0)
    for _ in range(STEPS):
        keys = jax.random.split(jax.random.split(jrng)[0], 8)
        dr, jrng = _jax_draws(jrng, Z_SIDE, Z_SIDE, jax_side["sample"])
        if vq:  # the JAX step's revival rows, keys[7]
            dr.revive_idx = torch.from_numpy(np.asarray(
                jax.random.randint(keys[7], (K,), 0, B2D * Z_SIDE * Z_SIDE), np.int64))
        draws.append({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                      for k, v in vars(dr).items()})
    return draws


def _case_2d(name: str, vae_kw: dict, train_kw: dict, jax_loss=None) -> dict:
    """A 2D case; ``jax_loss`` (D's and LPIPS's flax params): with JAX
    params and the JAX step's draws, else the port's from numpy."""
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.models.ae import VAE

    vq = vae_kw.get("reg_type") == "vq"
    jax_side = None
    if jax_loss is None:
        sd, _ = _port_case_params(VAE(VAEConfig(**vae_kw)))
        if vq:
            sd["g"] = _with_far_codes(sd["g"])
        codebook = sd["g"]["reg.codebook"].numpy() if vq else None
    else:
        vae_j, g = _params_2d(vae_kw)
        d, lp = jax_loss
        sd = {"g": jax_params_to_state_dict(g), "d": jax_disc_params_to_state_dict(d),
              "lpips": jax_lpips_params_to_state_dict(lp)}
        codebook = np.asarray(g["reg"]["codebook"]) if vq else None
        sample = None
        if vae_kw.get("reg_type") == "gaussian":
            sample = jax_eps_sampler(vae_j, g, (B2D, Z_SIDE, Z_SIDE, vae_kw["z_channels"]))
        jax_side = {"g": g, "d": d, "lpips": lp, "sample": sample}
    vq_ema = _vq_ema(codebook) if vq else None
    if jax_side is not None:
        jax_side["vq_ema"] = vq_ema
    rng = np.random.RandomState(5)
    batches = [rng.uniform(-1, 1, (B2D, 32, 32, 3)).astype(np.float32) for _ in range(STEPS)]
    return {"name": name, "kind": "2d", "model": vae_kw, "train": {**TRAIN, **train_kw},
            "gradnorm_shards": RANKS, "sd": sd,
            "vq_ema": None if vq_ema is None else jax_vq_ema_to_torch(vq_ema),
            "batches": batches,
            "draws": _global_draws_2d(vq, vae_kw["z_channels"], jax_side), "jax": jax_side}


def _case_3d(name: str, jax_side: bool) -> dict:
    from vqgan_tpu_torch.config import TVAEConfig
    from vqgan_tpu_torch.models.tae import TVAE

    rng = np.random.RandomState(5)
    batches = [rng.uniform(-1, 1, (B3D, FRAMES, RES3D, RES3D, 3)).astype(np.float32)
               for _ in range(STEPS)]
    draws, jax_params = [], None
    if not jax_side:
        sd, _ = _port_case_params(TVAE(TVAEConfig(**TINY_3D)))
        for u in (0.3, 0.8):
            draws.append({"eps": rng.randn(*LATENT_3D, 8).astype(np.float32), "frame_u": u})
    else:
        model_j = JaxTVAE(cfg=JaxTVAEConfig(**TINY_3D))
        g = randomize_params(jax.eval_shape(
            model_j.init, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
            jnp.zeros((1, FRAMES, RES3D, RES3D, 3)))["params"], 0)
        d, lp = _loss_params(jnp.zeros((1, RES3D, RES3D, 3)))
        sd = {"g": jax_params_to_state_dict(g), "d": jax_disc_params_to_state_dict(d),
              "lpips": jax_lpips_params_to_state_dict(lp)}
        jax_params = {"g": g, "d": d, "lpips": lp, "vq_ema": None}
        jrng = jax.random.PRNGKey(RNG0)
        for _ in range(STEPS):
            key, jrng = jax.random.split(jrng)
            k_sample, k_frames, _ = jax.random.split(key, 3)
            draws.append({"eps": np.array(jax.random.normal(k_sample, (*LATENT_3D, 8)),
                                          np.float32),
                          "frame_u": float(jax.random.uniform(k_frames, ()))})
    return {"name": name, "kind": "3d", "model": TINY_3D, "train": TRAIN_3D,
            "gradnorm_shards": RANKS, "sd": sd, "vq_ema": None, "batches": batches,
            "draws": draws, "jax": jax_params}


def _cases(jax_side: bool) -> list[dict]:
    """The four cases; ``jax_side``: JAX params and draws, for the JAX
    comparison."""
    jax_loss = _loss_params(jnp.zeros((1, 32, 32, 3))) if jax_side else None
    gauss = {**TINY_VAE, "reg_type": "gaussian"}
    return [
        _case_2d("2d-global", gauss, {}, jax_loss),
        _case_2d("2d-mean_shard_norm", gauss, {"gradnorm_mode": "mean_shard_norm"}, jax_loss),
        _case_2d("2d-vq", {**TINY_VAE, **VQ}, {}, jax_loss),
        _case_3d("3d-gan", jax_side),
    ] + ([] if jax_side else [_accum_case(gauss)])


def _accum_case(vae_kw: dict) -> dict:
    """The Gaussian step at ``grad_accum`` 2: microbatches of one sample a
    rank. The global batch is microbatch-major, so one process takes the
    rows (0, 2, 1, 3): rank 0's microbatch 0, rank 1's, then each one's
    microbatch 1; the draws index that order (port-only: the JAX step's
    microbatches are the global batch's own halves)."""
    case = _case_2d("2d-accum", vae_kw, {"grad_accum": 2})
    case["one_process_order"] = [0, 2, 1, 3]
    return case


def _run_cases(cases: list[dict], tmp, **spec):
    """The two-rank runs (a torchrun launch, with ``spec``'s other items)
    and here, meanwhile, the one-process runs, each recording its loss
    head's decisions (``chip_smoke.DecisionTape``) for the ranks to replay
    their rows of (``OUT/tape{i}.pt``, which the ranks wait for)."""
    from chip_smoke import DecisionTape

    launched = _launch({**spec, "cases": [{k: v for k, v in c.items() if k != "jax"}
                                          for c in cases]}, tmp)
    one = {}
    for i, c in enumerate(cases):
        tape = DecisionTape()
        one[c["name"]] = torch_dp_worker.run_case(c, tape=tape)
        torch.save(tape.calls, os.path.join(str(tmp), f"tape{i}.tmp"))
        os.replace(os.path.join(str(tmp), f"tape{i}.tmp"), os.path.join(str(tmp), f"tape{i}.pt"))
    return one, _collect(launched)


GN_SHAPE = (4, 6, 5, 3)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """(the cases, the one-process runs, each rank's output, GradNorm's
    inputs, the trainer's run dir), port params and numpy draws. The same
    launch then runs the two-rank ``Trainer`` twice (``_trainer_argv``)."""
    torch.set_num_threads(1)
    cases = _cases(jax_side=False)
    rng = np.random.RandomState(8)
    gn = {"x": rng.randn(*GN_SHAPE).astype(np.float32),
          "g": rng.randn(*GN_SHAPE).astype(np.float32), "weight": 0.5}
    tmp = tmp_path_factory.mktemp("dp")
    ckpt = str(tmp / "ckpt")
    one, ranks = _run_cases(cases, tmp, gradnorm=gn,
                            trainer=[_trainer_argv(ckpt, 2), _trainer_argv(ckpt, 3),
                                     _trainer3d_argv(ckpt)])
    return {c["name"]: c for c in cases}, one, ranks, gn, os.path.join(ckpt, "dp")


@pytest.fixture(scope="module")
def dp_jax(tmp_path_factory):
    """The same with JAX params and the JAX steps' draws."""
    torch.set_num_threads(1)
    cases = _cases(jax_side=True)
    _, ranks = _run_cases(cases, tmp_path_factory.mktemp("dp_jax"))
    return {c["name"]: c for c in cases}, ranks


# ---------------------------------------------------------------------------
# the mesh


@pytest.mark.parametrize("shape", [
    {"data": -1}, {"data": 2, "fsdp": -1}, {"data": -1, "tensor": 2, "context": -1},
    {"data": 3}, {"data": 3, "fsdp": -1}, {"fsdp": 2, "tensor": 4},
])
def test_mesh_extents_match_jax(eight_devices, shape):
    """``mesh_extents`` applies JAX ``create_mesh``'s rules to an axis dict:
    the extents, or the same error, over the 8 host devices."""
    try:
        want = dict(jax_create_mesh(dict(shape), devices=eight_devices).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_extents(shape, 8)
        assert str(got.value) == str(e)
        return
    assert mesh_extents(shape, 8) == want


def test_create_mesh_in_one_process():
    """Without torchrun the mesh is one rank with no process group, and a
    data, fsdp or context axis of 2 says how to get a second rank; the
    unported axes raise naming their ROADMAP items."""
    mesh = create_mesh({"data": -1})
    assert (mesh.shape, mesh.rank, mesh.world_size, mesh.group) == ({"data": 1}, 0, 1, None)
    assert mesh.is_master and mesh.n_data == 1
    assert mesh.any(True) and not mesh.any(False)
    for axes in ({"data": 2}, {"data": 1, "fsdp": 2}, {"data": 1, "context": 2}):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            create_mesh(axes)
    for axes, item in (({"data": 1, "tensor": 2}, "tensor sharding"),
                       ({"data": 1, "fsdp": 2, "context": 2}, "fsdp x context")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, Queue 1: {item}"):
            create_mesh(axes)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh_extents({"pipeline": 2}, 2)


# ---------------------------------------------------------------------------
# GradNorm


@pytest.mark.parametrize("mode", ["global", "mean_shard_norm"])
def test_gradnorm_across_ranks_matches_jax(dp, mode):
    """Each rank's rows of GradNorm's backward, concatenated, against JAX
    ``gradnorm`` on the global tensor: the Frobenius norm over both ranks,
    or (``shards=2``) the mean of the two ranks' norms."""
    _, _, ranks, gn, _ = dp
    got = torch.cat([r["gradnorm"][mode] for r in ranks]).numpy()
    shards = 2 if mode == "mean_shard_norm" else 1
    _, vjp = jax.vjp(lambda a: jax_gradnorm(a, gn["weight"], None, shards), jnp.asarray(gn["x"]))
    (want,) = vjp(jnp.asarray(gn["g"]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    other = "global" if mode == "mean_shard_norm" else "mean_shard_norm"
    assert not np.allclose(got, torch.cat([r["gradnorm"][other] for r in ranks]).numpy())


# ---------------------------------------------------------------------------
# the steps


def _check_moments(got: dict, ref: dict, drop_codebook: bool):
    """Step-1 first moments per tensor within GRAD_RTOL of its largest
    entry, floored at ZERO_FLOOR of the largest entry of all."""
    ref = dict(ref)
    if drop_codebook:  # EMA mode: no gradient reaches the codebook (optax keeps a 0 moment)
        assert "reg.codebook" not in got
        if "reg.codebook" in ref:
            assert float(ref.pop("reg.codebook").abs().max()) == 0
    assert set(got) == set(ref)
    floor = ZERO_FLOOR * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        assert err <= GRAD_RTOL * float(r.abs().max()) + floor, (name, err)


def _check_run(got: dict, ref: dict, vq: bool):
    """A two-rank run against a reference run of the global batch: the
    metric curve, step 1's moments of G and D, the VQ statistics."""
    for i in range(STEPS):
        assert set(got["metrics"][i]) == set(ref["metrics"][i])
        for k, v in ref["metrics"][i].items():
            np.testing.assert_allclose(got["metrics"][i][k], v, rtol=CURVE_RTOL, atol=CURVE_ATOL,
                                       err_msg=f"step {i} {k}")
    _check_moments(got["exp_avg_g"], ref["exp_avg_g"], drop_codebook=vq)
    _check_moments(got["exp_avg_d"], ref["exp_avg_d"], drop_codebook=False)
    if vq:
        s_ref, s_got = ref["vq_ema"], got["vq_ema"]
        assert float((s_got["counts"] - s_ref["counts"]).abs().sum()) <= 0.2 + 1e-4
        scale = float(s_ref["sums"].abs().max())
        assert float((s_got["sums"] - s_ref["sums"]).abs().max()) <= CURVE_RTOL * scale
        cb_ref, cb = ref["params"]["reg.codebook"], got["params"]["reg.codebook"]
        assert float((cb - cb_ref).abs().max()) <= CURVE_RTOL * float(cb_ref.abs().max())


@pytest.mark.parametrize("name", CASES)
def test_ranks_stay_bitwise_equal(dp, name):
    """After every step both ranks hold the same train state bit for bit
    (parameters, buffers, AdamW moments and counts, LeCam anchors, the
    generator, the EMAs), and log the same global metrics."""
    _, _, ranks, _, _ = dp
    assert all(r[name]["replicas_equal"] == [True] * STEPS for r in ranks)
    assert ranks[0][name]["metrics"] == ranks[1][name]["metrics"]


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_make_the_one_process_step(dp, name):
    """Two ranks of B/2 make the one-process step on the global batch B:
    the same losses and metrics, gradients and VQ statistics, at the bounds
    of tests/test_torch_train_step.py (the two differ by the rounding of
    convolutions over another batch size)."""
    _, one, ranks, _, _ = dp
    _check_run(ranks[0][name], one[name], vq=name == "2d-vq")


def test_vq_counts_are_summed_exactly(dp):
    """The code counts are integers: after step 1 the two ranks' summed
    counts, folded into the EMA, are the one-process EMA counts of the
    global batch exactly; some codes were revived."""
    _, one, ranks, _, _ = dp
    got, ref = ranks[0]["2d-vq"]["vq_ema_steps"][0], one["2d-vq"]["vq_ema_steps"][0]
    assert torch.equal(got["counts"], ref["counts"])
    assert 0 < int((got["counts"] < 0.5).sum()) < K


def _jax_run(case: dict) -> dict:
    """The JAX step on the case's global batches with its draws' keys: per
    step the metrics, step 1's first moments, the final G params and EMAs."""
    from vqgan_tpu.train.state import create_train_state as jax_state
    from vqgan_tpu.train.state import make_discriminator_optimizer as jax_d_opt
    from vqgan_tpu.train.state import make_generator_optimizer as jax_g_opt
    from vqgan_tpu.train.step import make_train_step as jax_step_2d
    from vqgan_tpu.train.step3d import make_train_step_3d_gan as jax_step_3d

    jp = case["jax"]
    three_d = case["kind"] == "3d"
    cfg_j = JaxTrainConfig(**case["train"])
    model_cfg = (JaxTVAEConfig if three_d else JaxVAEConfig)(**case["model"])
    model = (JaxTVAE if three_d else JaxVAE)(cfg=model_cfg)
    vq_ema = None if jp["vq_ema"] is None else jax.tree_util.tree_map(jnp.asarray, jp["vq_ema"])
    state = jax.jit(lambda g, d, e: jax_state(cfg_j, g, d, model_cfg.ch,
                                              jax.random.PRNGKey(RNG0), vq_ema=e)[0])(
        jp["g"], jp["d"], vq_ema)
    g_tx, d_tx = jax_g_opt(cfg_j, model_cfg.ch, jp["g"]), jax_d_opt(cfg_j)
    if three_d:
        step = jax.jit(jax_step_3d(cfg_j, model_cfg, model, JaxDisc(), JaxLPIPS(), g_tx, d_tx))
    else:
        step = jax.jit(jax_step_2d(cfg_j, model_cfg, model, JaxDisc(), JaxLPIPS(), g_tx, d_tx,
                                   gradnorm_shards=RANKS), static_argnums=(3,))
    out = {"metrics": []}
    for i, batch in enumerate(case["batches"]):
        args = (state, jnp.asarray(batch), jp["lpips"]) + (() if three_d else (0,))
        state, m = step(*args)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["exp_avg_g"] = jax_params_to_state_dict(_mu_tree(state.g_opt))
            out["exp_avg_d"] = jax_disc_params_to_state_dict(_mu_tree(state.d_opt))
    out["params"] = jax_params_to_state_dict(jax.device_get(state.g_params))
    out["vq_ema"] = (None if state.vq_ema is None
                     else jax_vq_ema_to_torch(jax.device_get(state.vq_ema)))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", JAX_CASES)
def test_two_ranks_make_the_jax_step_on_the_global_batch(dp_jax, name):
    """The JAX step on the global batch (``gradnorm_shards`` = 2, JAX's
    ``n_data``), its own draws: the two-rank run's metric curve, step-1
    moments and VQ statistics at tests/test_torch_train_step.py's bounds."""
    cases, ranks = dp_jax
    assert all(r[name]["replicas_equal"] == [True] * STEPS for r in ranks)
    _check_run(ranks[0][name], _jax_run(cases[name]), vq=name == "2d-vq")


# ---------------------------------------------------------------------------
# the Trainer


def same(a, b) -> bool:
    """Two state trees equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def _trainer_argv(run_dir: str, max_steps: int) -> list[str]:
    return ["--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
            "--vae_num_res_blocks", "1", "--vae_z_channels", "8", "--vae_resolution", "32",
            "--image_size", "32", "--batch_size", "4", "--synthetic_data", "true",
            "--max_steps", str(max_steps), "--evaluate_every_n_steps", "2",
            "--eval_batches", "1", "--log_every", "1", "--use_wandb", "false",
            "--mesh_shape", "data=-1", "--ckpt_dir", run_dir, "--run_name", "dp"]


def _trainer3d_argv(ckpt: str) -> list[str]:
    return ["train3d", "--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
            "--vae_num_res_blocks", "1", "--vae_z_channels", "4", "--vae_resolution", "16",
            "--frames", "4", "--batch_size", "2", "--max_steps", "2",
            "--evaluate_every_n_steps", "2", "--eval_batches", "1", "--use_wandb", "false",
            "--log_every", "1", "--mesh_shape", "data=2", "--ckpt_dir", ckpt,
            "--run_name", "dp3d"]


def test_two_rank_trainer3d_trains_one_clip_a_rank(dp):
    """``train3d --batch_size 2 --mesh_shape data=2`` over 2 ranks: one
    synthetic clip a rank, 2 recon-only steps, the ranks' states bitwise
    equal after them; rank 0 alone logs (each step once, its evals) and
    saves: at (step + 1) % 2 == 1 (after step 0, as state step 1) and at
    the end."""
    _, _, ranks, _, run_dir = dp
    runs = [r["trainer"][2] for r in ranks]
    assert [r["local_batch"] for r in runs] == [1, 1]
    assert [r["mesh"] for r in runs] == [{"data": 2}] * RANKS
    assert [r["logs"] for r in runs] == [True, False]
    assert same(runs[1]["trained"], runs[0]["trained"]) and runs[0]["trained"]["step"] == 2
    run3d = os.path.join(os.path.dirname(run_dir), "dp3d")
    assert sorted(os.listdir(os.path.join(run3d, "state"))) == [
        "step_00000001.pt", "step_00000002.pt"]
    with open(os.path.join(run3d, "metrics_dp3d.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [ln["step"] for ln in lines if "loss" in ln] == [0, 1]
    assert [ln["step"] for ln in lines if "eval/psnr" in ln] == [0, 2]


def test_two_rank_trainer_saves_on_rank_0_and_resumes(dp):
    """``--batch_size 4`` over 2 ranks: 2 samples a rank; eval and a save
    after step 1, the final save at step 2; a second ``Trainer`` restores
    step 2 on both ranks bit for bit as the first left it, and trains step
    3 (eval and save after it). Rank 0 alone logs: one config header a
    ``Trainer``, one line a step, the evals."""
    _, _, ranks, _, run_dir = dp
    first, second = ([r["trainer"][i] for r in ranks] for i in range(2))
    for runs in (first, second):
        assert [r["local_batch"] for r in runs] == [2, 2]
        assert [r["mesh"] for r in runs] == [{"data": 2}] * RANKS
        assert [r["logs"] for r in runs] == [True, False]
    for r in range(RANKS):
        assert same(second[r]["built"], first[0]["trained"])
        assert same(first[r]["trained"], first[0]["trained"])
        assert same(second[r]["trained"], second[0]["trained"])
    assert first[0]["trained"]["step"] == 2
    assert second[0]["trained"]["step"] == 3
    assert sorted(os.listdir(os.path.join(run_dir, "state"))) == [
        "step_00000001.pt", "step_00000002.pt", "step_00000003.pt"]
    with open(os.path.join(run_dir, "metrics_dp.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    headers = [ln for ln in lines if "_config" in ln]
    assert len(headers) == 2  # one a launch, from rank 0
    steps = [ln["step"] for ln in lines if "overall_vae_loss" in ln]
    assert steps == [0, 1, 2]
    assert [ln["step"] for ln in lines if "eval/psnr" in ln] == [1, 3]
    assert os.path.exists(os.path.join(run_dir, "eval", "test_images_step1.png"))
