"""The port's three calibration and scoring tools on the CPU against the JAX
package's (``tools/unit_activation_reinit.py``,
``tools/recompute_eval_metrics.py``, ``tools/make_alt_lpips.py``):

  - ``compute_activation_std`` per layer within 1e-5 relative of JAX's on
    weights carried across from JAX params and the same numpy batch, at the
    JAX test's tiny VAE (tests/test_tools.py); ``adjust_weight_init``
    (no muP start, 2 iterations) rescales the kernels as JAX's does, within
    1e-4; ``mup_reinit``'s draws have N(0, 1/fan_in)'s statistics;
  - ``recompute_eval_metrics`` on two tiny checkpoints and a PNG tar shard
    written here, with a ``make_alt_lpips`` judge: its JSON rows match the
    JAX tool's within 1e-4 with the eval in fp32 on both sides (the eval
    dtypes patched into both tools' configs: the shipped bf16 eval rounds
    each package's convolutions its own way); two judges of one name raise;
  - ``make_alt_lpips``'s file loads in both packages' LPIPS loaders, which
    give the same LPIPS within 1e-5, never negative.
"""

import functools
import importlib.util
import json
import os
import shutil
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu_torch.config import VAEConfig
from vqgan_tpu_torch.losses.lpips import LPIPS
from vqgan_tpu_torch.models.ae import VAE, init_vae
from vqgan_tpu_torch.tools import make_alt_lpips, recompute_eval_metrics
from vqgan_tpu_torch.tools.unit_activation_reinit import (
    adjust_weight_init,
    compute_activation_std,
    mup_reinit,
)
from vqgan_tpu_torch.utils.logging import write_png
from vqgan_tpu_torch.weights import (
    _flax_to_torch_key,
    jax_params_to_state_dict,
    load_lpips_weights,
    save_weights,
)

from torch_parity import randomize_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX test's calibrator model (tests/test_tools.py)
CALIB = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
             enc_dtype="float32", dec_dtype="float32")
# the recompute tool's model: its CLI sets these four and keeps the rest
RECOMPUTE = ["--vae_ch", "32", "--vae_ch_mult", "1,2", "--vae_z_channels", "8",
             "--vae_resolution", "32", "--image_size", "32", "--batch_size", "2",
             "--eval_batches", "2"]
STD_RTOL = 1e-5
KERNEL_ATOL = 1e-4
ROW_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=1)
def _calib_models():
    """(flax model, JAX params from numpy, the numpy batch)."""
    model_j = JaxVAE(cfg=JaxVAEConfig(**CALIB))
    shapes = jax.eval_shape(model_j.init, {"params": jax.random.PRNGKey(0),
                                           "sample": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 16, 16, 3)))["params"]
    batch = np.random.RandomState(1).randn(4, 16, 16, 3).astype(np.float32)
    return model_j, randomize_params(shapes, 0), batch


def _port_calib(params) -> VAE:
    vae = VAE(VAEConfig(**CALIB))
    vae.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return vae


def _port_name(path: tuple) -> str:
    return _flax_to_torch_key(list(path) + ["kernel"])[:-len(".weight")]


def test_activation_std_matches_jax():
    """Every layer both record: the same std within 1e-5 relative. The
    common layers cover every conv of the port and most of JAX's."""
    tool = _jax_tool("unit_activation_reinit")
    model_j, params, batch = _calib_models()
    want = tool.compute_activation_std(model_j, params, jnp.asarray(batch),
                                       {"sample": jax.random.PRNGKey(2)})
    vae = _port_calib(params)
    got = compute_activation_std(vae, torch.from_numpy(batch))
    want = {_port_name(k): v for k, v in want.items()}
    common = set(got) & set(want)
    convs = {n for n, m in vae.named_modules() if getattr(m, "weight", None) is not None
             and m.weight.ndim >= 2}
    assert convs <= common and len(common) >= 0.8 * len(want), sorted(set(want) - common)
    for name in sorted(common):
        np.testing.assert_allclose(got[name], want[name], rtol=STD_RTOL, err_msg=name)


def test_adjust_weight_init_matches_jax():
    """Without the muP start, two iterations: the port's rescaled kernels
    are JAX's within 1e-4, and the reports agree."""
    tool = _jax_tool("unit_activation_reinit")
    model_j, params, batch = _calib_models()
    vae = _port_calib(params)
    params_j = jax.tree_util.tree_map(lambda a: a, params)
    params_j, report_j = tool.adjust_weight_init(model_j, params_j, jnp.asarray(batch),
                                                 {"sample": jax.random.PRNGKey(2)}, tol=0.1,
                                                 max_iters=2, use_mup_start=False)
    _, report = adjust_weight_init(vae, torch.from_numpy(batch), tol=0.1, max_iters=2,
                                   use_mup_start=False)
    want = jax_params_to_state_dict(params_j)
    moved = 0
    for name, p in vae.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=KERNEL_ATOL, err_msg=name)
        moved += not np.allclose(want[name].numpy(),
                                 jax_params_to_state_dict(params)[name].numpy())
    assert moved > 5
    report_j = {_port_name(tuple(k.split("/"))): v for k, v in report_j.items()}
    for name in set(report) & set(report_j):
        for key, v in report_j[name].items():
            np.testing.assert_allclose(report[name][key], v, rtol=1e-4, err_msg=name)


def test_mup_reinit_statistics():
    """Each kernel N(0, 1/fan_in): the sample std within 10 % and the mean
    within 4 standard errors of 0 where a kernel has 4,096+ entries; biases
    0; GroupNorm scales kept; one seed gives one draw, another seed another."""
    vae = init_vae(VAEConfig(**CALIB), torch.Generator().manual_seed(0))
    scales = {n: p.clone() for n, p in vae.named_parameters() if "norm" in n}
    mup_reinit(vae, torch.Generator().manual_seed(3))
    checked = 0
    for name, p in vae.named_parameters():
        if name.endswith("bias"):
            assert float(p.detach().abs().max()) == 0.0, name
        elif p.ndim >= 2 and p.numel() >= 4096:
            std = 1.0 / p[0].numel() ** 0.5
            assert abs(float(p.detach().std()) / std - 1.0) < 0.1, name
            assert abs(float(p.detach().mean())) < 4 * std / p.numel() ** 0.5, name
            checked += 1
    assert checked >= 5
    for n, v in scales.items():
        assert torch.equal(dict(vae.named_parameters())[n], v), n
    again = mup_reinit(init_vae(VAEConfig(**CALIB), torch.Generator().manual_seed(9)),
                       torch.Generator().manual_seed(3))
    other = mup_reinit(init_vae(VAEConfig(**CALIB), torch.Generator().manual_seed(9)),
                       torch.Generator().manual_seed(4))
    w = "encoder.conv_in.weight"
    assert torch.equal(again.state_dict()[w], vae.state_dict()[w])
    assert not torch.equal(other.state_dict()[w], vae.state_dict()[w])


# ---------------------------------------------------------------------------
# recompute_eval_metrics and make_alt_lpips


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Two checkpoints of the recompute tool's model, a tar shard of six PNG
    images of mixed sizes, and an alternate LPIPS judge file."""
    root = tmp_path_factory.mktemp("recompute")
    cfg = VAEConfig(ch=32, ch_mult=(1, 2), z_channels=8, resolution=32)
    for step, seed in ((1, 0), (20, 1)):
        save_weights(init_vae(cfg, torch.Generator().manual_seed(seed)),
                     str(root / f"vae_epoch_0_step_{step}.pt"))
    rng = np.random.RandomState(0)
    shard = str(root / "00000.tar")
    with tarfile.open(shard, "w") as tf:
        for i, (h, w) in enumerate([(40, 48), (32, 32), (64, 40), (36, 36), (50, 70),
                                    (32, 45)]):
            png = str(root / f"{i}.png")
            yy, xx = np.mgrid[0:h, 0:w]
            img = (127 + 100 * np.sin(xx[..., None] / (3 + i) + yy[..., None] / 5
                                      + np.arange(3)) + rng.randint(-20, 20, (h, w, 3)))
            write_png(png, np.clip(img, 0, 255).astype(np.uint8))
            tf.add(png, arcname=f"img{i}.png")
    judge = str(root / "alt.npz")
    make_alt_lpips.main(["--seed", "7", "--out", judge])
    yield root, shard, judge
    shutil.rmtree(root, ignore_errors=True)


def _rows(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_lpips_init():
    """JAX ``load_lpips_params`` with its flax init jitted: the op-by-op
    init of the VGG takes ~13 s here, and a weight file replaces every
    leaf it makes."""
    import vqgan_tpu.losses.lpips as jax_lpips

    real = jax_lpips.load_lpips_params

    def load(path, rng, image_size=256):
        x = jnp.zeros((1, image_size, image_size, 3))
        init = jax.jit(JaxLPIPS().init)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_lpips.LPIPS, "init", lambda self, *a: init(*a))
            return real(path, rng, image_size)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lpips, "load_lpips_params", load)
        yield


def _both_tools(run_dir, capsys, monkeypatch):
    """The JAX tool's rows and the port tool's, on the same files, both
    tools' eval in fp32 (their configs patched)."""
    root, shard, judge = run_dir
    args = ["--ckpt_glob", str(root / "vae_epoch_0_step_*.pt"), "--test_dataset_url", shard,
            "--judge_lpips", judge] + RECOMPUTE
    jax_tool = _jax_tool("recompute_eval_metrics")
    import vqgan_tpu_torch.config as port_config

    for module in (jax_tool, port_config):
        monkeypatch.setattr(module, "VAEConfig",
                            functools.partial(module.VAEConfig, dec_dtype="float32"))
        monkeypatch.setattr(module, "TrainConfig",
                            functools.partial(module.TrainConfig, eval_bf16=False))
    jax_tool.main.main(args=args, standalone_mode=False)
    want = _rows(capsys.readouterr().out)
    got = recompute_eval_metrics.recompute(
        recompute_eval_metrics.build_parser().parse_args(args + ["--device", "cpu"]))
    assert _rows(capsys.readouterr().out) == got
    return got, want


def test_recompute_rows_match_jax_in_fp32(run_dir, capsys, monkeypatch):
    """The eval in fp32 on both sides: each checkpoint's PSNR, SSIM and
    judge LPIPS within 1e-4 of the JAX tool's (relative, or absolute for an
    SSIM near 0: the random checkpoints reconstruct noise), in step order."""
    got, want = _both_tools(run_dir, capsys, monkeypatch)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 20]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"step", "eval/psnr", "eval/ssim", "eval/lpips_judge_alt"}
        for k in ("eval/psnr", "eval/ssim", "eval/lpips_judge_alt"):
            np.testing.assert_allclose(g[k], w[k], rtol=ROW_TOL, atol=ROW_TOL, err_msg=k)
        assert np.isfinite(list(g.values())).all() and g["eval/lpips_judge_alt"] >= 0


def test_default_judge_and_duplicate_names(run_dir, capsys):
    """``default`` alone is ``eval/lpips_judge``; two judges of one name
    (one stem, or a file named ``default``) raise before any work."""
    root, shard, judge = run_dir
    base = ["--ckpt_glob", str(root / "vae_epoch_0_step_1.pt"), "--test_dataset_url", shard,
            "--device", "cpu"] + RECOMPUTE
    parse = recompute_eval_metrics.build_parser().parse_args
    (row,) = recompute_eval_metrics.recompute(parse(base + ["--judge_lpips", "default"]))
    assert row["eval/lpips_judge"] >= 0 and np.isfinite(row["eval/lpips_judge"])
    other = os.path.join(str(root), "sub")
    os.makedirs(other, exist_ok=True)
    for spec in (f"{judge},{os.path.join(other, 'alt.npz')}",
                 f"default,{os.path.join(other, 'default.npz')}"):
        with pytest.raises(ValueError, match="two judges named"):
            recompute_eval_metrics.recompute(parse(base + ["--judge_lpips", spec]))


def test_alt_lpips_loads_in_both_packages(run_dir):
    """The file's LPIPS in both packages: within 1e-5 on a pair, and >= 0
    on random pairs (signed heads could make it negative)."""
    _, _, judge = run_dir
    ours = LPIPS()
    ours.load_state_dict(load_lpips_weights(judge), strict=True)
    import vqgan_tpu.losses.lpips as jax_lpips

    theirs = jax_lpips.load_lpips_params(judge, jax.random.PRNGKey(0), image_size=32)
    rng = np.random.RandomState(3)
    x, y = (rng.uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(JaxLPIPS().apply({"params": theirs}, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert (got >= 0).all() and (got > 0).any()
    for k in range(5):
        assert float(ours.state_dict()[f"lin{k}.model.1.weight"].min()) >= 0
