"""Reference-format weights, the port's init scheme, and the rule that
chip_smoke.py never passes without a CUDA device."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.models.ae import init_vae_params
from vqgan_tpu.models.tae import TVAE as JaxTVAE
from vqgan_tpu.train.checkpoint import save_weights_torch
from vqgan_tpu.train.torch_import import params_to_torch_state_dict, save_torch_checkpoint
from vqgan_tpu_torch.config import TVAEConfig, VAEConfig
from vqgan_tpu_torch.models.ae import VAE, init_vae
from vqgan_tpu_torch.models.tae import TVAE
from vqgan_tpu_torch.models.blocks import Conv2d, FP32GroupNorm
from vqgan_tpu_torch.weights import (
    jax_params_to_state_dict,
    load_weights,
    save_weights,
)

from torch_parity import randomize_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
            z_channels=8)


@pytest.fixture(scope="module")
def jax_params():
    _, params = init_vae_params(JaxVAEConfig(**TINY), jax.random.PRNGKey(0))
    return jax.device_get(params)


@pytest.mark.parametrize("reg_type", ["identity_gaussian", "gaussian"])
def test_state_dict_matches_jax_exporter_and_loads_strictly(reg_type):
    _, params = init_vae_params(JaxVAEConfig(**TINY, reg_type=reg_type),
                                jax.random.PRNGKey(1))
    ours = jax_params_to_state_dict(jax.device_get(params))
    theirs = params_to_torch_state_dict(jax.device_get(params))
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v)
    model = VAE(VAEConfig(**TINY, reg_type=reg_type))
    model.load_state_dict(ours, strict=True)
    assert "encoder.mid.block_1.norm1.weight" in ours
    assert "decoder.up.1.upsample.conv.bias" in ours
    assert "decoder.up.0.block.0.nin_shortcut.weight" in ours


@pytest.mark.parametrize("reg_type", ["gaussian", "vq"])
def test_conv3d_kernels_transpose_to_oidhw(reg_type, tmp_path):
    """A JAX TVAE tree: every 5-D kernel DHWIO → OIDHW, as the JAX exporter
    writes it, and the state dict loads into the port's TVAE strictly; the
    ``.pt`` the JAX package writes reads back the same."""
    kw = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
              reg_type=reg_type, vq_codebook_size=64)
    model = JaxTVAE(cfg=JaxTVAEConfig(**kw))
    x = jax.numpy.zeros((1, 4, 16, 16, 3))
    # the init's shapes (tracing only), filled with numpy
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "sample": jax.random.PRNGKey(1)}, x)
    params = randomize_params(shapes["params"], 0)
    ours = jax_params_to_state_dict(params)
    theirs = params_to_torch_state_dict(params)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    kernel = params["decoder"]["up_1"]["upsample"]["conv"]["kernel"]  # DHWIO
    np.testing.assert_array_equal(ours["decoder.up.1.upsample.conv.weight"].numpy(),
                                  np.transpose(kernel, (4, 3, 0, 1, 2)))
    TVAE(TVAEConfig(**kw)).load_state_dict(ours, strict=True)
    path = str(tmp_path / "tvae.pt")
    save_torch_checkpoint(params, path)
    sd = load_weights(path)
    assert set(sd) == set(ours)
    assert all(torch.equal(sd[k], ours[k]) for k in ours)


def test_load_weights_reads_the_jax_package_pt(jax_params, tmp_path):
    path = str(tmp_path / "w.pt")
    save_weights_torch(jax_params, path)
    sd = load_weights(path)
    want = jax_params_to_state_dict(jax_params)
    assert set(sd) == set(want)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)


def test_load_weights_strips_ddp_and_compile_prefixes(jax_params, tmp_path):
    sd = jax_params_to_state_dict(jax_params)
    path = str(tmp_path / "ddp.pt")
    torch.save({f"module._orig_mod.{k}": v for k, v in sd.items()}, path)
    assert set(load_weights(path)) == set(sd)


def test_save_weights_round_trip(tmp_path):
    cfg = VAEConfig(**TINY)
    model = init_vae(cfg, torch.Generator().manual_seed(3))
    model.to(memory_format=torch.channels_last)
    path = str(tmp_path / "w.pt")
    save_weights(model, path)
    sd = load_weights(path)
    assert all(v.is_contiguous() for v in sd.values())
    again = VAE(cfg)
    again.load_state_dict(sd, strict=True)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_init_scheme():
    cfg = VAEConfig(ch=64, ch_mult=(1, 2), num_res_blocks=1, z_channels=8)
    model = init_vae(cfg, torch.Generator().manual_seed(0))
    same = init_vae(cfg, torch.Generator().manual_seed(0))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              same.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    for name, m in model.named_modules():
        if isinstance(m, FP32GroupNorm):
            assert bool((m.weight == 1).all()) and bool((m.bias == 0).all())
        elif isinstance(m, Conv2d):
            assert bool((m.bias == 0).all()), name
            w = m.weight.detach()
            if name.endswith("conv2"):
                # normal, std 1e-4/out_ch (reference ae.py:120-121)
                want = 1e-4 / w.shape[0]
                assert abs(float(w.std()) / want - 1) < 0.05, name
            else:
                # torch's default: U(±1/√fan_in), std bound/√3
                bound = 1 / np.sqrt(w[0].numel())
                assert float(w.abs().max()) <= bound
                assert abs(float(w.std()) / (bound / np.sqrt(3)) - 1) < 0.1, name


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No CUDA device: chip_smoke.py exits non-zero and prints no result,
    in the repo and in a directory that holds only the script."""
    if torch.cuda.is_available():
        pytest.fail("this test pins the CUDA-less behaviour; run it without a card")
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    for cwd in (REPO, str(lone)):
        out = _run_smoke(cwd)
        assert out.returncode != 0, cwd
        assert '"ok": true' not in out.stdout, cwd
        assert '"kernels"' not in out.stdout, cwd
