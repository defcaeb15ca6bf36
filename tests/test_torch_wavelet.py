"""The port's wavelet transform and the wavelet + HR VAE against the JAX
package's, on the CPU.

The transform (``ops/wavelet.py``) at C = 3 and 5 in fp32, non-square, to
1e-6 of the largest entry; the VAE of ``tools/launch_hdr.sh``'s kind
(``use_wavelet``, ``decoder_also_perform_hr``) at a tiny width (ch 32,
ch_mult 1,2, 32 px in, 64 px out), flax-init params redrawn by
``randomize_params`` and carried by ``jax_params_to_state_dict`` into
``load_state_dict(strict=True)``: encode and decode within
tests/test_torch_models.py's ``ATOL_NET``, and the gradients of a fixed
projection of the reconstruction, per tensor, within ``GRAD_RTOL`` of the
tensor's largest entry; then the same weights as a reference-format .pt
through ``VAEPipeline`` against the JAX pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.inference import VAEPipeline as JaxPipeline
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.ops.wavelet import wavelet_transform_multi_channel as jax_wavelet
from vqgan_tpu.train.checkpoint import save_weights_torch
from vqgan_tpu_torch.config import VAEConfig
from vqgan_tpu_torch.inference import VAEPipeline
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.ops.wavelet import wavelet_transform_multi_channel, wavelet_weight
from vqgan_tpu_torch.weights import jax_params_to_state_dict

from test_torch_models import ATOL_NET
from torch_parity import randomize_params

WAVELET_HR = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                  use_wavelet=True, decoder_also_perform_hr=True,
                  enc_dtype="float32", dec_dtype="float32")
# per-tensor gradient bound, relative to the tensor's largest entry, floored
# at 1e-6 of the largest entry of all: fp32 on both sides, convs and
# GroupNorm backwards summed in other orders (measured: 9.0e-6)
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread: beside the other test workers, a
    tiny model's ops spend far longer waiting for threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("c", [3, 5])
def test_wavelet_transform_matches_jax(c):
    x = np.random.RandomState(c).randn(2, 16, 20, c).astype(np.float32)
    ref = np.asarray(jax_wavelet(jnp.asarray(x)))
    got = wavelet_transform_multi_channel(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 8, 10, 4 * c)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    # computed in fp32, returned in x's dtype (JAX wavelet.py:52-63)
    xb = torch.from_numpy(x).bfloat16()
    got_b = wavelet_transform_multi_channel(xb)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got_b.float().numpy(),
        wavelet_transform_multi_channel(xb.float()).bfloat16().float().numpy())


def test_wavelet_weight_is_the_grouped_bank():
    """Output channel c*4 + f of the grouped conv is filter f of input
    channel c: f1 varies along rows with the high-pass tap, f2 along
    columns."""
    w = wavelet_weight(2)
    assert w.shape == (8, 1, 6, 6)
    assert torch.equal(w[0:4], w[4:8])
    lo = torch.tensor([-0.1768, 0.3536, 1.0607, 0.3536, -0.1768, 0.0])
    hi = torch.tensor([0.0, -0.0, 0.3536, -0.7071, 0.3536, -0.0])
    torch.testing.assert_close(w[1, 0], torch.outer(hi, lo))
    torch.testing.assert_close(w[2, 0], torch.outer(lo, hi))


@pytest.fixture(scope="module")
def wavelet_vae():
    vae_j = JaxVAE(cfg=JaxVAEConfig(**WAVELET_HR))
    x0 = jnp.zeros((1, 32, 32, 3))
    params = randomize_params(jax.eval_shape(vae_j.init, {"params": jax.random.PRNGKey(0),
                                                          "sample": jax.random.PRNGKey(0)},
                                             x0)["params"], 0)
    vae = VAE(VAEConfig(**WAVELET_HR))
    vae.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return vae_j, params, vae


def test_wavelet_front_end_layout(wavelet_vae):
    """conv_in maps 4·3 wavelet channels to 2·ch, level 0 keeps its size (no
    Downsample) at twice ch_mult[0]; the decoder's first level carries the
    doubled width too (the config's decoder_ch_mult) and the HR level."""
    _, _, vae = wavelet_vae
    enc, dec = vae.encoder, vae.decoder
    assert tuple(enc.conv_in.weight.shape) == (64, 12, 3, 3)
    assert enc.down[0].downsample is None and enc.down[1].downsample is None
    assert tuple(enc.down[0].block[0].conv1.weight.shape) == (64, 64, 3, 3)
    assert VAEConfig(**WAVELET_HR).decoder_ch_mult == (2, 2, 4)
    assert tuple(dec.conv_out.weight.shape) == (3, 64, 3, 3)


def test_wavelet_vae_encode_decode_and_gradients_match_jax(wavelet_vae):
    vae_j, params, vae = wavelet_vae
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    proj = rng.randn(2, 64, 64, 3).astype(np.float32)

    def jax_loss(p, x):
        z = vae_j.apply({"params": p}, x, method=vae_j.encode)
        dec = vae_j.apply({"params": p}, z, method=vae_j.decode)
        return (dec * proj).sum() + 0.1 * (z ** 2).sum(), (z, dec)

    (_, (z_ref, dec_ref)), g_ref = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params, jnp.asarray(x))
    z = vae.encode(torch.from_numpy(x))
    dec = vae.decode(z)
    loss = (dec * torch.from_numpy(proj)).sum() + 0.1 * z.square().sum()
    loss.backward()
    assert z.shape == (2, 16, 16, 8) and dec.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref), atol=ATOL_NET)
    np.testing.assert_allclose(dec.detach().numpy(), np.asarray(dec_ref), atol=ATOL_NET)
    ref = jax_params_to_state_dict(jax.device_get(g_ref))
    got = {n: p.grad for n, p in vae.named_parameters()}
    assert set(got) == set(ref)
    floor = GRAD_FLOOR * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        assert err <= GRAD_RTOL * float(r.abs().max()) + floor, (name, err)


def test_wavelet_pipeline_serves_the_pt(tmp_path, wavelet_vae):
    """A wavelet + HR .pt (``save_weights_torch``) loads strictly and serves
    the HR output at twice the input size: the JAX pipeline's images within
    the fp32 bound of tests/test_torch_inference.py."""
    _, params, _ = wavelet_vae
    path = str(tmp_path / "wavelet_hr.pt")
    save_weights_torch(params, path)
    jax_pipe = JaxPipeline.from_checkpoint(path, JaxVAEConfig(**WAVELET_HR))
    port = VAEPipeline.from_checkpoint(path, VAEConfig(**WAVELET_HR), device="cpu")
    images = np.random.RandomState(2).randint(0, 256, (2, 32, 32, 3), np.uint8)
    got, ref = port.reconstruct(images), np.asarray(jax_pipe.reconstruct(images))
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=5e-5)
