"""The port's VQ latent (``vqgan_tpu_torch/models/quant.py`` and its wiring in
``models/ae.py`` and ``weights.py``) against the JAX package's
``vqgan_tpu/models/quant.py``, on the CPU.

Inputs and codebooks come from numpy seeds and go to both sides. The JAX
quantizer runs its default implementation on the CPU (the XLA formulation);
the port's CPU tensors take the plain versions of the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.models.ae import init_vae_params
from vqgan_tpu.models.quant import VectorQuantizer as JaxVQ
from vqgan_tpu.models.quant import apply_ema_codebook_update as jax_apply_ema
from vqgan_tpu.models.quant import revive_dead_codes as jax_revive
from vqgan_tpu_torch.config import VAEConfig
from vqgan_tpu_torch.models.ae import VAE, init_vae
from vqgan_tpu_torch.models.quant import (
    VectorQuantizer,
    apply_ema_codebook_update,
    revive_dead_codes,
)
from vqgan_tpu_torch.weights import jax_params_to_state_dict, jax_vq_ema_to_torch

from torch_parity import assert_codes_by_distance, randomize_params

K, D = 128, 8
# losses and perplexity: means and sums over a few hundred fp32 terms taken
# in other orders on the two sides, a few ulps
RTOL = 1e-5
# z_q and its gradients: the same fp32 operations on the same values
ATOL = 1e-6
TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=D,
            enc_dtype="float32", dec_dtype="float32", reg_type="vq", vq_codebook_size=K)
# whole VAE, fp32: XLA's and oneDNN's convs sum in other orders
# (tests/test_torch_inference.py)
ATOL_NET = 5e-5


def _inputs(seed=0, shape=(2, 6, 5, D)):
    rng = np.random.RandomState(seed)
    z = rng.randn(*shape).astype(np.float32)
    cb = (0.7 * rng.randn(K, D)).astype(np.float32)
    return z, cb


def _port_vq(cb, ema_decay):
    vq = VectorQuantizer(K, D, beta=0.25, ema_decay=ema_decay)
    with torch.no_grad():
        vq.codebook.copy_(torch.from_numpy(cb))
    return vq


def _jax(z, cb, ema_decay):
    """The JAX quantizer's (z_q, aux, new vq_ema or None) at z, with
    codebook cb and, with EMA, the init statistics (counts 1, sums cb)."""
    vq = JaxVQ(codebook_size=K, embedding_dim=D, beta=0.25, ema_decay=ema_decay)
    variables = {"params": {"codebook": jnp.asarray(cb)}}
    if ema_decay > 0:
        variables["vq_ema"] = {"counts": jnp.ones(K), "sums": jnp.asarray(cb)}
        (z_q, aux), mut = vq.apply(variables, jnp.asarray(z), mutable=["vq_ema"])
        return vq, variables, z_q, aux, mut["vq_ema"]
    z_q, aux = vq.apply(variables, jnp.asarray(z))
    return vq, variables, z_q, aux, None


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_quantizer_matches_jax(ema_decay):
    z, cb = _inputs()
    _, _, z_q_ref, aux_ref, ema_ref = _jax(z, cb, ema_decay)
    vq = _port_vq(cb, ema_decay)
    ema0 = vq.init_ema() if ema_decay > 0 else None
    z_q, aux, new_ema = vq(torch.from_numpy(z), ema0, update_stats=True)
    assert set(aux) == set(aux_ref)
    assert aux["codes"].shape == z.shape[:-1] and aux["codes"].dtype == torch.int32
    assert_codes_by_distance(z.reshape(-1, D), cb, aux["codes"].numpy().reshape(-1),
                             np.asarray(aux_ref["codes"]).reshape(-1), min_agree=1.0)
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(z_q_ref), atol=ATOL, rtol=0)
    for key in ("vq_loss", "commitment_loss", "codebook_loss", "perplexity", "usage"):
        np.testing.assert_allclose(float(aux[key].detach()), float(aux_ref[key]), rtol=RTOL,
                                   err_msg=key)
    if ema_decay > 0:
        assert float(aux["vq_loss"]) == pytest.approx(0.25 * float(aux["commitment_loss"]))
        for key in ("counts", "sums"):
            np.testing.assert_allclose(new_ema[key].numpy(), np.asarray(ema_ref[key]),
                                       rtol=1e-6, atol=1e-7, err_msg=key)
    else:
        assert new_ema is None


def test_quantizer_without_stats_update_returns_no_ema():
    z, cb = _inputs(seed=1)
    vq = _port_vq(cb, 0.9)
    _, aux, new_ema = vq(torch.from_numpy(z))
    assert new_ema is None and float(aux["usage"]) > 0
    with pytest.raises(ValueError, match="ema_state"):
        vq(torch.from_numpy(z), None, update_stats=True)
    # quantize: the forward's z_q, with no statistics
    np.testing.assert_array_equal(vq.quantize(torch.from_numpy(z)).detach().numpy(),
                                  vq(torch.from_numpy(z))[0].detach().numpy())


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_straight_through_gradient(ema_decay):
    """d/dz Σ z_q² = 2·z_q through the straight-through estimator, on both
    sides."""
    z, cb = _inputs(seed=2)
    vq_j, variables, z_q_ref, _, _ = _jax(z, cb, ema_decay)
    ref = jax.grad(lambda x: jnp.sum(vq_j.apply(variables, x, False)[0] ** 2))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    z_q, _, _ = _port_vq(cb, ema_decay)(zt)
    z_q.square().sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(zt.grad.numpy(), 2 * np.asarray(z_q_ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_vq_loss_gradients(ema_decay):
    """∂vq_loss/∂z on both sides; ∂vq_loss/∂codebook with EMA 0 (codebook +
    β·commitment), and none with EMA (β·commitment alone)."""
    z, cb = _inputs(seed=3)
    vq_j, variables, _, _, _ = _jax(z, cb, ema_decay)

    def loss(params, x):
        return vq_j.apply({**variables, "params": params}, x, False)[1]["vq_loss"]

    g_params, g_z = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(z))
    vq = _port_vq(cb, ema_decay)
    zt = torch.from_numpy(z).requires_grad_()
    vq(zt)[1]["vq_loss"].backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_z), atol=1e-8, rtol=RTOL)
    if ema_decay > 0:
        assert vq.codebook.grad is None
        assert float(jnp.abs(g_params["codebook"]).max()) == 0.0
    else:
        np.testing.assert_allclose(vq.codebook.grad.numpy(), np.asarray(g_params["codebook"]),
                                   atol=1e-8, rtol=RTOL)
        assert float(vq.codebook.grad.abs().max()) > 0


def test_ema_fold_and_revive_match_jax():
    """``apply_ema_codebook_update`` on the EMA statistics of a batch, then
    ``revive_dead_codes`` with the JAX draw of the K rows."""
    z, cb = _inputs(seed=4, shape=(4, 6, 6, D))
    _, _, _, _, ema_ref = _jax(z, cb, 0.9)
    vq = _port_vq(cb, 0.9)
    _, _, ema = vq(torch.from_numpy(z), vq.init_ema(), update_stats=True)
    folded_ref = jax_apply_ema({"codebook": jnp.asarray(cb)}, ema_ref)["codebook"]
    folded = apply_ema_codebook_update(vq.codebook.detach(), ema["counts"], ema["sums"])
    np.testing.assert_allclose(folded.numpy(), np.asarray(folded_ref), rtol=1e-5, atol=1e-7)

    flat = z.reshape(-1, D)
    key = jax.random.PRNGKey(7)
    threshold = 0.95  # unused codes: 0.9·1 + 0.1·0 < 0.95
    revived_ref = jax_revive(folded_ref, ema_ref["counts"], jnp.asarray(flat), key, threshold)
    idx = torch.from_numpy(np.asarray(jax.random.randint(key, (K,), 0, flat.shape[0]),
                                      np.int64))
    revived = revive_dead_codes(folded, ema["counts"], torch.from_numpy(flat), idx, threshold)
    dead = (ema["counts"] < threshold).numpy()
    assert 0 < dead.sum() < K
    np.testing.assert_allclose(revived.numpy(), np.asarray(revived_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(revived.numpy()[dead], flat[idx.numpy()][dead])


def test_codebook_init_follows_the_jax_initializer():
    """flax's variance_scaling(1, fan_in, uniform) on (K, D) is U(±√(3/K)):
    the port draws from the same law (not the same numbers)."""
    k = 4096
    cb_jax = np.asarray(JaxVQ(codebook_size=k, embedding_dim=16).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16)))["params"]["codebook"])
    vq = VectorQuantizer(k, 16)
    vq.init_codebook_(torch.Generator().manual_seed(0))
    limit = np.sqrt(3.0 / k)
    for cb in (cb_jax, vq.codebook.detach().numpy()):
        assert np.abs(cb).max() <= limit
        assert np.abs(cb).max() > 0.99 * limit
        np.testing.assert_allclose(cb.std(), limit / np.sqrt(3), rtol=0.02)


def test_init_vae_draws_the_codebook_last():
    """The codebook comes after every conv in module order, so a VQ model's
    convs get the identity model's weights from the same seed."""
    vq = init_vae(VAEConfig(**TINY), torch.Generator().manual_seed(0))
    ident = init_vae(VAEConfig(**{**TINY, "reg_type": "identity_gaussian"}),
                     torch.Generator().manual_seed(0))
    ref = ident.state_dict()
    for name, t in vq.state_dict().items():
        if name != "reg.codebook":
            assert torch.equal(t, ref[name]), name
    assert float(vq.reg.codebook.detach().abs().max()) <= np.sqrt(3.0 / K)


def _jax_vq_params(seed=0):
    cfg = JaxVAEConfig(**TINY, vq_ema_decay=0.0)
    _, params = init_vae_params(cfg, jax.random.PRNGKey(seed))
    return randomize_params(jax.device_get(params), seed)


def test_state_dict_maps_the_codebook():
    params = _jax_vq_params()
    sd = jax_params_to_state_dict(params)
    np.testing.assert_array_equal(sd["reg.codebook"].numpy(), params["reg"]["codebook"])
    model = VAE(VAEConfig(**TINY))
    model.load_state_dict(sd, strict=True)  # the codebook and no EMA buffers
    assert [n for n, _ in model.named_buffers()] == []


def test_vq_ema_collection_maps_to_the_train_state():
    rng = np.random.RandomState(0)
    vq_ema = {"reg": {"counts": rng.rand(K).astype(np.float32),
                      "sums": rng.randn(K, D).astype(np.float32)}}
    got = jax_vq_ema_to_torch(jax.tree_util.tree_map(jnp.asarray, vq_ema))
    assert set(got) == {"counts", "sums"}
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), vq_ema["reg"][k])


def test_vae_forward_matches_jax():
    params = _jax_vq_params(seed=1)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jax_model = JaxVAE(cfg=JaxVAEConfig(**TINY, vq_ema_decay=0.0))
    dec_ref, z_ref = jax_model.apply({"params": params}, jnp.asarray(x))
    model = VAE(VAEConfig(**TINY, vq_ema_decay=0.0))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        dec, z = model(torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=ATOL_NET)
    codes = model.reg(z)[1]["codes"].numpy().reshape(-1)
    ref_codes = np.asarray(jax_model.apply({"params": params}, z_ref, False,
                                           method=jax_model.regularize)[1]["codes"]).reshape(-1)
    assert_codes_by_distance(z.numpy().reshape(-1, D), params["reg"]["codebook"], codes,
                             ref_codes, min_agree=1.0)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_ref), atol=ATOL_NET)


def test_vae_regularize_returns_the_quantizer_triple():
    model = init_vae(VAEConfig(**TINY), torch.Generator().manual_seed(2))
    z = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 4, D).astype(np.float32))
    z_q, aux, new_ema = model.regularize(z, model.reg.init_ema(), update_stats=True)
    assert z_q.shape == z.shape and "vq_loss" in aux
    assert float(new_ema["counts"].sum()) == pytest.approx(0.99 * K + 0.01 * 16)
