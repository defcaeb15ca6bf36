"""The port's training losses against the JAX package's, on the CPU.

VGG16 taps, LPIPS and the PatchDiscriminator run with the same params: the
flax init made non-trivial with numpy (``randomize_params``: the LPIPS heads
and the discriminator's zero-init final heads included), carried to the port
through ``weights.jax_lpips_params_to_state_dict`` /
``jax_disc_params_to_state_dict`` and ``load_state_dict(strict=True)``. Those
converters are also held to be the exact inverse of the JAX package's
``convert_torch_lpips`` / ``convert_torch_patch_discriminator``. Images are
NHWC on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.losses import gan as jgan
from vqgan_tpu.losses.discriminator import PatchDiscriminator as JaxDisc
from vqgan_tpu.losses.discriminator import convert_torch_patch_discriminator
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.losses.lpips import convert_torch_lpips
from vqgan_tpu.losses.recon import vae_loss_function as jax_vae_loss
from vqgan_tpu.losses.vgg import VGG16Features as JaxVGG
from vqgan_tpu.ops.gradnorm import gradnorm as jax_gradnorm
from vqgan_tpu.ops.resize import area_downsample as jax_area_downsample
from vqgan_tpu.ops.resize import resize_area as jax_resize_area
from vqgan_tpu_torch.losses import gan
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
from vqgan_tpu_torch.losses.lpips import LPIPS
from vqgan_tpu_torch.losses.recon import vae_loss_function
from vqgan_tpu_torch.ops.gradnorm import gradnorm
from vqgan_tpu_torch.ops.resize import area_downsample, resize_area
from vqgan_tpu_torch.weights import (
    jax_disc_params_to_state_dict,
    jax_lpips_params_to_state_dict,
)

from torch_parity import randomize_params

RES = 32  # the smallest side the VGG's four pools and the heads take
# fp32 through 13 convs on both sides (XLA's and oneDNN's summation orders).
# Measured, relative to the largest value: taps 5e-7 to 1.2e-6, LPIPS 7e-8
# and its input gradient 2.2e-6, D logits 1.8e-6 and their input gradient
# 1e-6. The bound leaves 9x or more.
RTOL_NET = 2e-5
# bf16 convs: each of 13 layers rounds its output to bf16 (2^-9 relative) on
# either side, in other places; measured 5.0e-3 (LPIPS) and 5.8e-3 (D
# logits) relative to the largest value; the bound leaves 5x
RTOL_NET_BF16 = 3e-2


def _images(seed, b=2):
    return np.random.RandomState(seed).uniform(-1, 1, (b, RES, RES, 3)).astype(np.float32)


def _lpips_pair(dtype=torch.float32, jdtype=jnp.float32, seed=0):
    x0 = jnp.zeros((1, RES, RES, 3))
    jmodel = JaxLPIPS(dtype=jdtype)
    params = randomize_params(jmodel.init(jax.random.PRNGKey(seed), x0, x0)["params"], seed)
    port = LPIPS(dtype)
    port.load_state_dict(jax_lpips_params_to_state_dict(params), strict=True)
    return jmodel, params, port


def _disc_pair(dtype=torch.float32, jdtype=jnp.float32, seed=0):
    x0 = jnp.zeros((1, RES, RES, 3))
    jmodel = JaxDisc(dtype=jdtype)
    params = randomize_params(jmodel.init(jax.random.PRNGKey(seed), x0)["params"], seed)
    port = PatchDiscriminator(dtype)
    port.load_state_dict(jax_disc_params_to_state_dict(params), strict=True)
    return jmodel, params, port


def _close(got, ref, rtol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def test_vgg_taps_match_jax():
    jmodel = JaxVGG()
    x = _images(1)
    params = randomize_params(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 0)
    ref = jmodel.apply({"params": params}, jnp.asarray(x))
    lp = {"vgg": params, **{f"lin_{k}": np.ones(c, np.float32)
                            for k, c in enumerate((64, 128, 256, 512, 512))}}
    port = LPIPS()
    port.load_state_dict(jax_lpips_params_to_state_dict(lp), strict=True)
    with torch.no_grad():
        taps = port.net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(t.shape[1:]) for t in taps] == [
        (64, 32, 32), (128, 16, 16), (256, 8, 8), (512, 4, 4), (512, 2, 2)]
    for got, r in zip(taps, ref):
        assert got.is_contiguous(memory_format=torch.channels_last)
        _close(got.permute(0, 2, 3, 1).numpy(), r, RTOL_NET)


def test_lpips_and_its_input_gradient_match_jax():
    jmodel, params, port = _lpips_pair()
    x, y = _images(2), _images(3)
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    ref_grad = jax.grad(
        lambda a: jmodel.apply({"params": params}, a, jnp.asarray(y)).mean()
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, torch.from_numpy(y))
    assert got.shape == (2, 1)
    got.mean().backward()
    _close(got.detach().numpy(), ref, RTOL_NET)
    _close(xt.grad.numpy(), ref_grad, RTOL_NET)
    assert all(not p.requires_grad for p in port.parameters())
    assert all(p.grad is None for p in port.parameters())


def test_lpips_target_pass_builds_no_graph():
    """The target's VGG pass runs under no_grad: its taps carry no grad_fn
    even when the target requires grad."""
    _, _, port = _lpips_pair()
    seen = []
    hook = port.net.slice5.register_forward_hook(lambda m, i, o: seen.append(o.grad_fn))
    port(torch.from_numpy(_images(2)).requires_grad_(),
         torch.from_numpy(_images(3)).requires_grad_())
    hook.remove()
    assert seen[0] is not None and seen[1] is None


def test_lpips_heads_start_at_one_over_c():
    port = LPIPS()
    for k, c in enumerate((64, 128, 256, 512, 512)):
        w = getattr(port, f"lin{k}").model[1].weight
        assert tuple(w.shape) == (1, c, 1, 1)
        torch.testing.assert_close(w, torch.full_like(w, 1.0 / c))


def test_patch_discriminator_matches_jax():
    jmodel, params, port = _disc_pair()
    x = _images(4)
    ref = jmodel.apply({"params": params}, jnp.asarray(x))
    ref_grad = jax.grad(lambda a: jmodel.apply({"params": params}, a).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    assert got.shape == (2, 4) and got.dtype == torch.float32
    got.sum().backward()
    _close(got.detach().numpy(), ref, RTOL_NET)
    _close(xt.grad.numpy(), ref_grad, RTOL_NET)


@pytest.mark.parametrize("which", ["lpips", "disc"])
def test_bf16_convs_match_jax(which):
    x, y = _images(5), _images(6)
    if which == "lpips":
        jmodel, params, port = _lpips_pair(torch.bfloat16, jnp.bfloat16, seed=1)
        ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(y))
    else:
        jmodel, params, port = _disc_pair(torch.bfloat16, jnp.bfloat16, seed=1)
        ref = jmodel.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, RTOL_NET_BF16)


def test_discriminator_init_zero_final_heads():
    disc = PatchDiscriminator()
    init_discriminator_(disc, torch.Generator().manual_seed(0))
    sd = disc.state_dict()
    for key in ("binary_classifier1.2", "binary_classifier2.2", "binary_classifier3.2",
                "binary_classifier4.0", "binary_classifier5.0"):
        assert bool((sd[f"{key}.weight"] == 0).all())
        bound = sd[f"{key}.weight"][0].numel() ** -0.5
        b = sd[f"{key}.bias"]
        assert bool((b.abs() <= bound).all()) and bool((b != 0).all())
    w = sd["binary_classifier1.0.weight"]
    assert bool((w != 0).all()) and float(w.abs().max()) <= (64 * 16) ** -0.5
    assert bool((sd["slice1.0.0.bias"] == 0).all())
    with torch.no_grad():
        logits = disc(torch.from_numpy(_images(7)))
    # zero final heads: the logits are the sum of the head biases
    expect = sum(float(sd[f"{k}.bias"]) for k in (
        "binary_classifier1.2", "binary_classifier2.2", "binary_classifier3.2",
        "binary_classifier4.0", "binary_classifier5.0"))
    torch.testing.assert_close(logits, torch.full_like(logits, expect))


@pytest.mark.parametrize("disc_type", ["bce", "hinge"])
def test_gan_losses_match_jax(disc_type):
    rng = np.random.RandomState(8)
    real, fake = rng.randn(4, 16).astype(np.float32), rng.randn(4, 16).astype(np.float32)
    anchors = (np.float32(0.3), np.float32(-0.2))
    loss, m = gan.gan_disc_loss(torch.from_numpy(real), torch.from_numpy(fake), disc_type)
    jloss, jm = jgan.gan_disc_loss(jnp.asarray(real), jnp.asarray(fake), disc_type)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in ("avg_real_logits", "avg_fake_logits", "disc_acc"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    np.testing.assert_allclose(
        float(gan.generator_gan_loss(torch.from_numpy(fake), disc_type)),
        float(jgan.generator_gan_loss(jnp.asarray(fake), disc_type)), rtol=1e-6)
    new = gan.update_lecam_anchors(torch.tensor(anchors[0]), torch.tensor(anchors[1]),
                                   m["avg_real_logits"], m["avg_fake_logits"], 0.9)
    jnew = jgan.update_lecam_anchors(*anchors, jm["avg_real_logits"],
                                     jm["avg_fake_logits"], 0.9)
    np.testing.assert_allclose([float(v) for v in new], [float(v) for v in jnew], rtol=1e-6)
    np.testing.assert_allclose(
        float(gan.lecam_penalty(torch.from_numpy(real), torch.from_numpy(fake), *new)),
        float(jgan.lecam_penalty(jnp.asarray(real), jnp.asarray(fake), *jnew)), rtol=1e-6)
    np.testing.assert_allclose(
        float(gan.disc_accuracy(torch.from_numpy(real), torch.from_numpy(fake))),
        float(jgan.disc_accuracy(jnp.asarray(real), jnp.asarray(fake))), rtol=0)
    with pytest.raises(ValueError, match="disc_type"):
        gan.gan_disc_loss(torch.from_numpy(real), torch.from_numpy(fake), "wgan")


@pytest.mark.parametrize("recon_weight", [0.0, 0.5])
def test_vae_loss_function_matches_jax(recon_weight):
    rng = np.random.RandomState(9)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    xr = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = (2 * rng.randn(2, 4, 4, 8)).astype(np.float32)
    loss, m = vae_loss_function(torch.from_numpy(x), torch.from_numpy(xr),
                                torch.from_numpy(z), True, recon_weight, 0.1)
    jloss, jm = jax_vae_loss(jnp.asarray(x), jnp.asarray(xr), jnp.asarray(z), True,
                             recon_weight, 0.1)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert set(m) == set(jm)
    for k in jm:  # std_of_abs_z pins the population std
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    if recon_weight:
        assert float(m["recon_loss"]) > 0
        # do_pool=False: the L1 masked by the target's blurriness heatmap
        loss, m = vae_loss_function(torch.from_numpy(x), torch.from_numpy(xr),
                                    torch.from_numpy(z), False, recon_weight, 0.1)
        jloss, jm = jax_vae_loss(jnp.asarray(x), jnp.asarray(xr), jnp.asarray(z), False,
                                 recon_weight, 0.1)
        assert float(m["recon_loss"]) > 0
        np.testing.assert_allclose(float(m["recon_loss"]), float(jm["recon_loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def test_area_downsample_and_resize_area():
    x = np.random.RandomState(10).randn(2, 32, 32, 3).astype(np.float32)
    for f in (2, 4, 16):
        got = area_downsample(torch.from_numpy(x), f).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_area_downsample(jnp.asarray(x), f)),
                                   atol=1e-6)
    xt = torch.from_numpy(x)
    assert resize_area(xt, (32, 32)) is xt
    assert tuple(resize_area(xt, (8, 8)).shape) == (2, 8, 8, 3)
    # not one integer factor: the antialiased linear resize, as JAX's
    # jax.image.resize fallback (tests/test_torch_heatmap.py holds more sizes)
    np.testing.assert_allclose(resize_area(xt, (24, 24)).numpy(),
                               np.asarray(jax_resize_area(jnp.asarray(x), (24, 24))),
                               atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        area_downsample(xt, 5)


@pytest.mark.parametrize("shards", [1, 2], ids=["global", "mean_shard_norm"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gradnorm_backward_matches_jax(shards, dtype):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.RandomState(11)
    x = rng.randn(4, 8, 8, 3).astype(np.float32)
    g = np.array(jnp.asarray(3.0 * rng.randn(4, 8, 8, 3), jdt), np.float32)
    _, vjp = jax.vjp(lambda a: jax_gradnorm(a, 0.5, None, shards), jnp.asarray(x, jdt))
    (ref,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = gradnorm(xt, 0.5, None, shards)
    assert torch.equal(y, xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)
    else:  # the same fp32 value, rounded to bf16 on both sides
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=2.0 ** -8, atol=0)


def test_gradnorm_rejects_axis_name_and_ragged_shards():
    x = torch.zeros(3, 2, requires_grad=True)
    # "data" names the mesh's process group; this process has none
    with pytest.raises(RuntimeError, match="axis_name"):
        gradnorm(x, 1.0, "data")
    with pytest.raises(ValueError, match="divide"):
        gradnorm(x, 1.0, None, 2).sum().backward()


def test_lpips_weights_round_trip_through_the_jax_converter():
    x0 = jnp.zeros((1, RES, RES, 3))
    params = randomize_params(JaxLPIPS().init(jax.random.PRNGKey(3), x0, x0)["params"], 3)
    sd = jax_lpips_params_to_state_dict(params)
    assert "net.slice3.14.weight" in sd and tuple(sd["lin2.model.1.weight"].shape) == (1, 256, 1, 1)
    assert set(sd) == set(LPIPS().state_dict())
    back = convert_torch_lpips(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)


def test_disc_weights_round_trip_through_the_jax_converter():
    x0 = jnp.zeros((1, RES, RES, 3))
    params = randomize_params(JaxDisc().init(jax.random.PRNGKey(4), x0)["params"], 4)
    sd = jax_disc_params_to_state_dict(params)
    assert "slice5.0.28.bias" in sd and "binary_classifier3.2.weight" in sd
    assert set(sd) == set(PatchDiscriminator().state_dict())
    back = convert_torch_patch_discriminator(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)
