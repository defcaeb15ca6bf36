"""The port's blurriness heatmap (``ops/heatmap.py``) and the non-integer
branch of ``resize_area`` (``ops/resize.py``) against the JAX package's, on
the CPU.

The heatmap's mask to 1e-5, where a position whose normalized blur puts 1 −
it within 1e-4 of the 0.8 threshold is left out (the two sides' convs sum in
other orders, so such a position may fall on either side) and counted; the
resize to 1e-5 of the largest entry, downsampling and upsampling, square and
not, at odd sizes, against ``jax.image.resize(..., "linear")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.ops.heatmap import _gaussian_kernel_1d as jax_gaussian_kernel_1d
from vqgan_tpu.ops.heatmap import blurriness_heatmap as jax_heatmap
from vqgan_tpu.ops.resize import resize_area as jax_resize_area
from vqgan_tpu_torch.ops.heatmap import (
    THRESHOLD,
    blurriness_heatmap,
    gaussian_kernel_1d,
    normalized_blur,
)
from vqgan_tpu_torch.ops.resize import linear_weight_matrix, resize_area

NEAR_THRESHOLD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread: beside the other test workers, a
    tiny model's ops spend far longer waiting for threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, shape):
    """Smooth gradients with noise in [-1, 1]: edges of every strength, so
    the mask has zeros, values near 1 and a band between."""
    rng = np.random.RandomState(seed)
    b, h, w, _ = shape
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.sin(6 * xx + 4 * yy)[None, :, :, None]
    img = base * rng.uniform(0.2, 1.0, (b, 1, 1, 3)) + 0.3 * rng.randn(*shape)
    return np.clip(img, -1, 1).astype(np.float32)


def test_gaussian_tap_matches_jax():
    np.testing.assert_array_equal(gaussian_kernel_1d(), jax_gaussian_kernel_1d())


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (3, 24, 40, 3)])
def test_heatmap_matches_jax(shape):
    x = _images(shape[1], shape)
    ref = np.asarray(jax_heatmap(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = blurriness_heatmap(xt).numpy()
    assert got.shape == ref.shape == shape and got.dtype == np.float32
    inverted = 1.0 - normalized_blur(xt).permute(0, 2, 3, 1).expand(*shape).numpy()
    near = np.abs(inverted - THRESHOLD) < NEAR_THRESHOLD
    assert near.sum() <= 0.001 * near.size, near.sum()
    np.testing.assert_allclose(got[~near], ref[~near], atol=1e-5)
    # the threshold zeroes part of the mask, and keeps part of it
    assert 0.05 < (ref == 0).mean() < 0.95
    assert ((got == 0) | (got >= THRESHOLD)).all()


def test_heatmap_takes_no_gradient_and_keeps_the_dtype():
    x = torch.from_numpy(_images(0, (1, 16, 16, 3))).requires_grad_(True)
    mask = blurriness_heatmap(x)
    assert not mask.requires_grad
    assert blurriness_heatmap(x.detach().bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("size,to", [
    ((48, 48), (32, 32)),   # the encoder's resize at image_size 48, resolution 32
    ((48, 48), (64, 64)),   # the HR target's
    ((96, 96), (64, 64)),
    ((37, 51), (20, 64)),   # down in H, up in W
    ((33, 17), (50, 9)),
    ((48, 40), (32, 32)),
])
def test_resize_area_non_integer_matches_jax(size, to):
    x = np.random.RandomState(sum(size)).randn(2, *size, 3).astype(np.float32)
    ref = np.asarray(jax_resize_area(jnp.asarray(x), to))
    got = resize_area(torch.from_numpy(x), to).numpy()
    assert got.shape == ref.shape == (2, *to, 3)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_linear_weights_widen_when_downsampling():
    """Each output's weights sum to 1; downsampling 48 → 32 spreads each
    over the triangle widened by 1.5 (3 inputs, where a plain linear resize
    takes 2), upsampling 48 → 64 over 2."""
    down, up = linear_weight_matrix(48, 32), linear_weight_matrix(48, 64)
    np.testing.assert_allclose(down.sum(0), 1.0, rtol=1e-6)
    np.testing.assert_allclose(up.sum(0), 1.0, rtol=1e-6)
    assert (down > 0).sum(0).max() == 3 and (up > 0).sum(0).max() == 2

