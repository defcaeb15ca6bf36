"""The port's native image decoder (``vqgan_tpu_torch/data/native``: its own
copy of ``decoder.cpp``, built into ``vqgan_tpu_torch/_build/``) against the
JAX package's library, on the CPU: ``native_pipeline`` (float32 and uint8)
and ``native_probe`` on PNG (RGB, gray, RGBA) and JPEG bytes, bit for bit,
at no resize, a downscale (area) and an upscale (bilinear); garbage bytes;
``make_native_train_transform`` against the JAX one from the same seed and
with per-call rngs, its cv2 fallback included; the 2D loader's choice; and
a failed build, which logs the compiler's first error line once, and a
library that does not load, which is reported the same way.

The tests skip only where the library does not build here (no ``g++``, or
no libjpeg or libpng headers); the skip reason carries the compiler's
error."""

import logging

import cv2
import numpy as np
import pytest

from vqgan_tpu.data import native as jax_native
from vqgan_tpu.data import transforms as jax_transforms
from vqgan_tpu_torch.data import native, transforms


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.native_available():
        pytest.skip(f"the native decoder does not build here: {native.build_error}")
    if not jax_native.native_available():
        pytest.skip("the JAX package's native decoder does not build here")


def _images():
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    smooth = cv2.GaussianBlur(rgb, (5, 5), 2)
    out = {}
    out["png_rgb"] = cv2.imencode(".png", rgb[..., ::-1])[1].tobytes()
    out["png_gray"] = cv2.imencode(".png", rgb[..., 0])[1].tobytes()
    rgba = np.concatenate([rgb, rng.randint(0, 256, (37, 53, 1)).astype(np.uint8)], -1)
    out["png_rgba"] = cv2.imencode(".png", rgba)[1].tobytes()
    out["jpeg"] = cv2.imencode(".jpg", smooth[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])[1] \
        .tobytes()
    return rgb, out


@pytest.mark.parametrize("kind", ["png_rgb", "png_gray", "png_rgba", "jpeg"])
@pytest.mark.parametrize("resize_to, target", [(0, 32), (24, 20), (80, 64), (0, 48)])
@pytest.mark.parametrize("as_uint8", [False, True])
def test_pipeline_matches_jax(kind, resize_to, target, as_uint8):
    _, images = _images()
    data = images[kind]
    for fx, fy in ((0.0, 0.0), (0.37, 0.91), (0.999, 0.5)):
        ours = native.native_pipeline(data, resize_to, fx, fy, target, as_uint8=as_uint8)
        theirs = jax_native.native_pipeline(data, resize_to, fx, fy, target,
                                            as_uint8=as_uint8)
        assert ours.shape == (target, target, 3)
        assert ours.dtype == (np.uint8 if as_uint8 else np.float32)
        np.testing.assert_array_equal(ours, theirs)
    assert native.native_probe(data) == jax_native.native_probe(data) == (53, 37)


def test_png_is_the_crop_of_its_decode():
    """No resize: the uint8 output is the crop of the decoded pixels and the
    float output their fp32 normalization (x · (1/127.5) − 1)."""
    rgb, images = _images()
    ours = native.native_pipeline(images["png_rgb"], 0, 0.5, 0.25, 32, as_uint8=True)
    ox, oy = int(0.5 * (53 - 32 + 1)), int(0.25 * (37 - 32 + 1))
    crop = rgb[oy: oy + 32, ox: ox + 32]
    np.testing.assert_array_equal(ours, crop)
    flt = native.native_pipeline(images["png_rgb"], 0, 0.5, 0.25, 32)
    np.testing.assert_array_equal(flt, crop.astype(np.float32) * np.float32(1 / 127.5)
                                  - np.float32(1))


def test_garbage_gives_none():
    for data in (b"", b"garbage bytes", b"\xff\xd8\xff\x00broken jpeg", b"\x89PNG\r\n\x1a\n"):
        assert native.native_pipeline(data, 0, 0.0, 0.0, 8) is None
        assert native.native_probe(data) is None
        assert jax_native.native_probe(data) is None


@pytest.mark.parametrize("as_uint8", [False, True])
def test_native_train_transform_matches_jax(as_uint8):
    """The shared rng draw after draw (the crop-or-resize coin, the two crop
    fractions), a per-call rng, and bytes the library cannot decode (BMP),
    which go through cv2 and the seed + 1 fallback transform."""
    _, images = _images()
    rgb = np.random.RandomState(3).randint(0, 256, (40, 44, 3)).astype(np.uint8)
    bmp = cv2.imencode(".bmp", rgb[..., ::-1])[1].tobytes()
    ours = transforms.make_native_train_transform(32, seed=4, as_uint8=as_uint8)
    theirs = jax_transforms.make_native_train_transform(32, seed=4, as_uint8=as_uint8)
    assert ours.wants_bytes and ours.accepts_rng and ours.decoder_name == "native"
    for data in [images["jpeg"], images["png_rgb"], bmp] * 3:
        np.testing.assert_array_equal(ours(data), theirs(data))
    for seed in range(3):
        np.testing.assert_array_equal(ours(bmp, rng=np.random.default_rng(seed)),
                                      theirs(bmp, rng=np.random.default_rng(seed)))
        np.testing.assert_array_equal(ours(images["jpeg"], rng=np.random.default_rng(seed)),
                                      theirs(images["jpeg"], rng=np.random.default_rng(seed)))
    with pytest.raises(ValueError, match="undecodable"):
        ours(b"garbage bytes")


def test_failed_build_is_logged_once(tmp_path, monkeypatch, caplog):
    """A source that does not compile: ``native_available()`` is False, the
    compiler's first error line is in ``build_error`` and logged once, and
    nothing lands under the final library name."""
    bad = tmp_path / "decoder.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)
    with caplog.at_level(logging.WARNING, logger="vqgan_tpu_torch"):
        assert not native.native_available()
        assert not native.native_available()
        assert native.native_pipeline(b"x", 0, 0.0, 0.0, 8) is None
    assert "error" in native.build_error and "decoder.cpp" in native.build_error
    warnings = [r for r in caplog.records if "native image decoder unavailable" in r.message]
    assert len(warnings) == 1 and native.build_error in warnings[0].message
    assert not native.library_path().exists()
    assert list((tmp_path / "build").iterdir()) == []


def test_a_library_that_does_not_load_is_reported(tmp_path, monkeypatch, caplog):
    """A file under the library's name that does not load is not built
    over: ``native_available()`` is False, the loader's error is in
    ``build_error`` and logged once, and the file is left as it was."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)
    native.library_path().write_bytes(b"not a shared library")
    with caplog.at_level(logging.WARNING, logger="vqgan_tpu_torch"):
        assert not native.native_available()
        assert not native.native_available()
    assert native.library_path().name in native.build_error
    warnings = [r for r in caplog.records if "native image decoder unavailable" in r.message]
    assert len(warnings) == 1
    assert native.library_path().read_bytes() == b"not a shared library"
