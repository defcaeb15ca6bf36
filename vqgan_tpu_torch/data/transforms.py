"""Host-side image transforms matching the reference's torchvision pipelines
(vae_trainer.py:93-116), on numpy and cv2 (a copy of
``vqgan_tpu/data/transforms.py``), and the train path through the C++
decode-and-transform pipeline (``data/native``).

Train path (this_transform_random_crop_resize): normalize to [-1,1]; with
p=0.5 random-crop directly at `width`, else resize-shorter-side-to-width then
random-crop. Eval path (this_transform): normalize, center-crop 512, resize
to width. The resizes are cv2's (INTER_AREA down, INTER_LINEAR up); making a
transform without cv2 raises at once.
"""

from __future__ import annotations

import numpy as np

from vqgan_tpu_torch.data.native import native_pipeline
from vqgan_tpu_torch.data.tar_stream import _decode_image


def require_cv2():
    """cv2, or an ImportError that names it: the transforms' resizes are
    cv2's, so a transform is not built without it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "the image transforms resize with cv2, which does not import here "
            "(install opencv-python, or train on --synthetic_data true)") from e
    return cv2


def _to_float(img: np.ndarray) -> np.ndarray:
    """HWC uint8 [0,255] → float32 [-1,1] (ToTensor + Normalize ±0.5)."""
    return img.astype(np.float32) / 127.5 - 1.0


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """Resize shorter side to ``size`` (torchvision Resize semantics)."""
    cv2 = require_cv2()
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    interp = cv2.INTER_AREA if nh < h else cv2.INTER_LINEAR
    return cv2.resize(img, (nw, nh), interpolation=interp)


def _resize_exact(img: np.ndarray, size: int) -> np.ndarray:
    cv2 = require_cv2()
    h = img.shape[0]
    interp = cv2.INTER_AREA if size < h else cv2.INTER_LINEAR
    return cv2.resize(img, (size, size), interpolation=interp)


def _random_crop(img: np.ndarray, size: int, rng: np.random.Generator):
    h, w = img.shape[:2]
    if h < size or w < size:
        img = _resize(img, size)
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top: top + size, left: left + size]


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < size or w < size:
        img = _resize(img, size)
        h, w = img.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[top: top + size, left: left + size]


def make_train_transform(width: int = 512, seed: int = 0, as_uint8: bool = False):
    """p=0.5: RandomCrop(width) directly; else Resize(width)+RandomCrop
    (vae_trainer.py:105-116). ``as_uint8`` keeps the output uint8 HWC: the
    train and eval steps normalize a uint8 batch on the device.

    The optional per-call ``rng`` makes one sample's augmentation a pure
    function of that rng (indexed mode passes a position-derived generator;
    draws from the shared closure rng depend on thread scheduling)."""
    require_cv2()
    shared_rng = np.random.default_rng(seed)

    def transform(img: np.ndarray, rng=None) -> np.ndarray:
        rng = shared_rng if rng is None else rng
        if rng.random() < 0.5:
            out = _random_crop(img, width, rng)
        else:
            out = _random_crop(_resize(img, width), width, rng)
        out = np.ascontiguousarray(out)
        return out if as_uint8 else _to_float(out)

    transform.accepts_rng = True
    return transform


def make_native_train_transform(width: int = 512, seed: int = 0, as_uint8: bool = False):
    """The train path on bytes, through the C++ decode + resize + crop +
    normalize pipeline (``data/native``). The randomness stays here: the
    p=0.5 crop-or-resize branch and the fractional crop offsets
    (vae_trainer.py:105-116). Bytes the library cannot decode go through the
    cv2 decode and ``make_train_transform`` (seeded ``seed + 1``), as in the
    JAX package.

    The returned callable has ``wants_bytes = True``, so the readers hand it
    the member's bytes, and ``decoder_name = "native"``, which they log."""
    shared_rng = np.random.default_rng(seed)
    fallback = make_train_transform(width, seed + 1, as_uint8=as_uint8)

    def transform(data: bytes, rng=None) -> np.ndarray:
        r = shared_rng if rng is None else rng
        resize_to = 0 if r.random() < 0.5 else width
        out = native_pipeline(data, resize_to, float(r.random()), float(r.random()), width,
                              as_uint8=as_uint8)
        if out is None:
            img = _decode_image(data)
            if img is None:
                raise ValueError("undecodable image")
            return fallback(img, rng=rng)
        return out

    transform.wants_bytes = True
    transform.accepts_rng = True
    transform.decoder_name = "native"
    return transform


def make_eval_transform(width: int = 512, as_uint8: bool = False):
    """CenterCrop(512) → Resize(width) (vae_trainer.py:95-102)."""
    require_cv2()

    def transform(img: np.ndarray) -> np.ndarray:
        out = np.ascontiguousarray(_resize_exact(_center_crop(img, 512), width))
        return out if as_uint8 else _to_float(out)

    return transform
