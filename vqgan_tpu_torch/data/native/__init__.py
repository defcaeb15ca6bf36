"""The native (C++) host image pipeline: built at first use, bound by ctypes
(counterpart of ``vqgan_tpu/data/native/``).

``decoder.cpp`` decodes a JPEG or PNG with libjpeg or libpng, resizes,
crops and normalizes in one pass without the GIL. It is compiled with
``g++ -O3 -shared -fPIC -std=c++17 ... -ljpeg -lpng`` into
``vqgan_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the command, so an edited source is rebuilt
and a stale library is never loaded; the build goes to a temporary name and
is renamed into place, so concurrent builds never load a half-written file.

This is host code, not a kernel: it only chooses which decoder reads the
images, as the JAX package's loader does. Where the library does not build
or load (no ``g++``, no libjpeg or libpng headers, or no libjpeg or libpng
to load) ``native_available()`` is False, the compiler's first error line
(or the loader's error) is logged once, and the loader keeps the cv2
transforms.

``native_pipeline(data, resize_to, crop_fx, crop_fy, target, as_uint8)``
returns a (target, target, 3) array, float32 in [-1, 1] or uint8, or None
when the library is unavailable or the bytes do not decode;
``native_probe(data)`` returns (width, height) or None.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is unavailable, once a build or load has failed
build_error: Optional[str] = None


def library_path() -> Path:
    """Where ``decoder.cpp`` builds to: the name carries a hash of the source
    and the compiler command."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libvqdec-{digest}.so"


def _first_error_line(text: str) -> str:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    return next((ln for ln in lines if "error" in ln.lower()), lines[0] if lines else "")


def _build(out: Path) -> None:
    """Compile the library to ``out``; raises RuntimeError with the
    compiler's first error line."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), *LIBS, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(_first_error_line(proc.stderr + proc.stdout)
                           or f"g++ exited {proc.returncode}")
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> None:
    """Type every exported symbol."""
    args = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int]
    lib.vq_pipeline.restype = ctypes.c_int
    lib.vq_pipeline.argtypes = args + [ctypes.POINTER(ctypes.c_float)]
    lib.vq_pipeline_u8.restype = ctypes.c_int
    lib.vq_pipeline_u8.argtypes = args + [ctypes.POINTER(ctypes.c_uint8)]
    lib.vq_probe.restype = ctypes.c_int
    lib.vq_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    _bind(lib)
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The library, built on the first call where it is missing; None where
    it does not build or load (the reason in ``build_error``, logged once)."""
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        out = library_path()
        try:
            if not out.is_file():
                _build(out)
            lib = _load(out)
        except (RuntimeError, OSError, AttributeError) as e:
            build_error = str(e)
            logging.getLogger("vqgan_tpu_torch").warning(
                "native image decoder unavailable (%s): %s; the loader decodes with "
                "cv2", SOURCE.name, build_error)
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def native_pipeline(data: bytes, resize_to: int, crop_fx: float, crop_fy: float,
                    target: int, as_uint8: bool = False) -> Optional[np.ndarray]:
    """Decode ``data``; resize the shorter side to ``resize_to`` (0: no
    resize) and to at least ``target``; crop target² at the fractions
    (crop_fx, crop_fy) of the slack; float32 in [-1, 1], or uint8."""
    lib = load_native()
    if lib is None:
        return None
    if as_uint8:
        out = np.empty((target, target, 3), np.uint8)
        rc = lib.vq_pipeline_u8(data, len(data), resize_to, crop_fx, crop_fy, target,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    else:
        out = np.empty((target, target, 3), np.float32)
        rc = lib.vq_pipeline(data, len(data), resize_to, crop_fx, crop_fy, target,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def native_probe(data: bytes) -> Optional[tuple[int, int]]:
    """(width, height) of the decoded image, or None."""
    lib = load_native()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vq_probe(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value
