"""The conv-tile geometry probe's kernels: the binding of ``csrc/geometry_probe.cu``
(kernel #7, the counterpart of the Pallas probe
``tools/probe_mosaic_geometry.py::_run``).

``probe_case(case, a, b)`` computes one case of ``ops/geometry_probe.CASES``
on its two fp32 inputs: a CUDA tensor launches the case's hand-written
kernel (built by ``nvcc`` for ``sm_90a`` at first use, bound with ctypes)
and counts it in ``launches``, or raises; a CPU tensor runs the case's plain
version. There is no fallback between the two.

``attributes(case)`` reads the case kernel's registers, local memory (spills
and local arrays) and shared memory with ``cudaFuncGetAttributes``.
``build_case_alone(case)`` builds a library with only that case
(``-DGEOMETRY_PROBE_CASE``), so that when the whole source is rejected the
probe can say which geometries ptxas refuses.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vqgan_tpu_torch.ops.cuda_build import load_library
from vqgan_tpu_torch.ops.geometry_probe import CASES, INPUT_SHAPES, Case

# Kernel launches since the count was last set to 0: one per probe_case
# call on CUDA tensors; calls on CPU tensors do not count.
launches = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.geometry_probe_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.geometry_probe_run.restype = ctypes.c_int
    lib.geometry_probe_attributes.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.geometry_probe_attributes.restype = ctypes.c_int
    lib.geometry_probe_error_string.argtypes = [ctypes.c_int]
    lib.geometry_probe_error_string.restype = ctypes.c_char_p
    lib.geometry_probe_setup.argtypes = []
    lib.geometry_probe_setup.restype = ctypes.c_int
    lib.geometry_probe_grid.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.geometry_probe_grid.restype = ctypes.c_int
    err = lib.geometry_probe_setup()  # once, not in every launch
    if err:
        raise RuntimeError(f"geometry probe setup failed: "
                           f"{lib.geometry_probe_error_string(err).decode()}")
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The library of all eight cases (built on the first call)."""
    return _bind(load_library("geometry_probe"))


def build_case_alone(case: Case) -> ctypes.CDLL:
    """A library with only ``case``'s kernel; raises with nvcc's and ptxas's
    messages if that geometry does not build."""
    return _bind(load_library("geometry_probe",
                              (f"-DGEOMETRY_PROBE_CASE={CASES.index(case)}",)))


def _check(case: Case, a: torch.Tensor, b: torch.Tensor) -> None:
    for t, key in zip((a, b), case.inputs):
        if tuple(t.shape) != INPUT_SHAPES[key] or t.dtype != torch.float32:
            raise ValueError(f"case {case.letter} takes {key} of shape {INPUT_SHAPES[key]} "
                             f"in float32, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"case {case.letter} needs contiguous inputs")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inputs on {a.device} and {b.device}: both on cpu or one cuda device")


def probe_case(case: Case, a: torch.Tensor, b: torch.Tensor,
               lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """``case``'s function of (a, b), fp32. CUDA tensors launch its kernel
    from ``lib`` (default: the library of all cases) and count it in
    ``launches``; CPU tensors run its plain version."""
    global launches
    _check(case, a, b)
    if a.device.type == "cpu":
        return case.plain(a, b)
    lib = library() if lib is None else lib
    out = torch.empty(case.out_shape, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.geometry_probe_run(CASES.index(case), a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"geometry probe case {case.letter} launch failed: "
                           f"{lib.geometry_probe_error_string(err).decode()}")
    launches += 1
    return out


def attributes(case: Case, lib: ctypes.CDLL | None = None) -> dict[str, int]:
    """``cudaFuncGetAttributes`` of ``case``'s kernel: ``num_regs`` per
    thread, ``local_bytes`` per thread, ``shared_bytes`` per block (static
    and the dynamic amount its launch asks for)."""
    lib = library() if lib is None else lib
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = lib.geometry_probe_attributes(CASES.index(case), *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes of case {case.letter} failed: "
                           f"{lib.geometry_probe_error_string(err).decode()}")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes"), (v.value for v in vals)))


def grid(case: Case, lib: ctypes.CDLL | None = None) -> tuple[int, int]:
    """(blocks, blocks of a cluster) of ``case``'s launch; a cluster of 1 is
    none."""
    lib = library() if lib is None else lib
    vals = [ctypes.c_int(0) for _ in range(2)]
    err = lib.geometry_probe_grid(CASES.index(case), *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"geometry_probe_grid of case {case.letter} failed: "
                           f"{lib.geometry_probe_error_string(err).decode()}")
    return vals[0].value, vals[1].value
