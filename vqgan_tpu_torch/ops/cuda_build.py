"""Build a CUDA source of ``vqgan_tpu_torch/csrc/`` into a shared library at
first use and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds. The library lands in ``vqgan_tpu_torch/_build/``
(listed in ``.gitignore``) under a name that carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built when a module is imported: the CPU-only test machines import
every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    the one on PATH. Raises if there is none."""
    home = Path(os.environ.get("CUDA_HOME") or DEFAULT_CUDA_HOME)
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME or /usr/local/cuda, and on "
            "PATH): the CUDA kernels of vqgan_tpu_torch cannot be built"
        )
    return found


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to with the extra ``-D`` flags
    ``defines``: the name carries a hash of the source text, of every shared
    header (``csrc/*.cuh``, which a source may include) and of the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.name.encode() + p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + defines)
    digest = hashlib.sha256(src + headers + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@functools.cache
def load_library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (with the extra ``-D`` flags ``defines``) if
    its library is missing, then load it.

    The compiler's output (``-Xptxas -v``: registers, shared memory and spills
    of every kernel) is kept beside the library as ``<library>.log``.
    """
    out = library_path(name, defines)
    if not out.is_file():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename, so a concurrent or cut-off
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        Path(f"{out}.log").write_text(
            f"{' '.join(cmd)}\nbuild seconds: {seconds:.3f}\n"
            f"{proc.stdout}{proc.stderr}"
        )
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


@functools.cache
def num_sms(device_index: int) -> int:
    """The streaming multiprocessors of a CUDA device."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count
