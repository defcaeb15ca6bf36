"""The conv-tile geometry probe (kernel #7) on the CPU: the JAX tool's eight
cases in interpret mode, the port's case table against the tool, each plain
version against the tool's numpy expectation from the same
``RandomState(0)`` draws, and the binding's CPU path. The CUDA kernels
themselves run in tests/test_torch_cuda.py (marker ``cuda``) and in
``chip_smoke.py`` phase 22.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu_torch.ops import cuda_build
from vqgan_tpu_torch.ops import geometry_probe_cuda as gpc
from vqgan_tpu_torch.ops.geometry_probe import ATOL, CASES, RTOL, SPLITS, make_inputs, split_plain
from vqgan_tpu_torch.tools import probe_conv3d_geometry

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = REPO / "tools" / "probe_mosaic_geometry.py"


def _jax_expectations():
    """The JAX tool's numpy expectations, rebuilt as it builds them
    (tools/probe_mosaic_geometry.py:71-77, 87, 113, 128, 138, 143-158,
    178-205), by case letter."""
    M, K, CO = 256, 64, 64
    rng = np.random.RandomState(0)
    x = rng.randn(M, K).astype(np.float32)
    w3 = rng.randn(K, 3, CO).astype(np.float32)
    x9 = rng.randn(9, M, K).astype(np.float32)
    w9 = rng.randn(9, K, CO).astype(np.float32)
    x2 = rng.randn(2, M, K).astype(np.float32)
    w2 = rng.randn(2 * K, CO).astype(np.float32)
    H, W = 32, 34
    xs = rng.randn(H, W, K).astype(np.float32)
    w2b = rng.randn(2 * K, CO).astype(np.float32)
    bh, Wf, Ci = 32, 128, 64
    xh = rng.randn(bh + 2, Wf + 2, Ci).astype(np.float32)
    wh = rng.randn(9 * Ci, CO).astype(np.float32)
    exp_a = (x @ w3.reshape(K, 3 * CO)).reshape(M, 3, CO).sum(1)
    exp_f = np.concatenate([xs[:, 0:W - 2].reshape(-1, K), xs[:, 2:W].reshape(-1, K)], 1) @ w2b
    xq = np.asarray(jnp.asarray(xh, jnp.bfloat16), np.float32)
    wq = np.asarray(jnp.asarray(wh, jnp.bfloat16), np.float32)
    wins = [xq[dh:dh + bh, dw:dw + Wf, :].reshape(bh * Wf, Ci)
            for dh in range(3) for dw in range(3)]
    return {
        "A": exp_a, "B": exp_a,
        "C": np.einsum("kmi,kio->mo", x9, w9),
        "D": np.concatenate([x2[0].T, x2[1].T], 0).T @ w2,
        "E": np.concatenate([x2[0], x2[1]], 1) @ w2,
        "F": exp_f, "G": exp_f,
        "H": np.concatenate(wins, 1) @ wq,
    }


def test_jax_tool_lowers_every_case_in_interpret_mode():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(JAX_TOOL), "--interpret"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.startswith("  ")]
    assert len(lines) == 8, out.stdout
    for case, line in zip(CASES, lines):
        assert line.startswith(f"{case.name}: LOWERED, numerics OK"), line


def test_case_table_is_the_jax_tools():
    """The same eight cases, in order, with the tool's names and lines; each
    case's inputs in the tool's order of draws and shapes."""
    src = JAX_TOOL.read_text()
    names = re.findall(r'_run\(\s*"([^"]+)"', src)
    assert names == [c.name for c in CASES]
    lines = src.splitlines()
    for case in CASES:
        first, last = (int(v) for v in case.jax_lines.split("-"))
        block = "\n".join(lines[first - 1:last])
        assert f'_run("{case.name}"' in block, case.letter
    inputs = make_inputs()
    assert list(inputs) == ["x", "w3", "x9", "w9", "x2", "w2", "xs", "w2b", "xh", "wh"]
    assert {k: v.shape for k, v in inputs.items()} == {
        "x": (256, 64), "w3": (64, 3, 64), "x9": (9, 256, 64), "w9": (9, 64, 64),
        "x2": (2, 256, 64), "w2": (128, 64), "xs": (32, 34, 64), "w2b": (128, 64),
        "xh": (34, 130, 64), "wh": (576, 64)}
    assert [c.dtype for c in CASES] == ["fp32"] * 7 + ["bf16"]


@pytest.mark.parametrize("case", CASES, ids=[c.letter for c in CASES])
def test_plain_version_matches_the_jax_expectation(case):
    """At the tool's 2e-2, and far inside it: the same fp32 products summed
    in another order (H: exact products of the same bf16 values)."""
    exp = _jax_expectations()[case.letter]
    inputs = make_inputs()
    a, b = (torch.from_numpy(inputs[k]) for k in case.inputs)
    got = case.plain(a, b).numpy()
    assert got.shape == exp.shape == case.out_shape and got.dtype == np.float32
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=[c.letter for c in CASES])
def test_kernel_split_matches_the_plain_version_and_the_jax_expectation(case):
    """The kernel's grid split (``SPLITS``: K over a cluster, partial tiles
    summed in rank order; or output columns) computed in torch, against the
    plain version and the JAX tool's expectation at its 2e-2 and far inside
    it."""
    exp = _jax_expectations()[case.letter]
    inputs = make_inputs()
    a, b = (torch.from_numpy(inputs[k]) for k in case.inputs)
    got = split_plain(case, a, b)
    assert tuple(got.shape) == case.out_shape
    torch.testing.assert_close(got, case.plain(a, b), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-4)


def test_split_table_is_the_kernels():
    """``SPLITS`` states the source's splits: kSplit per case, and which
    split K over a cluster (kClusterK)."""
    src = (cuda_build.CSRC_DIR / "geometry_probe.cu").read_text()
    splits = [int(v) for v in re.search(r"kSplit\[8\] = \{([^}]*)\}", src).group(1).split(",")]
    cluster = [v.strip() == "true"
               for v in re.search(r"kClusterK\[8\] = \{([^}]*)\}", src).group(1).split(",")]
    assert [SPLITS[c.letter][1] for c in CASES] == splits
    assert [SPLITS[c.letter][0] == "k" for c in CASES] == cluster


def test_wrapper_runs_the_plain_version_on_the_cpu_and_counts_nothing():
    inputs = {k: torch.from_numpy(v) for k, v in make_inputs().items()}
    before = gpc.launches
    for case in CASES:
        a, b = (inputs[k] for k in case.inputs)
        torch.testing.assert_close(gpc.probe_case(case, a, b), case.plain(a, b), rtol=0, atol=0)
    assert gpc.launches == before
    with pytest.raises(ValueError, match="case A takes x"):
        gpc.probe_case(CASES[0], inputs["x2"], inputs["w3"])
    with pytest.raises(ValueError, match="float32"):
        gpc.probe_case(CASES[0], inputs["x"].double(), inputs["w3"])


def test_nothing_is_built_at_import_and_the_source_is_hand_written():
    """Importing the binding and the entry point builds nothing; the source
    has one kernel per case, H on bf16 mma.sync m16n8k16, and calls no
    library."""
    assert gpc.library.cache_info().currsize == 0
    assert cuda_build.load_library.cache_info().currsize == 0
    src = (cuda_build.CSRC_DIR / "geometry_probe.cu").read_text()
    assert len(re.findall(r"__global__ void", src)) == 8
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert not re.search(r"cublas|cudnn|#include <torch", src, re.IGNORECASE)


def test_entry_point_needs_a_card():
    """Without CUDA the entry point exits 1 and runs no case."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert probe_conv3d_geometry.main([]) == 1
    with pytest.raises(RuntimeError, match="CUDA device"):
        probe_conv3d_geometry.run_probe()
