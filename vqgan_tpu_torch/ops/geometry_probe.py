"""The conv-tile geometry probe's cases and their plain PyTorch versions
(counterpart of ``tools/probe_mosaic_geometry.py``).

The JAX tool compile-tests eight dot geometries (A-H) of a fat conv tile in
a minimal ``pallas_call`` on the TPU, each at its shapes, and holds each
against numpy at rtol = atol = 2e-2. The port asks the same question of an
H100: ``csrc/geometry_probe.cu`` computes each case's function by hand in
the Hopper geometry the table names, and ``ops/geometry_probe_cuda.py``
binds it. Every case here computes exactly the JAX case's function on the
JAX case's shapes, from inputs drawn in the JAX tool's order from
``np.random.RandomState(0)``. A-G are fp32 products (the JAX cases'
``Precision.HIGHEST``); H casts its fp32 inputs to bf16 and sums the exact
products in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

M, K, CO = 256, 64, 64
STRIP_H, STRIP_W = 32, 34  # F, G: a padded (H, W, K) strip; output width W - 2
BH, WF, CI = 32, 128, 64  # H: a (BH + 2, WF + 2, CI) halo strip, 9 windows
RTOL = ATOL = 2e-2  # the JAX tool's np.allclose bounds


# every case's inputs, in the JAX tool's order of draws
# (tools/probe_mosaic_geometry.py:71-77, 145-146, 180-181)
INPUT_SHAPES = {
    "x": (M, K), "w3": (K, 3, CO), "x9": (9, M, K), "w9": (9, K, CO), "x2": (2, M, K),
    "w2": (2 * K, CO), "xs": (STRIP_H, STRIP_W, K), "w2b": (2 * K, CO),
    "xh": (BH + 2, WF + 2, CI), "wh": (9 * CI, CO),
}


# How csrc/geometry_probe.cu spreads each case over its grid: ("k", s) splits
# K over the s blocks of a cluster, each block keeping its tile for its K
# range, and sums the s partial tiles in rank order; ("n", s) gives each
# block a 1/s of the output columns. The tiles per case are the output rows
# (A-E), the strip rows (F, G) or the output rows of the strip (H).
SPLITS = {"A": ("k", 4), "B": ("k", 4), "C": ("k", 9), "D": ("n", 4), "E": ("n", 4),
          "F": ("n", 4), "G": ("n", 8), "H": ("k", 4)}


def make_inputs(seed: int = 0) -> dict[str, np.ndarray]:
    """Every case's inputs, fp32, drawn as the JAX tool draws them."""
    rng = np.random.RandomState(seed)
    return {name: rng.randn(*shape).astype(np.float32) for name, shape in INPUT_SHAPES.items()}


def _fat_n(x, w3):
    """A: the (M, K) @ (K, 3·CO) product, then its three CO-column slices
    summed."""
    res = x @ w3.reshape(K, 3 * CO)
    return res[:, :CO] + res[:, CO:2 * CO] + res[:, 2 * CO:]


def _rank3(x, w3):
    """B: a rank-3 rhs contraction → (M, 3, CO), summed over the middle."""
    res = torch.tensordot(x, w3, dims=([1], [0]))
    return res[:, 0] + res[:, 1] + res[:, 2]


def _multi_contraction(x9, w9):
    """C: nine (M, K) @ (K, CO) products summed, "kmi,kio->mo"."""
    return torch.einsum("kmi,kio->mo", x9, w9)


def _sublane_concat(x2, w2):
    """D: both slabs transposed, stacked to (2K, M) and contracted on dim 0."""
    return torch.cat([x2[0].T, x2[1].T], 0).T @ w2


def _lane_concat(x2, w2):
    """E: both slabs side by side, (M, 2K) @ (2K, CO)."""
    return torch.cat([x2[0], x2[1]], 1) @ w2


def _shifted_windows(xs, w2b):
    """F and G: two windows of the strip two columns apart, side by side,
    (H·(W − 2), 2K) @ (2K, CO)."""
    a = xs[:, :STRIP_W - 2].reshape(-1, K)
    b = xs[:, 2:].reshape(-1, K)
    return torch.cat([a, b], 1) @ w2b


def _im2col_bf16(xh, wh):
    """H: the 9 windows (dh, dw) of the bf16 strip side by side, dh-major,
    (BH·WF, 9·CI) @ (9·CI, CO) of the bf16 weight; exact products, fp32
    sums."""
    xq = xh.to(torch.bfloat16).float()
    wq = wh.to(torch.bfloat16).float()
    wins = [xq[dh:dh + BH, dw:dw + WF].reshape(BH * WF, CI)
            for dh in range(3) for dw in range(3)]
    return torch.cat(wins, 1) @ wq


@dataclasses.dataclass(frozen=True)
class Case:
    """One geometry: its letter, the JAX tool's label and lines, its two
    inputs (keys of ``make_inputs``), the output shape, the Hopper geometry
    of its kernel, the plain version, the products' flops and their type."""

    letter: str
    label: str
    jax_lines: str
    inputs: tuple[str, str]
    out_shape: tuple[int, int]
    geometry: str
    plain: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    flops: int
    dtype: str  # "fp32" or "bf16": the operands of the products

    @property
    def name(self) -> str:
        return f"{self.letter} {self.label}"


CASES = (
    Case("A", "fat-N flat + 64-lane slices", "81-89", ("x", "w3"), (M, CO),
         "one N=192 tile per block; the three slices summed in registers",
         _fat_n, 2 * M * K * 3 * CO, "fp32"),
    Case("B", "rank-3 rhs dot_general", "91-102", ("x", "w3"), (M, CO),
         "three N=64 passes that reuse one loaded A value", _rank3, 2 * M * K * 3 * CO, "fp32"),
    Case("C", "multi-contraction fat-K", "104-115", ("x9", "w9"), (M, CO),
         "nine K=64 chunks into one accumulator", _multi_contraction, 2 * 9 * M * K * CO, "fp32"),
    Case("D", "sublane-concat transposed fat-K", "117-130", ("x2", "w2"), (M, CO),
         "the K=128 A tile staged K-major (transposed) in shared memory", _sublane_concat,
         2 * M * 2 * K * CO, "fp32"),
    Case("E", "lane-concat fat-K (control)", "132-140", ("x2", "w2"), (M, CO),
         "the K=128 A tile staged row-major, the two slabs side by side", _lane_concat,
         2 * M * 2 * K * CO, "fp32"),
    Case("F", "shifted-slice lane-concat (r4 failure repro)", "142-159", ("xs", "w2b"),
         (STRIP_H * (STRIP_W - 2), CO),
         "implicit im2col: both windows read in place from one shared-memory strip",
         _shifted_windows, 2 * STRIP_H * (STRIP_W - 2) * 2 * K * CO, "fp32"),
    Case("G", "shifted-slice lane-concat + copy normalize", "161-174", ("xs", "w2b"),
         (STRIP_H * (STRIP_W - 2), CO),
         "each window copied to its own shared-memory tile before the product",
         _shifted_windows, 2 * STRIP_H * (STRIP_W - 2) * 2 * K * CO, "fp32"),
    Case("H", "full im2col 9-window bf16 (kernel geometry)", "176-206", ("xh", "wh"),
         (BH * WF, CO),
         "bf16 mma.sync m16n8k16, fp32 accumulation, implicit im2col over the 9 windows "
         "of a halo strip in shared memory", _im2col_bf16, 2 * BH * WF * 9 * CI * CO, "bf16"),
)


def _k_parts(case: "Case", a: torch.Tensor, b: torch.Tensor) -> list[torch.Tensor]:
    """The partial outputs of a K-split case, one per block of a cluster:
    each its K range's products, summed as the case's tile sums them."""
    s = SPLITS[case.letter][1]
    if case.letter in "AB":
        step = K // s
        parts = []
        for r in range(s):
            xs, ws = a[:, r * step:(r + 1) * step], b[r * step:(r + 1) * step]
            if case.letter == "A":
                res = xs @ ws.reshape(step, 3 * CO)
                parts.append(res[:, :CO] + res[:, CO:2 * CO] + res[:, 2 * CO:])
            else:
                res = torch.tensordot(xs, ws, dims=([1], [0]))
                parts.append(res[:, 0] + res[:, 1] + res[:, 2])
        return parts
    if case.letter == "C":
        return [a[r] @ b[r] for r in range(s)]
    step = CI // s  # H: a 1/s of the input channels of every window
    xq = a.to(torch.bfloat16).float()
    wq = b.to(torch.bfloat16).float().reshape(9, CI, CO)
    parts = []
    for r in range(s):
        ch = slice(r * step, (r + 1) * step)
        wins = [xq[dh:dh + BH, dw:dw + WF, ch].reshape(BH * WF, step)
                for dh in range(3) for dw in range(3)]
        parts.append(torch.cat(wins, 1) @ wq[:, ch].reshape(9 * step, CO))
    return parts


def split_plain(case: "Case", a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``case``'s function computed the way its kernel's grid splits it
    (``SPLITS``): a K split's partials summed in rank order, or the output's
    column blocks, each from the whole K."""
    kind, s = SPLITS[case.letter]
    if kind == "k":
        parts = _k_parts(case, a, b)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
    step = CO // s
    return torch.cat([case.plain(a, b[:, r * step:(r + 1) * step].contiguous())
                      for r in range(s)], 1)
