"""Shared helper of the port's CPU parity tests (tests/test_torch_*.py)."""

import numpy as np


def randomize_params(params, seed):
    """A flax param tree with every leaf redrawn from numpy: conv kernels
    N(0, 1/fan_in) (ResnetBlock.conv2 included, so no residual branch is ~0),
    GroupNorm scales 1 + N(0, 0.2²), biases N(0, 0.1²)."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "kernel":
                std = 1.0 / np.sqrt(np.prod(np.shape(v)[:-1]))
                out[k] = (rng.randn(*np.shape(v)) * std).astype(np.float32)
            elif k == "scale":
                out[k] = (1.0 + 0.2 * rng.randn(*np.shape(v))).astype(np.float32)
            else:
                out[k] = (0.1 * rng.randn(*np.shape(v))).astype(np.float32)
        return out

    return walk(params)


def distance_gap(z, codebook, codes, ref_codes):
    """Per token, in fp64: ‖z − E[codes]‖² − ‖z − E[ref_codes]‖², and the
    most that fp32 rounding of a nearest-code search can make it. A search
    that computes each distance from a D-term dot product, ‖E‖² and ‖z‖²
    (or drops ‖z‖²) is off by at most (D + 2)·u·(‖z‖² + 2|z·E| + ‖E‖²) per
    distance, u = 2^-24, and 2|z·E| <= ‖z‖² + ‖E‖²; the code it picks is
    then at most the two codes' errors farther than the other."""
    z = np.asarray(z, np.float64)
    cb = np.asarray(codebook, np.float64)
    a, b = cb[np.asarray(codes)], cb[np.asarray(ref_codes)]
    gap = ((z - a) ** 2).sum(-1) - ((z - b) ** 2).sum(-1)
    tol = 2 * (z.shape[1] + 2) * 2.0 ** -24 * (
        2 * (z * z).sum(-1) + (a * a).sum(-1) + (b * b).sum(-1))
    return gap, tol


def assert_codes_by_distance(z, codebook, codes, ref_codes, min_agree=0.99):
    """Codes from two searches agree where they differ only by a near-tie:
    every chosen code is within fp32 rounding of the other's distance, and at
    least ``min_agree`` of them are the same code."""
    codes, ref_codes = np.asarray(codes), np.asarray(ref_codes)
    gap, tol = distance_gap(z, codebook, codes, ref_codes)
    assert (np.abs(gap) <= tol).all(), (gap.max(), tol[gap.argmax()])
    assert (codes == ref_codes).mean() >= min_agree, (codes == ref_codes).mean()
