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
