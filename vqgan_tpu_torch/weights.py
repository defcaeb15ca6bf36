"""Reference-format weights (counterpart of
``vqgan_tpu/train/torch_import.py::params_to_torch_state_dict`` and the ``.pt``
branch of ``vqgan_tpu/train/checkpoint.py::load_weights``).

The reference saves weights-only ``vae.state_dict()`` files, possibly with
DDP (``module.``) or torch.compile (``_orig_mod.``) prefixes. The port's module
names are the reference's, so such a file feeds
``VAE.load_state_dict(strict=True)`` as it is. A JAX param tree (nested dicts
of arrays, flax names) is mapped here without importing the JAX package:

    params["encoder"]["down_0"]["block_1"]["conv1"]["kernel"]  (HWIO)
      → "encoder.down.0.block.1.conv1.weight"                  (OIHW)
    params["encoder"]["mid_block_1"]["norm1"]["scale"]
      → "encoder.mid.block_1.norm1.weight"
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

_INDEXED = ("down", "up", "block", "attn")
_STRIP = ("module", "_orig_mod")


def _flax_to_torch_key(path: list[str]) -> str:
    tokens: list[str] = []
    for p in path[:-1]:
        base, _, idx = p.rpartition("_")
        if p.startswith("mid_"):
            tokens.extend(["mid", p[len("mid_"):]])
        elif base in _INDEXED and idx.isdigit():
            tokens.extend([base, idx])
        else:
            tokens.append(p)
    leaf = path[-1]
    tokens.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(tokens)


def jax_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """A flax VAE param tree (nested dicts of numpy-convertible arrays) → a
    reference state dict of fp32 CPU tensors; conv kernels HWIO → OIHW."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list[str]) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
                continue
            arr = np.array(v, dtype=np.float32)  # a writable copy
            if k == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            out[_flax_to_torch_key(path + [k])] = torch.from_numpy(
                np.ascontiguousarray(arr)
            )

    walk(params, [])
    return out


def load_weights(path: str) -> dict[str, torch.Tensor]:
    """Read a reference-format ``.pt`` state dict onto the CPU, with DDP and
    torch.compile prefixes stripped from its keys."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {
        ".".join(t for t in k.split(".") if t not in _STRIP): v
        for k, v in sd.items()
    }


def save_weights(model: nn.Module, path: str) -> None:
    """Write ``model``'s weights as a reference-format ``.pt`` (contiguous fp32
    CPU tensors, reference key names)."""
    sd = {k: v.detach().to("cpu", torch.float32).contiguous()
          for k, v in model.state_dict().items()}
    torch.save(sd, path)
