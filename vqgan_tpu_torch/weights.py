"""Reference-format weights (counterpart of
``vqgan_tpu/train/torch_import.py::params_to_torch_state_dict``, the ``.pt``
branch of ``vqgan_tpu/train/checkpoint.py::load_weights``, and the inverse of
the JAX package's LPIPS and discriminator converters).

The reference saves weights-only ``vae.state_dict()`` files, possibly with
DDP (``module.``) or torch.compile (``_orig_mod.``) prefixes. The port's module
names are the reference's, so such a file feeds
``VAE.load_state_dict(strict=True)`` as it is. A JAX param tree (nested dicts
of arrays, flax names) is mapped here without importing the JAX package:

    params["encoder"]["down_0"]["block_1"]["conv1"]["kernel"]  (HWIO; DHWIO)
      → "encoder.down.0.block.1.conv1.weight"                  (OIHW; OIDHW)
    params["encoder"]["mid_block_1"]["norm1"]["scale"]
      → "encoder.mid.block_1.norm1.weight"
    params["reg"]["codebook"]                                  (K, D)
      → "reg.codebook"
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from vqgan_tpu_torch.losses.vgg import TORCHVISION_CONV_INDICES, slice_of

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
    """A flax VAE or TVAE param tree (nested dicts of numpy-convertible
    arrays) → a reference state dict of fp32 CPU tensors; conv kernels HWIO →
    OIHW, Conv3d kernels DHWIO → OIDHW."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list[str]) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
                continue
            arr = np.array(v, dtype=np.float32)  # a writable copy
            if k == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif k == "kernel" and arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            out[_flax_to_torch_key(path + [k])] = torch.from_numpy(
                np.ascontiguousarray(arr)
            )

    walk(params, [])
    return out


def jax_vq_ema_to_torch(vq_ema: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``vq_ema`` collection ``{"reg": {"counts", "sums"}}`` → the
    port's EMA statistics (``TrainState.vq_ema``): fp32 CPU tensors counts
    (K,) and sums (K, D)."""
    return {k: torch.from_numpy(np.array(vq_ema["reg"][k], dtype=np.float32))
            for k in ("counts", "sums")}


def _conv(kernel, bias) -> tuple[torch.Tensor, torch.Tensor]:
    """A flax conv (HWIO kernel, bias) → torch (OIHW weight, bias), fp32."""
    w = np.array(kernel, dtype=np.float32).transpose(3, 2, 0, 1)
    return (torch.from_numpy(np.ascontiguousarray(w)),
            torch.from_numpy(np.array(bias, dtype=np.float32)))


def _vgg_state_dict(vgg: Mapping, prefix: str, wrapped: bool) -> dict[str, torch.Tensor]:
    out = {}
    for j, idx in enumerate(TORCHVISION_CONV_INDICES):
        w, b = _conv(vgg[f"conv_{j}"]["kernel"], vgg[f"conv_{j}"]["bias"])
        key = f"{prefix}slice{slice_of(idx)}.{'0.' if wrapped else ''}{idx}"
        out[f"{key}.weight"], out[f"{key}.bias"] = w, b
    return out


def jax_lpips_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``LPIPS`` params (``vgg/conv_{j}``, ``lin_{k}``) → the reference's
    ``vgg.pth`` keys, which the port's ``LPIPS`` loads strictly: the VGG
    under ``net.slice{n}.{idx}.*``, the heads as ``lin{k}.model.1.weight``
    (1, C, 1, 1). The exact inverse of the JAX package's
    ``convert_torch_lpips``."""
    out = _vgg_state_dict(params["vgg"], "net.", wrapped=False)
    for k in range(5):
        lin = np.array(params[f"lin_{k}"], dtype=np.float32)
        out[f"lin{k}.model.1.weight"] = torch.from_numpy(lin.reshape(1, -1, 1, 1))
    return out


# JAX head conv name → reference Sequential index (utils.py:156-185)
_DISC_HEADS = {
    "bc1_conv0": "binary_classifier1.0",
    "bc1_conv1": "binary_classifier1.2",
    "bc2_conv0": "binary_classifier2.0",
    "bc2_conv1": "binary_classifier2.2",
    "bc3_conv0": "binary_classifier3.0",
    "bc3_conv1": "binary_classifier3.2",
    "bc4_conv0": "binary_classifier4.0",
    "bc5_conv0": "binary_classifier5.0",
}


def jax_disc_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``PatchDiscriminator`` params → the reference's state-dict keys,
    which the port's ``PatchDiscriminator`` loads strictly: the backbone
    under ``slice{n}.0.{idx}.*``, the heads as ``binary_classifier{k}.{0,2}.*``.
    The exact inverse of the JAX package's
    ``convert_torch_patch_discriminator``. A ``TubeletDiscriminator``'s
    temporal mixers ``tmix{k}`` come too: the depthwise (kt, 1, 1, 1, C)
    kernel becomes the (C, 1, kt, 1, 1) ``tmix{k}.weight``."""
    out = _vgg_state_dict(params["vgg"], "", wrapped=True)
    for ours, theirs in _DISC_HEADS.items():
        out[f"{theirs}.weight"], out[f"{theirs}.bias"] = _conv(
            params[ours]["kernel"], params[ours]["bias"])
    for k in range(1, 6):
        if f"tmix{k}" in params:
            kernel = np.array(params[f"tmix{k}"]["kernel"], dtype=np.float32)
            out[f"tmix{k}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(4, 3, 0, 1, 2)))
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
