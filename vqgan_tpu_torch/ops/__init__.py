"""Ops: GroupNorm (plain version and CUDA kernel), resizing."""
