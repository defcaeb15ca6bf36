"""Ops: GroupNorm and the VQ search and statistics (plain versions and CUDA
kernels), GradNorm, resizing."""
