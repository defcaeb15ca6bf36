"""PyTorch/CUDA port of vqgan_tpu for NVIDIA Hopper (H100).

The JAX package ``vqgan_tpu`` is the reference this package is held against;
this package imports ``torch`` and never JAX. Ported so far: the 2D VAE
serving path (``inference.VAEPipeline``), with a hand-written CUDA
GroupNorm(+swish) kernel (``csrc/groupnorm.cu``, ``ops/groupnorm_cuda.py``).
"""
