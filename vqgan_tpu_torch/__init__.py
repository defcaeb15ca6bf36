"""PyTorch/CUDA port of vqgan_tpu for NVIDIA Hopper (H100).

The JAX package ``vqgan_tpu`` is the reference this package is held against;
this package imports ``torch`` and never JAX. Ported so far: the 2D VAE
serving path (``inference.VAEPipeline``) and the 2D GAN training step
(``train.state.create_train_state``, ``train.step.make_train_step``), with
hand-written CUDA GroupNorm(+swish) forward and backward kernels
(``csrc/groupnorm.cu``, ``ops/groupnorm_cuda.py``).
"""
