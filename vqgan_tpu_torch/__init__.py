"""PyTorch/CUDA port of vqgan_tpu for NVIDIA Hopper (H100).

The JAX package ``vqgan_tpu`` is the reference this package is held against;
this package imports ``torch`` and never JAX. Ported so far: the 2D VAE
serving path (``inference.VAEPipeline``), the 2D GAN training step
(``train.state.create_train_state``, ``train.step.make_train_step``) with
the identity, Gaussian or VQ latent (``models/quant.py``), the training job
around it (``cli``, ``train.trainer.Trainer``, ``data``), the TVAE's serving
and train steps, and hand-written CUDA
kernels: GroupNorm(+swish) forward and backward (``csrc/groupnorm.cu``,
``ops/groupnorm_cuda.py``), and the VQ nearest-code search and code
statistics (``csrc/vq.cu``, ``ops/vq_cuda.py``).
"""
