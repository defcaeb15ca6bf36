"""Host-side image data for the trainer (counterpart of ``vqgan_tpu/data``):
``synthetic``, ``transforms``, ``tar_stream``, ``indexed`` and ``loader``.
These are the port's own copies; nothing here imports the JAX package."""
