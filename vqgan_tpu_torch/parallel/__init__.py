"""Data parallelism across processes (counterpart of ``vqgan_tpu/parallel``)."""
