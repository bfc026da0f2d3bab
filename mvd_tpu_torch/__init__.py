"""PyTorch/CUDA port of mvd_tpu for one NVIDIA H100.

Mirrors ``mvd_tpu``'s module names. Imports torch and numpy, never JAX or
the JAX package. Kernels that the JAX package wrote in Pallas for the TPU are
hand-written CUDA kernels here (``kernels/``, sources in ``csrc/``), built on
first use.
"""
