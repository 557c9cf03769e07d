"""PyTorch/CUDA port of framedipt-tpu for NVIDIA Hopper (H100).

The JAX package ``framedipt_tpu`` is the reference; this package computes the
same functions with PyTorch on a CUDA device, and runs the N^2-wide edge stack
(embedder edge branch, edge transitions) in hand-written CUDA kernels
(``csrc/``). It imports nothing of the JAX package.
"""

__version__ = "0.1.0"
