"""PyTorch/CUDA port of ``fusiontransformer_tpu`` for NVIDIA H100 cards.

The JAX package beside it stays the reference.  This package imports
``torch`` and ``numpy`` and nothing of the JAX package; its hand-written
CUDA kernels live in ``csrc/`` and are built at first use
(``ops/kernels/build.py``).
"""
