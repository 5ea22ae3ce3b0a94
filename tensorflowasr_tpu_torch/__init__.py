"""PyTorch + CUDA port of ``tensorflowasr_tpu`` for one NVIDIA Hopper card.

The layout mirrors the JAX package: ``ops/cuda/`` holds the hand-written
kernels' wrappers (counterpart of ``ops/pallas/``), ``csrc/`` their CUDA
sources. Importing the package builds nothing; the kernels compile with
``nvcc`` at their first launch on a CUDA tensor.
"""
