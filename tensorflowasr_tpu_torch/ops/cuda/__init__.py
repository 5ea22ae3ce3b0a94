"""Wrappers of the hand-written CUDA kernels (counterpart of ``ops/pallas/``)."""
