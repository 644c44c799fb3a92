"""GemNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `gemnet_pytorch_tpu`, which stays the reference:
it serves GemNet energies and forces (-dE/dR) on an H100, with the bilinear
neighbour reduction, its VJP and the sorted segment sum as CUDA kernels
(`csrc/`). On CPU tensors the same entry points run plain PyTorch versions
of those kernels. This package imports neither JAX nor the JAX package.
"""
