"""GemNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `gemnet_pytorch_tpu`, which stays the reference:
it serves GemNet energies and forces (-dE/dR) on an H100 and trains GemNet
(`training.Trainer`: force loss, grad-of-grad, flat AdamW/Adam, EMA), in
fp32 or the bf16 compute mode, with the bilinear neighbour reduction, its
VJP and the sorted segment sum as CUDA kernels on fp32 and bf16 streams
(`csrc/`). On CPU tensors the same entry points run plain PyTorch versions
of those kernels. This package imports neither JAX nor the JAX package.
"""
