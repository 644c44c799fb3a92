"""GemNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `gemnet_pytorch_tpu`, which stays the reference:
it serves GemNet energies and forces (-dE/dR) on an H100 and trains GemNet
(`training.Trainer`: force loss, grad-of-grad, flat AdamW/Adam, EMA; the
`train` driver with checkpoints and resume), in fp32, in the bf16 compute
mode or in fp32 "high", with the bilinear neighbour reduction, its VJP and
the sorted segment sum as CUDA kernels on fp32 and bf16 streams, the
bilinear pair also in the split3 mode on the tensor cores (`csrc/`). On
CPU tensors the same entry points run plain PyTorch versions of those
kernels. Graphs are built on the host by a native C++ builder (`native/`);
released models load through `pretrained` (and TF2 checkpoints through
`tf_import`). This package imports neither JAX nor the JAX package.
"""
