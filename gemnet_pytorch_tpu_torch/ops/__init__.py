"""Geometry, segment reductions, the bilinear contraction and the CUDA
kernels' wrappers (`segment_outer`, `expand_gather`, built by `_cuda`)."""
