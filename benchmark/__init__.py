"""The benchmark of the PyTorch and CUDA port of GemNet (`benchmark/README.md`)."""
