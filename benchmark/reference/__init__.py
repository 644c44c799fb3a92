"""The benchmark's plain reference: GemNet in fp32 PyTorch (`model`), the
graph rebuilt from Z and R in numpy (`graph`) and the published training
step (`train`). It imports nothing of the program under test."""
