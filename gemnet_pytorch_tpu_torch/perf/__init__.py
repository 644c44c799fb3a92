"""Measurement of the port on the card: value-fetch timing windows
(`timing`), the roofline of the train step against the H100's published
peaks (`roofline`), and device time read back from torch.profiler traces
(`trace`). `gemnet_pytorch_tpu_torch.bench` drives all three."""
