"""Measurement of the port on the card: value-fetch timing windows
(`timing`), the roofline of the train step against the H100's published
peaks (`roofline`), and device time read back from torch.profiler traces
(`trace`), which `gemnet_pytorch_tpu_torch.bench` drives; and the port's
own spans and counters (`spans`), which record while a profiler records."""
