"""Command-line probes of the port (`python -m gemnet_pytorch_tpu_torch.scripts.<name>`)."""
