"""The port's trainers, run as ``python -m ps_tpu_torch.examples.<name>``."""
