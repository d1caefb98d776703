"""Measurement scripts of the port, runnable as `python -m
magicdance_tpu_torch.scripts.<name>` on a machine with an NVIDIA GPU."""
