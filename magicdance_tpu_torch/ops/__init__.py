"""Tensor ops of the port: schedules, attention dispatch, CUDA kernels."""
