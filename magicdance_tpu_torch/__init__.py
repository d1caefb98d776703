"""PyTorch/CUDA port of magicdance_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module layout (`config`, `ops`, `models`,
`sampling`, `pipeline`, `train`, `data`, `cli`, `utils`) so each module has
an obvious counterpart. Imports
torch and numpy only: never jax, flax or the JAX package. Entry points run
on the GPU unless the caller passes ``device="cpu"``; the attention hot
spots, forward and backward, go through the hand-written CUDA kernels in
`ops/kernels/csrc`.
"""
