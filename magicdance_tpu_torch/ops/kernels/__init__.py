"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Kernel A (`self_attention`) and kernel B (`two_source_attention`) replace the
three Pallas attention kernels on the exact image-serving path. Sources are
under `csrc/`; `build` compiles them with nvcc at first use.
"""

from magicdance_tpu_torch.ops.kernels.attention import (  # noqa: F401
    LAUNCHES,
    reset_launches,
    self_attention,
    self_attention_ref,
    two_source_attention,
    two_source_attention_ref,
)
