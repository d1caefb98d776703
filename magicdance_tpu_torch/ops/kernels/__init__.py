"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Kernel A (`self_attention`) and kernel B (`two_source_attention`) replace the
three Pallas attention kernels on the exact image-serving path; with their
LSE output (`flash_vjp.self_attention_lse` / `two_source_attention_lse`)
they are the training forward, and kernels C (`flash_vjp.attention_dq`) and
D (`flash_vjp.attention_dkv`) the backward. Kernel B with a `bank_mask` is
the gated forward of fused classifier-free guidance. Kernel G
(`grouped_attention`, `grouped.grouped_attention_bwd`) replaces the Pallas
grouped (temporal) attention kernel and its backward on the video path, and
K8 (`groupnorm.groupnorm_act`) the fused GroupNorm with a SiLU or identity
epilogue. K9
(`packed.packed_attention`) is the head-packed attention of the
head-packing probe. Sources are under
`csrc/`; `build` compiles them with nvcc at first use.
"""

from magicdance_tpu_torch.ops.kernels.attention import (  # noqa: F401
    LAUNCHES,
    reset_launches,
    self_attention,
    self_attention_ref,
    two_source_attention,
    two_source_attention_ref,
)
from magicdance_tpu_torch.ops.kernels.grouped import (  # noqa: F401
    grouped_attention,
    grouped_attention_ref,
)
from magicdance_tpu_torch.ops.kernels.packed import (  # noqa: F401
    packed_attention,
    packed_attention_ref,
)
