"""The benchmark's yardstick: the card's peaks, the least time of a piece of
work, and the model FLOPs of a request or a training step.

Peaks are NVIDIA's data sheet for the H100 SXM (dense rates, no sparsity) at
its full 700 W power limit; each run prints the card's limit beside them.
The bound functions are copies of `chip_smoke.py`'s (`attention_bound_ms`,
`training_bound_ms`, `grouped_bound_ms`), frozen here so that what a later
change is measured against cannot move with the program. FLOPs are counted
once per cell by `torch.utils.flop_counter.FlopCounterMode` over the plain
reference (`port_bench.reference`) on the meta device, so the count is the
same whatever kernels the program uses.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3


def least_time_s(flops: float, nbytes: float) -> float:
    """The larger of the compute bound and the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


# --- copied from chip_smoke.py (attention_bound_ms) ---------------------------
def attention_bound_ms(b, sq, h, d, kv, itemsize=2) -> tuple[float, str]:
    """kv: list of (batch, length) per K/V source. Least time for the work:
    the matmul FLOPs over the bf16 peak vs each input read and the output
    written once over the memory rate."""
    flops = sum(4.0 * b * h * sq * sk * d for _, sk in kv)
    nbytes = itemsize * h * d * (2 * b * sq + sum(2 * bb * sk for bb, sk in kv))
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# --- copied from chip_smoke.py (training_bound_ms) ----------------------------
def training_bound_ms(mode, b, sq, h, d, kv, itemsize=2) -> tuple[float, str]:
    """Least time of one training-kernel launch: 4, 6 or 8 x Sq x Skv x D per
    batch, head and source (LSE forward, dQ, dK/dV) over the bf16 peak vs
    each input read and each output written once; lse/delta rows fp32."""
    per = {"lse": 4.0, "dq": 6.0, "dkv": 8.0}[mode]
    flops = sum(per * b * h * sq * sk * d for _, sk in kv)
    rows_f32 = 4 * b * h * sq * (1 if mode == "lse" else 2)
    q_side = {"lse": 2, "dq": 3, "dkv": 2}[mode]
    kv_side = 4 if mode == "dkv" else 2
    nbytes = itemsize * h * d * (q_side * b * sq + sum(kv_side * bb * sk for bb, sk in kv))
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, (nbytes + rows_f32) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# --- copied from chip_smoke.py (grouped_bound_ms) -----------------------------
def grouped_bound_ms(kind: str, n: int, s: int, c: int, itemsize: int = 2):
    """Least time of one grouped launch over n sequences of s rows and c =
    H*D channels (forward: q, k, v in, o out, 2 products; backward: 7
    tensors, 5 products)."""
    rows = n * s
    tensors, products = (4, 2) if kind == "fwd" else (7, 5)
    nbytes = itemsize * tensors * rows * c
    flops = 2.0 * products * rows * s * c
    t_ops, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def attention_module_bound_s(b: int, sq: int, cq: int, inner: int, sk: int, ck: int,
                             cross: bool, bank_rows: int = 0, bank_batch: int = 1,
                             itemsize: int = 2) -> float:
    """Least time of one attention module call: the q, k, v and output
    projections and the core softmax(QK^T)V over the layer's keys and the
    bank's. A cross-attention's keys come from one prompt shared by the
    batch (the traffic sends one prompt), so its K/V projection is counted
    for one row of context; the bank's for its own batch. Each input read
    once, the output written once, the weights read once."""
    kv_rows = sk if cross else b * sk
    flops = (2.0 * b * sq * cq * inner                     # q
             + 4.0 * kv_rows * ck * inner                  # k, v
             + 4.0 * bank_batch * bank_rows * cq * inner   # bank k, v
             + 4.0 * b * sq * (sk + bank_rows) * inner     # QK^T and PV
             + 2.0 * b * sq * inner * cq)                  # output
    nbytes = itemsize * (2 * b * sq * cq + (sk * ck if cross else 0)
                         + bank_batch * bank_rows * cq
                         + inner * (2 * cq + 2 * ck) + cq)
    return least_time_s(flops, nbytes)


def count_flops(fn, *args, **kwargs) -> float:
    """FLOPs of fn(*args) as FlopCounterMode counts them (matrix products and
    convolutions, the backward ones where fn runs a backward pass)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
