"""CUDA kernels A (self_attention) and B (two_source_attention), with and
without their LSE output and B in its gated (bank_mask) mode, the backward
kernels C (attention_dq) and D (attention_dkv), the grouped kernel G, the
fused GroupNorm+SiLU (K8) and the head-packed attention (K9) against their
plain PyTorch versions, on the card. Kernels A, B and K9 run the Hopper
body (wgmma, TMA; csrc/attention_wgmma.cuh) in bf16 up to D = 192 (K9: G*D
= 128), attention_tc (mma.sync) above and when named, and their CUDA-core
bodies in fp32; C and D run their Hopper body (csrc/attention_bwd_wgmma.cuh,
C up to D = 192, D up to 160) where `attention_body` picks it, their mma.sync
body otherwise and when named, and their CUDA-core body in fp32; G (forward
and backward) runs its tensor-core body in bf16 and its CUDA-core body in
fp32; K8 runs the same two kernels (statistics, then apply) in both types.
C, D, K8 and G's backward are held to give the same bits on every run.

Every test here needs an NVIDIA GPU and the CUDA toolkit and skips without
one. On a machine with a card, from the repository root (this file imports
neither jax nor the JAX package, so the JAX test conftest can be left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: in fp32, max-abs 2e-4 (summation order). In bf16, max-abs
5e-2 (magicdance_tpu/ops/kernel_gate.py:52) and at most a tenth of the RMS of
the plain output: with randn q/k/v the outputs are ~sqrt(e / S_kv), i.e.
0.02-0.1 here, so the fixed bound alone would pass an error the size of the
output, while bf16 rounding of the output stays a few hundredths of its RMS.
Gradients (dQ, dK, dV): fp32 within 2e-4 x max(1, max |plain|) (summation
order over up to 8192 keys); bf16 within min(1e-1 (kernel_gate.py:52), 0.1 x
the RMS of the plain gradient).
"""

import pytest
import torch

from magicdance_tpu_torch.ops import kernels as K
from magicdance_tpu_torch.ops.kernels import flash_vjp as V

TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-4}
GRAD_TOL = {torch.bfloat16: 1e-1, torch.float32: 2e-4}
BF16_REL_TOL = 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(dev, *shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    tol = min(TOL[dtype], BF16_REL_TOL * rms) if dtype == torch.bfloat16 else TOL[dtype]
    assert err <= tol, f"max abs err {err:.3e} > {tol:.3e} (plain rms {rms:.3e})"


def _grad_close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    if dtype == torch.bfloat16:
        tol = min(GRAD_TOL[dtype], BF16_REL_TOL * rms)
    else:
        tol = GRAD_TOL[dtype] * max(1.0, want.float().abs().max().item())
    assert err <= tol, f"max abs err {err:.3e} > {tol:.3e} (plain rms {rms:.3e})"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d", [
    (1, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160),  # main-path sites
    (3, 300, 4, 48),                                        # ragged tiles
    (2, 256, 2, 256), (2, 128, 2, 8),                       # widest, narrowest D
])
def test_self_attention_matches_plain(cuda, dtype, b, s, h, d):
    q, k, v = (_rand(cuda, b, s, h, d, dtype=dtype, seed=i) for i in range(3))
    _close(K.self_attention(q, k, v), K.self_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_self_attention_bsnh_strided(cuda, dtype):
    """A BSNH view of a (B, H, S, D) tensor: the same kernel through strides."""
    q, k, v = (_rand(cuda, 2, 8, 1024, 80, dtype=dtype, seed=i).transpose(1, 2)
               for i in range(3))
    _close(K.self_attention(q, k, v), K.self_attention_ref(q, k, v), dtype)


def _rand_bshd(dev, b, s, h, d, dtype, seed, bsnh):
    """A (B, S, H, D) operand; with `bsnh` a transposed view of a (B, H, S,
    D) tensor, the layout of flash.py::_attn2_kernel_nomask."""
    if bsnh:
        return _rand(dev, b, h, s, d, dtype=dtype, seed=seed).transpose(1, 2)
    return _rand(dev, b, s, h, d, dtype=dtype, seed=seed)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,sb,bb,d,bsnh", [
    (2, 4096, 4096, 1, 40, False), (2, 1024, 1024, 1, 80, False),
    (2, 256, 256, 1, 160, False), (2, 1024, 1024, 2, 80, False),
    (3, 300, 200, 3, 48, False), (1, 256, 512, 1, 64, False),
    (2, 256, 256, 1, 256, False),    # widest D: 64-key tiles, H = 2
    (2, 4096, 4096, 1, 40, True),    # BSNH-strided operands and bank
    (16, 1024, 1024, 1, 80, False),  # the video batch: 16 frames, one reference
])
def test_two_source_matches_plain(cuda, dtype, b, s, sb, bb, d, bsnh):
    h = 8 if d <= 160 else 2
    q, k, v = (_rand_bshd(cuda, b, s, h, d, dtype, i, bsnh) for i in range(3))
    kb, vb = (_rand_bshd(cuda, bb, sb, h, d, dtype, 10 + i, bsnh) for i in range(2))
    _close(K.two_source_attention(q, k, v, kb, vb),
           K.two_source_attention_ref(q, k, v, kb, vb), dtype)


def test_launch_counters_and_dispatch(cuda):
    """Counters move only on kernel launches; the dispatcher sends S >= 256
    to the kernels and the short cross-attention to the plain math."""
    from magicdance_tpu_torch.ops.attention import (
        attention_packed, bank_read_attention_packed)

    x = _rand(cuda, 2, 256, 64, dtype=torch.bfloat16, seed=0)
    ctx = _rand(cuda, 2, 77, 64, dtype=torch.bfloat16, seed=1)
    bank = _rand(cuda, 1, 256, 64, dtype=torch.bfloat16, seed=2)
    K.reset_launches()
    attention_packed(x, x, x, num_heads=8)
    bank_read_attention_packed(x, x, x, bank, bank, num_heads=8)
    attention_packed(x, ctx, ctx, num_heads=8)
    assert K.LAUNCHES == {**{name: 0 for name in K.LAUNCHES},
                          "self_attention": 1, "two_source_attention": 1}


def test_wrappers_reject_bad_operands(cuda):
    q = _rand(cuda, 1, 256, 2, 40, dtype=torch.bfloat16, seed=0)
    with pytest.raises(ValueError):  # head dim not a multiple of 8
        K.self_attention(q[..., :36], q[..., :36], q[..., :36])
    with pytest.raises(ValueError):  # mixed dtypes
        K.self_attention(q, q.float(), q)
    with pytest.raises(ValueError):  # bank batch neither 1 nor B
        big = _rand(cuda, 3, 256, 2, 40, dtype=torch.bfloat16, seed=1)
        K.two_source_attention(big[:2], big[:2], big[:2], big, big)
    rows = torch.zeros(1, 2, 256, device=cuda)
    q36 = q[..., :36]
    with pytest.raises(ValueError):  # C and D: head dim not a multiple of 8
        V.attention_dq(q36, q36, q36, q36, rows, rows)
    with pytest.raises(ValueError):
        V.attention_dkv(q36, q36, q36, q36, rows, rows)
    with pytest.raises(ValueError):  # LSE rows of the wrong shape
        V.attention_dq(q, q, q, q, rows[:, :1], rows)


# --------------------------------------------------------------------------
# training path: LSE forward, kernel C (dQ), kernel D (dK/dV), autograd
# --------------------------------------------------------------------------


def _bwd_inputs(dev, b, s, h, d, dtype, bank=None, seed=0):
    """q, k, v, dout (and bank k/v) plus the plain forward's LSE and delta."""
    q, k, v, dout = (_rand(dev, b, s, h, d, dtype=dtype, seed=seed + i) for i in range(4))
    if bank is None:
        out, lse = V.self_attention_lse_ref(q, k, v)
        return q, k, v, dout, None, None, lse, V.attention_delta(dout, out)
    bb, sb = bank
    kb, vb = (_rand(dev, bb, sb, h, d, dtype=dtype, seed=seed + 10 + i) for i in range(2))
    out, lse = V.two_source_attention_lse_ref(q, k, v, kb, vb)
    return q, k, v, dout, kb, vb, lse, V.attention_delta(dout, out)


SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160),  # training sites
          (3, 300, 4, 48), (1, 256, 2, 256)]                        # ragged, widest D


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d,bsnh", [(*shape, False) for shape in SHAPES] + [
    (2, 1024, 8, 80, True),    # BSNH-strided operands and bank
    (16, 1024, 8, 80, False),  # a 16-frame clip (stage 3)
])
@pytest.mark.parametrize("bank", [None, 1, "B"])
def test_forward_lse_matches_plain(cuda, dtype, b, s, h, d, bsnh, bank):
    q, k, v = (_rand_bshd(cuda, b, s, h, d, dtype, i, bsnh) for i in range(3))
    if bank is None:
        got, want = V.self_attention_lse(q, k, v), V.self_attention_lse_ref(q, k, v)
    else:
        bb = b if bank == "B" else 1
        kb, vb = (_rand_bshd(cuda, bb, s, h, d, dtype, 5 + i, bsnh) for i in range(2))
        got = V.two_source_attention_lse(q, k, v, kb, vb)
        want = V.two_source_attention_lse_ref(q, k, v, kb, vb)
    _close(got[0], want[0], dtype)
    assert got[1].dtype == torch.float32 and got[1].shape == (b, h, s)
    _close(got[1], want[1], torch.float32)


# (b, s, h, d, bank, sb): bank None (self-attention), 1 (one reference read
# by every frame) or "B" (a bank per frame), of length sb (None: s)
BWD_CASES = [(*shape, bank, None) for shape in SHAPES for bank in (None, 1, "B")] + [
    (16, 1024, 8, 80, 1, None),  # a 16-frame clip, one reference: bank dK/dV summed over 16
    (16, 256, 8, 160, 1, None),  # the same at the D = 160 site
    (3, 300, 4, 48, 1, 200),     # a bank shorter than the self keys; ragged tiles
    (3, 300, 4, 48, "B", 200),
    (2, 512, 2, 256, 1, None),   # widest D with a shared bank
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d,bank,sb", BWD_CASES)
def test_dq_and_dkv_match_plain(cuda, dtype, b, s, h, d, bank, sb):
    spec = None if bank is None else (b if bank == "B" else 1, sb or s)
    q, k, v, dout, kb, vb, lse, delta = _bwd_inputs(cuda, b, s, h, d, dtype, spec)
    _grad_close(V.attention_dq(q, k, v, dout, lse, delta, k_bank=kb, v_bank=vb),
                V.attention_dq_ref(q, k, v, dout, lse, delta, k_bank=kb, v_bank=vb),
                dtype)
    for kk, vv in ((k, v),) if kb is None else ((k, v), (kb, vb)):
        got = V.attention_dkv(kk, vv, q, dout, lse, delta)
        want = V.attention_dkv_ref(kk, vv, q, dout, lse, delta)
        for g, w in zip(got, want):
            _grad_close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_bsnh_strided(cuda, dtype):
    """BSNH views of (B, H, S, D) tensors go through C and D by strides."""
    def r(seed):
        return _rand(cuda, 2, 8, 1024, 80, dtype=dtype, seed=seed).transpose(1, 2)
    q, k, v, dout = r(0), r(1), r(2), r(3)
    out, lse = V.self_attention_lse_ref(q, k, v)
    delta = V.attention_delta(dout, out)
    _grad_close(V.attention_dq(q, k, v, dout, lse, delta),
                V.attention_dq_ref(q, k, v, dout, lse, delta), dtype)
    for g, w in zip(V.attention_dkv(k, v, q, dout, lse, delta),
                    V.attention_dkv_ref(k, v, q, dout, lse, delta)):
        _grad_close(g, w, dtype)


@pytest.mark.parametrize("bank", [None, 1, "B"])
def test_grads_through_kernel_sites_match_plain(cuda, bank):
    """A loss through each kernel site of the dispatcher gets finite grads
    that match autograd through the plain path (fp32)."""
    from magicdance_tpu_torch.ops.attention import (
        attention_packed, bank_read_attention_packed)

    def leaf(*shape, seed):
        return _rand(cuda, *shape, dtype=torch.float32, seed=seed).requires_grad_()

    q, k, v = (leaf(2, 256, 64, seed=i) for i in range(3))
    args = [q, k, v]
    if bank is not None:
        bb = 2 if bank == "B" else 1
        args += [leaf(bb, 256, 64, seed=7), leaf(bb, 256, 64, seed=8)]
    K.reset_launches()
    if bank is None:
        out = attention_packed(q, k, v, num_heads=8)
        ref = K.self_attention_ref(*(t.unflatten(-1, (8, 8)) for t in args)).flatten(-2)
    else:
        out = bank_read_attention_packed(*args, num_heads=8)
        ref = K.two_source_attention_ref(*(t.unflatten(-1, (8, 8)) for t in args)).flatten(-2)
    got = torch.autograd.grad(out.sin().sum(), args)
    want = torch.autograd.grad(ref.sin().sum(), args)
    for g, w in zip(got, want):
        assert g is not None and torch.isfinite(g).all()
        _grad_close(g, w, torch.float32)
    two = bank is not None
    assert K.LAUNCHES["two_source_attention_lse" if two else "self_attention_lse"] == 1
    assert K.LAUNCHES["attention_dq_two_source" if two else "attention_dq"] == 1
    assert K.LAUNCHES["attention_dkv"] == (2 if two else 1)
    assert K.LAUNCHES["self_attention"] == K.LAUNCHES["two_source_attention"] == 0


def test_backward_launches_only_needed_grads(cuda):
    """Only the bank needs a gradient (a frozen UNet's first bank read): no
    dQ, no self-source dK/dV."""
    x = _rand(cuda, 2, 256, 64, dtype=torch.bfloat16, seed=0)
    bank = _rand(cuda, 1, 256, 64, dtype=torch.bfloat16, seed=1).requires_grad_()
    from magicdance_tpu_torch.ops.attention import bank_read_attention_packed

    K.reset_launches()
    out = bank_read_attention_packed(x, x, x, bank, bank, num_heads=8)
    (g,) = torch.autograd.grad(out.float().sum(), [bank])
    assert torch.isfinite(g).all()
    assert K.LAUNCHES["attention_dq_two_source"] == 0
    assert K.LAUNCHES["attention_dkv"] == 1


def test_kernels_refuse_to_drop_gradients(cuda):
    """Kernels A/B have no backward: a direct call on an input that needs a
    gradient raises instead of returning a detached output."""
    q = _rand(cuda, 1, 256, 2, 40, dtype=torch.float32, seed=0).requires_grad_()
    with pytest.raises(RuntimeError):
        K.self_attention(q, q, q)
    with pytest.raises(RuntimeError):
        K.two_source_attention(q, q, q, q, q)
    with torch.no_grad():
        K.self_attention(q, q, q)


# --------------------------------------------------------------------------
# video path: the grouped (temporal) kernel G, forward and backward
# --------------------------------------------------------------------------

GROUPED_SHAPES = [
    (4096, 16, 8, 40), (1024, 16, 8, 80), (256, 16, 8, 160), (64, 16, 8, 160),  # motion
    (8192, 1, 8, 40),                                  # one frame per clip
    (128, 4, 2, 16), (8, 16, 2, 256), (4, 32, 4, 64), (2, 64, 2, 256),  # other S and D
    (2048, 8, 8, 40), (8192, 2, 8, 40),  # S < 16: sequences packed into 16-row tiles
    (256, 16, 2, 8), (128, 8, 4, 24), (64, 32, 2, 136),  # D ragged against the k16 steps
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,s,h,d", GROUPED_SHAPES)
def test_grouped_forward_and_backward_match_plain(cuda, dtype, n, s, h, d):
    from magicdance_tpu_torch.ops.kernels import grouped as G

    q, k, v, g = (_rand(cuda, n, s, h * d, dtype=dtype, seed=30 + i) for i in range(4))
    K.reset_launches()
    _close(G.grouped_attention(q, k, v, None, h), G.grouped_attention_ref(q, k, v, None, h),
           dtype)
    got = G.grouped_attention_bwd(q, k, v, g, None, h)
    want = G.grouped_attention_bwd_ref(q, k, v, g, None, h)
    for a, b in zip(got, want):
        _grad_close(a, b, dtype)
    assert K.LAUNCHES["grouped"] == K.LAUNCHES["grouped_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,s,h,d", [(1024, 16, 8, 40), (512, 4, 8, 80)])
def test_grouped_strided_views_of_one_projection(cuda, dtype, n, s, h, d):
    """q, k and v as views of one fused (N*S, 3*H*D) projection: row stride
    3*H*D, and k and v start H*D and 2*H*D elements in."""
    from magicdance_tpu_torch.ops.kernels import grouped as G

    qkv = _rand(cuda, n, s, 3 * h * d, dtype=dtype, seed=35)
    q, k, v = qkv.split(h * d, dim=-1)
    assert q.stride(1) == 3 * h * d and not q.is_contiguous()
    K.reset_launches()
    _close(G.grouped_attention(q, k, v, None, h), G.grouped_attention_ref(q, k, v, None, h),
           dtype)
    g = _rand(cuda, n, s, h * d, dtype=dtype, seed=36)
    got = G.grouped_attention_bwd(q, k, v, g, None, h)
    want = G.grouped_attention_bwd_ref(q, k, v, g, None, h)
    for a, b in zip(got, want):
        _grad_close(a, b, dtype)
    assert K.LAUNCHES["grouped"] == K.LAUNCHES["grouped_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["sequence-minor", "row-sliced"])
def test_grouped_backward_strided_dout(cuda, dtype, layout):
    """dO as a strided view, not contiguous: the transpose of an (S, N,
    H*D) tensor (sequence stride H*D, row stride N*H*D), or the first half
    of the channels of an (N, S, 2*H*D) tensor (row stride 2*H*D)."""
    from magicdance_tpu_torch.ops.kernels import grouped as G

    n, s, h, d = 512, 16, 8, 40
    q, k, v = (_rand(cuda, n, s, h * d, dtype=dtype, seed=50 + i) for i in range(3))
    if layout == "sequence-minor":
        g = _rand(cuda, s, n, h * d, dtype=dtype, seed=53).transpose(0, 1)
    else:
        g = _rand(cuda, n, s, 2 * h * d, dtype=dtype, seed=53)[..., :h * d]
    assert not g.is_contiguous()
    K.reset_launches()
    got = G.grouped_attention_bwd(q, k, v, g, None, h)
    want = G.grouped_attention_bwd_ref(q, k, v, g.contiguous(), None, h)
    for a, b in zip(got, want):
        _grad_close(a, b, dtype)
    assert K.LAUNCHES["grouped_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,s,h,d", [(4096, 16, 8, 40), (2048, 8, 8, 40), (4, 32, 4, 64),
                                     (2, 64, 2, 256)])
def test_grouped_backward_is_deterministic(cuda, dtype, n, s, h, d):
    """Two runs give the same bits: no atomics, a fixed order of every sum
    (at S = 32 and 64 a key row sums the query rows of several warps)."""
    from magicdance_tpu_torch.ops.kernels import grouped as G

    q, k, v, g = (_rand(cuda, n, s, h * d, dtype=dtype, seed=60 + i) for i in range(4))
    first = G.grouped_attention_bwd(q, k, v, g, None, h)
    second = G.grouped_attention_bwd(q, k, v, g, None, h)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_grouped_dispatch_and_autograd(cuda):
    """A motion-module shape goes to the grouped kernel without a gradient
    and through mha_grouped (forward and backward kernels) with one; the
    gradients equal autograd through the plain version."""
    from magicdance_tpu_torch.ops.attention import attention_packed
    from magicdance_tpu_torch.ops.kernels import grouped as G

    q, k, v = (_rand(cuda, 256, 16, 320, dtype=torch.float32, seed=40 + i) for i in range(3))
    K.reset_launches()
    with torch.no_grad():
        attention_packed(q, k, v, num_heads=8)
    assert K.LAUNCHES == {**{name: 0 for name in K.LAUNCHES}, "grouped": 1}
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    attention_packed(qs, ks, vs, num_heads=8).square().sum().backward()
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    G.grouped_attention_ref(qr, kr, vr, None, 8).square().sum().backward()
    for a, b in ((qs, qr), (ks, kr), (vs, vr)):
        _grad_close(a.grad, b.grad, torch.float32)
    assert K.LAUNCHES["grouped"] == 2 and K.LAUNCHES["grouped_bwd"] == 1
    with pytest.raises(RuntimeError):  # the forward kernel alone drops gradients
        G.grouped_attention(qs, ks, vs, None, 8)
    with pytest.raises(ValueError):  # 64 rows are not a whole 128-row tile
        G.grouped_attention(q[:4], k[:4], v[:4], None, 8)


# --------------------------------------------------------------------------
# kernel B gated by a bank mask (fused CFG) and the fused GroupNorm+SiLU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,sk,d,gates,bb", [
    (4, 4096, 4096, 40, (1, 1, 0, 0), 1), (4, 1024, 1024, 80, (1, 1, 0, 0), 1),
    (4, 256, 256, 160, (1, 1, 0, 0), 1), (2, 1024, 1024, 80, (0.5, 0), 1),
    (4, 4096, 1024, 40, (1, 0.25, 0, 1), 1),  # pooled self keys (S_k = S / 4)
    (3, 300, 200, 48, (0, 1, 0.5), 1),        # ragged tiles
    (4, 256, 256, 160, (0.5, 1, 0, 0.25), 4),  # fractional gates, a bank per row
])
def test_gated_two_source_matches_plain(cuda, dtype, b, s, sk, d, gates, bb):
    q = _rand(cuda, b, s, 8, d, dtype=dtype, seed=50)
    k, v = (_rand(cuda, b, sk, 8, d, dtype=dtype, seed=51 + i) for i in range(2))
    kb, vb = (_rand(cuda, bb, s, 8, d, dtype=dtype, seed=53 + i) for i in range(2))
    mask = torch.tensor(gates, dtype=torch.float32, device=cuda)
    K.reset_launches()
    got = K.two_source_attention(q, k, v, kb, vb, bank_mask=mask)
    _close(got, K.two_source_attention_ref(q, k, v, kb, vb, bank_mask=mask), dtype)
    assert K.LAUNCHES["two_source_attention_gated"] == 1
    assert K.LAUNCHES["two_source_attention"] == 0
    # a gate of 0 is plain self-attention, a gate of 1 the ungated read
    for row, g in enumerate(gates):
        if g == 0:
            _close(got[row:row + 1], K.self_attention_ref(q[row:row + 1], k[row:row + 1],
                                                          v[row:row + 1]), dtype)
        elif g == 1:
            rb = slice(0, 1) if bb == 1 else slice(row, row + 1)
            _close(got[row:row + 1], K.two_source_attention_ref(
                q[row:row + 1], k[row:row + 1], v[row:row + 1], kb[rb], vb[rb]), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,sk,d", [(2, 4096, 1024, 40), (2, 4096, 256, 40)])
def test_pooled_key_lengths_match_plain(cuda, dtype, b, s, sk, d):
    """self_kv_downsample 2 and 4 at the S = 4096 sites: S_k < S_q."""
    q = _rand(cuda, b, s, 8, d, dtype=dtype, seed=60)
    k, v = (_rand(cuda, b, sk, 8, d, dtype=dtype, seed=61 + i) for i in range(2))
    kb, vb = (_rand(cuda, 1, s, 8, d, dtype=dtype, seed=63 + i) for i in range(2))
    _close(K.self_attention(q, k, v), K.self_attention_ref(q, k, v), dtype)
    _close(K.two_source_attention(q, k, v, kb, vb),
           K.two_source_attention_ref(q, k, v, kb, vb), dtype)


def test_gated_bank_read_dispatch(cuda):
    """A gated kernel site launches the gated mode, the S = 64 site takes
    the gated plain version; a gated site asked for a gradient raises."""
    from magicdance_tpu_torch.ops.attention import bank_read_attention_packed

    mask = torch.tensor([1.0, 0.0], device=cuda)
    x = _rand(cuda, 2, 256, 64, dtype=torch.bfloat16, seed=70)
    bank = _rand(cuda, 1, 256, 64, dtype=torch.bfloat16, seed=71)
    small = _rand(cuda, 2, 64, 64, dtype=torch.bfloat16, seed=72)
    K.reset_launches()
    bank_read_attention_packed(x, x, x, bank, bank, num_heads=8, bank_mask=mask)
    bank_read_attention_packed(small, small, small, small[:1], small[:1], num_heads=8,
                               bank_mask=mask)
    assert K.LAUNCHES == {**{name: 0 for name in K.LAUNCHES},
                          "two_source_attention_gated": 1}
    xg = x.float().requires_grad_()
    with pytest.raises(NotImplementedError):
        bank_read_attention_packed(xg, xg, xg, bank.float(), bank.float(), num_heads=8,
                                   bank_mask=mask)
    with pytest.raises(ValueError):  # the gated kernel has no LSE output
        K.attention.two_source_attention_cuda(x.view(2, 256, 8, 8), x.view(2, 256, 8, 8),
                                              x.view(2, 256, 8, 8), bank.view(1, 256, 8, 8),
                                              bank.view(1, 256, 8, 8), 0.3, True, mask)


# every (HW, C) where the SD1.5 UNets and the ControlNet call GN+SiLU at
# 512x512 with HW >= 256 (B = 2), plus a gcd group count and a ragged group;
# the 16-frame sites (B = 16) and 8x8 ones (B = 16 and 1); row counts no
# chunk size divides; and
# channels that are not whole 16-byte pieces (one channel per load)
GN_SHAPES = [(2, hw, c) for hw, c in (
    (4096, 320), (4096, 640), (4096, 960), (1024, 320), (1024, 640), (1024, 960),
    (1024, 1280), (1024, 1920), (256, 640), (256, 1280), (256, 1920), (256, 2560),
    (300, 48), (256, 80))] + [
    (16, 4096, 320), (16, 1024, 640), (16, 64, 1280), (1, 64, 2560),
    (2, 997, 320), (1, 4099, 960), (3, 251, 2560),
    (2, 300, 36)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hw,c", GN_SHAPES)
def test_groupnorm_silu_matches_plain(cuda, dtype, b, hw, c):
    from magicdance_tpu_torch.ops.kernels import groupnorm as GN

    groups = __import__("math").gcd(c, 32)
    x = (_rand(cuda, b, hw, c, dtype=torch.float32, seed=80) * 3 + 1).to(dtype)
    w = _rand(cuda, c, dtype=torch.float32, seed=81) * 0.2 + 1
    bias = _rand(cuda, c, dtype=torch.float32, seed=82) * 0.2
    K.reset_launches()
    _close(GN.groupnorm_act(x, w, bias, groups, 1e-5, "silu"),
           GN.groupnorm_silu_ref(x, w, bias, groups, 1e-5), dtype)
    assert K.LAUNCHES["groupnorm_silu"] == 2  # gn_stats and gn_apply


@pytest.mark.parametrize("affine", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hw,c", [(2, 4096, 320), (16, 1024, 640), (1, 256, 1280),
                                    (3, 300, 48), (2, 300, 36)])
def test_groupnorm_identity_matches_fp32(cuda, dtype, affine, b, hw, c):
    """K8's identity epilogue (the transformers' norms) on channels_last
    activations, the affine stored in bf16 or fp32 and read as stored,
    against the fp32 group norm of the same (rounded) inputs: exactly two
    launches, nothing cast."""
    from magicdance_tpu_torch.ops.kernels import groupnorm as GN

    import math

    groups = math.gcd(c, 32)
    side = math.isqrt(hw - 1) + 1  # a ragged hw reads the first hw of side**2 rows
    x4 = (_rand(cuda, b, c, side, side, dtype=torch.float32, seed=83) * 3 + 1).to(dtype)
    x4 = x4.contiguous(memory_format=torch.channels_last)
    x = x4.permute(0, 2, 3, 1).reshape(b, side * side, c)  # a view: rows of channels
    assert x.data_ptr() == x4.data_ptr() and x.stride(2) == 1
    x = x[:, :hw]
    w = (_rand(cuda, c, dtype=torch.float32, seed=84) * 0.2 + 1).to(affine)
    bias = (_rand(cuda, c, dtype=torch.float32, seed=85) * 0.2).to(affine)
    want = torch.nn.functional.group_norm(x.float().transpose(1, 2), groups, w.float(),
                                          bias.float(), 1e-6).transpose(1, 2)
    K.reset_launches()
    got = GN.groupnorm_act(x, w, bias, groups, 1e-6, None)
    assert got.dtype == dtype and got.is_contiguous()
    _close(got, want, dtype)
    assert K.LAUNCHES == {**{name: 0 for name in K.LAUNCHES}, "groupnorm_silu": 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_groupnorm_silu_unaligned_view(cuda, dtype):
    """A view that starts one channel into a wider row: no 16-byte pieces."""
    from magicdance_tpu_torch.ops.kernels import groupnorm as GN

    wide = _rand(cuda, 2, 1024, 328, dtype=torch.float32, seed=86).to(dtype)
    x = wide[:, :, 1:321]
    w = _rand(cuda, 320, dtype=torch.float32, seed=87) * 0.2 + 1
    bias = _rand(cuda, 320, dtype=torch.float32, seed=88) * 0.2
    _close(GN.groupnorm_act(x, w, bias, 32, 1e-5, "silu"),
           GN.groupnorm_silu_ref(x, w, bias, 32, 1e-5), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hw,c", [(2, 4096, 320), (16, 4096, 320), (2, 256, 1280)])
def test_groupnorm_silu_is_deterministic(cuda, dtype, b, hw, c):
    """No atomics, no order that depends on scheduling: two runs on the same
    input give the same bits."""
    from magicdance_tpu_torch.ops.kernels import groupnorm as GN

    x = (_rand(cuda, b, hw, c, dtype=torch.float32, seed=89) * 3 + 1).to(dtype)
    w = _rand(cuda, c, dtype=torch.float32, seed=90) * 0.2 + 1
    bias = _rand(cuda, c, dtype=torch.float32, seed=91) * 0.2
    first = GN.groupnorm_act(x, w, bias, 32, 1e-5, "silu")
    second = GN.groupnorm_act(x, w, bias, 32, 1e-5, "silu")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_groupnorm_dispatch(cuda, monkeypatch):
    """By default GroupNorm32 on channels_last activations with HW >= 64
    and grad mode off takes K8, with SiLU (act=True) or without; a smaller
    grid, grad mode on or MAGICDANCE_FUSED_GN=0 take the plain norm."""
    from magicdance_tpu_torch.models.layers import GroupNorm32

    gn = GroupNorm32(320, act=True).to(cuda)
    norm_only = GroupNorm32(320, eps=1e-6).to(cuda)
    x = _rand(cuda, 2, 320, 64, 64, dtype=torch.float32, seed=90).contiguous(
        memory_format=torch.channels_last)
    monkeypatch.delenv("MAGICDANCE_FUSED_GN", raising=False)
    with torch.no_grad():
        monkeypatch.setenv("MAGICDANCE_FUSED_GN", "0")
        plain, plain_norm = gn(x), norm_only(x)
        monkeypatch.delenv("MAGICDANCE_FUSED_GN")
        K.reset_launches()
        fused = gn(x)
        gn(x[:, :, :7, :9])
        fused_norm = norm_only(x)
    assert K.LAUNCHES["groupnorm_silu"] == 4
    _close(fused, plain, torch.float32)
    _close(fused_norm, plain_norm, torch.float32)
    assert fused.is_contiguous(memory_format=torch.channels_last)
    assert fused_norm.is_contiguous(memory_format=torch.channels_last)
    gn(x)  # grad mode on: the plain norm, also with nothing asking for a gradient
    gn(x.requires_grad_())
    assert K.LAUNCHES["groupnorm_silu"] == 4
    with torch.no_grad(), pytest.raises(ValueError):  # NCHW-contiguous: not rows of channels
        gn(x.detach().contiguous())


# --------------------------------------------------------------------------
# kernel A's tensor-core body (bf16) in every mode; kernel K9 (head-packed)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("sq,sk", [(300, 200), (130, 390)])
def test_self_attention_ragged_lengths(cuda, dtype, d, sq, sk):
    """Sq and Sk not multiples of the 64-row tiles, Sk below and above Sq."""
    q = _rand(cuda, 2, sq, 4, d, dtype=dtype, seed=100)
    k, v = (_rand(cuda, 2, sk, 4, d, dtype=dtype, seed=101 + i) for i in range(2))
    _close(K.self_attention(q, k, v), K.self_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_self_attention_lse_pooled_bsnh(cuda, dtype, d):
    """Pooled keys (Sk = Sq / 4) through BSNH views of (B, H, S, D) tensors,
    with the LSE output: out as the other tests, LSE within 2e-4."""
    q = _rand(cuda, 2, 8, 1000, d, dtype=dtype, seed=110).transpose(1, 2)
    k, v = (_rand(cuda, 2, 8, 250, d, dtype=dtype, seed=111 + i).transpose(1, 2)
            for i in range(2))
    got, want = V.self_attention_lse(q, k, v), V.self_attention_lse_ref(q, k, v)
    _close(got[0], want[0], dtype)
    assert got[1].dtype == torch.float32 and got[1].shape == (2, 8, 1000)
    _close(got[1], want[1], torch.float32)


# the Hopper body of A and B (csrc/attention_wgmma.cuh) in every mode, beside
# attention_tc named explicitly: (b, sq, sk, sb, bank batch, d); D = 40 takes
# one partial 64-column TMA box, 80 a full and a partial one, 160 three, 192
# the body's widest; ragged lengths everywhere but the main-path widths
HOPPER_CASES = [
    (2, 1024, 1024, 1024, 1, 40), (2, 300, 200, 130, 1, 40), (2, 1024, 1024, 1024, 2, 80),
    (3, 130, 390, 200, 1, 80), (2, 256, 256, 256, 1, 160), (2, 200, 70, 100, 2, 160),
    (1, 150, 250, 64, 1, 192),
]


@pytest.mark.parametrize("mode", ["self", "self_lse", "two", "two_lse", "gated"])
@pytest.mark.parametrize("b,sq,sk,sb,bb,d", HOPPER_CASES)
def test_attention_bodies_match_plain(cuda, mode, b, sq, sk, sb, bb, d):
    """bf16 A and B on the body `attention_body` picks for the shape, on the
    Hopper body (which takes D up to 192) and on attention_tc named
    explicitly, one launch each, all against the plain version; the LSE
    within 2e-4."""
    from magicdance_tpu_torch.ops.kernels.attention import attention_body

    assert attention_body(torch.bfloat16, d) == "wgmma"
    dt = torch.bfloat16
    q = _rand(cuda, b, sq, 4, d, dtype=dt, seed=170)
    k, v = (_rand(cuda, b, sk, 4, d, dtype=dt, seed=171 + i) for i in range(2))
    kb, vb = (_rand(cuda, bb, sb, 4, d, dtype=dt, seed=173 + i) for i in range(2))
    gates = torch.tensor([1.0, 0.0, 0.5][:b], device=cuda)
    run = {
        "self": (lambda body: (K.self_attention(q, k, v, body=body), None),
                 lambda: (K.self_attention_ref(q, k, v), None), "self_attention"),
        "self_lse": (lambda body: V.self_attention_lse(q, k, v, body=body),
                     lambda: V.self_attention_lse_ref(q, k, v), "self_attention_lse"),
        "two": (lambda body: (K.two_source_attention(q, k, v, kb, vb, body=body), None),
                lambda: (K.two_source_attention_ref(q, k, v, kb, vb), None),
                "two_source_attention"),
        "two_lse": (lambda body: V.two_source_attention_lse(q, k, v, kb, vb, body=body),
                    lambda: V.two_source_attention_lse_ref(q, k, v, kb, vb),
                    "two_source_attention_lse"),
        "gated": (lambda body: (K.two_source_attention(q, k, v, kb, vb, bank_mask=gates,
                                                       body=body), None),
                  lambda: (K.two_source_attention_ref(q, k, v, kb, vb, bank_mask=gates), None),
                  "two_source_attention_gated"),
    }
    kern, plain, counter = run[mode]
    want = plain()
    for body in (None, "wgmma", "mma_sync"):
        K.reset_launches()
        got = kern(body)
        assert K.LAUNCHES == {**{name: 0 for name in K.LAUNCHES}, counter: 1}
        _close(got[0], want[0], dt)
        if want[1] is not None:
            _close(got[1], want[1], torch.float32)


def test_attention_bodies_refuse_what_they_cannot_take(cuda):
    """A named body must take the dtype and width, and the C entry refuses
    the Hopper body past D = 192 with cudaErrorInvalidValue: nothing falls
    back to another body."""
    import ctypes

    from magicdance_tpu_torch.ops.kernels import build

    q = _rand(cuda, 1, 128, 2, 256, dtype=torch.bfloat16, seed=180)
    with pytest.raises(ValueError):
        K.self_attention(q, q, q, body="wgmma")
    with pytest.raises(ValueError):
        K.two_source_attention(q, q, q, q, q, body="wgmma")
    with pytest.raises(ValueError):
        K.self_attention(q[..., :40], q[..., :40], q[..., :40], body="cuda_core")
    with pytest.raises(ValueError):
        K.self_attention(q.float(), q.float(), q.float(), body="wgmma")
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*([q.stride(0), q.stride(1), q.stride(2)] * 4))
    lib = build.load("self_attention")
    err = lib.md_self_attention(1, 2, q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
                                None, strides, 1, 2, 256, 128, 128, ctypes.c_float(0.0625),
                                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err != 0 and b"invalid argument" in lib.md_error_string(err)


def test_attention_broadcast_operands(cuda):
    """Operands broadcast over batch rows or heads (stride 0) run on the
    Hopper body, read at coordinate 0; keys broadcast over rows (row stride
    0), which its TMA maps cannot read, go to attention_tc by default, and
    naming the Hopper body for them raises."""
    from magicdance_tpu_torch.ops.kernels.attention import tma_readable

    dt = torch.bfloat16
    q = _rand(cuda, 3, 200, 4, 80, dtype=dt, seed=190)
    over_heads = [_rand(cuda, 3, 150, 1, 80, dtype=dt, seed=191 + i).expand(3, 150, 4, 80)
                  for i in range(2)]
    over_batch = [_rand(cuda, 1, 150, 4, 80, dtype=dt, seed=193 + i).expand(3, 150, 4, 80)
                  for i in range(2)]
    for k, v in (over_heads, over_batch):
        assert tma_readable(k) and tma_readable(v)
        _close(K.self_attention(q, k, v, body="wgmma"), K.self_attention_ref(q, k, v), dt)
        _close(K.two_source_attention(q, q, q, k, v, body="wgmma"),
               K.two_source_attention_ref(q, q, q, k, v), dt)
    kbh = over_batch[1]
    k_row = _rand(cuda, 3, 1, 4, 80, dtype=dt, seed=195).expand(3, 150, 4, 80)
    assert not tma_readable(k_row)
    _close(K.self_attention(q, k_row, kbh), K.self_attention_ref(q, k_row, kbh), dt)
    with pytest.raises(ValueError):
        K.self_attention(q, k_row, kbh, body="wgmma")


# the Hopper body of C and D (csrc/attention_bwd_wgmma.cuh) beside the
# mma.sync body named explicitly: (b, sq, sk, sb, bank batch or None, d); the
# training sites, 77 keys (D's split), a batch-1 bank read by 16 frames, a
# ragged case, D's widest 64-query-tile width (96) and C's widest width (192)
BWD_HOPPER_CASES = [
    (2, 4096, 4096, None, None, 40), (2, 1024, 1024, 1024, 2, 80), (2, 256, 256, 256, 2, 160),
    (16, 1024, 1024, 1024, 1, 80), (2, 4096, 77, None, None, 40), (2, 1024, 77, None, None, 80),
    (3, 300, 200, 130, 1, 48), (2, 132, 390, None, None, 96), (1, 150, 250, 64, 1, 192),
]


@pytest.mark.parametrize("b,sq,sk,sb,bb,d", BWD_HOPPER_CASES)
def test_backward_bodies_match_plain(cuda, b, sq, sk, sb, bb, d):
    """bf16 C and D on the body `attention_body` picks, on the Hopper body
    where it takes the width (C up to D = 192, D up to 160; D also in 1 and 3
    query splits) and on the mma.sync body named explicitly, one launch
    each, all against the plain version by the gradient rule; the default
    bodies twice, with the same bits."""
    dt = torch.bfloat16
    q, dout = (_rand(cuda, b, sq, 4, d, dtype=dt, seed=200 + i) for i in range(2))
    k, v = (_rand(cuda, b, sk, 4, d, dtype=dt, seed=202 + i) for i in range(2))
    kb = vb = None
    if bb:
        kb, vb = (_rand(cuda, bb, sb, 4, d, dtype=dt, seed=204 + i) for i in range(2))
        out, lse = V.two_source_attention_lse_ref(q, k, v, kb, vb)
    else:
        out, lse = V.self_attention_lse_ref(q, k, v)
    delta = V.attention_delta(dout, out)
    counter = "attention_dq_two_source" if bb else "attention_dq"
    want = V.attention_dq_ref(q, k, v, dout, lse, delta, None, kb, vb)
    for body in (None, "wgmma", "mma_sync") if d <= 192 else (None, "mma_sync"):
        K.reset_launches()
        got = V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb, body=body)
        assert K.LAUNCHES == {**{name: 0 for name in K.LAUNCHES}, counter: 1}
        _grad_close(got, want, dt)
    assert torch.equal(V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb),
                       V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb))
    for kk, vv in [(k, v)] + ([(kb, vb)] if bb else []):
        want = V.attention_dkv_ref(kk, vv, q, dout, lse, delta)
        runs = [(None, None), ("mma_sync", None)]
        if d <= 160:
            runs += [("wgmma", None), ("wgmma", 1), ("wgmma", 3)]
        for body, nsplit in runs:
            K.reset_launches()
            got = V.attention_dkv(kk, vv, q, dout, lse, delta, body=body, nsplit=nsplit)
            assert K.LAUNCHES == {**{name: 0 for name in K.LAUNCHES}, "attention_dkv": 1}
            for g, w in zip(got, want):
                _grad_close(g, w, dt)
        first = V.attention_dkv(kk, vv, q, dout, lse, delta)
        again = V.attention_dkv(kk, vv, q, dout, lse, delta)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_backward_bodies_route_what_tma_cannot_read(cuda, monkeypatch):
    """What the Hopper body of C and D cannot read goes to the mma.sync body
    by default, and naming the Hopper body for it raises: queries broadcast
    over rows (row stride 0; keys broadcast so would all be the same key,
    which makes dQ zero up to rounding, below any rule relative to its RMS)
    and, for D, lse rows off 16 bytes (S_q not a multiple of 4); a
    BSNH-strided case stays on the Hopper body. The C entries refuse the
    Hopper body past its widths with cudaErrorInvalidValue: nothing falls
    back to another body."""
    import ctypes

    from magicdance_tpu_torch.ops.kernels import build

    seen = []
    real = V.launch
    monkeypatch.setattr(V, "launch", lambda lib, counter, ref, lead, *rest: (
        seen.append((lib, lead[0])), real(lib, counter, ref, lead, *rest)))
    dt = torch.bfloat16
    q, dout = (_rand(cuda, 2, 1030, 4, 40, dtype=dt, seed=210 + i) for i in range(2))
    k, v = (_rand(cuda, 2, 390, 4, 40, dtype=dt, seed=212 + i) for i in range(2))
    out, lse = V.self_attention_lse_ref(q, k, v)
    delta = V.attention_delta(dout, out)
    for g, w in zip(V.attention_dkv(k, v, q, dout, lse, delta),
                    V.attention_dkv_ref(k, v, q, dout, lse, delta)):
        _grad_close(g, w, dt)
    with pytest.raises(ValueError):
        V.attention_dkv(k, v, q, dout, lse, delta, body="wgmma")
    dout = dout[:, :1024]
    q_row = _rand(cuda, 2, 1, 4, 40, dtype=dt, seed=214).expand(2, 1024, 4, 40)
    out, lse = V.self_attention_lse_ref(q_row, k, v)
    delta = V.attention_delta(dout, out)
    _grad_close(V.attention_dq(q_row, k, v, dout, lse, delta),
                V.attention_dq_ref(q_row, k, v, dout, lse, delta), dt)
    for g, w in zip(V.attention_dkv(k, v, q_row, dout, lse, delta),
                    V.attention_dkv_ref(k, v, q_row, dout, lse, delta)):
        _grad_close(g, w, dt)
    for call in (V.attention_dq, lambda *a, **kw: V.attention_dkv(a[1], a[2], a[0], *a[3:], **kw)):
        with pytest.raises(ValueError):
            call(q_row, k, v, dout, lse, delta, body="wgmma")

    def bsnh(seed):
        return _rand(cuda, 2, 4, 1024, 80, dtype=dt, seed=seed).transpose(1, 2)
    q, k, v, dout = (bsnh(220 + i) for i in range(4))
    out, lse = V.self_attention_lse_ref(q, k, v)
    delta = V.attention_delta(dout, out)
    _grad_close(V.attention_dq(q, k, v, dout, lse, delta),
                V.attention_dq_ref(q, k, v, dout, lse, delta), dt)
    for g, w in zip(V.attention_dkv(k, v, q, dout, lse, delta),
                    V.attention_dkv_ref(k, v, q, dout, lse, delta)):
        _grad_close(g, w, dt)
    assert seen == [("attention_dkv", 1), ("attention_dq", 1), ("attention_dkv", 1),
                    ("attention_dq", 2), ("attention_dkv", 2)]

    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for lib_name, d in (("attention_dq", 256), ("attention_dkv", 192)):
        x = _rand(cuda, 1, 128, 2, d, dtype=dt, seed=230)
        rows = torch.zeros(1, 2, 128, device=cuda)
        lib = build.load(lib_name)
        if lib_name == "attention_dq":
            strides = (ctypes.c_longlong * 21)(*([x.stride(0), x.stride(1), x.stride(2)] * 7))
            err = lib.md_attention_dq(1, 2, 1, x.data_ptr(), x.data_ptr(), x.data_ptr(), None,
                                      None, x.data_ptr(), rows.data_ptr(), rows.data_ptr(),
                                      torch.empty_like(x).data_ptr(), strides, 1, 2, d, 128,
                                      128, 0, ctypes.c_float(0.1), stream)
        else:
            strides = (ctypes.c_longlong * 18)(*([x.stride(0), x.stride(1), x.stride(2)] * 6))
            err = lib.md_attention_dkv(1, 2, 1, x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                       x.data_ptr(), rows.data_ptr(), rows.data_ptr(),
                                       torch.empty_like(x).data_ptr(),
                                       torch.empty_like(x).data_ptr(), None, strides, 1, 1, 2,
                                       d, 128, 128, ctypes.c_float(0.1), stream)
        assert err != 0 and b"invalid argument" in lib.md_error_string(err)


def test_backward_hopper_body_is_deterministic(cuda):
    """C and D on the Hopper body at the stage-3 shape (16 frames over a
    batch-1 bank, D = 40) and D split at 77 keys: two launches on the same
    inputs give the same bits (no atomics; D's split partials summed in a
    fixed order)."""
    dt = torch.bfloat16
    q, k, v, dout = (_rand(cuda, 16, 4096, 8, 40, dtype=dt, seed=240 + i) for i in range(4))
    kb, vb = (_rand(cuda, 1, 4096, 8, 40, dtype=dt, seed=244 + i) for i in range(2))
    lse = torch.randn(16, 8, 4096, device=cuda) + 8.0
    delta = torch.randn(16, 8, 4096, device=cuda)
    assert torch.equal(V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb, body="wgmma"),
                       V.attention_dq(q, k, v, dout, lse, delta, None, kb, vb, body="wgmma"))
    for kk, vv, nsplit in ((k, v, None), (k[:2, :77], v[:2, :77], None), (kb, vb, 4)):
        qq, oo, ll, dd = (q, dout, lse, delta) if kk.shape[0] != 2 else (
            q[:2], dout[:2], lse[:2], delta[:2])
        first = V.attention_dkv(kk, vv, qq, oo, ll, dd, body="wgmma", nsplit=nsplit)
        again = V.attention_dkv(kk, vv, qq, oo, ll, dd, body="wgmma", nsplit=nsplit)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def _packed_inputs(dev, bg, sq, s, g, d, dtype, blockdiag_heads, seed):
    from magicdance_tpu_torch.ops.kernels import packed as P

    if blockdiag_heads:  # the probe's layout: bg = B * H / G heads packed
        b = bg
        q = _rand(dev, b, sq, g, d, dtype=dtype, seed=seed)
        k, v = (_rand(dev, b, s, g, d, dtype=dtype, seed=seed + 1 + i) for i in range(2))
        return P.pack_heads(q, g), P.blockdiag(k, g), P.blockdiag(v, g)
    qp = _rand(dev, bg, sq, g * d, dtype=dtype, seed=seed)
    kbd, vbd = (_rand(dev, bg, g * s, g * d, dtype=dtype, seed=seed + 1 + i) for i in range(2))
    return qp, kbd, vbd


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bg,sq,s,g,d,blockdiag_heads", [
    (4, 1024, 1024, 3, 40, True),    # the probe's G and D, block-diagonal K/V
    (3, 200, 300, 3, 40, False),     # ragged S and Sq != S, random K/V
    (2, 130, 70, 2, 32, False),      # another packed width (64)
])
def test_packed_attention_matches_plain(cuda, dtype, bg, sq, s, g, d, blockdiag_heads):
    from magicdance_tpu_torch.ops.kernels import packed as P

    qp, kbd, vbd = _packed_inputs(cuda, bg, sq, s, g, d, dtype, blockdiag_heads, seed=120)
    K.reset_launches()
    got = P.packed_attention(qp, kbd, vbd, g)
    assert K.LAUNCHES == {**{name: 0 for name in K.LAUNCHES}, "packed_attention": 1}
    assert got.shape == qp.shape and got.dtype == dtype
    _close(got, P.packed_attention_ref(qp, kbd, vbd, g), dtype)


@pytest.mark.parametrize("bg,sq,s,g,d,blockdiag_heads", [
    (4, 1024, 1024, 3, 40, True),    # the probe's width, G*D = 120: the Hopper body
    (3, 200, 300, 3, 40, False),     # ragged: tiles reach into the next segment
    (8, 1000, 1000, 1, 40, False),   # G = 1, D = 40
    (4, 300, 100, 1, 8, False),      # G*D = 8
    (3, 500, 333, 2, 64, False),     # G*D = 128, the Hopper body's widest
    (4, 1000, 1000, 2, 128, False),  # G*D = 256: routed to attention_tc
])
def test_packed_attention_bodies_match_plain(cuda, bg, sq, s, g, d, blockdiag_heads):
    """bf16 K9 on the body `packed_body` routes it to (the Hopper body of
    attention_wgmma.cuh up to G*D = 128, attention_tc above), one launch
    each, and on attention_tc named explicitly, both against the plain
    version."""
    from magicdance_tpu_torch.ops.kernels import packed as P

    qp, kbd, vbd = _packed_inputs(cuda, bg, sq, s, g, d, torch.bfloat16, blockdiag_heads,
                                  seed=150)
    assert P.packed_body(torch.bfloat16, g * d) == ("wgmma" if g * d <= 128 else "mma_sync")
    want = P.packed_attention_ref(qp, kbd, vbd, g)
    K.reset_launches()
    got = P.packed_attention(qp, kbd, vbd, g)
    assert K.LAUNCHES["packed_attention"] == 1
    _close(got, want, torch.bfloat16)
    _close(P.packed_attention(qp, kbd, vbd, g, body="mma_sync"), want, torch.bfloat16)


def test_packed_attention_hopper_body_refuses_wide_rows(cuda):
    """The Hopper body holds two fp32 accumulators of G*D columns a row in
    registers: named at G*D = 256 it raises, it never falls back."""
    from magicdance_tpu_torch.ops.kernels import packed as P

    qp, kbd, vbd = _packed_inputs(cuda, 2, 64, 64, 2, 128, torch.bfloat16, False, seed=160)
    with pytest.raises(ValueError):
        P.packed_attention(qp, kbd, vbd, 2, body="wgmma")


def test_packed_attention_is_per_head_attention(cuda):
    """On block-diagonal K/V, K9 unpacked equals kernel A per head."""
    from magicdance_tpu_torch.ops.kernels import packed as P

    q, k, v = (_rand(cuda, 2, 512, 6, 40, dtype=torch.bfloat16, seed=130 + i)
               for i in range(3))
    got = P.unpack_heads(P.packed_attention(P.pack_heads(q, 3), P.blockdiag(k, 3),
                                            P.blockdiag(v, 3), 3), 2, 3)
    _close(got, K.self_attention(q, k, v), torch.bfloat16)


def test_packed_attention_rejects_bad_operands(cuda):
    from magicdance_tpu_torch.ops.kernels import packed as P

    qp, kbd, vbd = _packed_inputs(cuda, 2, 64, 64, 3, 40, torch.bfloat16, False, seed=140)
    with pytest.raises(ValueError):  # key rows not G segments
        P.packed_attention(qp, kbd[:, :100], vbd[:, :100], 3)
    with pytest.raises(ValueError):  # mixed dtypes
        P.packed_attention(qp, kbd.float(), vbd, 3)
    with pytest.raises(ValueError):  # a row stride that breaks 16-byte loads
        wide = _rand(cuda, 2, 64, 124, dtype=torch.bfloat16, seed=143)
        P.packed_attention(wide[:, :, :120], kbd, vbd, 3)


def test_kernel_gate_production_cases(cuda):
    """The kernel gate at its production cases (every JAX gate case, the
    main path's shapes at H = 8, K8) through the port's dispatch."""
    from magicdance_tpu_torch.ops.kernel_gate import run_gate

    K.reset_launches()
    assert run_gate() == "ok"
    assert all(K.LAUNCHES[m] > 0 for m in ("self_attention_lse", "two_source_attention_gated",
                                           "attention_dkv", "grouped_bwd", "groupnorm_silu"))


def test_dual_control_request_card_matches_cpu(cuda):
    """A narrow DUAL_CONTROL request at 128x128 (S = 256 at the first level
    reaches kernel A in both ControlNets and the UNet), 3 steps of CFG 7 in
    fp32, pose and image hints: the card equals the CPU within 1e-4 x
    max(1, max |out|) (summation order amplified by CFG)."""
    from magicdance_tpu_torch import config as C
    from magicdance_tpu_torch.pipeline import MagicPosePipeline

    narrow = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                  attention_resolutions=(1, 2), num_heads=2, context_dim=16)
    cfg = C.ModelConfig(variant=C.ModelVariant.DUAL_CONTROL, unet=C.UNetConfig(**narrow),
                        pose_control=C.ControlNetConfig(**narrow),
                        image_control=C.ControlNetConfig(**narrow),
                        vae=C.VAEConfig(base_channels=32, channel_mult=(1, 1, 2, 2),
                                        num_res_blocks=1),
                        clip=C.CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2),
                        latent_size=16, dtype="float32")
    g = torch.Generator().manual_seed(5)
    pose, img = torch.rand(2, 128, 128, 3, generator=g), torch.rand(2, 128, 128, 3, generator=g)
    x_T = torch.randn(2, 16, 16, 4, generator=g)
    cpu = MagicPosePipeline(cfg, device="cpu")
    cpu.init_params(seed=2, scale=0.1)
    gpu = MagicPosePipeline(cfg, device="cuda")
    for name in ("model", "vae", "clip"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    scfg = C.SampleConfig(steps=3)
    want = cpu.sample_frames(pose, None, scfg, x_T=x_T, image_hints=img)
    K.reset_launches()
    got = gpu.sample_frames(pose, None, scfg, x_T=x_T, image_hints=img).cpu()
    # per step: the first level's one site in each ControlNet, three in the
    # cond and three in the uncond pass (no bank, so kernel A only); and the
    # VAE decode's mid attention (S = 256, one head of 64)
    assert K.LAUNCHES["self_attention"] == 3 * (2 * 1 + 2 * 3) + 1
    assert K.LAUNCHES["two_source_attention"] == 0
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err
