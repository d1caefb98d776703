"""CUDA kernels A (self_attention) and B (two_source_attention) against their
plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit and skips without
one. On a machine with a card, from the repository root (this file imports
neither jax nor the JAX package, so the JAX test conftest can be left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: in fp32, max-abs 2e-4 (summation order). In bf16, max-abs
5e-2 (magicdance_tpu/ops/kernel_gate.py:52) and at most a tenth of the RMS of
the plain output: with randn q/k/v the outputs are ~sqrt(e / S_kv), i.e.
0.02-0.1 here, so the fixed bound alone would pass an error the size of the
output, while bf16 rounding of the output stays a few hundredths of its RMS.
"""

import pytest
import torch

from magicdance_tpu_torch.ops import kernels as K

TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-4}
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,sb,bb,d", [
    (2, 4096, 4096, 1, 40), (2, 1024, 1024, 1, 80), (2, 256, 256, 1, 160),
    (2, 1024, 1024, 2, 80), (3, 300, 200, 3, 48), (1, 256, 512, 1, 64),
])
def test_two_source_matches_plain(cuda, dtype, b, s, sb, bb, d):
    h = 8 if d <= 160 else 2
    q, k, v = (_rand(cuda, b, s, h, d, dtype=dtype, seed=i) for i in range(3))
    kb, vb = (_rand(cuda, bb, sb, h, d, dtype=dtype, seed=10 + i) for i in range(2))
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
    assert K.LAUNCHES == {"self_attention": 1, "two_source_attention": 1}


def test_wrappers_reject_bad_operands(cuda):
    q = _rand(cuda, 1, 256, 2, 40, dtype=torch.bfloat16, seed=0)
    with pytest.raises(ValueError):  # head dim not a multiple of 8
        K.self_attention(q[..., :36], q[..., :36], q[..., :36])
    with pytest.raises(ValueError):  # mixed dtypes
        K.self_attention(q, q.float(), q)
    with pytest.raises(ValueError):  # bank batch neither 1 nor B
        big = _rand(cuda, 3, 256, 2, 40, dtype=torch.bfloat16, seed=1)
        K.two_source_attention(big[:2], big[:2], big[:2], big, big)
