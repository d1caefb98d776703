"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Both sides get the same inputs and the same weights: inputs are drawn with
numpy from a seed, weights are a JAX parameter tree with EVERY leaf drawn at
random (the zero-initialised output convs included -- otherwise the UNet
output is exactly 0 and the bank and pose branches have no effect), carried
into the port by `magicdance_tpu_torch.convert.from_jax`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import magicdance_tpu.config as jcfg
import magicdance_tpu_torch.config as tcfg

@pytest.fixture(scope="module", autouse=True)
def torch_single_thread():
    """The tiny configs gain nothing from intra-op threads; one thread keeps
    these modules from crowding the other test processes that share the
    machine. Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1, 2), num_heads=2, context_dim=16)


def tiny_model_cfg_jax() -> jcfg.ModelConfig:
    """The verify recipe's tiny config: 8x8 latent (64x64 image), fp32."""
    return jcfg.ModelConfig(
        variant=jcfg.ModelVariant.APPEARANCE_POSE,
        unet=jcfg.UNetConfig(**TINY_UNET),
        pose_control=jcfg.ControlNetConfig(**TINY_UNET),
        vae=jcfg.VAEConfig(base_channels=32, channel_mult=(1, 1, 2, 2),
                           num_res_blocks=1),
        clip=jcfg.CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2),
        latent_size=8,
        dtype="float32",
    )


def port_cfg(cfg):
    """The same configuration as the port's dataclass (via to_dict/from_dict)."""
    return tcfg.from_dict(getattr(tcfg, type(cfg).__name__), jcfg.to_dict(cfg))


def randomize(tree, seed: int):
    """Every leaf of a (nested dict) parameter tree drawn from numpy: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases and embeddings
    N(0, 0.1^2). Returns a tree of numpy float32 arrays."""
    rs = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rs.standard_normal(shape) / np.sqrt(fan_in)
            elif k == "scale":
                a = 1.0 + 0.1 * rs.standard_normal(shape)
            else:
                a = 0.1 * rs.standard_normal(shape)
            out[k] = a.astype(np.float32)
        return out

    return walk(tree)


def np_rand(shape, seed: int, lo: float = None, hi: float = None) -> np.ndarray:
    rs = np.random.RandomState(seed)
    if lo is None:
        return rs.standard_normal(shape).astype(np.float32)
    return (lo + (hi - lo) * rs.random_sample(shape)).astype(np.float32)


def to_t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def assert_close(got, want, atol: float, rtol: float) -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)
