"""Low-level metric math: L1/MAE, PSNR, SSIM, Frechet distance (PyTorch).

Counterpart of `magicdance_tpu.metrics.core` (the DisCo metric suite's
pure-math pieces, ref: tool/metrics/ssim_l1_lpips_psnr.py:38
compute_ssim_l1_psnr -- L1 on [0,1] arrays, skimage-convention SSIM (7x7
uniform window, channel-averaged) and PSNR; tool/cleanfid/fid.py
frechet_distance). Images are (B, H, W, C) tensors at the API, as in JAX;
the results are 0-d fp32 tensors on the inputs' device. The Frechet and
inception-score statistics are numpy/scipy, as in JAX.

`seeded_init` draws the weights of a metric net built without a weights file
(smoke mode: its scores are not comparable to published ones).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.device import full_fp32


def l1_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain mean absolute error over all pixels; inputs in [0, 1].
    (DisCo's reported 'L1' uses a different normalization -- mean |a-b| on
    0-255 pixels divided by H*W, ref ssim_l1_lpips_psnr.py:31-34 -- which
    metrics/center.py reproduces for the `l1` key; this function backs the
    `mae` key.)"""
    return torch.mean(torch.abs(a.float() - b.float()))


mae = l1_error


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio, per skimage convention."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10((data_range ** 2) / torch.clamp(mse, min=1e-12))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """win x win mean filter, valid padding. x: (B, H, W, C).

    Runs in full fp32 (TF32 off): SSIM's `uxx - ux*ux` variance cancellation
    goes negative on near-constant windows when the window sums are taken
    at reduced precision, which gives per-pixel SSIM values far outside
    [-1, 1] and a folder score above the bound of 1."""
    c = x.shape[-1]
    kern = torch.ones((c, 1, win, win), dtype=x.dtype, device=x.device) / (win * win)
    with full_fp32():
        y = F.conv2d(x.permute(0, 3, 1, 2), kern, groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    data_range: float = 1.0,
    win: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity, skimage defaults (uniform 7x7 window, sample
    covariance normalization, channel-averaged). a/b: (B, H, W, C) in
    [0, data_range]."""
    a = a.float()
    b = b.float()
    C1 = (k1 * data_range) ** 2
    C2 = (k2 * data_range) ** 2
    NP = win * win
    cov_norm = NP / (NP - 1)

    ux = _uniform_filter(a, win)
    uy = _uniform_filter(b, win)
    uxx = _uniform_filter(a * a, win)
    uyy = _uniform_filter(b * b, win)
    uxy = _uniform_filter(a * b, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2)
    )
    return torch.mean(s)


def gaussian_frechet_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a feature matrix (N, D)."""
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """FID/FVD core: ||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))
    (ref tool/cleanfid/fid.py frechet_distance; standard Heusel et al.).

    `sqrtm` is called without `disp` (the JAX copy passes disp=False, which
    SciPy 1.18 removed): the same square root on every SciPy."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def inception_score_from_logits(logits: np.ndarray, splits: int = 10) -> tuple[float, float]:
    """IS from class logits (N, 1000) (ref tool/inception_score.py)."""
    from scipy.stats import entropy

    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = probs / probs.sum(axis=1, keepdims=True)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        py = part.mean(axis=0)
        scores.append(np.exp(np.mean([entropy(p, py) for p in part])))
    return float(np.mean(scores)), float(np.std(scores))


@torch.no_grad()
def seeded_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights for a metric net built without a weights file: every
    conv or linear weight N(0, 1/fan_in), norm scales 1, biases 0, other
    parameters (class and position embeddings) N(0, 0.02^2); drawn on the
    CPU from one generator, so every device gets the same net."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.ndim >= 2:
            fan_in = p[0].numel()
            v = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
        elif leaf == "weight":
            v = torch.ones(p.shape)
        elif leaf == "bias":
            v = torch.zeros(p.shape)
        else:
            v = torch.randn(p.shape, generator=gen) * 0.02
        p.copy_(v)
    return module


def as_tensor(x) -> torch.Tensor:
    """A state-dict value (torch tensor or numpy array) as an fp32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float()
    return torch.from_numpy(np.asarray(x, dtype=np.float32))
