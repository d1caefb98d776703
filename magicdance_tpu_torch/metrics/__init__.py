from magicdance_tpu_torch.metrics.core import (
    frechet_distance,
    l1_error,
    mae,
    psnr,
    ssim,
)
