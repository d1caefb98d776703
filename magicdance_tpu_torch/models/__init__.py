"""Networks of the port: UNet, pose ControlNet, composite denoiser, VAE, CLIP."""

from magicdance_tpu_torch.models.clip import CLIPTextEncoder  # noqa: F401
from magicdance_tpu_torch.models.magicpose import MagicPoseModel  # noqa: F401
from magicdance_tpu_torch.models.vae import AutoencoderKL  # noqa: F401
