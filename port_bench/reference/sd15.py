"""The SD1.5 MagicPose reference family, the one a configuration file holds
the program to when it names no `"reference"`: the networks of `model.py`
(UNet with the appearance bank, pose ControlNet, KL VAE, one CLIP ViT-L/14
tower), the DDIM sampler of `sample.py` and the training step of
`train.py`, behind the interface that `harness.spec.reference_family`
resolves."""

from __future__ import annotations

from port_bench.reference import sample as _sample
from port_bench.reference.model import VAE, CLIPText, MagicPose, Numerics
from port_bench.reference.sample import decode
from port_bench.reference.train import ReferenceTrainer

__all__ = ["MagicPose", "VAE", "CLIPText", "ReferenceTrainer", "decode", "networks", "sample"]


def networks(model_cfg: dict, num: Numerics = Numerics()) -> dict:
    """The networks on the meta device, parameters named as the program's
    state-dict keys."""
    return {"model": MagicPose(model_cfg, num), "vae": VAE(model_cfg["vae"]),
            "clip": CLIPText(model_cfg["clip"])}


def sample(nets: dict, model_cfg: dict, pose, ref_image, x_T, steps: int, scale: float,
           num: Numerics, video: bool = False, offsets=None, window: int = 16,
           stride: int = 12):
    """`sample.sample` over the networks of `networks`."""
    return _sample.sample(nets["model"], nets["vae"], nets["clip"], model_cfg, pose, ref_image,
                          x_T, steps, scale, num, video=video, offsets=offsets, window=window,
                          stride=stride)
