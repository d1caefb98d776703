"""Device time of the trainer's frozen encoders (VAE of images and
references, CLIP) over the window (CUDA events around each call), per
image encoded."""

UNIT, BETTER, SOURCE, MOVES = "ms/frame", "lower", "program_span", "train_frames_per_s"


def read(run):
    return run.vae_ms_per_frame if run.kind == "train" else None
