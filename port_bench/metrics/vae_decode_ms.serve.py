"""Device time of the pipeline's VAE decode over the window (CUDA events
around each call), per frame decoded."""

UNIT, BETTER, SOURCE, MOVES = "ms/frame", "lower", "program_span", "frames_per_s"


def read(run):
    return run.vae_ms_per_frame if run.kind == "serve" else None
