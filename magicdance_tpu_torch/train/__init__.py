"""Training: the one-device trainer and checkpoints."""
