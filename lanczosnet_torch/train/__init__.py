"""Training: steps, optimizer, checkpoints and runners."""
