"""Training: train and serve steps, and the restartable training loop."""
