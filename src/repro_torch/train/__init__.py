"""Training substrate of the port: AdamW, the synthetic data recipe,
checkpoints, the step watchdog and the training loop."""
