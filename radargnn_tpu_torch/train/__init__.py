"""Training: losses, learning-rate schedules, checkpoints and the Trainer
(port of `radargnn_tpu/train/`)."""
