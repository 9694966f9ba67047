"""Ground truth and synthetic frames."""
