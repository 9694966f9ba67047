"""MLPs, conv layers and DetNet."""
