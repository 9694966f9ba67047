"""Box algebra and inference."""
