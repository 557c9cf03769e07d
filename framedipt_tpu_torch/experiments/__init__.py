"""Entry points: the inpainting HTTP service."""
