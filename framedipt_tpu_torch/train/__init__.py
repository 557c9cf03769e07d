"""Training: the denoising score-matching losses and one train step."""
