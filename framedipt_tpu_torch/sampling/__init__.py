"""Reverse-SDE sampler."""

from framedipt_tpu_torch.sampling.reverse import sample

__all__ = ["sample"]
