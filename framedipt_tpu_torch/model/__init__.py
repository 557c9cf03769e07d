"""Score network (embedder + IPA trunk) with the CUDA edge-stack kernels."""

from framedipt_tpu_torch.model.score_network import ScoreNetwork

__all__ = ["ScoreNetwork"]
