"""SE(3) diffusion: IGSO(3) rotation + VP-SDE translation diffusion."""

from framedipt_tpu_torch.diffusion.r3_diffuser import R3Diffuser
from framedipt_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from framedipt_tpu_torch.diffusion.so3_diffuser import SO3Diffuser

__all__ = ["R3Diffuser", "SO3Diffuser", "SE3Diffuser"]
