"""Geometry core: quaternion algebra, SO(3) maps, rigid frames, backbone
reconstruction."""

from framedipt_tpu_torch.geometry import frames, quat, rigid, so3
from framedipt_tpu_torch.geometry.rigid import Rigid

__all__ = ["frames", "quat", "rigid", "so3", "Rigid"]
