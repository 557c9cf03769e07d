"""Dense layers with a compute dtype, in the reference's torch layout.

Parameters stay float32 (``weight`` [out, in], ``bias`` [out], the reference
state_dict layout). A layer built with ``dtype=torch.bfloat16`` casts input
and parameters to bf16, accumulates the product in float32 and rounds the
result to bf16; LayerNorm statistics are always float32 (eps 1e-6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class Linear(nn.Linear):
    """nn.Linear whose forward runs in ``dtype`` (float32 by default)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(dim, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(self.compute_dtype)


def layer_norm_f32(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, float32 out."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + eps) * scale + bias


def mlp3_layer_norm(in_dim: int, width: int, dtype: torch.dtype) -> nn.Sequential:
    """Linear-ReLU-Linear-ReLU-Linear-LayerNorm (reference indices 0..5)."""
    return nn.Sequential(
        Linear(in_dim, width, dtype=dtype), nn.ReLU(),
        Linear(width, width, dtype=dtype), nn.ReLU(),
        Linear(width, width, dtype=dtype), LayerNorm(width, dtype=dtype),
    )
