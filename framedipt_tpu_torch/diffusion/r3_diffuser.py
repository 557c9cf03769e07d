"""VP-SDE translation diffusion on torch tensors: linear beta(t), coordinate
scaling, score / score scaling, the closed-form forward marginal, NaN-safe
stationary sampling, and the Euler-Maruyama reverse step with the reference's centering convention (the
COM sums all residues but divides by the diffused count)."""
from __future__ import annotations

import math

import torch

from framedipt_tpu_torch.tools.config import R3Config


def _expand(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Right-pad t's shape with singleton dims to broadcast against ref."""
    while t.ndim < ref.ndim:
        t = t[..., None]
    return t


class R3Diffuser:
    def __init__(self, conf: R3Config) -> None:
        self.conf = conf
        self.min_b = float(conf.min_b)
        self.max_b = float(conf.max_b)
        self.coordinate_scaling = float(conf.coordinate_scaling)

    def scale(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.coordinate_scaling

    def unscale(self, x: torch.Tensor) -> torch.Tensor:
        return x / self.coordinate_scaling

    def b_t(self, t: torch.Tensor) -> torch.Tensor:
        return self.min_b + t * (self.max_b - self.min_b)

    def diffusion_coef(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.b_t(t))

    def drift_coef(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return -0.5 * self.b_t(t) * x

    def marginal_b_t(self, t: torch.Tensor) -> torch.Tensor:
        return t * self.min_b + 0.5 * t**2 * (self.max_b - self.min_b)

    def conditional_var(self, t: torch.Tensor) -> torch.Tensor:
        """Var[x_t | x_0] = 1 - exp(-marginal_b_t)."""
        return 1.0 - torch.exp(-self.marginal_b_t(t))

    def score_scaling(self, t: torch.Tensor) -> torch.Tensor:
        return 1.0 / torch.sqrt(self.conditional_var(t))

    def score(
        self,
        x_t: torch.Tensor,
        x_0: torch.Tensor,
        t: torch.Tensor,
        scale: bool = False,
    ) -> torch.Tensor:
        if scale:
            x_t, x_0 = self.scale(x_t), self.scale(x_0)
        tb = _expand(t, x_t)
        return -(x_t - torch.exp(-0.5 * self.marginal_b_t(tb)) * x_0) / (
            self.conditional_var(tb)
        )

    def calc_trans_0(
        self, score_t: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor
    ) -> torch.Tensor:
        """Recover x_0 from x_t and the score."""
        tb = _expand(t, x_t)
        beta_t = self.marginal_b_t(tb)
        cond_var = 1.0 - torch.exp(-beta_t)
        return (score_t * cond_var + x_t) / torch.exp(-0.5 * beta_t)

    def forward_marginal(
        self,
        generator: torch.Generator,
        x_0: torch.Tensor,
        t,
        diffuse_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Sample x_t ~ p(x_t | x_0) in closed form; returns (x_t, score_t).
        x_0 in Angstroms; t a scalar or one time per leading batch entry."""
        z = torch.randn(x_0.shape, generator=generator, device=x_0.device, dtype=x_0.dtype)
        return self.marginal_from_noise(x_0, t, z, diffuse_mask)

    def marginal_from_noise(
        self,
        x_0: torch.Tensor,
        t,
        z: torch.Tensor,
        diffuse_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The forward marginal given its standard-normal noise ``z``: the
        score is in scaled coordinates; masked residues keep x_0 and get a
        zero score."""
        t = torch.as_tensor(t, dtype=x_0.dtype, device=x_0.device)
        x_0_scaled = self.scale(x_0)
        tb = _expand(t, x_0)
        loc = torch.exp(-0.5 * self.marginal_b_t(tb)) * x_0_scaled
        std = torch.sqrt(1.0 - torch.exp(-self.marginal_b_t(tb)))
        x_t_scaled = loc + std * z
        score_t = self.score(x_t_scaled, x_0_scaled, t, scale=False)
        x_t = self.unscale(x_t_scaled)
        if diffuse_mask is not None:
            m = diffuse_mask[..., None]
            x_t = m * x_t + (1.0 - m) * x_0
            score_t = m * score_t
        return x_t, score_t

    def sample_stationary(
        self,
        generator: torch.Generator,
        x_reference: torch.Tensor,
        diffuse_mask: torch.Tensor | None,
    ) -> torch.Tensor:
        """Sample p(x_T) = N(0, I) in the diffused region, keeping the fixed
        region from x_reference (selected with ``where``, NaN-safe)."""
        if diffuse_mask is None:
            mask = torch.ones(x_reference.shape[:-1], dtype=torch.bool, device=x_reference.device)
        else:
            mask = diffuse_mask.to(torch.bool)
        noise = torch.randn(
            x_reference.shape, generator=generator, device=x_reference.device,
            dtype=x_reference.dtype,
        )
        out_scaled = torch.where(mask[..., None], noise, self.scale(x_reference))
        return self.unscale(out_scaled)

    def reverse(
        self,
        x_t: torch.Tensor,
        score_t: torch.Tensor,
        t: torch.Tensor,
        dt: float,
        z: torch.Tensor,
        diffuse_mask: torch.Tensor | None = None,
        noise_scale: float = 1.0,
    ) -> torch.Tensor:
        """One reverse Euler-Maruyama step, centred on the COM; ``z`` is the
        standard-normal noise, shaped like ``score_t``."""
        x = self.scale(x_t)
        g_t = self.diffusion_coef(t)
        f_t = self.drift_coef(x, t)
        z = noise_scale * z
        perturb = (f_t - g_t**2 * score_t) * dt + g_t * math.sqrt(dt) * z
        if diffuse_mask is not None:
            perturb = perturb * diffuse_mask[..., None]
            mask = diffuse_mask
        else:
            mask = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
        x_t_1 = x - perturb
        com = torch.sum(x_t_1, dim=-2) / torch.sum(mask, dim=-1)[..., None]
        return self.unscale(x_t_1 - com[..., None, :])
