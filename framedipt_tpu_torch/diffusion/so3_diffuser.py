"""IGSO(3) rotation diffusion on torch tensors: logarithmic sigma schedule,
diffusion coefficient, inverse-CDF sampling, truncated-series score, score
scaling, the forward marginal, and the geodesic-random-walk reverse step (right-multiplication
composition). Lookup tables live on the diffuser's device; every random draw
takes an explicit ``torch.Generator``."""
from __future__ import annotations

import numpy as np
import torch

from framedipt_tpu_torch.diffusion import igso3
from framedipt_tpu_torch.geometry import so3
from framedipt_tpu_torch.geometry.quat import safe_norm
from framedipt_tpu_torch.tools.config import SO3Config
from framedipt_tpu_torch.tools.device import resolve_device

F32 = torch.float32


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of (xp, fp) at x, clamped to the end
    values outside [xp[0], xp[-1]] (``numpy.interp`` semantics; xp
    non-decreasing). Flat segments of xp return the left value."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    flat = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class SO3Diffuser:
    def __init__(self, conf: SO3Config, device: torch.device | str | None = None) -> None:
        self.conf = conf
        self.device = resolve_device(device)
        self.min_sigma = float(conf.min_sigma)
        self.max_sigma = float(conf.max_sigma)
        self.num_sigma = int(conf.num_sigma)
        self.num_omega = int(conf.num_omega)
        if conf.schedule != "logarithmic":
            raise ValueError(f"Unrecognized schedule {conf.schedule}")

        disc_omega = np.linspace(0, np.pi, self.num_omega + 1)[1:]
        disc_sigma = self._sigma_np(np.linspace(0.0, 1.0, self.num_sigma))
        tables = igso3.build_lookup_tables(disc_sigma, disc_omega, cache_dir=conf.cache_dir)

        def put(x):
            return torch.as_tensor(np.asarray(x), dtype=F32, device=self.device)

        self.discrete_omega = put(disc_omega)
        self.discrete_sigma = put(disc_sigma)
        self._cdf = put(tables["cdf"])
        self._score_scaling = put(tables["score_scaling"])
        # exp(max/min sigma) evaluated in float32, as the reference does
        # (held as Python floats so no step copies a scalar to the device).
        self._exp_max = float(torch.exp(torch.tensor(self.max_sigma, dtype=F32)))
        self._exp_min = float(torch.exp(torch.tensor(self.min_sigma, dtype=F32)))
        self._exp_span = float(
            torch.tensor(self._exp_max, dtype=F32) - torch.tensor(self._exp_min, dtype=F32)
        )

    def _t(self, t) -> torch.Tensor:
        if isinstance(t, torch.Tensor):
            return t.to(F32)
        return torch.full((), float(t), dtype=F32, device=self.device)

    def _sigma_np(self, t: np.ndarray) -> np.ndarray:
        return np.log(t * np.exp(self.max_sigma) + (1 - t) * np.exp(self.min_sigma))

    def sigma(self, t) -> torch.Tensor:
        """sigma(t) = log(t e^{max} + (1-t) e^{min})."""
        t = self._t(t)
        return torch.log(t * self._exp_max + (1.0 - t) * self._exp_min)

    def diffusion_coef(self, t) -> torch.Tensor:
        """g(t) = sqrt(2 (e^{max} - e^{min}) sigma(t) / e^{sigma(t)})."""
        sig = self.sigma(t)
        return torch.sqrt(2.0 * self._exp_span * sig / torch.exp(sig))

    def t_to_idx(self, t) -> torch.Tensor:
        """Bucket of sigma(t) in the discrete sigma grid (np.digitize - 1)."""
        return torch.searchsorted(self.discrete_sigma, self.sigma(t), right=True) - 1

    def sample_igso3(self, generator: torch.Generator, t, n: int) -> torch.Tensor:
        """Inverse-CDF sample of the rotation angle; [n] angles."""
        x = torch.rand((n,), generator=generator, device=self.device, dtype=F32)
        cdf_row = self._cdf[self.t_to_idx(t)]
        return interp(x, cdf_row, self.discrete_omega)

    def sample(self, generator: torch.Generator, t, n: int) -> torch.Tensor:
        """[n, 3] rotation vectors ~ IGSO3(t): uniform axis x sampled angle."""
        axis = torch.randn((n, 3), generator=generator, device=self.device, dtype=F32)
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        return axis * self.sample_igso3(generator, t, n)[:, None]

    def sample_ref(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.sample(generator, 1.0, n)

    def score(self, vec: torch.Tensor, t, eps: float = 1e-6) -> torch.Tensor:
        """Score of the IGSO3 density as a rotation vector [..., 3]; ``t`` is
        a scalar or broadcasts over the leading batch dims."""
        omega = safe_norm(vec) + eps
        sigma = self.discrete_sigma[self.t_to_idx(t)]
        while sigma.ndim < omega.ndim:
            sigma = sigma[..., None]
        sigma = torch.broadcast_to(sigma, omega.shape)
        exp_vals = igso3.expansion(omega, sigma)
        omega_score = igso3.score_ratio(exp_vals, omega, sigma)
        return omega_score[..., None] * vec / omega[..., None]

    def score_scaling(self, t) -> torch.Tensor:
        """sqrt(E ||score||^2 / 3) at time t (LUT gather)."""
        return self._score_scaling[self.t_to_idx(t)]

    def forward_marginal(
        self, generator: torch.Generator, rot_0: torch.Tensor, t
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Sample rot_t ~ p(rot_t | rot_0) and its score."""
        return self.marginal_from_sample(rot_0, t, self.sample_like(generator, t, rot_0))

    def sample_like(self, generator: torch.Generator, t, rot_0: torch.Tensor) -> torch.Tensor:
        """IGSO3(t) rotation vectors shaped like rot_0: [..., 3] with a
        scalar t, or [B, ..., 3] with t [B], each sample then drawn at its
        own t, in batch order (axes, then angles)."""
        t = self._t(t)
        if t.ndim == 0:
            return self.sample(generator, t, rot_0[..., 0].numel()).reshape(rot_0.shape)
        n = rot_0[0, ..., 0].numel()
        return torch.stack([self.sample(generator, t_b, n) for t_b in t]).reshape(rot_0.shape)

    def marginal_from_sample(
        self, rot_0: torch.Tensor, t, sampled: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The forward marginal given the IGSO3(t) rotation vectors
        ``sampled`` (shaped like rot_0): (rot_0 composed with sampled, the
        score of sampled)."""
        return so3.compose_rotvec(rot_0, sampled), self.score(sampled, t)

    def reverse(
        self,
        rot_t: torch.Tensor,
        score_t: torch.Tensor,
        t,
        dt: float,
        z: torch.Tensor,
        diffuse_mask: torch.Tensor | None = None,
        noise_scale: float = 1.0,
    ) -> torch.Tensor:
        """One reverse step of the geodesic random walk; ``z`` is the
        standard-normal noise, shaped like ``score_t``."""
        g_t = self.diffusion_coef(t)
        z = noise_scale * z
        perturb = (g_t**2) * score_t * dt + g_t * np.sqrt(dt) * z
        if diffuse_mask is not None:
            perturb = perturb * diffuse_mask[..., None]
        return so3.compose_rotvec(rot_t, perturb)
