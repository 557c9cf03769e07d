"""IGSO(3) rotation diffusion on torch tensors: logarithmic sigma schedule,
diffusion coefficient, inverse-CDF sampling, the score (truncated series or table), score
scaling, the forward marginal, the geodesic-random-walk reverse step (right-multiplication
composition), one forward noising step, and the Gaussian log-densities of a
step in either direction (the EigenFold confidence score). Lookup tables
live on the diffuser's device; every random draw takes an explicit
``torch.Generator`` or is handed in as noise."""
from __future__ import annotations

import numpy as np
import torch

from framedipt_tpu_torch.diffusion import igso3
from framedipt_tpu_torch.geometry import so3
from framedipt_tpu_torch.geometry.quat import safe_norm
from framedipt_tpu_torch.tools.config import SO3Config
from framedipt_tpu_torch.tools.device import resolve_device

F32 = torch.float32


def gaussian_log_prob(
    mu: torch.Tensor,
    std: torch.Tensor,
    x: torch.Tensor,
    diffuse_mask: torch.Tensor | None,
) -> torch.Tensor:
    """Isotropic Gaussian log-density of ``x`` [..., 3], summed over every
    entry, each residue weighted by ``diffuse_mask``."""
    var = std**2
    log_p = -0.5 * ((x - mu) ** 2 / var + torch.log(2.0 * torch.pi * var))
    if diffuse_mask is not None:
        log_p = log_p * diffuse_mask[..., None]
    return torch.sum(log_p)


def align_rotation_vectors(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``inputs`` flipped to the hemisphere of ``targets``: where the two
    axes point apart, the negated axis with the complementary angle
    2 pi - |omega| (the same rotation)."""
    in_angle = torch.linalg.norm(inputs, dim=-1, keepdim=True)
    in_axis = inputs / torch.clamp(in_angle, min=1e-12)
    tgt_axis = targets / torch.clamp(torch.linalg.norm(targets, dim=-1, keepdim=True), min=1e-12)
    sign = torch.sign(torch.sum(tgt_axis * in_axis, dim=-1, keepdim=True))
    new_angle = torch.where(sign > 0, in_angle, 2.0 * torch.pi - in_angle)
    return in_axis * sign * new_angle


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
        self.use_cached_score = bool(conf.use_cached_score)
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
        self._score_norms = put(tables["score_norms"])
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
        a scalar or broadcasts over the leading batch dims. The truncated
        series by default; with ``use_cached_score`` the score-norm table's
        entry for sigma(t) and the omega bucket (searchsorted-left over the
        grid without its last edge)."""
        omega = safe_norm(vec) + eps
        if self.use_cached_score:
            norms = self._score_norms[self.t_to_idx(t)]  # [..., num_omega]
            idx = torch.clamp(
                torch.searchsorted(self.discrete_omega[:-1], omega),
                0, self.num_omega - 1,
            )
            if norms.ndim == 1:
                omega_score = norms[idx]
            else:
                omega_score = torch.take_along_dim(norms, idx, dim=-1)
            return omega_score[..., None] * vec / omega[..., None]
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

    def forward(
        self,
        rot_t_1: torch.Tensor,
        t_1,
        dt: float,
        z: torch.Tensor,
        diffuse_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One forward (noising) step of the geodesic random walk; ``z`` is
        the standard-normal noise, shaped like ``rot_t_1``."""
        perturb = self.diffusion_coef(t_1) * np.sqrt(dt) * z
        if diffuse_mask is not None:
            perturb = perturb * diffuse_mask[..., None]
        return so3.compose_rotvec(rot_t_1, perturb)

    def distribution(
        self,
        rot_t: torch.Tensor,
        score_t: torch.Tensor,
        t,
        dt: float,
        diffuse_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, std) of the reverse step from rot_t: the mean is rot_t
        composed with the drift."""
        g_t = self.diffusion_coef(t)
        drift = (g_t**2) * score_t * dt
        if diffuse_mask is not None:
            drift = drift * diffuse_mask[..., None]
        return so3.compose_rotvec(rot_t, drift), g_t * np.sqrt(dt)

    def log_prob_forward(
        self,
        rot_t: torch.Tensor,
        rot_t_1: torch.Tensor,
        t_1,
        dt: float,
        diffuse_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """log p(rot_t | rot_t_1) of the forward step, as a Gaussian in the
        rotation vectors, rot_t aligned to rot_t_1's hemisphere."""
        std = self.diffusion_coef(t_1) * np.sqrt(dt)
        return gaussian_log_prob(
            rot_t_1, std, align_rotation_vectors(rot_t, rot_t_1), diffuse_mask
        )

    def log_prob_backward(
        self,
        rot_t: torch.Tensor,
        rot_t_1: torch.Tensor,
        score_t: torch.Tensor,
        t,
        dt: float,
        diffuse_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """log p(rot_t_1 | rot_t) of the reverse step with score ``score_t``."""
        mu, std = self.distribution(rot_t, score_t, t, dt, diffuse_mask)
        return gaussian_log_prob(mu, std, align_rotation_vectors(rot_t_1, mu), diffuse_mask)
