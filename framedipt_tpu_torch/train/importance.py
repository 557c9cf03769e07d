"""Loss-aware timestep importance sampling (numpy, on the host).

A per-bin history of recent losses; once every bin holds a full history,
timesteps are drawn in proportion to sqrt(E[loss^2]) per bin (mixed with a
small uniform share) and the loss is weighted by 1/p to stay unbiased. The
same state and the same draws as the JAX package's ``train/importance.py``.
"""
from __future__ import annotations

import numpy as np


class TimestepImportanceSampler:
    def __init__(
        self,
        num_bins: int = 100,
        history_per_term: int = 10,
        min_t: float = 0.01,
        uniform_prob: float = 1e-3,
    ) -> None:
        self.num_bins = num_bins
        self.history_per_term = history_per_term
        self.min_t = min_t
        self.uniform_prob = uniform_prob
        self._history = np.zeros((num_bins, history_per_term))
        self._count = np.zeros(num_bins, np.int64)

    @property
    def warmed_up(self) -> bool:
        return bool((self._count >= self.history_per_term).all())

    def _weights(self) -> np.ndarray:
        if not self.warmed_up:
            return np.ones(self.num_bins) / self.num_bins
        w = np.sqrt((self._history**2).mean(axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_bins

    def sample(self, rng: np.random.Generator, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """(t [B] in [min_t, 1), loss weights [B]), float32."""
        w = self._weights()
        bins = rng.choice(self.num_bins, size=batch_size, p=w)
        u = rng.random(batch_size)
        t = self.min_t + (bins + u) / self.num_bins * (1.0 - self.min_t)
        # Unbiased: uniform density / sampling density = 1 / (w[bin] num_bins).
        loss_weights = 1.0 / (w[bins] * self.num_bins)
        return t.astype(np.float32), loss_weights.astype(np.float32)

    def update(self, t: np.ndarray, losses: np.ndarray) -> None:
        bins = np.clip(
            ((t - self.min_t) / (1.0 - self.min_t) * self.num_bins).astype(int),
            0, self.num_bins - 1,
        )
        for b, loss in zip(bins, losses):
            self._history[b, self._count[b] % self.history_per_term] = loss
            self._count[b] += 1
