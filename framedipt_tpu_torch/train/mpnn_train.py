"""ProteinMPNN's train and eval steps.

The port of the JAX package's ``train/mpnn_train.py``, the training contract
of the reference ProteinMPNN's training scripts:

- the label-smoothed negative log-likelihood summed over the valid positions
  and divided by the fixed 2000 (:func:`smoothed_loss`), which the step
  minimises, and the mask-averaged NLL and argmax accuracy that it reports
  (:func:`nll_and_accuracy`), both over ``mask * chain_M``;
- Adam(0.9, 0.98, eps 1e-9) at the Noam rate (:func:`noam_schedule`,
  factor 2, warmup 4000), after an optional global-norm clip;
- backbone noise (``MPNNConfig.augment_eps``) and dropout
  (``MPNNConfig.dropout``) in training, and a fresh random decoding order a
  step.

Randomness comes from one ``torch.Generator`` on the model's device, drawn
in this order: the backbone noise (when ``augment_eps`` > 0), the
decoding-order ``randn``, the dropout masks (encoder layers, then decoder
layers). A step takes the noise and the ``randn`` as tensors instead where
they are handed in. ``augment_eps`` 0 means no noise.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.nn import functional as F

from framedipt_tpu_torch.model import mpnn
from framedipt_tpu_torch.train.loop import ClippedAdam

# The reference's normaliser of the smoothed loss: a fixed token count, not
# the batch's.
LOSS_NORMALISER = 2000.0


def noam_schedule(d_model: int, factor: float = 2.0,
                  warmup: int = 4000) -> Callable[[int], float]:
    """lr(count) = factor d_model^-0.5 min(step^-0.5, step warmup^-1.5) with
    step = count + 1: ``count`` is the number of updates already applied,
    so the first update runs at step 1."""

    def schedule(count: int) -> float:
        step = max(count + 1, 1)
        return factor * d_model ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)

    return schedule


def make_mpnn_optimizer(params, gradient_norm: float = -1.0) -> ClippedAdam:
    """Adam(0.9, 0.98, eps 1e-9), clipping by the global norm first when
    ``gradient_norm`` > 0. The caller sets the learning rate each step."""
    return ClippedAdam(params, lr=0.0, max_grad_norm=gradient_norm, betas=(0.9, 0.98), eps=1e-9)


def smoothed_loss(s: torch.Tensor, log_probs: torch.Tensor, mask: torch.Tensor,
                  weight: float = 0.1) -> torch.Tensor:
    """Label-smoothed cross entropy (one-hot plus weight / vocab,
    renormalised) summed over the positions of ``mask``, over 2000."""
    vocab = log_probs.shape[-1]
    target = F.one_hot(s.long(), vocab).to(log_probs.dtype) + weight / vocab
    target = target / target.sum(dim=-1, keepdim=True)
    loss = -(target * log_probs).sum(dim=-1)
    return (loss * mask).sum() / LOSS_NORMALISER


def nll_and_accuracy(s: torch.Tensor, log_probs: torch.Tensor,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The mask-averaged negative log-likelihood of ``s`` and the
    mask-weighted share of positions whose argmax is ``s``."""
    s = s.long()
    nll = -torch.gather(log_probs, -1, s[..., None])[..., 0]
    total = mask.sum()
    acc = ((log_probs.argmax(dim=-1) == s).to(mask.dtype) * mask).sum() / total
    return (nll * mask).sum() / total, acc


def _inputs(batch: dict) -> tuple:
    return (batch["X"], batch["S"], batch["mask"], batch["chain_M"], batch["residue_idx"],
            batch["chain_encoding_all"])


class MPNNTrainer:
    """A model, its optimizer and the count of updates applied. ``batch``
    is a dict of tensors on the model's device: X [B, L, 4, 3] (CA-only
    [B, L, 3]), S [B, L], mask, chain_M, residue_idx and chain_encoding_all
    [B, L]."""

    def __init__(self, model: mpnn.ProteinMPNN, gradient_norm: float = -1.0) -> None:
        self.model = model
        self.optimizer = make_mpnn_optimizer(model.parameters(), gradient_norm)
        self.schedule = noam_schedule(model.cfg.hidden_dim)
        self.step_count = 0

    def step(self, batch: dict, generator: torch.Generator, randn: torch.Tensor | None = None,
             noise: torch.Tensor | None = None) -> dict:
        """One update. Returns the step's loss, nll, accuracy and grad_norm
        (the norm before clipping) as tensors and the learning rate it
        applied, ``lr``, as a float. The gradients stay in the parameters'
        ``.grad`` (clipped where the norm was clipped)."""
        model = self.model
        x, s, mask, chain_m, residue_idx, chain_enc = _inputs(batch)
        if noise is None and model.cfg.augment_eps > 0:
            noise = torch.randn(x.shape, generator=generator, device=x.device)
        if randn is None:
            randn = torch.randn(s.shape, generator=generator, device=x.device)
        model.train()
        log_probs = mpnn.mpnn_log_probs(model, x, s, mask, chain_m, residue_idx, chain_enc,
                                        randn=randn, noise=noise, dropout=generator)
        mask_full = mask * chain_m
        loss = smoothed_loss(s, log_probs, mask_full)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = self.schedule(self.step_count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        grad_norm = self.optimizer.step()
        self.step_count += 1
        nll, acc = nll_and_accuracy(s, log_probs.detach(), mask_full)
        return {"loss": loss.detach(), "nll": nll, "accuracy": acc, "grad_norm": grad_norm,
                "lr": lr}

    @torch.no_grad()
    def eval_step(self, batch: dict, generator: torch.Generator,
                  randn: torch.Tensor | None = None) -> dict:
        """The validation pass: a random decoding order (``randn``, drawn
        when not handed in), no noise, no dropout. Returns nll and
        accuracy over mask * chain_M as tensors."""
        x, s, mask, chain_m, residue_idx, chain_enc = _inputs(batch)
        if randn is None:
            randn = torch.randn(s.shape, generator=generator, device=x.device)
        self.model.eval()
        log_probs = mpnn.mpnn_log_probs(self.model, x, s, mask, chain_m, residue_idx, chain_enc,
                                        randn=randn)
        nll, acc = nll_and_accuracy(s, log_probs, mask * chain_m)
        return {"nll": nll, "accuracy": acc}
