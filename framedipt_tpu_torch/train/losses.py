"""Denoising score-matching losses for SE(3) diffusion training, line for
line as the JAX package computes them.

Translation score loss (or the x0 loss below ``trans_x0_threshold``),
rotation loss split into axis and angle (the angle term gated by
``rot_loss_t_threshold``) or one score loss, and the auxiliary backbone-atom
and pairwise-distance losses gated at small t; the pairwise term keeps only
ground-truth pairs under 6 A, in its numerator and its denominator. Every
loss is a masked mean over the diffused region (res_mask * (1 -
fixed_mask)).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from framedipt_tpu_torch.geometry.quat import safe_norm
from framedipt_tpu_torch.tools.config import ExperimentConfig

F32 = torch.float32


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    return torch.sum(x * mask, dim=dim) / (torch.sum(mask, dim=dim) + 1e-10)


def score_matching_losses(
    pred: dict[str, torch.Tensor],
    batch: dict[str, torch.Tensor],
    exp_conf: ExperimentConfig,
    diffuse_rot: bool = True,
    diffuse_trans: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss and the per-term dict.

    ``batch``: trans_score, rot_score [B,N,3], trans_score_scaling,
    rot_score_scaling [B], t [B], res_mask, fixed_mask [B,N], rigids_0
    [B,N,7], atom14_gt [B,N,14,3] (idealized backbone from the clean
    frames). ``pred``: trans_score, rot_score, rigids, atom14."""
    t = batch["t"]
    res_mask = batch["res_mask"].to(F32)
    loss_mask = res_mask * (1.0 - batch["fixed_mask"].to(F32))
    batch_size = res_mask.shape[0]

    # ---------------- translation ----------------
    trans_scale = batch["trans_score_scaling"][:, None, None]
    gt_ts, pred_ts = batch["trans_score"], pred["trans_score"]
    trans_score_mse = torch.sum(((gt_ts - pred_ts) / trans_scale) ** 2, dim=-1)
    trans_score_loss = _masked_mean(trans_score_mse, loss_mask, dim=-1)

    # x0-parameterized loss in scaled coordinates.
    coord_scale = exp_conf.coordinate_scaling
    gt_trans_x0 = batch["rigids_0"][..., 4:] * coord_scale
    pred_trans_x0 = pred["rigids"][..., 4:] * coord_scale
    trans_x0_mse = torch.sum((gt_trans_x0 - pred_trans_x0) ** 2, dim=-1)
    trans_x0_loss = _masked_mean(trans_x0_mse, loss_mask, dim=-1)

    use_x0 = (t < exp_conf.trans_x0_threshold).to(F32)
    trans_loss = (
        trans_x0_loss * use_x0 + trans_score_loss * (1.0 - use_x0)
    ) * exp_conf.trans_loss_weight
    trans_loss = trans_loss * float(diffuse_trans)

    # ---------------- rotation ----------------
    gt_rs, pred_rs = batch["rot_score"], pred["rot_score"]
    rot_scale = batch["rot_score_scaling"][:, None, None]
    if exp_conf.separate_rot_loss:
        gt_angle = safe_norm(gt_rs, keepdim=True)
        pred_angle = safe_norm(pred_rs, keepdim=True)
        gt_axis = gt_rs / (gt_angle + 1e-6)
        pred_axis = pred_rs / (pred_angle + 1e-6)
        axis_loss = _masked_mean(torch.sum((gt_axis - pred_axis) ** 2, dim=-1), loss_mask, dim=-1)
        angle_mse = torch.sum(((gt_angle - pred_angle) / rot_scale) ** 2, dim=-1)
        angle_loss = _masked_mean(angle_mse, loss_mask, dim=-1) * exp_conf.rot_loss_weight
        angle_loss = angle_loss * (t > exp_conf.rot_loss_t_threshold).to(F32)
        rot_loss = axis_loss + angle_loss
    else:
        rot_mse = torch.sum(((gt_rs - pred_rs) / rot_scale) ** 2, dim=-1)
        rot_loss = _masked_mean(rot_mse, loss_mask, dim=-1) * exp_conf.rot_loss_weight
    rot_loss = rot_loss * float(diffuse_rot)

    # ---------------- auxiliary: backbone atoms ----------------
    # atom14 slots 0-4 = N, CA, C, O, CB.
    gt_bb = batch["atom14_gt"][..., :5, :]
    pred_bb = pred["atom14"][..., :5, :]
    bb_mse = torch.sum((gt_bb - pred_bb) ** 2, dim=(-1, -2))
    bb_atom_loss = _masked_mean(bb_mse, loss_mask, dim=-1) * exp_conf.bb_atom_loss_weight
    bb_atom_loss = bb_atom_loss * (t < exp_conf.bb_atom_loss_t_filter).to(F32)

    # ---------------- auxiliary: pairwise distances ----------------
    num_res = res_mask.shape[1]
    gt_flat = gt_bb.reshape(batch_size, num_res * 5, 3)
    pred_flat = pred_bb.reshape(batch_size, num_res * 5, 3)
    atom_mask = torch.repeat_interleave(loss_mask, 5, dim=-1)
    # safe_norm keeps the self-distance diagonal's gradient finite.
    gt_d = safe_norm(gt_flat[:, :, None] - gt_flat[:, None, :], eps=1e-10)
    pred_d = safe_norm(pred_flat[:, :, None] - pred_flat[:, None, :], eps=1e-10)
    pair_mask = atom_mask[:, :, None] * atom_mask[:, None, :]
    pair_mask = pair_mask * (
        1.0 - torch.eye(num_res * 5, dtype=pair_mask.dtype, device=pair_mask.device)[None]
    )
    # Only local structure: ground-truth pairs < 6 A, in the mask (numerator
    # and denominator).
    pair_mask = pair_mask * (gt_d < 6.0) * (gt_d > 0)
    dist_mse = (gt_d - pred_d) ** 2
    dist_mat_loss = torch.sum(dist_mse * pair_mask, dim=(-1, -2)) / (
        torch.sum(pair_mask, dim=(-1, -2)) + 1e-10
    )
    dist_mat_loss = dist_mat_loss * exp_conf.dist_mat_loss_weight
    dist_mat_loss = dist_mat_loss * (t < exp_conf.dist_mat_loss_t_filter).to(F32)

    aux_loss = (bb_atom_loss + dist_mat_loss) * exp_conf.aux_loss_weight

    per_example = trans_loss + rot_loss + aux_loss
    total = torch.mean(per_example)
    terms = {
        "total_loss": total,
        "trans_loss": torch.mean(trans_loss),
        "rot_loss": torch.mean(rot_loss),
        "bb_atom_loss": torch.mean(bb_atom_loss),
        "dist_mat_loss": torch.mean(dist_mat_loss),
        "per_example_loss": per_example,
    }
    return total, terms


def t_stratified_metrics(
    per_example_loss: torch.Tensor, t: torch.Tensor, num_bins: int = 4
) -> dict[str, Any]:
    """Loss binned by timestep, for logging (host-side)."""
    losses = per_example_loss.detach().cpu().numpy()
    ts = t.detach().cpu().numpy()
    bins = np.linspace(0.0, 1.0 + 1e-3, num_bins + 1)
    out = {}
    idx = np.digitize(ts, bins) - 1
    for b in range(num_bins):
        sel = idx == b
        if sel.any():
            out[f"loss t=[{bins[b]:.2f},{bins[b+1]:.2f})"] = float(losses[sel].mean())
    return out
