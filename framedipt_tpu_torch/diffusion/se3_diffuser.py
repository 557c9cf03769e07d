"""SE(3) diffusion over rigid frames: IGSO(3) rotations + VP-SDE
translations, with inpainting masks (the forward marginal that noises a
training batch, reference sampling with imputation, scores from predicted
frames, one reverse step)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from framedipt_tpu_torch.diffusion.r3_diffuser import R3Diffuser
from framedipt_tpu_torch.diffusion.so3_diffuser import SO3Diffuser
from framedipt_tpu_torch.geometry import quat as quat_ops
from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.tools.config import DiffuserConfig
from framedipt_tpu_torch.tools.device import resolve_device


def _apply_mask(x_diff, x_fixed, mask):
    return mask * x_diff + (1.0 - mask) * x_fixed


def extract_trans_rotvec(r: Rigid) -> tuple[torch.Tensor, torch.Tensor]:
    """Rigid -> (translations [..., 3], rotation vectors [..., 3])."""
    return r.trans, quat_ops.to_rotvec(r.qs)


def assemble_rigid(rotvec: torch.Tensor, trans: torch.Tensor) -> Rigid:
    return Rigid(quat_ops.from_rotvec(rotvec), trans)


class MarginalSample(NamedTuple):
    rigids_t: Rigid
    trans_score: torch.Tensor
    rot_score: torch.Tensor
    trans_score_scaling: torch.Tensor
    rot_score_scaling: torch.Tensor


class SE3Diffuser:
    def __init__(self, conf: DiffuserConfig, device: torch.device | str | None = None) -> None:
        self.conf = conf
        self.device = resolve_device(device)
        self.diffuse_rot = bool(conf.diffuse_rot)
        self.diffuse_trans = bool(conf.diffuse_trans)
        self.so3 = SO3Diffuser(conf.so3, device=self.device)
        self.r3 = R3Diffuser(conf.r3)

    def score_scaling(self, t) -> tuple[torch.Tensor, torch.Tensor]:
        return self.so3.score_scaling(t), self.r3.score_scaling(self.so3._t(t))

    def calc_trans_score(
        self,
        trans_t: torch.Tensor,
        trans_0: torch.Tensor,
        t: torch.Tensor,
        scale: bool = True,
    ) -> torch.Tensor:
        return self.r3.score(trans_t, trans_0, t, scale=scale)

    def calc_rot_score(
        self, rots_t_quats: torch.Tensor, rots_0_quats: torch.Tensor, t
    ) -> torch.Tensor:
        """Score of the rotation marginal from the quaternion delta
        q_{0->t} = q_0^{-1} q_t."""
        quats_0t = quat_ops.multiply(quat_ops.invert(rots_0_quats), rots_t_quats)
        return self.so3.score(quat_ops.to_rotvec(quats_0t), t)

    def forward_marginal(
        self,
        generator: torch.Generator,
        rigids_0: Rigid,
        t,
        diffuse_mask: torch.Tensor | None = None,
    ) -> MarginalSample:
        """Noise clean frames [B, N] to times t [B] (or one scalar t): the
        rotation draws first (per sample, in batch order), then the
        translation noise."""
        trans_0, rot_0 = extract_trans_rotvec(rigids_0)
        t = self.so3._t(t)
        rot = self.so3.forward_marginal(generator, rot_0, t) if self.diffuse_rot else None
        trans = (self.r3.forward_marginal(generator, trans_0, t, diffuse_mask)
                 if self.diffuse_trans else None)
        return self._marginal(rigids_0, t, rot, trans, diffuse_mask)

    def marginal_from_noise(
        self,
        rigids_0: Rigid,
        t,
        rot_sample: torch.Tensor | None,
        trans_noise: torch.Tensor | None,
        diffuse_mask: torch.Tensor | None = None,
    ) -> MarginalSample:
        """The forward marginal given its randomness: IGSO3(t) rotation
        vectors ``rot_sample`` and standard-normal ``trans_noise``, both
        shaped [..., 3] like the frames (None for a part not diffused)."""
        trans_0, rot_0 = extract_trans_rotvec(rigids_0)
        t = self.so3._t(t)
        rot = self.so3.marginal_from_sample(rot_0, t, rot_sample) if self.diffuse_rot else None
        trans = (self.r3.marginal_from_noise(trans_0, t, trans_noise, diffuse_mask)
                 if self.diffuse_trans else None)
        return self._marginal(rigids_0, t, rot, trans, diffuse_mask)

    def _marginal(self, rigids_0, t, rot, trans, diffuse_mask) -> MarginalSample:
        """The sample from the parts' (x_t, score) pairs, None for a part not
        diffused. Masked residues keep their frames and get zero scores."""
        trans_0, rot_0 = extract_trans_rotvec(rigids_0)
        ones = torch.ones_like(t)
        if rot is not None:
            (rot_t, rot_score), rot_score_scaling = rot, self.so3.score_scaling(t)
        else:
            rot_t, rot_score, rot_score_scaling = rot_0, torch.zeros_like(rot_0), ones
        if trans is not None:
            (trans_t, trans_score), trans_score_scaling = trans, self.r3.score_scaling(t)
        else:
            trans_t, trans_score, trans_score_scaling = trans_0, torch.zeros_like(trans_0), ones
        if diffuse_mask is not None:
            m = diffuse_mask[..., None]
            rot_t = _apply_mask(rot_t, rot_0, m)
            rot_score = _apply_mask(rot_score, torch.zeros_like(rot_score), m)
        return MarginalSample(
            assemble_rigid(rot_t, trans_t), trans_score, rot_score,
            trans_score_scaling, rot_score_scaling,
        )

    def reverse(
        self,
        rigid_t: Rigid,
        rot_score: torch.Tensor,
        trans_score: torch.Tensor,
        t,
        dt: float,
        z_rot: torch.Tensor,
        z_trans: torch.Tensor,
        diffuse_mask: torch.Tensor | None = None,
        noise_scale: float = 1.0,
    ) -> Rigid:
        """One reverse-SDE step on frames. ``z_rot`` / ``z_trans`` are the
        standard-normal noises of the two steps, shaped like the scores."""
        trans_t, rot_t = extract_trans_rotvec(rigid_t)
        t = self.so3._t(t)
        if self.diffuse_rot:
            rot_t_1 = self.so3.reverse(
                rot_t, rot_score, t, dt, z_rot, noise_scale=noise_scale
            )
        else:
            rot_t_1 = rot_t
        if self.diffuse_trans:
            trans_t_1 = self.r3.reverse(
                trans_t, trans_score, t, dt, z_trans,
                diffuse_mask=diffuse_mask, noise_scale=noise_scale,
            )
        else:
            trans_t_1 = trans_t
        if diffuse_mask is not None:
            m = diffuse_mask[..., None]
            trans_t_1 = _apply_mask(trans_t_1, trans_t, m)
            rot_t_1 = _apply_mask(rot_t_1, rot_t, m)
        return assemble_rigid(rot_t_1, trans_t_1)

    def sample_ref(
        self,
        generator: torch.Generator,
        n_samples: int,
        impute: Rigid | None = None,
        diffuse_mask: torch.Tensor | None = None,
    ) -> Rigid:
        """Frames from the stationary distribution, imputing the fixed region
        from ``impute`` where diffuse_mask == 0."""
        if impute is None:
            if not (self.diffuse_rot and self.diffuse_trans):
                raise ValueError("impute frames required when not diffusing rot or trans")
            if diffuse_mask is not None:
                raise ValueError("impute frames required for masked diffusion")
            impute = Rigid.identity((n_samples,), device=self.device)
        trans_impute, rot_impute = extract_trans_rotvec(impute)

        if self.diffuse_rot:
            rot_ref = self.so3.sample_ref(generator, n_samples).reshape(rot_impute.shape)
        else:
            rot_ref = rot_impute
        if self.diffuse_trans:
            trans_ref = self.r3.sample_stationary(generator, trans_impute, diffuse_mask)
        else:
            trans_ref = trans_impute
        if diffuse_mask is not None:
            rot_ref = _apply_mask(rot_ref, rot_impute, diffuse_mask[..., None])
        return assemble_rigid(rot_ref, trans_ref)
