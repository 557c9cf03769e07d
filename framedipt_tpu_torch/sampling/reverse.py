"""The reverse-SDE sampler as a Python loop on the device.

Reverse steps over linspace(min_t, 1, num_t) reversed, dt = 1/num_t; one
initial self-conditioning forward; per step a model forward, the SE(3)
reverse step for t > min_t and the model's x0 prediction at the final step,
the self-conditioning CA update from the predicted frames, and the atom37
rebuild; the trajectory is flipped at the end to start at t = 0. A model
without self-conditioning skips the initial forward and keeps ``sc_ca_t``.
"""
from __future__ import annotations

import numpy as np
import torch

from framedipt_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from framedipt_tpu_torch.geometry import frames
from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.model.score_network import preprocess_aatype

F32 = torch.float32


@torch.inference_mode()
def sample(
    model: torch.nn.Module,
    diffuser: SE3Diffuser,
    feats: dict[str, torch.Tensor],
    generator: torch.Generator,
    num_t: int,
    min_t: float,
    noise_scale: float = 1.0,
    inpainting: bool = False,
    input_aatype: bool = False,
) -> dict[str, torch.Tensor]:
    """Run the sampler on ``feats`` (rigids_t [B,N,7], res_mask/fixed_mask
    [B,N], seq_idx [B,N], sc_ca_t [B,N,3], torsion_angles_sin_cos
    [B,N,7,2], aatype [B,N] when inpainting), all on the model's device.

    Returns prot_traj [num_t, B, N, 37, 3] (index 0 is t = 0), psi_pred
    [1, B, N, 2] and final_rigids [B, N, 7]."""
    reverse_steps = np.linspace(min_t, 1.0, num_t)[::-1].astype(np.float32)
    dt = 1.0 / num_t
    min_t32 = np.float32(min_t)

    res_mask = feats["res_mask"].to(F32)
    fixed_mask = feats["fixed_mask"].to(F32) * res_mask
    diffuse_mask = (1.0 - feats["fixed_mask"].to(F32)) * res_mask
    aatype = preprocess_aatype(feats.get("aatype"), fixed_mask, inpainting, input_aatype)
    rigids_t7 = feats["rigids_t"].to(F32)
    sc_ca = feats["sc_ca_t"].to(F32)
    batch = res_mask.shape[0]
    device = rigids_t7.device

    def step_feats(rigids7, sc, t):
        out = dict(feats)
        out.update(
            rigids_t=rigids7, sc_ca_t=sc,
            t=torch.full((batch,), float(t), dtype=F32, device=device),
        )
        return out

    self_conditioning = model.conf.embed.embed_self_conditioning
    if self_conditioning:
        sc_ca = model(step_feats(rigids_t7, sc_ca, reverse_steps[0]))["rigids"][..., 4:]

    traj = []
    psi = None
    for t in reverse_steps:
        out = model(step_feats(rigids_t7, sc_ca, t))
        rigid_pred = out["rigids"]
        if self_conditioning:
            sc_ca = rigid_pred[..., 4:]
        z_rot = torch.randn(out["rot_score"].shape, generator=generator, device=device)
        z_trans = torch.randn(out["trans_score"].shape, generator=generator, device=device)
        if t > min_t32:
            rigids_t7 = diffuser.reverse(
                Rigid.from_tensor7(rigids_t7), out["rot_score"], out["trans_score"],
                float(t), dt, z_rot, z_trans, diffuse_mask=diffuse_mask,
                noise_scale=noise_scale,
            ).to_tensor7()
        else:
            # Final step: the model's x0 prediction.
            rigids_t7 = rigid_pred
        psi = out["psi"]
        atom37, atom37_mask, _, _ = frames.compute_backbone(
            Rigid.from_tensor7(rigids_t7), psi, aatype=aatype
        )
        traj.append(atom37 * atom37_mask[..., None])

    return {
        "prot_traj": torch.stack(traj[::-1]),
        "psi_pred": psi[None],
        "final_rigids": rigids_t7,
    }
