"""The reverse-SDE sampler as a Python loop on the device.

Reverse steps over linspace(min_t, 1, num_t) reversed, dt = 1/num_t; one
initial self-conditioning forward; per step a model forward, the SE(3)
reverse step for t > min_t and the model's x0 prediction at the final step,
the self-conditioning CA update from the predicted frames, and the atom37
rebuild; the trajectory is flipped at the end to start at t = 0. A model
without self-conditioning skips the initial forward and keeps ``sc_ca_t``.
With ``aux_traj`` the sampler also returns the model's x0 predictions as
atom37, the frames and the translations of each step.

With ``sp_mesh``, a ``(dp, sp)`` mesh (``parallel/sp.py``), the samples are
split over ``dp`` and the edge stack's rows over ``sp``; every rank draws the
noise of the whole batch and keeps its samples' rows, so the run equals the
single-process run draw for draw, and every rank returns the whole batch.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from framedipt_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from framedipt_tpu_torch.geometry import frames
from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.model.score_network import preprocess_aatype
from framedipt_tpu_torch.parallel import sp
from framedipt_tpu_torch.parallel.mesh import DP_AXIS, all_gather_rows

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

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
    aux_traj: bool = False,
    sp_mesh: DeviceMesh | None = None,
) -> dict[str, torch.Tensor]:
    """Run the sampler on ``feats`` (rigids_t [B,N,7], res_mask/fixed_mask
    [B,N], seq_idx [B,N], sc_ca_t [B,N,3], torsion_angles_sin_cos
    [B,N,7,2], aatype [B,N] when inpainting), all on the model's device.

    Returns prot_traj [num_t, B, N, 37, 3] (index 0 is t = 0), psi_pred
    [1, B, N, 2] and final_rigids [B, N, 7]. With ``aux_traj`` also, each
    starting at t = 0: rigid_0_traj [num_t, B, N, 37, 3], the atom37 of the
    model's x0 prediction at each step; rigid_traj [num_t + 1, B, N, 7], the
    frames after each step and the initial frames last; trans_traj
    [num_t, B, N, 3], the predicted translations in the diffused region and
    the step's own in the fixed region.

    ``sp_mesh``: a ``(dp, sp)`` mesh from ``parallel.make_sp_mesh`` (every
    rank calls with the same ``feats`` and generator seed), or None. The
    fused IPA attention kernel (``model.ipa.use_pallas_ipa``) is refused
    with it, as in the JAX package."""
    if sp_mesh is not None and model.conf.ipa.use_pallas_ipa:
        raise ValueError(
            "sequence parallelism (sp_mesh) runs the edge-embedder and pair-MLP kernels "
            "on row blocks but not the fused IPA attention kernel; set "
            "model.ipa.use_pallas_ipa=False"
        )
    with sp.sp_context(sp_mesh):
        return _sample(model, diffuser, feats, generator, num_t, min_t, noise_scale,
                       inpainting, input_aatype, aux_traj, sp_mesh)


def _sample(model, diffuser, feats, generator, num_t, min_t, noise_scale, inpainting,
            input_aatype, aux_traj, sp_mesh):
    global_batch = feats["res_mask"].shape[0]
    dp_group = None
    if sp_mesh is not None:
        dp_size = sp_mesh.size(0)
        if global_batch % dp_size:
            raise ValueError(f"{global_batch} samples do not split over dp={dp_size}")
        start = sp_mesh.get_local_rank(DP_AXIS) * (global_batch // dp_size)
        rows = slice(start, start + global_batch // dp_size)
        feats = {k: v[rows] for k, v in feats.items()}
        dp_group = sp_mesh.get_group(DP_AXIS) if dp_size > 1 else None
    else:
        rows = slice(None)

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

    traj, x0_traj, rigid_traj, trans_traj = [], [], [], []
    psi = None
    for t in reverse_steps:
        out = model(step_feats(rigids_t7, sc_ca, t))
        rigid_pred = out["rigids"]
        if self_conditioning:
            sc_ca = rigid_pred[..., 4:]
        # The whole batch's noise, drawn on every rank; this rank keeps its rows.
        z_rot = torch.randn((global_batch,) + out["rot_score"].shape[1:], generator=generator,
                            device=device)[rows]
        z_trans = torch.randn((global_batch,) + out["trans_score"].shape[1:],
                              generator=generator, device=device)[rows]
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
        if aux_traj:
            a37_0, m37_0, _, _ = frames.compute_backbone(
                Rigid.from_tensor7(rigid_pred), psi, aatype=aatype
            )
            x0_traj.append(a37_0 * m37_0[..., None])
            rigid_traj.append(rigids_t7)
            trans_traj.append(diffuse_mask[..., None] * rigid_pred[..., 4:]
                              + fixed_mask[..., None] * rigids_t7[..., 4:])

    out = {
        "prot_traj": torch.stack(traj[::-1]),
        "psi_pred": psi[None],
        "final_rigids": rigids_t7,
    }
    if aux_traj:
        out["rigid_0_traj"] = torch.stack(x0_traj[::-1])
        out["rigid_traj"] = torch.stack(rigid_traj[::-1] + [feats["rigids_t"].to(F32)])
        out["trans_traj"] = torch.stack(trans_traj[::-1])
    if dp_group is not None:
        # Every rank returns the whole batch: dim 0 of final_rigids, 1 of the rest.
        for k, v in out.items():
            dim = 0 if k == "final_rigids" else 1
            out[k] = all_gather_rows(v.movedim(dim, 0), dp_group).movedim(0, dim)
    return out
