"""The EigenFold confidence score of a sampled structure: the forward
noising ladder from the final frames over linspace(min_t, 1, num_t)[:-1],
summing per step the log-density of the reverse step under the model's
scores (evaluated at the next grid point, after a self-conditioning
forward) minus that of the forward step, plus the terminal priors: N(0, I)
on the scaled translations and uniform rotations, over the diffused
residues. A Python loop on the device, two model forwards a step."""
from __future__ import annotations

import math

import numpy as np
import torch

from framedipt_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from framedipt_tpu_torch.geometry.rigid import Rigid

F32 = torch.float32
_MODEL_KEYS = ("res_mask", "fixed_mask", "seq_idx", "sc_ca_t", "torsion_angles_sin_cos", "aatype")


@torch.inference_mode()
def logp_confidence_score(
    model: torch.nn.Module,
    diffuser: SE3Diffuser,
    sample_feats: dict[str, torch.Tensor],
    final_rigids_t7: torch.Tensor,
    diffuse_mask: torch.Tensor,
    num_t: int,
    min_t: float,
    generator: torch.Generator | None = None,
    noise: list[tuple[torch.Tensor, torch.Tensor]] | None = None,
) -> torch.Tensor:
    """The score (higher is more likely under the model) of the frames
    ``final_rigids_t7`` [B, N, 7] given the model inputs ``sample_feats``
    (res_mask, fixed_mask, seq_idx, sc_ca_t, torsion_angles_sin_cos,
    aatype), all on the model's device. ``diffuse_mask`` is [B, N] or [N].
    The forward noise is drawn from ``generator`` (rotations, then
    translations, each step), or taken from ``noise``: one (z_rot, z_trans)
    pair a step, each shaped like the frames' [B, N, 3]. A model that embeds
    self-conditioning gets its self-conditioning forward each step."""
    forward_steps = np.linspace(min_t, 1.0, num_t)[:-1]
    eval_ts = np.append(forward_steps[1:], 1.0)  # the next grid point; 1 last
    dt = 1.0 / num_t
    if noise is not None and len(noise) != len(forward_steps):
        raise ValueError(f"noise has {len(noise)} steps, the ladder {len(forward_steps)}")

    feats = {k: sample_feats[k] for k in _MODEL_KEYS if k in sample_feats}
    self_condition = model.conf.embed.embed_self_conditioning
    rigids_t7 = final_rigids_t7.to(F32)
    batch, device = rigids_t7.shape[0], rigids_t7.device
    dmask = diffuse_mask.to(F32)
    n_diffused = torch.sum(dmask if dmask.ndim == 1 else dmask[0])
    if dmask.ndim == 1:
        dmask = dmask[None]

    def model_scores(rigids7: torch.Tensor, t: float) -> tuple[torch.Tensor, torch.Tensor]:
        step_feats = dict(feats, rigids_t=rigids7,
                          t=torch.full((batch,), float(t), dtype=F32, device=device))
        if self_condition:
            step_feats["sc_ca_t"] = model(step_feats)["rigids"][..., 4:]
        out = model(step_feats)
        return out["trans_score"], out["rot_score"]

    log_p = torch.zeros((), dtype=F32, device=device)
    for i, (t_1, t_eval) in enumerate(zip(forward_steps.astype(np.float32),
                                          eval_ts.astype(np.float32))):
        if noise is None:
            shape = rigids_t7[..., 4:].shape
            z_rot = torch.randn(shape, generator=generator, device=device)
            z_trans = torch.randn(shape, generator=generator, device=device)
        else:
            z_rot, z_trans = noise[i]
        r_prev = Rigid.from_tensor7(rigids_t7)
        r_next = diffuser.forward(r_prev, float(t_1), dt, z_rot, z_trans, diffuse_mask=dmask)
        rigids_t7 = r_next.to_tensor7()
        trans_score, rot_score = model_scores(rigids_t7, t_eval)
        log_p = log_p + diffuser.log_prob_backward(
            r_next, r_prev, trans_score, rot_score, float(t_eval), dt, diffuse_mask=dmask
        ) - diffuser.log_prob_forward(r_next, r_prev, float(t_1), dt, diffuse_mask=dmask)

    trans = diffuser.r3.scale(rigids_t7[..., 4:])
    lp_trans = torch.sum(-0.5 * (trans**2 + math.log(2.0 * math.pi)) * dmask[..., None])
    lp_rot = math.log(1.0 / math.pi**2) * n_diffused
    return log_p + lp_trans + lp_rot
