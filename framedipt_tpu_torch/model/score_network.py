"""ScoreNetwork: embedder + IPA trunk + score/psi/backbone heads.

aatype preprocessing (UNK in the diffused region), masked embeddings, the
trunk, psi blending with the ground truth on fixed residues, the rotation
score from the quaternion delta between input and predicted frames, the
translation score from the translation residual, and atom37/atom14 backbone
reconstruction. Module names follow the reference state_dict
(``embedding_layer.*``, ``score_model.trunk.*``, ``score_model.torsion_pred.*``).
"""
from __future__ import annotations

import torch
from torch import nn

from framedipt_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from framedipt_tpu_torch.geometry import frames
from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.model.embed import Embedder
from framedipt_tpu_torch.model.ipa import IpaScore
from framedipt_tpu_torch.model.layers import compute_dtype
from framedipt_tpu_torch.tools.config import ModelConfig

F32 = torch.float32


def preprocess_aatype(
    aatype: torch.Tensor | None,
    fixed_mask: torch.Tensor,
    inpainting: bool,
    input_aatype: bool,
) -> torch.Tensor | None:
    """Replace diffused-region residue types with UNK (20) unless the model
    is configured to see them."""
    if aatype is None or (not inpainting and not input_aatype):
        return None
    aatype = aatype.long()
    if not input_aatype:
        aatype = torch.where(fixed_mask > 0.5, aatype, torch.full_like(aatype, 20))
    return aatype


class ScoreNetwork(nn.Module):
    def __init__(self, conf: ModelConfig, diffuser: SE3Diffuser, inpainting: bool = False) -> None:
        super().__init__()
        self.conf = conf
        self.diffuser = diffuser
        self.inpainting = inpainting
        dtype = compute_dtype(conf.compute_dtype)
        self.embedding_layer = Embedder(conf, inpainting, dtype)
        self.score_model = IpaScore(conf, dtype)

    def forward(self, input_feats: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """input_feats: res_mask [B,N], fixed_mask [B,N], seq_idx [B,N],
        t [B], sc_ca_t [B,N,3], rigids_t [B,N,7],
        torsion_angles_sin_cos [B,N,7,2], optional aatype [B,N]."""
        bb_mask = input_feats["res_mask"].to(F32)
        fixed_mask = input_feats["fixed_mask"].to(F32)
        t = input_feats["t"].to(F32)
        aatype = preprocess_aatype(
            input_feats.get("aatype"), fixed_mask, self.inpainting, self.conf.input_aatype
        )

        node_embed, edge_embed = self.embedding_layer(
            seq_idx=input_feats["seq_idx"],
            t=t,
            fixed_mask=fixed_mask,
            self_conditioning_ca=input_feats["sc_ca_t"],
            aatype=aatype,
            node_mask=bb_mask,
        )
        node_embed = node_embed * bb_mask[..., None].to(node_embed.dtype)

        diffuse_mask = (1.0 - fixed_mask) * bb_mask
        rigids_t7 = input_feats["rigids_t"].to(F32)
        trunk_out = self.score_model(node_embed, edge_embed, rigids_t7, bb_mask, diffuse_mask)

        init_rigids = Rigid.from_tensor7(rigids_t7)
        curr_scaled = Rigid.from_tensor7(trunk_out["final_rigids_scaled_t7"])
        rot_score = self.diffuser.calc_rot_score(init_rigids.qs, curr_scaled.qs, t)
        rot_score = rot_score * bb_mask[..., None]

        curr = curr_scaled.scale_trans(1.0 / self.conf.ipa.coordinate_scaling)
        trans_score = self.diffuser.calc_trans_score(
            init_rigids.trans, curr.trans, t[:, None, None], scale=True
        )
        trans_score = trans_score * bb_mask[..., None]

        # Fixed residues keep their ground-truth psi.
        gt_psi = input_feats["torsion_angles_sin_cos"][..., 2, :].to(F32)
        blend = 1.0 - fixed_mask[..., None]
        psi_pred = blend * trunk_out["psi"] + (1.0 - blend) * gt_psi

        atom37, atom37_mask, _, atom14 = frames.compute_backbone(curr, psi_pred, aatype=aatype)
        return {
            "psi": psi_pred,
            "rot_score": rot_score,
            "trans_score": trans_score,
            "rigids": curr.to_tensor7(),
            "atom37": atom37 * atom37_mask[..., None],
            "atom14": atom14,
        }
