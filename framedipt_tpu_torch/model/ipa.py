"""Invariant Point Attention trunk: IPA with pair bias and down-projected
pair output, StructureModuleTransition, EdgeTransition, the 2-layer post-norm
sequence transformer, BackboneUpdate, the psi head, and the per-block masked
frame update.

The squared point distance is expanded as |q|^2 + |k|^2 - 2 q.k, so the
[B, N, N, H, P, 3] displacement tensor never exists. Contractions accumulate
in float32; frame algebra is always float32. The EdgeTransition is
concat-free (kernel rows sliced into O(N) node terms) and runs its pair MLP
through the pair-MLP wrapper's autograd Function (``kernels/pair_mlp.py``):
the CUDA kernels (forward and backward) on the card, their plain PyTorch
versions on CPU tensors. With ``model.ipa.use_pallas_ipa`` the IPA attention
runs through the fused attention wrapper (``kernels/ipa_attention.py``) in
the same way, forward only (it refuses to run where autograd records);
without it, as einsums.

Under sequence parallelism (``parallel/sp.py``) the pair tensor is this
rank's row block: the IPA attends from this rank's query rows to every key,
the edge transition's row terms are this rank's rows, and the trunk
all-gathers each IPA block's output, so every node-level tensor is whole on
every rank. The fused IPA attention kernel is refused there, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.model.kernels.ipa_attention import build_point_inputs, ipa_attention
from framedipt_tpu_torch.model.kernels.pair_mlp import PairMLPFunction
from framedipt_tpu_torch.model.layers import Linear, LayerNorm
from framedipt_tpu_torch.parallel import sp
from framedipt_tpu_torch.tools.config import IPAConfig, ModelConfig

F32 = torch.float32


def _apply_frames(mats: torch.Tensor, trans: torch.Tensor, pts: torch.Tensor):
    """Apply per-residue frames [B,N,3,3]/[B,N,3] to points [B,N,P,3]."""
    return (mats[:, :, None] * pts[..., None, :]).sum(-1) + trans[:, :, None, :]


def _invert_apply_frames(mats: torch.Tensor, trans: torch.Tensor, pts: torch.Tensor):
    """Apply inverse frames to points [B,N,P,3] (R^T (x - t))."""
    rel = pts - trans[:, :, None, :]
    return (mats[:, :, None] * rel[..., :, None]).sum(-2)


def _refuse_grad(module: nn.Module, *tensors: torch.Tensor) -> None:
    """The IPA attention kernel is forward-only (so is the JAX package's):
    its output has no autograd history, so a gradient would stop there
    silently. Raise where autograd records and anything requires grad."""
    if torch.is_grad_enabled() and (
        any(p.requires_grad for p in module.parameters())
        or any(t.requires_grad for t in tensors)
    ):
        raise RuntimeError(
            "the IPA attention kernel (model.ipa.use_pallas_ipa) is forward-only: "
            "train with use_pallas_ipa=False or run under torch.no_grad()"
        )


def _points_from_linear(x: torch.Tensor) -> torch.Tensor:
    """[.., 3*P] -> [.., P, 3], coordinate-major (x/y/z thirds stacked)."""
    return torch.stack(torch.chunk(x, 3, dim=-1), dim=-1)


class InvariantPointAttention(nn.Module):
    def __init__(self, conf: IPAConfig, dtype: torch.dtype, inf: float = 1e5,
                 eps: float = 1e-8, use_kernel: bool = False) -> None:
        super().__init__()
        c = conf
        self.conf, self.dtype, self.inf, self.eps = conf, dtype, inf, eps
        # Attention through the fused kernel (model.ipa.use_pallas_ipa) or
        # as einsums; both compute the same function on unmasked rows.
        self.use_kernel = use_kernel
        H, C, Pq, Pv = c.no_heads, c.c_hidden, c.no_qk_points, c.no_v_points
        self.linear_q = Linear(c.c_s, H * C, dtype=dtype)
        self.linear_kv = Linear(c.c_s, 2 * H * C, dtype=dtype)
        self.linear_q_points = Linear(c.c_s, H * Pq * 3)
        self.linear_kv_points = Linear(c.c_s, H * (Pq + Pv) * 3)
        self.linear_b = Linear(c.c_z, H, dtype=dtype)
        self.down_z = Linear(c.c_z, c.c_z // 4, dtype=dtype)
        self.head_weights = nn.Parameter(torch.full((H,), 0.541324854612918))
        c_out = H * (C + Pv * 4 + c.c_z // 4)
        self.linear_out = Linear(c_out, c.c_s, dtype=dtype)
        # Unused by the forward pass; kept so reference checkpoints load
        # with strict=True.
        self.linear_rbf = nn.Linear(20, 1)

    def forward(self, s: torch.Tensor, z: torch.Tensor, rigids: Rigid,
                mask: torch.Tensor) -> torch.Tensor:
        """[B, N, C_s]; under sequence parallelism ``z`` is this rank's row
        block and the output its rows [B, ceil(N/sp), C_s]."""
        mats, trans = rigids.rot_mats(), rigids.trans
        q, k, v, q_pts, k_pts, v_pts, pt_scale = self.project(s, mats, trans)
        # The query side: this rank's rows under sequence parallelism.
        q, q_pts, mats, trans, row_mask = (
            sp.local_rows(x) for x in (q, q_pts, mats, trans, mask))
        if self.use_kernel:
            o, o_pt_global, o_pair = self.attend_kernel(
                q, k, v, q_pts, k_pts, v_pts, pt_scale, z, mask)
        else:
            o, o_pt_global, o_pair = self.attend_einsum(
                q, k, v, q_pts, k_pts, v_pts, pt_scale, z, mask, row_mask)

        o_pt = _invert_apply_frames(mats, trans, o_pt_global)
        o_pt_norm = torch.sqrt(torch.sum(o_pt**2, dim=-1) + self.eps)
        o_feats = torch.cat(
            [o, o_pt[..., 0], o_pt[..., 1], o_pt[..., 2], o_pt_norm, o_pair], dim=-1
        )
        return self.linear_out(o_feats)

    def project(self, s: torch.Tensor, mats: torch.Tensor, trans: torch.Tensor):
        """Scalar q, k, v [B,N,H,C] in the compute dtype, global-frame points
        q_pts, k_pts [B,N,H,Pq,3] and v_pts [B,N,H,Pv,3] in float32, and the
        point-logit head weights pt_scale [H]."""
        c = self.conf
        H, C, Pq, Pv = c.no_heads, c.c_hidden, c.no_qk_points, c.no_v_points
        B, N, _ = s.shape
        q = self.linear_q(s).reshape(B, N, H, C)
        k, v = torch.split(self.linear_kv(s).reshape(B, N, H, 2 * C), C, dim=-1)

        s32 = s.to(F32)
        q_pts = _points_from_linear(self.linear_q_points(s32))
        q_pts = _apply_frames(mats, trans, q_pts).reshape(B, N, H, Pq, 3)
        kv_pts = _points_from_linear(self.linear_kv_points(s32))
        kv_pts = _apply_frames(mats, trans, kv_pts).reshape(B, N, H, Pq + Pv, 3)
        k_pts, v_pts = torch.split(kv_pts, [Pq, Pv], dim=-2)

        pt_scale = F.softplus(self.head_weights) * np.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
        return q, k, v, q_pts, k_pts, v_pts, pt_scale

    def attend_einsum(self, q, k, v, q_pts, k_pts, v_pts, pt_scale, z, mask, row_mask=None):
        """Attention as einsums (the JAX package's XLA formulation): returns
        o [B,Nr,H*C], o_pt_global [B,Nr,H*Pv,3] and o_pair [B,Nr,H*dz], float32,
        for the Nr query rows of q, q_pts and z [B,Nr,N,C_z] against the N
        keys; ``mask`` [B,N] masks the keys and ``row_mask`` [B,Nr] (default
        ``mask``) the queries. Fully masked rows get uniform-softmax values
        (node-masked downstream)."""
        row_mask = mask if row_mask is None else row_mask
        B, Nr, H, C = q.shape
        N = k.shape[1]
        Pq, Pv = q_pts.shape[3], v_pts.shape[3]
        b = self.linear_b(z)  # [B, N, N, H]
        a = torch.einsum("bihc,bjhc->bhij", q.to(F32), k.to(F32))
        a = a * np.sqrt(1.0 / (3 * C))
        a = a + np.sqrt(1.0 / 3) * b.to(F32).permute(0, 3, 1, 2)

        sq_q = torch.sum(q_pts**2, dim=(-1, -2))  # [B, N, H]
        sq_k = torch.sum(k_pts**2, dim=(-1, -2))
        qk_pts = torch.einsum(
            "bihp,bjhp->bhij", q_pts.reshape(B, Nr, H, Pq * 3), k_pts.reshape(B, N, H, Pq * 3)
        )
        sq_dist = (
            sq_q.permute(0, 2, 1)[..., :, None]
            + sq_k.permute(0, 2, 1)[..., None, :]
            - 2.0 * qk_pts
        )
        a = a + (-0.5) * pt_scale[None, :, None, None] * sq_dist

        square_mask = self.inf * (row_mask[:, :, None] * mask[:, None, :] - 1.0)
        a = torch.softmax(a + square_mask[:, None, :, :], dim=-1)

        o = torch.einsum(
            "bhij,bjhc->bihc", a.to(self.dtype).to(F32), v.to(F32)
        ).reshape(B, Nr, H * C)
        o_pt_global = torch.einsum(
            "bhij,bjhp->bihp", a, v_pts.reshape(B, N, H, Pv * 3)
        ).reshape(B, Nr, H, Pv, 3).reshape(B, Nr, H * Pv, 3)
        pair_z = self.down_z(z)
        o_pair = torch.einsum(
            "bhij,bijd->bihd", a.to(self.dtype).to(F32), pair_z.to(F32)
        ).reshape(B, Nr, -1)
        return o, o_pt_global, o_pair

    def attend_kernel(self, q, k, v, q_pts, k_pts, v_pts, pt_scale, z, mask):
        """The same attention through the fused kernel's wrapper
        (``kernels/ipa_attention.py``), as the JAX package's Pallas branch
        feeds it: q pre-scaled by sqrt(1/(3C)), linear_b's weight by
        sqrt(1/3) without its bias (which cancels in the softmax), down_z's
        weight with its bias added to o_pair after (rows of p sum to 1), and
        the augmented points. Fully masked rows get exactly 0. Refuses to
        run where autograd records a gradient (the kernel is forward-only)."""
        _refuse_grad(self, q, k, v, q_pts, k_pts, v_pts, pt_scale, z)
        B, N, H, C = q.shape
        dt = self.dtype
        qhat, khat, vpt = build_point_inputs(q_pts, k_pts, v_pts, pt_scale)
        o, o_pt_global, o_pair = ipa_attention(
            (q * np.sqrt(1.0 / (3 * C))).reshape(B, N, H * C),
            k.contiguous().reshape(B, N, H * C),
            v.contiguous().reshape(B, N, H * C),
            qhat, khat, vpt, z.to(dt).contiguous(), mask.to(F32).contiguous(),
            (self.linear_b.weight.t() * np.sqrt(1.0 / 3)).to(dt).contiguous(),
            self.down_z.weight.t().to(dt).contiguous(),
            no_heads=H, no_v_points=v_pts.shape[3], inf=self.inf,
        )
        o_pair = (o_pair.reshape(B, N, H, -1) + self.down_z.bias.to(F32)).reshape(B, N, -1)
        return o, o_pt_global, o_pair


class StructureModuleTransition(nn.Module):
    def __init__(self, c: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear_1 = Linear(c, c, dtype=dtype)
        self.linear_2 = Linear(c, c, dtype=dtype)
        self.linear_3 = Linear(c, c, dtype=dtype)
        self.ln = LayerNorm(c, dtype=dtype)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        s_init = s
        s = torch.relu(self.linear_1(s))
        s = torch.relu(self.linear_2(s))
        return self.ln(self.linear_3(s) + s_init)


class EdgeTransition(nn.Module):
    """Edge update: concat([e, bias_i, bias_j]) -> 2-layer MLP with residual
    -> final layer -> LayerNorm -> edge mask, written concat-free."""

    def __init__(self, node_embed_size: int, edge_embed_in: int, edge_embed_out: int,
                 dtype: torch.dtype, node_dilation: int = 2) -> None:
        super().__init__()
        self.dtype = dtype
        self.bias_size = node_embed_size // node_dilation
        self.c_e = edge_embed_in
        hidden = edge_embed_in + 2 * self.bias_size
        self.initial_embed = Linear(node_embed_size, self.bias_size, dtype=dtype)
        self.trunk = nn.Sequential(nn.Linear(hidden, hidden), nn.ReLU(), nn.Linear(hidden, hidden))
        self.final_layer = nn.Linear(hidden, edge_embed_out)
        self.layer_norm = nn.LayerNorm(edge_embed_out, eps=1e-6)

    def forward(self, node_embed: torch.Tensor, edge_embed: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        """The updated edge tensor; under sequence parallelism ``edge_embed``
        and the output are this rank's row block, and so are the row terms."""
        dtype, c_e, b = self.dtype, self.c_e, self.bias_size
        node_bias = self.initial_embed(node_embed)
        w0 = self.trunk[0].weight.t().to(dtype)  # [hidden, hidden] kernel layout
        b0 = self.trunk[0].bias.to(dtype)
        w1 = self.trunk[2].weight.t().to(dtype).contiguous()
        b1 = self.trunk[2].bias.to(dtype)
        wf = self.final_layer.weight.t().to(dtype)  # [hidden, c_out]
        bf = self.final_layer.bias.to(dtype)

        # O(N) row/column terms of the first and final layers.
        i_term = torch.matmul(node_bias, w0[c_e : c_e + b])
        j_term = torch.matmul(node_bias, w0[c_e + b :])
        fi = torch.matmul(node_bias, wf[c_e : c_e + b])
        fj = torch.matmul(node_bias, wf[c_e + b :])
        mask = node_mask.to(dtype).contiguous()
        args = (
            edge_embed.contiguous(), sp.local_rows(i_term).contiguous(), j_term.contiguous(),
            sp.local_rows(mask), mask,
            w0[:c_e].contiguous(), b0, w1, b1, wf.contiguous(), bf,
            self.layer_norm.weight, self.layer_norm.bias,
            sp.local_rows(fi).contiguous(), fj.contiguous(), wf[:c_e].contiguous(),
        )
        return PairMLPFunction.apply(*args)


class _SelfAttention(nn.Module):
    """Parameters of torch's MultiheadAttention (in_proj_*, out_proj)."""

    def __init__(self, d: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = Linear(d, d, dtype=dtype)


class SeqTransformerLayer(nn.Module):
    """Post-norm transformer encoder layer (ReLU, no dropout)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.self_attn = _SelfAttention(d_model, dtype)
        self.linear1 = Linear(d_model, d_model, dtype=dtype)
        self.linear2 = Linear(d_model, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        Hn, dt = self.num_heads, self.dtype
        Hd = D // Hn
        qkv = F.linear(
            x.to(dt), self.self_attn.in_proj_weight.to(dt), self.self_attn.in_proj_bias.to(dt)
        )
        q, k, v = (u.reshape(B, N, Hn, Hd) for u in torch.chunk(qkv, 3, dim=-1))
        logits = torch.einsum("bihd,bjhd->bhij", q.to(F32), k.to(F32)) / np.sqrt(Hd)
        logits = logits + (pad_mask[:, None, None, :] - 1.0) * 1e9
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum(
            "bhij,bjhd->bihd", attn.to(dt).to(F32), v.to(F32)
        ).reshape(B, N, D)
        x = self.norm1(x + self.self_attn.out_proj(out))
        ff = self.linear2(torch.relu(self.linear1(x)))
        return self.norm2(x + ff)


class SeqTransformer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            SeqTransformerLayer(d_model, num_heads, dtype) for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, pad_mask)
        return x


class BackboneUpdate(nn.Module):
    def __init__(self, c_s: int) -> None:
        super().__init__()
        self.linear = Linear(c_s, 6)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        return self.linear(s)


class TorsionAngles(nn.Module):
    def __init__(self, c: int, num_torsions: int = 1, eps: float = 1e-8) -> None:
        super().__init__()
        self.eps = eps
        self.linear_1 = Linear(c, c)
        self.linear_2 = Linear(c, c)
        # Unused by the forward pass; kept so reference checkpoints load.
        self.linear_3 = nn.Linear(c, c)
        self.linear_final = Linear(c, num_torsions * 2)

    def forward(self, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        s_init = s
        s = self.linear_2(torch.relu(self.linear_1(s))) + s_init
        unnormalized = self.linear_final(s)
        norm = torch.sqrt(
            torch.clamp_min(torch.sum(unnormalized**2, dim=-1, keepdim=True), self.eps)
        )
        return unnormalized, unnormalized / norm


class IpaScore(nn.Module):
    """The IPA trunk (``trunk``) and psi head (``torsion_pred``)."""

    def __init__(self, conf: ModelConfig, dtype: torch.dtype) -> None:
        super().__init__()
        ipa = conf.ipa
        self.conf, self.dtype = conf, dtype
        trunk = {}
        for b in range(ipa.num_blocks):
            trunk[f"ipa_{b}"] = InvariantPointAttention(
                ipa, dtype, use_kernel=bool(ipa.use_pallas_ipa)
            )
            trunk[f"ipa_ln_{b}"] = LayerNorm(ipa.c_s, dtype=dtype)
            trunk[f"skip_embed_{b}"] = Linear(conf.node_embed_size, ipa.c_skip, dtype=dtype)
            trunk[f"seq_tfmr_{b}"] = SeqTransformer(
                ipa.c_s + ipa.c_skip, ipa.seq_tfmr_num_heads, ipa.seq_tfmr_num_layers, dtype
            )
            trunk[f"post_tfmr_{b}"] = Linear(ipa.c_s + ipa.c_skip, ipa.c_s, dtype=dtype)
            trunk[f"node_transition_{b}"] = StructureModuleTransition(ipa.c_s, dtype)
            trunk[f"bb_update_{b}"] = BackboneUpdate(ipa.c_s)
            if b < ipa.num_blocks - 1:
                trunk[f"edge_transition_{b}"] = EdgeTransition(
                    ipa.c_s, conf.edge_embed_size, conf.edge_embed_size, dtype
                )
        self.trunk = nn.ModuleDict(trunk)
        self.torsion_pred = TorsionAngles(ipa.c_s, 1)

    def forward(
        self,
        init_node_embed: torch.Tensor,  # [B, N, C_s]
        edge_embed: torch.Tensor,  # [B, N, N, C_z]
        rigids_t7: torch.Tensor,  # [B, N, 7] (translations in Angstroms)
        node_mask: torch.Tensor,  # [B, N]
        diffuse_mask: torch.Tensor,  # [B, N]
    ) -> dict[str, torch.Tensor]:
        ipa, dtype, t = self.conf.ipa, self.dtype, self.trunk
        if sp.active() is not None and any(t[f"ipa_{b}"].use_kernel for b in range(ipa.num_blocks)):
            raise ValueError(
                "sequence parallelism runs the edge-embedder and pair-MLP kernels on row "
                "blocks but not the fused IPA attention kernel; set model.ipa.use_pallas_ipa=False"
            )
        curr = Rigid.from_tensor7(rigids_t7).scale_trans(ipa.coordinate_scaling)
        init_node_embed = (init_node_embed * node_mask[..., None]).to(dtype)
        edge_embed = edge_embed.to(dtype)
        node_embed = init_node_embed
        node_mask_c = node_mask[..., None].to(dtype)

        for b in range(ipa.num_blocks):
            # Under sequence parallelism the block's rows are gathered from
            # every rank: the trunk's one collective a block.
            ipa_embed = sp.gather_rows(
                t[f"ipa_{b}"](node_embed, edge_embed, curr, node_mask), node_embed.shape[1])
            node_embed = t[f"ipa_ln_{b}"](node_embed + ipa_embed * node_mask_c)
            skip = t[f"skip_embed_{b}"](init_node_embed)
            tfmr_out = t[f"seq_tfmr_{b}"](torch.cat([node_embed, skip], dim=-1), node_mask)
            node_embed = node_embed + t[f"post_tfmr_{b}"](tfmr_out)
            node_embed = t[f"node_transition_{b}"](node_embed) * node_mask_c

            # Frame updates always in float32.
            rigid_update = t[f"bb_update_{b}"](
                (node_embed * diffuse_mask[..., None].to(dtype)).to(F32)
            )
            curr = curr.compose_q_update_vec(rigid_update, update_mask=diffuse_mask[..., None])

            if b < ipa.num_blocks - 1:
                edge_embed = t[f"edge_transition_{b}"](node_embed, edge_embed, node_mask)

        _, psi_pred = self.torsion_pred(node_embed.to(F32))
        return {
            "final_rigids_scaled_t7": curr.to_tensor7(),
            "psi": psi_pred,
            "node_embed": node_embed.to(F32),
        }
