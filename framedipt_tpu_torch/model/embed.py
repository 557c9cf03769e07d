"""Input featurization: timestep/positional embeddings, self-conditioning
distogram, node/edge embedders.

The edge MLP's first layer is concat-free: the reference feeds
concat([node_i, node_j, rel_offset_embedding, distogram]) to one Linear;
here its kernel rows are sliced so the node terms become O(N) products
broadcast over rows and columns, and the pairwise terms come from O(N)
factors (``kernels/edge_embedder.py``). The whole edge branch (first layer,
2 Linears, LayerNorm, edge mask) is one call of the edge-embedder wrapper,
through its autograd Function: the CUDA kernel on the card, its plain
PyTorch version on CPU tensors; its backward follows
``model.ipa.pallas_emb_bwd_impl``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from framedipt_tpu_torch.model.kernels.edge_embedder import (
    EdgeEmbedderFunction,
    expand_w_rel,
    rel_cp_factors,
)
from framedipt_tpu_torch.model.layers import Linear, LayerNorm, mlp3_layer_norm
from framedipt_tpu_torch.tools.config import ModelConfig

F32 = torch.float32


def get_index_embedding(
    indices: torch.Tensor, embed_size: int, max_len: int = 2056
) -> torch.Tensor:
    """Sine/cosine positional embedding of integer indices -> [..., E]."""
    k = torch.arange(embed_size // 2, dtype=F32, device=indices.device)
    angle = indices[..., None] * np.pi / (max_len ** (2.0 * k / embed_size))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def get_timestep_embedding(
    timesteps: torch.Tensor, embedding_dim: int, max_positions: int = 10000
) -> torch.Tensor:
    """DDPM timestep embedding; timesteps in [0, 1], shape [B] -> [B, E]."""
    timesteps = timesteps * max_positions
    half_dim = embedding_dim // 2
    emb_factor = np.log(max_positions) / (half_dim - 1)
    freq = torch.exp(torch.arange(half_dim, dtype=F32, device=timesteps.device) * -emb_factor)
    emb = timesteps.to(F32)[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class Embedder(nn.Module):
    """Node + edge input embedder. Parameter names follow the reference
    (``node_embedder.{0,2,4,5}``, ``edge_embedder.{0,2,4,5}``)."""

    def __init__(self, conf: ModelConfig, inpainting: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.conf = conf
        self.inpainting = inpainting
        self.dtype = dtype
        e = conf.embed
        # Node features: [aatype one-hot (21) if inpainting or input_aatype,
        # timestep embedding, fixed mask] then the index embedding.
        self.c_t = (21 if (inpainting or conf.input_aatype) else 0) + e.index_embed_size + 1
        c_rest = e.index_embed_size + (e.num_bins if e.embed_self_conditioning else 0)
        hidden = conf.edge_embed_size
        self.node_embedder = mlp3_layer_norm(
            self.c_t + e.index_embed_size, conf.node_embed_size, dtype
        )
        self.edge_embedder = nn.Sequential(
            Linear(2 * self.c_t + c_rest, hidden, dtype=dtype), nn.ReLU(),
            Linear(hidden, hidden, dtype=dtype), nn.ReLU(),
            Linear(hidden, hidden, dtype=dtype), LayerNorm(hidden, dtype=dtype),
        )

    def forward(
        self,
        seq_idx: torch.Tensor,  # [B, N] int
        t: torch.Tensor,  # [B]
        fixed_mask: torch.Tensor,  # [B, N]
        self_conditioning_ca: torch.Tensor,  # [B, N, 3]
        aatype: torch.Tensor | None,  # [B, N] int or None
        node_mask: torch.Tensor,  # [B, N]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(node_embed [B, N, C_s], edge_embed [B, N, N, C_z]); the edge
        output already carries the edge mask node_mask_i * node_mask_j."""
        e = self.conf.embed
        dtype = self.dtype
        num_batch, num_res = seq_idx.shape
        fixed_mask_c = fixed_mask[..., None]

        t_embed = get_timestep_embedding(t, e.index_embed_size)[:, None, :].expand(
            num_batch, num_res, e.index_embed_size
        )
        if aatype is not None:
            aatype_oh = torch.nn.functional.one_hot(aatype.long(), 21).to(F32)
            # Fixed residues are "clean": embed them at t = 1e-5.
            eps_embed = get_timestep_embedding(
                torch.full_like(t, 1e-5), e.index_embed_size
            )[:, None, :].expand(num_batch, num_res, e.index_embed_size)
            t_embed = torch.where(fixed_mask_c > 0.5, eps_embed, t_embed)
            prot_t_embed = torch.cat([aatype_oh, t_embed, fixed_mask_c], dim=-1)
        else:
            prot_t_embed = torch.cat([t_embed, fixed_mask_c], dim=-1)

        node_in = torch.cat(
            [prot_t_embed, get_index_embedding(seq_idx, e.index_embed_size)], dim=-1
        )
        node_embed = self.node_embedder(node_in)

        lin0, lin1, lin2, ln = (self.edge_embedder[i] for i in (0, 2, 4, 5))
        c_t = prot_t_embed.shape[-1]
        w0 = lin0.weight.t().to(dtype)  # [2 c_t + c_rest, hidden] kernel layout
        b0 = lin0.bias.to(dtype)
        w1 = lin1.weight.t().to(dtype).contiguous()
        b1 = lin1.bias.to(dtype)
        w2 = lin2.weight.t().to(dtype).contiguous()
        b2 = lin2.bias.to(dtype)
        prot_c = prot_t_embed.to(dtype)
        i_term = torch.matmul(prot_c, w0[:c_t])
        j_term = torch.matmul(prot_c, w0[c_t : 2 * c_t])

        n_rel = e.index_embed_size
        g, h = rel_cp_factors(seq_idx, n_rel)
        if e.embed_self_conditioning:
            lower = np.linspace(e.min_bin, e.max_bin, e.num_bins)
            upper = np.concatenate([lower[1:], [1e8]])
        else:
            lower = upper = np.zeros(0)  # no distogram: no pair gets a bin
        mask = node_mask.to(dtype).contiguous()
        ca = self_conditioning_ca.to(F32).contiguous()
        edge_embed = EdgeEmbedderFunction.apply(
            self.conf.ipa.pallas_emb_bwd_impl,
            tuple(float(x) for x in lower), tuple(float(x) for x in upper),
            g.to(dtype).contiguous(), h.to(dtype).contiguous(), ca, ca,
            i_term.contiguous(), j_term.contiguous(), mask, mask,
            expand_w_rel(w0[2 * c_t : 2 * c_t + n_rel]).contiguous(),
            w0[2 * c_t + n_rel :].contiguous(),
            b0, w1, b1, w2, b2, ln.weight, ln.bias,
        )
        return node_embed, edge_embed
