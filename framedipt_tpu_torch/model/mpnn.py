"""ProteinMPNN (inverse folding) in PyTorch.

:class:`ProteinMPNN` holds the weights under the reference ProteinMPNN's
state_dict names (``features.edge_embedding.weight``,
``encoder_layers.{i}.W1.weight``, ``W_s.weight``, ``W_out.weight``, ...), so
a published checkpoint (``v_48_020.pt``'s ``model_state_dict``) loads with
``strict=True``; the CA-only models' vestigial ``features.node_embedding``,
``features.norm_nodes`` and ``W_v``, which no forward reads, are held too.
The functions below compute on tensors with the module's weights, on the
device of their inputs, and draw from an explicit ``torch.Generator``:

- :func:`mpnn_features` / :func:`mpnn_features_ca`: the k-nearest-neighbour
  graph on CA and the edge features (25 atom-pair RBF maps of N, CA, C, O
  and the virtual CB; or for the CA-only models 9 RBF maps of the CA window
  and 7 orientation features), with the relative-position encoding;
- :func:`mpnn_encode`: the features and the encoder layers;
- :func:`mpnn_log_probs` (teacher-forced), :func:`mpnn_unconditional_log_probs`,
  :func:`mpnn_conditional_log_probs` and :func:`mpnn_scores`;
- :func:`mpnn_sample`: autoregressive sampling, one decode step a position
  as a Python loop (each step runs the decoder layers on that step's
  position of every batch row), with the omit, bias, per-residue bias, PSSM
  and per-position omit restraints; :func:`mpnn_tied_sample`: tied
  positions share one draw;
- :func:`featurize_chains`: chains of (sequence, backbone) -> inputs;
- :func:`init_mpnn_state_dict`: fresh weights for training.

Training mode (``train/mpnn_train.py``): :func:`mpnn_encode` and
:func:`mpnn_log_probs` take ``noise``, standard-normal draws that move the
backbone by ``cfg.augment_eps`` times them, and ``dropout``, a generator
whose draws drop the residual branches of every layer at ``cfg.dropout``
while the model is in training mode. Without them every path computes what
it computes at inference.

Neighbour lists and decoding orders come from stable sorts, so equal
distances and equal keys keep the lower index first. A draw is the argmax of
``log(probs + 1e-20)`` plus Gumbel noise from the generator: at a near-zero
temperature every draw is the argmax. Products are float32 (the entry
points turn TF32 off through ``tools/device.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

MPNN_ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"  # 21 letters, X = unknown

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MPNNConfig:
    """Hyperparameters of the published vanilla models (v_48_*: hidden 128,
    3 encoder and 3 decoder layers, 48 neighbours for v_48_020)."""

    hidden_dim: int = 128
    num_encoder_layers: int = 3
    num_decoder_layers: int = 3
    k_neighbors: int = 48
    vocab: int = 21
    num_rbf: int = 16
    num_positional_embeddings: int = 16
    max_relative_feature: int = 32
    scale: float = 30.0  # message-sum normaliser of the encoder and decoder layers
    ca_only: bool = False  # the CA-only models
    augment_eps: float = 0.0  # backbone noise std in training (0 at inference)
    dropout: float = 0.1  # residual-branch dropout in training


def edge_input_width(cfg: MPNNConfig) -> int:
    """Width of the edge features: positional encodings, then 25 RBF maps
    (vanilla) or 9 RBF maps and 7 orientation features (CA-only)."""
    rbf = cfg.num_rbf * 9 + 7 if cfg.ca_only else cfg.num_rbf * 25
    return cfg.num_positional_embeddings + rbf


# ---------------------------------------------------------------------------
# The module: weights under the reference names
# ---------------------------------------------------------------------------


class _PositionalEncodings(nn.Module):
    def __init__(self, num_embeddings: int, max_relative_feature: int) -> None:
        super().__init__()
        self.linear = nn.Linear(2 * max_relative_feature + 2, num_embeddings)


class _Features(nn.Module):
    def __init__(self, cfg: MPNNConfig) -> None:
        super().__init__()
        h = cfg.hidden_dim
        self.embeddings = _PositionalEncodings(cfg.num_positional_embeddings,
                                               cfg.max_relative_feature)
        if cfg.ca_only:  # never read by a forward
            self.node_embedding = nn.Linear(3, h, bias=False)
            self.norm_nodes = nn.LayerNorm(h)
        self.edge_embedding = nn.Linear(edge_input_width(cfg), h, bias=False)
        self.norm_edges = nn.LayerNorm(h)


class _FeedForward(nn.Module):
    def __init__(self, h: int) -> None:
        super().__init__()
        self.W_in = nn.Linear(h, 4 * h)
        self.W_out = nn.Linear(4 * h, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.W_out(F.gelu(self.W_in(x)))


class _EncLayer(nn.Module):
    def __init__(self, h: int) -> None:
        super().__init__()
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(h), nn.LayerNorm(h), nn.LayerNorm(h)
        self.W1, self.W2, self.W3 = nn.Linear(3 * h, h), nn.Linear(h, h), nn.Linear(h, h)
        self.W11, self.W12, self.W13 = nn.Linear(3 * h, h), nn.Linear(h, h), nn.Linear(h, h)
        self.dense = _FeedForward(h)


class _DecLayer(nn.Module):
    def __init__(self, h: int) -> None:
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(h), nn.LayerNorm(h)
        self.W1, self.W2, self.W3 = nn.Linear(4 * h, h), nn.Linear(h, h), nn.Linear(h, h)
        self.dense = _FeedForward(h)


class ProteinMPNN(nn.Module):
    """The weights of one ProteinMPNN model and its config."""

    def __init__(self, cfg: MPNNConfig = MPNNConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.features = _Features(cfg)
        self.W_e = nn.Linear(h, h)
        if cfg.ca_only:  # never read by a forward
            self.W_v = nn.Linear(h, h)
        self.W_s = nn.Embedding(cfg.vocab, h)
        self.encoder_layers = nn.ModuleList(_EncLayer(h) for _ in range(cfg.num_encoder_layers))
        self.decoder_layers = nn.ModuleList(_DecLayer(h) for _ in range(cfg.num_decoder_layers))
        self.W_out = nn.Linear(h, cfg.vocab)


def mpnn_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's MPNN params (a nested dict of arrays: Linear
    weights [in, out]) -> this module's state_dict (Linear weights [out,
    in]). A CA-only model's vestigial tensors, which the JAX params do not
    hold, come back as zeros, so the result loads with ``strict=True``."""

    def arr(x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, np.float32))

    sd: dict[str, torch.Tensor] = {}

    def lin(dst: str, p: Mapping) -> None:
        sd[f"{dst}.weight"] = arr(np.asarray(p["w"]).T)
        if "b" in p:
            sd[f"{dst}.bias"] = arr(p["b"])

    def ln(dst: str, p: Mapping) -> None:
        sd[f"{dst}.weight"] = arr(p["scale"])
        sd[f"{dst}.bias"] = arr(p["bias"])

    feats = params["features"]
    lin("features.embeddings.linear", feats["pos_emb"])
    lin("features.edge_embedding", feats["edge_embedding"])
    ln("features.norm_edges", feats["norm_edges"])
    lin("W_e", params["W_e"])
    sd["W_s.weight"] = arr(params["W_s"])
    for i, p in enumerate(params["encoder"]):
        s = f"encoder_layers.{i}"
        for name in ("W1", "W2", "W3", "W11", "W12", "W13"):
            lin(f"{s}.{name}", p[name])
        for name in ("norm1", "norm2", "norm3"):
            ln(f"{s}.{name}", p[name])
        lin(f"{s}.dense.W_in", p["ffn_in"])
        lin(f"{s}.dense.W_out", p["ffn_out"])
    for i, p in enumerate(params["decoder"]):
        s = f"decoder_layers.{i}"
        for name in ("W1", "W2", "W3"):
            lin(f"{s}.{name}", p[name])
        for name in ("norm1", "norm2"):
            ln(f"{s}.{name}", p[name])
        lin(f"{s}.dense.W_in", p["ffn_in"])
        lin(f"{s}.dense.W_out", p["ffn_out"])
    lin("W_out", params["W_out"])
    return with_unused_tensors(sd)


def with_unused_tensors(sd: Mapping[str, Any]) -> dict[str, Any]:
    """``sd`` with zeros for the CA-only models' vestigial tensors it lacks
    (a state_dict from the JAX params or a JAX-written checkpoint holds
    none), so that it loads with ``strict=True``."""
    out = dict(sd)
    if sd["features.edge_embedding.weight"].shape[1] != 25 * 16 + 16:  # CA-only
        h = sd["W_e.weight"].shape[0]
        for name, shape in (("features.node_embedding.weight", (h, 3)),
                            ("features.norm_nodes.weight", (h,)),
                            ("features.norm_nodes.bias", (h,)),
                            ("W_v.weight", (h, h)), ("W_v.bias", (h,))):
            out.setdefault(name, torch.zeros(shape))
    return out


def init_mpnn_state_dict(cfg: MPNNConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """Fresh weights under the reference names, on the JAX package's
    distributions (``init_mpnn_params``): every matrix xavier-uniform,
    U(-a, a) with a = sqrt(6 / (fan_in + fan_out)), every bias 0, LayerNorm
    scales 1. Drawn on the CPU from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in ProteinMPNN(cfg).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if len(shape) == 2:
            a = math.sqrt(6.0 / (shape[0] + shape[1]))
            sd[name] = (2.0 * torch.rand(shape, generator=gen) - 1.0) * a
        elif name.endswith(".weight"):  # LayerNorm scales
            sd[name] = torch.ones(shape)
        else:
            sd[name] = torch.zeros(shape)
    return sd


def config_from_state_dict(sd: Mapping[str, Any], k_neighbors: int = 48) -> MPNNConfig:
    """The config a reference-named state_dict was trained with: the
    CA-only models by their edge-embedding input width (9*16+7+16 = 167,
    vanilla 25*16+16 = 416), hidden width and layer counts from the weights."""
    edge_w = sd["features.edge_embedding.weight"]
    n_enc = len({k.split(".")[1] for k in sd if k.startswith("encoder_layers.")})
    n_dec = len({k.split(".")[1] for k in sd if k.startswith("decoder_layers.")})
    return MPNNConfig(
        hidden_dim=int(edge_w.shape[0]),
        num_encoder_layers=n_enc or 3,
        num_decoder_layers=n_dec or 3,
        k_neighbors=int(k_neighbors),
        ca_only=int(edge_w.shape[1]) != 416,
    )


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _gather_nodes(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """nodes [B, L, C] at neighbour indices [B, L, K] -> [B, L, K, C]."""
    b, _, c = nodes.shape
    flat = torch.gather(nodes, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
    return flat.reshape(*idx.shape, c)


def _cat_neighbors_nodes(h_nodes: torch.Tensor, h_neighbors: torch.Tensor,
                         e_idx: torch.Tensor) -> torch.Tensor:
    return torch.cat([h_neighbors, _gather_nodes(h_nodes, e_idx)], dim=-1)


def _messages(layer: nn.Module, w1: str, w2: str, w3: str, x: torch.Tensor) -> torch.Tensor:
    x = F.gelu(getattr(layer, w1)(x))
    return getattr(layer, w3)(F.gelu(getattr(layer, w2)(x)))


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout: identity without a generator or at rate 0; else an
    element is kept where a uniform draw from ``generator`` falls below 1 -
    rate, and scaled by 1 / (1 - rate)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _enc_layer(layer: _EncLayer, h_V, h_E, e_idx, mask_V, mask_attend, scale,
               dropout: float = 0.0, generator: torch.Generator | None = None):
    """Node messages over the neighbours, the feed-forward, then the edge
    update; with a ``generator``, dropout on the message sum, the
    feed-forward and the edge update, drawn in that order."""
    h_EV = _cat_neighbors_nodes(h_V, h_E, e_idx)
    h_EV = torch.cat([h_V[:, :, None, :].expand(*h_EV.shape[:3], h_V.shape[-1]), h_EV], -1)
    msg = _messages(layer, "W1", "W2", "W3", h_EV) * mask_attend[..., None]
    h_V = layer.norm1(h_V + _dropout(torch.sum(msg, dim=-2) / scale, dropout, generator))
    h_V = layer.norm2(h_V + _dropout(layer.dense(h_V), dropout, generator))
    h_V = h_V * mask_V[..., None]

    h_EV = _cat_neighbors_nodes(h_V, h_E, e_idx)
    h_EV = torch.cat([h_V[:, :, None, :].expand(*h_EV.shape[:3], h_V.shape[-1]), h_EV], -1)
    msg = _messages(layer, "W11", "W12", "W13", h_EV)
    h_E = layer.norm3(h_E + _dropout(msg, dropout, generator))
    return h_V, h_E


def _dec_layer(layer: _DecLayer, h_V, h_ESV, mask_V, scale,
               dropout: float = 0.0, generator: torch.Generator | None = None):
    """h_V [..., H], h_ESV [..., K, 3H]: the whole [B, L] pass and one
    position of each batch row [B] alike; with a ``generator``, dropout on
    the message sum, then on the feed-forward."""
    h_EV = torch.cat([h_V[..., None, :].expand(*h_ESV.shape[:-1], h_V.shape[-1]), h_ESV], -1)
    msg = _messages(layer, "W1", "W2", "W3", h_EV)
    h_V = layer.norm1(h_V + _dropout(torch.sum(msg, dim=-2) / scale, dropout, generator))
    h_V = layer.norm2(h_V + _dropout(layer.dense(h_V), dropout, generator))
    return h_V * mask_V[..., None]


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------

# Atom order [N, CA, C, O, CB] (CB the ideal virtual beta carbon); the 25
# pairs in the reference's order, pair 0 (CA-CA) taking the masked
# neighbour distances.
_ATOM = {"N": 0, "Ca": 1, "C": 2, "O": 3, "Cb": 4}
_PAIR_ORDER = [
    ("Ca", "Ca"),
    ("N", "N"), ("C", "C"), ("O", "O"), ("Cb", "Cb"),
    ("Ca", "N"), ("Ca", "C"), ("Ca", "O"), ("Ca", "Cb"),
    ("N", "C"), ("N", "O"), ("N", "Cb"), ("Cb", "C"), ("Cb", "O"),
    ("O", "C"),
    ("N", "Ca"), ("C", "Ca"), ("O", "Ca"), ("Cb", "Ca"),
    ("C", "N"), ("O", "N"), ("Cb", "N"), ("C", "Cb"), ("O", "Cb"),
    ("C", "O"),
]
_PAIR_IDX = np.array([[_ATOM[a], _ATOM[b]] for a, b in _PAIR_ORDER])
# The CA-only models' 9 pairs of the (previous, self, next) CA window.
_CA_PAIR_IDX = np.array([[1, 1], [0, 0], [2, 2], [0, 1], [0, 2], [1, 0], [1, 2], [2, 0], [2, 1]])


def _rbf(d: torch.Tensor, num_rbf: int) -> torch.Tensor:
    """Gaussian bins on [2, 22] A."""
    mu = torch.linspace(2.0, 22.0, num_rbf, device=d.device, dtype=F32)
    sigma = (22.0 - 2.0) / num_rbf
    return torch.exp(-(((d[..., None] - mu) / sigma) ** 2))


def _knn(ca: torch.Tensor, mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest neighbours on CA (distances, indices [B, L, k]): pairs
    with a masked residue are pushed to the row's largest distance, so they
    are taken only when fewer than k valid neighbours exist. A stable sort:
    equal distances keep the lower index first."""
    mask_2d = mask[:, :, None] * mask[:, None, :]
    d2 = torch.sum((ca[:, :, None, :] - ca[:, None, :, :]) ** 2, dim=-1)
    d = mask_2d * torch.sqrt(d2 + 1e-6)
    d_max = torch.amax(d, dim=-1, keepdim=True)
    d_adjust = d + (1.0 - mask_2d) * d_max
    values, idx = torch.sort(d_adjust, dim=-1, stable=True)
    return values[..., :k], idx[..., :k]


def _positional(model: ProteinMPNN, residue_idx, chain_labels, e_idx) -> torch.Tensor:
    """The relative-position encoding of each edge: the clipped offset
    within a chain, one extra class between chains."""
    cfg = model.cfg
    offset = residue_idx[:, :, None] - residue_idx[:, None, :]
    offset = torch.gather(offset, 2, e_idx)
    same_chain = (chain_labels[:, :, None] == chain_labels[:, None, :]).long()
    e_chains = torch.gather(same_chain, 2, e_idx)
    mrel = cfg.max_relative_feature
    d = torch.clamp(offset + mrel, 0, 2 * mrel) * e_chains + (1 - e_chains) * (2 * mrel + 1)
    return model.features.embeddings.linear(F.one_hot(d.long(), 2 * mrel + 2).to(F32))


def mpnn_features(model: ProteinMPNN, x, mask, residue_idx, chain_labels):
    """Backbone [B, L, 4, 3] (N, CA, C, O) -> (edge embeddings [B, L, K, H],
    neighbour indices [B, L, K])."""
    cfg = model.cfg
    n, ca, c, o = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    bvec = ca - n
    cvec = c - ca
    avec = torch.linalg.cross(bvec, cvec, dim=-1)
    cb = -0.58273431 * avec + 0.56802827 * bvec - 0.54067466 * cvec + ca

    k = min(cfg.k_neighbors, x.shape[1])
    d_neighbors, e_idx = _knn(ca, mask, k)

    atoms = torch.stack([n, ca, c, o, cb], dim=2)  # [B, L, 5, 3]
    bsz, length = x.shape[:2]
    nbr = _gather_nodes(atoms.reshape(bsz, length, 15), e_idx).reshape(bsz, length, k, 5, 3)
    diff = atoms[:, :, None, :, None, :] - nbr[:, :, :, None, :, :]
    d_all = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-6)  # [B, L, K, 5, 5]
    d_pairs = d_all[..., _PAIR_IDX[:, 0], _PAIR_IDX[:, 1]].clone()  # [B, L, K, 25]
    d_pairs[..., 0] = d_neighbors
    rbf_all = _rbf(d_pairs, cfg.num_rbf).reshape(bsz, length, k, 25 * cfg.num_rbf)

    pos = _positional(model, residue_idx, chain_labels, e_idx)
    e = model.features.edge_embedding(torch.cat([pos, rbf_all], dim=-1))
    return model.features.norm_edges(e), e_idx


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """v / max(|v|, eps) over the last axis."""
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _quaternions(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (x, y, z,
    then w; the signs from the off-diagonals)."""
    rxx, ryy, rzz = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    magnitudes = 0.5 * torch.sqrt(torch.abs(
        1 + torch.stack([rxx - ryy - rzz, -rxx + ryy - rzz, -rxx - ryy + rzz], -1)))
    signs = torch.sign(torch.stack([
        r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1],
    ], -1))
    xyz = signs * magnitudes
    w = torch.sqrt(torch.relu(1 + rxx + ryy + rzz))[..., None] / 2.0
    return _normalize(torch.cat([xyz, w], -1))


def _orientations_coarse(ca: torch.Tensor, e_idx: torch.Tensor, eps: float = 1e-6):
    """Local frames from the CA walk (CA-CA steps outside 3.6-4.0 A
    dropped), each neighbour's direction in the residue's frame and the
    quaternion of the relative rotation to the neighbour's frame. Returns
    (angle features [B, L, 3], orientation features [B, L, K, 7])."""
    dx = ca[:, 1:, :] - ca[:, :-1, :]
    dx_norm = torch.linalg.norm(dx, dim=-1)
    dx = dx * ((3.6 < dx_norm) & (dx_norm < 4.0))[:, :, None]
    u = _normalize(dx)
    u_2, u_1, u_0 = u[:, :-2, :], u[:, 1:-1, :], u[:, 2:, :]
    n_2 = _normalize(torch.linalg.cross(u_2, u_1, dim=-1))
    n_1 = _normalize(torch.linalg.cross(u_1, u_0, dim=-1))

    cos_a = torch.clamp(-(u_1 * u_0).sum(-1), -1 + eps, 1 - eps)
    a = torch.arccos(cos_a)
    cos_d = torch.clamp((n_2 * n_1).sum(-1), -1 + eps, 1 - eps)
    d = torch.sign((u_2 * n_1).sum(-1)) * torch.arccos(cos_d)
    ad = torch.stack([torch.cos(a), torch.sin(a) * torch.cos(d), torch.sin(a) * torch.sin(d)], 2)
    ad = F.pad(ad, (0, 0, 1, 2))

    o_1 = _normalize(u_2 - u_1)
    o = torch.stack([o_1, n_2, torch.linalg.cross(o_1, n_2, dim=-1)], 2)  # [B, L-3, 3, 3]
    o_flat = F.pad(o.reshape(o.shape[0], o.shape[1], 9), (0, 0, 1, 2))
    o_neighbors = _gather_nodes(o_flat, e_idx)
    x_neighbors = _gather_nodes(ca, e_idx)

    o_mat = o_flat.reshape(o_flat.shape[0], o_flat.shape[1], 3, 3)
    on_mat = o_neighbors.reshape(*o_neighbors.shape[:3], 3, 3)
    dxn = x_neighbors - ca[:, :, None, :]
    du = _normalize(torch.einsum("blij,blkj->blki", o_mat, dxn))
    r_rel = torch.einsum("blji,blkjm->blkim", o_mat, on_mat)
    return ad, torch.cat([du, _quaternions(r_rel)], -1)


def mpnn_features_ca(model: ProteinMPNN, ca, mask, residue_idx, chain_labels):
    """CA trace [B, L, 3] -> (edge embeddings, neighbour indices): 9 RBF
    maps over the CA window, 7 orientation features and the positional
    encodings."""
    cfg = model.cfg
    k = min(cfg.k_neighbors, ca.shape[1])
    d_neighbors, e_idx = _knn(ca, mask, k)

    ca_0 = F.pad(ca[:, :-1, :], (0, 0, 1, 0))  # the previous residue
    ca_2 = F.pad(ca[:, 1:, :], (0, 0, 0, 1))  # the next residue
    _, o_features = _orientations_coarse(ca, e_idx)

    window = torch.stack([ca_0, ca, ca_2], dim=2)  # [B, L, 3, 3]
    bsz, length = ca.shape[:2]
    nbr = _gather_nodes(window.reshape(bsz, length, 9), e_idx).reshape(bsz, length, k, 3, 3)
    diff = window[:, :, None, :, None, :] - nbr[:, :, :, None, :, :]
    d_all = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-6)  # [B, L, K, 3, 3]
    d_pairs = d_all[..., _CA_PAIR_IDX[:, 0], _CA_PAIR_IDX[:, 1]].clone()
    d_pairs[..., 0] = d_neighbors
    rbf_all = _rbf(d_pairs, cfg.num_rbf).reshape(bsz, length, k, 9 * cfg.num_rbf)

    pos = _positional(model, residue_idx, chain_labels, e_idx)
    e = model.features.edge_embedding(torch.cat([pos, rbf_all, o_features], dim=-1))
    return model.features.norm_edges(e), e_idx


# ---------------------------------------------------------------------------
# Encoder and decoder passes
# ---------------------------------------------------------------------------


def mpnn_encode(model: ProteinMPNN, x, mask, residue_idx, chain_labels, noise=None,
                dropout: torch.Generator | None = None):
    """The features and the encoder layers -> (h_V, h_E, e_idx). For the
    CA-only models ``x`` is [B, L, 3] or [B, L, 1, 3]. In training,
    ``noise`` (standard-normal draws of x's shape) moves the backbone by
    ``cfg.augment_eps * noise`` before the features, and ``dropout`` draws
    the dropout masks of every layer while the model is in training mode."""
    cfg = model.cfg
    if noise is not None:
        x = x + cfg.augment_eps * noise
    dropout = dropout if model.training else None
    if cfg.ca_only:
        ca = x[:, :, 0, :] if x.dim() == 4 else x
        e, e_idx = mpnn_features_ca(model, ca, mask, residue_idx, chain_labels)
    else:
        e, e_idx = mpnn_features(model, x, mask, residue_idx, chain_labels)
    h_V = torch.zeros(*e.shape[:2], cfg.hidden_dim, dtype=F32, device=e.device)
    h_E = model.W_e(e)
    mask_attend = mask[:, :, None] * _gather_nodes(mask[:, :, None], e_idx)[..., 0]
    for layer in model.encoder_layers:
        h_V, h_E = _enc_layer(layer, h_V, h_E, e_idx, mask, mask_attend, cfg.scale,
                              cfg.dropout, dropout)
    return h_V, h_E, e_idx


def _decoding_order_from_randn(chain_mask: torch.Tensor, randn: torch.Tensor) -> torch.Tensor:
    """argsort((chain_mask + 1e-4) * |randn|), stable: the positions not
    designed decode first."""
    return torch.argsort((chain_mask + 0.0001) * torch.abs(randn), dim=-1, stable=True)


def _autoregressive_masks(decoding_order, e_idx, mask):
    """(mask_bw, mask_fw) [B, L, K, 1]: mask_bw is 1 where the neighbour
    decodes strictly before the position."""
    rank = torch.argsort(decoding_order, dim=-1, stable=True)  # decode step of each position
    omb = (rank[:, None, :] < rank[:, :, None]).to(F32)  # [B, q, p]
    mask_attend = torch.gather(omb, 2, e_idx)[..., None]
    mask_1d = mask[:, :, None, None]
    return mask_1d * mask_attend, mask_1d * (1.0 - mask_attend)


def mpnn_log_probs(model: ProteinMPNN, x, s, mask, chain_m, residue_idx, chain_labels,
                   randn=None, decoding_order=None, noise=None,
                   dropout: torch.Generator | None = None) -> torch.Tensor:
    """Teacher-forced log-probabilities [B, L, 21], in ``decoding_order``
    or in the order that ``randn`` draws; ``noise`` and ``dropout`` as in
    :func:`mpnn_encode` (the encoder's masks drawn first)."""
    h_V, h_E, e_idx = mpnn_encode(model, x, mask, residue_idx, chain_labels, noise, dropout)
    dropout = dropout if model.training else None
    h_S = model.W_s(s.long())
    h_ES = _cat_neighbors_nodes(h_S, h_E, e_idx)
    h_EX = _cat_neighbors_nodes(torch.zeros_like(h_S), h_E, e_idx)
    h_EXV = _cat_neighbors_nodes(h_V, h_EX, e_idx)

    chain_m = chain_m * mask
    if decoding_order is None:
        decoding_order = _decoding_order_from_randn(chain_m, randn)
    mask_bw, mask_fw = _autoregressive_masks(decoding_order, e_idx, mask)
    h_EXV_fw = mask_fw * h_EXV
    for layer in model.decoder_layers:
        h_ESV = mask_bw * _cat_neighbors_nodes(h_V, h_ES, e_idx) + h_EXV_fw
        h_V = _dec_layer(layer, h_V, h_ESV, mask, model.cfg.scale, model.cfg.dropout, dropout)
    return F.log_softmax(model.W_out(h_V), dim=-1)


def mpnn_unconditional_log_probs(model: ProteinMPNN, x, mask, residue_idx,
                                 chain_labels) -> torch.Tensor:
    """log p(s_i | backbone) in one pass: every position sees the encoder's
    context only."""
    h_V, h_E, e_idx = mpnn_encode(model, x, mask, residue_idx, chain_labels)
    h_EX = _cat_neighbors_nodes(torch.zeros_like(h_V), h_E, e_idx)
    h_EXV_fw = mask[:, :, None, None] * _cat_neighbors_nodes(h_V, h_EX, e_idx)
    for layer in model.decoder_layers:
        h_V = _dec_layer(layer, h_V, h_EXV_fw, mask, model.cfg.scale)
    return F.log_softmax(model.W_out(h_V), dim=-1)


def mpnn_scores(s: torch.Tensor, log_probs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean negative log-likelihood of ``s`` per batch row."""
    nll = -torch.gather(log_probs, -1, s.long()[..., None])[..., 0]
    return torch.sum(nll * mask, dim=-1) / torch.sum(mask, dim=-1)


def mpnn_conditional_log_probs(model: ProteinMPNN, x, s, mask, chain_m, residue_idx,
                               chain_labels, randn, backbone_only: bool = False,
                               chunk: int = 8) -> torch.Tensor:
    """log p(s_i | s_j for j != i, backbone) for each designed position i
    (the position decodes last), or with ``backbone_only`` log p(s_i |
    backbone) (it decodes first); ``randn`` orders the other positions, the
    same for every i. Encodes once, then runs the decoder layers for
    ``chunk`` positions at a time stacked on the batch axis. Rows not
    designed (chain_m * mask = 0) are zeros."""
    h_V_enc, h_E, e_idx = mpnn_encode(model, x, mask, residue_idx, chain_labels)
    h_S = model.W_s(s.long())
    h_ES = _cat_neighbors_nodes(h_S, h_E, e_idx)
    h_EX = _cat_neighbors_nodes(torch.zeros_like(h_S), h_E, e_idx)
    h_EXV = _cat_neighbors_nodes(h_V_enc, h_EX, e_idx)
    chain_m = chain_m * mask
    bsz, length = s.shape
    out = torch.zeros(bsz, length, model.cfg.vocab, dtype=F32, device=x.device)

    def rep(a: torch.Tensor, n: int) -> torch.Tensor:
        return a.repeat(n, *([1] * (a.dim() - 1)))

    for start in range(0, length, chunk):
        idx = torch.arange(start, min(start + chunk, length), device=x.device)
        n = len(idx)
        rows = torch.arange(n, device=x.device)
        order_mask = torch.full((n, length), 1.0 if backbone_only else 0.0, device=x.device)
        order_mask[rows, idx] = 0.0 if backbone_only else 1.0
        # [n * B, L]: position idx[c] for batch row b at c * B + b.
        keys = (order_mask[:, None, :] + 0.0001) * torch.abs(randn)[None]
        decoding_order = torch.argsort(keys.reshape(n * bsz, length), dim=-1, stable=True)
        e_idx_n, mask_n = rep(e_idx, n), rep(mask, n)
        mask_bw, mask_fw = _autoregressive_masks(decoding_order, e_idx_n, mask_n)
        h_EXV_fw = mask_fw * rep(h_EXV, n)
        h_ES_n = rep(h_ES, n)
        h_V = rep(h_V_enc, n)
        for layer in model.decoder_layers:
            h_ESV = mask_bw * _cat_neighbors_nodes(h_V, h_ES_n, e_idx_n) + h_EXV_fw
            h_V = _dec_layer(layer, h_V, h_ESV, mask_n, model.cfg.scale)
        h_V = h_V.reshape(n, bsz, length, -1)[rows, :, idx]  # [n, B, H]
        out[:, idx] = F.log_softmax(model.W_out(h_V), dim=-1).transpose(0, 1)
    return torch.where(chain_m[..., None] > 0, out, torch.zeros((), device=x.device))


# ---------------------------------------------------------------------------
# Autoregressive sampling
# ---------------------------------------------------------------------------


def _draw(probs: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row: argmax of log(probs + 1e-20) + Gumbel."""
    return torch.argmax(torch.log(probs + 1e-20) + gumbel, dim=-1)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(F32).tiny)
    return -torch.log(-torch.log(u))


def _defaults(bsz, length, vocab, device, omit_aas, bias_aas, chain_m_pos, bias_by_res):
    if omit_aas is None:  # the runner's default: never X
        omit_aas = torch.zeros(vocab, device=device)
        omit_aas[MPNN_ALPHABET.index("X")] = 1.0
    if bias_aas is None:
        bias_aas = torch.zeros(vocab, device=device)
    if chain_m_pos is None:
        chain_m_pos = torch.ones(bsz, length, device=device)
    if bias_by_res is None:
        bias_by_res = torch.zeros(bsz, length, vocab, device=device)
    return omit_aas, bias_aas, chain_m_pos, bias_by_res


def _restrained_probs(logits, temperature, omit_aas, bias_aas, bias_res, pssm_coef, pssm_bias,
                      pssm_multi, pssm_log_odds_mask, omit_aa_mask):
    """The step's distribution from the logits at ``temperature`` (already
    divided): omit and bias, softmax, then the PSSM bias mix, the log-odds
    mask renormalised, the per-position omit mask renormalised, in that
    order. The per-position restraints are the step's rows, or None."""
    logits = logits - omit_aas[None, :] * 1e8 + bias_aas[None, :] / temperature \
        + bias_res / temperature
    probs = F.softmax(logits, dim=-1)
    if pssm_coef is not None and pssm_bias is not None:
        coef = pssm_multi * pssm_coef[:, None]
        probs = (1.0 - coef) * probs + coef * pssm_bias
    if pssm_log_odds_mask is not None:
        pm = probs * pssm_log_odds_mask + probs * 0.001
        probs = pm / torch.sum(pm, dim=-1, keepdim=True)
    if omit_aa_mask is not None:
        pm = probs * (1.0 - omit_aa_mask)
        probs = pm / torch.sum(pm, dim=-1, keepdim=True)
    return probs


@torch.inference_mode()
def mpnn_sample(model: ProteinMPNN, generator: torch.Generator, x, randn, s_true, chain_mask,
                chain_labels, residue_idx, mask, temperature: float = 0.1,
                omit_aas=None, bias_aas=None, chain_m_pos=None, omit_aa_mask=None,
                bias_by_res=None, pssm_coef=None, pssm_bias=None, pssm_multi: float = 0.0,
                pssm_log_odds_mask=None) -> dict[str, torch.Tensor]:
    """Sample the designed positions (chain_mask * chain_m_pos * mask) in
    the order ``randn`` draws; the others keep ``s_true``. One Python step a
    position: the decoder layers on that position of every batch row, their
    outputs written into the per-layer node states. Returns S [B, L], the
    step distributions ``probs`` [B, L, 21] (zero rows where not designed)
    and ``decoding_order``. ``pssm_coef`` with ``pssm_bias`` turns on the
    PSSM mix, ``pssm_log_odds_mask`` the log-odds renormalisation."""
    bsz, length = x.shape[:2]
    device = x.device
    vocab = model.cfg.vocab
    omit_aas, bias_aas, chain_m_pos, bias_by_res = _defaults(
        bsz, length, vocab, device, omit_aas, bias_aas, chain_m_pos, bias_by_res)

    h_V_enc, h_E, e_idx = mpnn_encode(model, x, mask, residue_idx, chain_labels)
    chain_mask = chain_mask * chain_m_pos * mask
    decoding_order = _decoding_order_from_randn(chain_mask, randn)
    mask_bw, mask_fw = _autoregressive_masks(decoding_order, e_idx, mask)
    h_EX = _cat_neighbors_nodes(torch.zeros_like(h_V_enc), h_E, e_idx)
    h_EXV_fw = mask_fw * _cat_neighbors_nodes(h_V_enc, h_EX, e_idx)

    # Everything that does not change from step to step, in decode order.
    b_idx = torch.arange(bsz, device=device)[:, None]
    o = decoding_order

    def ordered(a):
        return None if a is None else a[b_idx, o]

    e_idx_o, h_E_o, h_EXV_o, mask_bw_o = ordered(e_idx), ordered(h_E), ordered(h_EXV_fw), \
        ordered(mask_bw)
    chain_mask_o, mask_o, s_true_o = ordered(chain_mask), ordered(mask), ordered(s_true.long())
    bias_res_o, coef_o, pbias_o = ordered(bias_by_res), ordered(pssm_coef), ordered(pssm_bias)
    lo_mask_o, omit_mask_o = ordered(pssm_log_odds_mask), ordered(omit_aa_mask)
    gumbel = _gumbel((length, bsz, vocab), generator, device)

    h = model.cfg.hidden_dim
    h_V = [h_V_enc] + [torch.zeros_like(h_V_enc) for _ in model.decoder_layers]
    h_S = torch.zeros_like(h_V_enc)
    S = torch.zeros(bsz, length, dtype=torch.long, device=device)
    probs_out = torch.zeros(bsz, length, vocab, dtype=F32, device=device)
    rows = b_idx[:, 0]
    for step in range(length):
        t = o[:, step]
        nbr = e_idx_o[:, step, :, None].expand(-1, -1, h)
        h_es_t = torch.cat([h_E_o[:, step], torch.gather(h_S, 1, nbr)], dim=-1)
        for layer, dec in enumerate(model.decoder_layers):
            h_esv = torch.cat([h_es_t, torch.gather(h_V[layer], 1, nbr)], dim=-1)
            h_esv = mask_bw_o[:, step] * h_esv + h_EXV_o[:, step]
            h_V[layer + 1][rows, t] = _dec_layer(dec, h_V[layer][rows, t], h_esv,
                                                 mask_o[:, step], model.cfg.scale)
        logits = model.W_out(h_V[-1][rows, t]) / temperature
        probs = _restrained_probs(
            logits, temperature, omit_aas, bias_aas, bias_res_o[:, step],
            None if coef_o is None else coef_o[:, step],
            None if pbias_o is None else pbias_o[:, step], pssm_multi,
            None if lo_mask_o is None else lo_mask_o[:, step],
            None if omit_mask_o is None else omit_mask_o[:, step])
        designed = chain_mask_o[:, step]
        s_t = torch.where(designed > 0, _draw(probs, gumbel[step]), s_true_o[:, step])
        probs_out[rows, t] = designed[:, None] * probs
        h_S[rows, t] = model.W_s.weight[s_t]
        S[rows, t] = s_t
    return {"S": S, "probs": probs_out, "decoding_order": decoding_order}


@torch.inference_mode()
def mpnn_tied_sample(model: ProteinMPNN, generator: torch.Generator, x, randn, s_true,
                     chain_mask, chain_labels, residue_idx, mask,
                     tied_pos: tuple[tuple[int, ...], ...], temperature: float = 0.1,
                     omit_aas=None, bias_aas=None, chain_m_pos=None, omit_aa_mask=None,
                     bias_by_res=None, tied_beta=None, pssm_coef=None, pssm_bias=None,
                     pssm_multi: float = 0.0, pssm_log_odds_mask=None) -> dict[str, torch.Tensor]:
    """Tied sampling: the members of a group of ``tied_pos`` decode at
    consecutive steps and share one draw from their tied_beta-weighted mean
    logits; the sampled residue goes to every member. The groups (the ties,
    then every other position alone) decode in the order of their earliest
    member under batch row 0's ``randn`` order, the members in their
    ``tied_pos`` order, one order for the whole batch. The per-residue bias,
    the PSSM rows and the fallback to ``s_true`` read the group's last
    member. A member masked in every batch row ends the group: from there
    no member runs the decoder, every member takes that member's ``s_true``
    and no probs are written. The group table and that control flow are on
    the host (one copy of row 0's keys and of ``mask``)."""
    bsz, length = x.shape[:2]
    device = x.device
    vocab = model.cfg.vocab
    omit_aas, bias_aas, chain_m_pos, bias_by_res = _defaults(
        bsz, length, vocab, device, omit_aas, bias_aas, chain_m_pos, bias_by_res)
    if tied_beta is None:
        tied_beta = torch.ones(length, device=device)

    groups = [tuple(int(p) for p in g) for g in tied_pos]
    in_group = {p for g in groups for p in g}
    groups += [(i,) for i in range(length) if i not in in_group]

    h_V_enc, h_E, e_idx = mpnn_encode(model, x, mask, residue_idx, chain_labels)
    chain_mask = chain_mask * chain_m_pos * mask

    keys0 = ((chain_mask[0] + 0.0001) * torch.abs(randn[0])).cpu().numpy()
    pos_rank = np.argsort(np.argsort(keys0, kind="stable"), kind="stable")
    ordered_groups = [groups[g] for g in np.argsort([min(pos_rank[p] for p in g)
                                                     for g in groups], kind="stable")]
    flat_order = torch.as_tensor([p for g in ordered_groups for p in g], device=device)
    decoding_order = flat_order[None].repeat(bsz, 1)
    mask_bw, mask_fw = _autoregressive_masks(decoding_order, e_idx, mask)
    h_EX = _cat_neighbors_nodes(torch.zeros_like(h_V_enc), h_E, e_idx)
    h_EXV_fw = mask_fw * _cat_neighbors_nodes(h_V_enc, h_EX, e_idx)
    masked_everywhere = (mask == 0).all(dim=0).cpu().numpy()

    h = model.cfg.hidden_dim
    h_V = [h_V_enc] + [torch.zeros_like(h_V_enc) for _ in model.decoder_layers]
    h_S = torch.zeros_like(h_V_enc)
    S = torch.zeros(bsz, length, dtype=torch.long, device=device)
    probs_acc = torch.zeros(bsz, length, vocab, dtype=F32, device=device)
    gumbel = _gumbel((len(ordered_groups), bsz, vocab), generator, device)
    s_true = s_true.long()
    for gi, mems in enumerate(ordered_groups):
        logits_acc = torch.zeros(bsz, vocab, dtype=F32, device=device)
        src_t, done = mems[0], False
        for t in mems:
            if masked_everywhere[t]:
                src_t, done = t, True
                break
            nbr = e_idx[:, t, :, None].expand(-1, -1, h)
            h_es_t = torch.cat([h_E[:, t], torch.gather(h_S, 1, nbr)], dim=-1)
            for layer, dec in enumerate(model.decoder_layers):
                h_esv = torch.cat([h_es_t, torch.gather(h_V[layer], 1, nbr)], dim=-1)
                h_esv = mask_bw[:, t] * h_esv + h_EXV_fw[:, t]
                h_V[layer + 1][:, t] = _dec_layer(dec, h_V[layer][:, t], h_esv, mask[:, t],
                                                  model.cfg.scale)
            lg = model.W_out(h_V[-1][:, t]) / temperature
            logits_acc = logits_acc + tied_beta[t] / len(mems) * lg
        last_t = mems[-1]
        if done:
            s_t = s_true[:, src_t]
        else:
            probs = _restrained_probs(
                logits_acc, temperature, omit_aas, bias_aas, bias_by_res[:, last_t],
                None if pssm_coef is None else pssm_coef[:, last_t],
                None if pssm_bias is None else pssm_bias[:, last_t], pssm_multi,
                None if pssm_log_odds_mask is None else pssm_log_odds_mask[:, last_t],
                None if omit_aa_mask is None else omit_aa_mask[:, last_t])
            s_t = torch.where(chain_mask[:, last_t] > 0, _draw(probs, gumbel[gi]),
                              s_true[:, last_t])
        for t in mems:
            S[:, t] = s_t
            h_S[:, t] = model.W_s.weight[s_t]
            if not done:
                probs_acc[:, t] = probs
    return {"S": S, "probs": probs_acc, "decoding_order": decoding_order}


# ---------------------------------------------------------------------------
# Inputs from chains
# ---------------------------------------------------------------------------


def featurize_chains(
    chains: list[tuple[str, np.ndarray]],
    designed: list[bool] | None = None,
) -> dict[str, np.ndarray]:
    """[(sequence, coords [L, 4, 3] N/CA/C/O, or [L, 1, 3] CA), ...] -> the
    model's inputs with a batch of one (numpy): the residue index jumps 100
    between chains, chain encodings count from 1, a residue with a
    non-finite coordinate is masked and zero-filled; ``designed`` (all by
    default) sets chain_M per chain."""
    if designed is None:
        designed = [True] * len(chains)
    seqs, coords, enc, res_idx, ch_m = [], [], [], [], []
    l0 = 0
    for c, ((seq, xyz), des) in enumerate(zip(chains, designed), start=1):
        if len(seq) != len(xyz):
            raise ValueError(f"chain {c}: seq len {len(seq)} != coords {len(xyz)}")
        seqs.append(seq)
        coords.append(np.asarray(xyz, np.float64))
        enc.append(np.full(len(seq), c))
        res_idx.append(100 * (c - 1) + np.arange(l0, l0 + len(seq)))
        ch_m.append(np.full(len(seq), 1.0 if des else 0.0))
        l0 += len(seq)
    x = np.concatenate(coords, axis=0)[None]  # [1, L, 4, 3]
    seq = "".join(seqs)
    s = np.array(
        [MPNN_ALPHABET.index(a if a in MPNN_ALPHABET else "X") for a in seq], np.int32
    )[None]
    mask = np.isfinite(x.sum(axis=(2, 3))).astype(np.float32)
    x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0).astype(np.float32)
    return {
        "X": x,
        "S": s,
        "mask": mask,
        "chain_M": np.concatenate(ch_m)[None].astype(np.float32),
        "chain_encoding_all": np.concatenate(enc)[None].astype(np.int32),
        "residue_idx": np.concatenate(res_idx)[None].astype(np.int32),
    }
