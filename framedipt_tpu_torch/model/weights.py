"""Weights for the port's ScoreNetwork, whose state_dict uses the reference
torch names.

- :func:`params_from_jax`: the JAX package's flax params (a nested dict of
  numpy arrays) -> this model's state_dict (the inverse of the JAX
  package's ``convert_state_dict``).
- :func:`load_reference_checkpoint`: a reference ``.pth`` ({model, conf, ...}
  pickle or a bare state_dict; DDP ``module.`` prefixes stripped).
- :func:`init_state_dict`: the JAX package's initialization (the AF2
  initializer zoo), for training a new model and serving without a
  checkpoint.
- :func:`synth_state_dict`: the test fixtures' weights, a pure function of
  each parameter's (name, shape), with the zero-initialized final layers
  damped so the trunk stays contractive.
- :func:`cancelled_entries`: the entries whose gradient is 0 in exact
  arithmetic, which comparisons of training runs leave out.
"""
from __future__ import annotations

import math
import re
import zlib
from typing import Any, Mapping

import numpy as np
import torch


def _t(w) -> torch.Tensor:
    """flax kernel [in, out] -> torch Linear weight [out, in]."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(w, np.float32).T))


def _v(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32).copy())


def _dense(sd: dict, dst: str, node: Mapping) -> None:
    sd[f"{dst}.weight"] = _t(node["dense"]["kernel"])
    if "bias" in node["dense"]:
        sd[f"{dst}.bias"] = _v(node["dense"]["bias"])


def _ln(sd: dict, dst: str, node: Mapping) -> None:
    sd[f"{dst}.weight"] = _v(node["scale"])
    sd[f"{dst}.bias"] = _v(node["bias"])


def params_from_jax(params: Mapping[str, Any], num_blocks: int = 4,
                    seq_tfmr_layers: int = 2) -> dict[str, torch.Tensor]:
    """Flax ScoreNetwork params -> state_dict of this package's ScoreNetwork.

    The two reference tensors the forward pass never reads (IPA
    ``linear_rbf``, TorsionAngles ``linear_3``) have no flax counterpart and
    come back as zeros, so the result loads with ``strict=True``."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    emb = p["embedding_layer"]
    for i, t_idx in enumerate((0, 2, 4)):
        _dense(sd, f"embedding_layer.node_embedder.{t_idx}", emb["node_embedder"][f"linear_{i}"])
    _ln(sd, "embedding_layer.node_embedder.5", emb["node_embedder"]["layer_norm"])
    e = "embedding_layer.edge_embedder"
    sd[f"{e}.0.weight"] = _t(emb["edge_embedder_w0"])
    sd[f"{e}.0.bias"] = _v(emb["edge_embedder_b0"])
    sd[f"{e}.2.weight"] = _t(emb["edge_linear_1_kernel"])
    sd[f"{e}.2.bias"] = _v(emb["edge_linear_1_bias"])
    sd[f"{e}.4.weight"] = _t(emb["edge_linear_2_kernel"])
    sd[f"{e}.4.bias"] = _v(emb["edge_linear_2_bias"])
    sd[f"{e}.5.weight"] = _v(emb["edge_ln_scale"])
    sd[f"{e}.5.bias"] = _v(emb["edge_ln_bias"])

    sm = p["score_model"]
    trunk = "score_model.trunk"
    for b in range(num_blocks):
        ipa = sm[f"ipa_{b}"]
        for name in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points",
                     "linear_b", "down_z", "linear_out"):
            _dense(sd, f"{trunk}.ipa_{b}.{name}", ipa[name])
        sd[f"{trunk}.ipa_{b}.head_weights"] = _v(ipa["head_weights"])
        sd[f"{trunk}.ipa_{b}.linear_rbf.weight"] = torch.zeros(1, 20)
        sd[f"{trunk}.ipa_{b}.linear_rbf.bias"] = torch.zeros(1)
        _ln(sd, f"{trunk}.ipa_ln_{b}", sm[f"ipa_ln_{b}"])
        _dense(sd, f"{trunk}.skip_embed_{b}", sm[f"skip_embed_{b}"])
        for layer in range(seq_tfmr_layers):
            src = sm[f"seq_tfmr_{b}_layer_{layer}"]
            dst = f"{trunk}.seq_tfmr_{b}.layers.{layer}"
            sd[f"{dst}.self_attn.in_proj_weight"] = _t(src["in_proj"]["dense"]["kernel"])
            sd[f"{dst}.self_attn.in_proj_bias"] = _v(src["in_proj"]["dense"]["bias"])
            _dense(sd, f"{dst}.self_attn.out_proj", src["out_proj"])
            _dense(sd, f"{dst}.linear1", src["ff_linear1"])
            _dense(sd, f"{dst}.linear2", src["ff_linear2"])
            _ln(sd, f"{dst}.norm1", src["norm1"])
            _ln(sd, f"{dst}.norm2", src["norm2"])
        _dense(sd, f"{trunk}.post_tfmr_{b}", sm[f"post_tfmr_{b}"])
        nt = sm[f"node_transition_{b}"]
        for i in (1, 2, 3):
            _dense(sd, f"{trunk}.node_transition_{b}.linear_{i}", nt[f"linear_{i}"])
        _ln(sd, f"{trunk}.node_transition_{b}.ln", nt["ln"])
        _dense(sd, f"{trunk}.bb_update_{b}.linear", sm[f"bb_update_{b}"])
        if b < num_blocks - 1:
            et = sm[f"edge_transition_{b}"]
            dst = f"{trunk}.edge_transition_{b}"
            _dense(sd, f"{dst}.initial_embed", et["initial_embed"])
            sd[f"{dst}.trunk.0.weight"] = _t(et["trunk_0_kernel"])
            sd[f"{dst}.trunk.0.bias"] = _v(et["trunk_0_bias"])
            sd[f"{dst}.trunk.2.weight"] = _t(et["trunk_1_kernel"])
            sd[f"{dst}.trunk.2.bias"] = _v(et["trunk_1_bias"])
            sd[f"{dst}.final_layer.weight"] = _t(et["final_kernel"])
            sd[f"{dst}.final_layer.bias"] = _v(et["final_bias"])
            sd[f"{dst}.layer_norm.weight"] = _v(et["ln_scale"])
            sd[f"{dst}.layer_norm.bias"] = _v(et["ln_bias"])

    tp = sm["torsion_pred"]
    for name in ("linear_1", "linear_2", "linear_final"):
        _dense(sd, f"score_model.torsion_pred.{name}", tp[name])
    c = sd["score_model.torsion_pred.linear_1.weight"].shape[0]
    sd["score_model.torsion_pred.linear_3.weight"] = torch.zeros(c, c)
    sd["score_model.torsion_pred.linear_3.bias"] = torch.zeros(c)
    return sd


def load_reference_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], dict | None]:
    """Reference ``.pth`` -> (state_dict with ``module.`` stripped, saved
    config or None). The file is a pickle: load only trusted checkpoints."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("model", ckpt)
    conf = ckpt.get("conf")
    if conf is not None and not isinstance(conf, dict):
        try:
            conf = dict(conf)
        except (TypeError, ValueError):
            conf = None
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    return sd, conf


# The AF2 initializer zoo of the JAX package's layers
# (framedipt_tpu/model/layers.py): "default" and "relu" are truncated
# normals (to +-2 std) of variance 1 / fan_in and 2 / fan_in, "glorot" is
# uniform of variance 2 / (fan_in + fan_out), "normal" N(0, 1 / fan_in);
# "gating" and "final" weights are 0, a "gating" bias 1, every other bias 0.
IPA_POINT_WEIGHTS_INIT = 0.541324854612918  # softplus^{-1}(1)
# std of N(0, 1) truncated to [-2, 2]
_TRUNC_STD = math.sqrt(1.0 - 4.0 * math.exp(-2.0) / math.sqrt(2.0 * math.pi) / math.erf(math.sqrt(2.0)))

# The w_init of each weight matrix the JAX modules name (model/ipa.py; the
# edge transition's raw trunk and final kernels as their initializers);
# every other matrix takes "default".
_W_INIT = (
    (r"\.ipa_\d+\.linear_out\.weight$", "final"),
    (r"\.skip_embed_\d+\.weight$", "final"),
    (r"\.post_tfmr_\d+\.weight$", "final"),
    (r"\.bb_update_\d+\.linear\.weight$", "final"),
    (r"\.node_transition_\d+\.linear_[12]\.weight$", "relu"),
    (r"\.node_transition_\d+\.linear_3\.weight$", "final"),
    (r"\.edge_transition_\d+\.(initial_embed|trunk\.[02])\.weight$", "relu"),
    (r"\.edge_transition_\d+\.final_layer\.weight$", "final"),
    (r"\.self_attn\.in_proj_weight$", "glorot"),
    (r"torsion_pred\.linear_[12]\.weight$", "relu"),
    (r"torsion_pred\.linear_final\.weight$", "final"),
)
# Tensors the forward never reads (no JAX counterpart): 0, as the importer
# gives them.
_UNREAD = ("linear_rbf", "torsion_pred.linear_3")


def _w_init_of(name: str) -> str:
    """The zoo initializer of weight matrix ``name`` (a state_dict name)."""
    return next((kind for pat, kind in _W_INIT if re.search(pat, name)), "default")


def _zoo_matrix(kind: str, shape: tuple[int, int], gen: torch.Generator) -> torch.Tensor:
    fan_out, fan_in = shape  # torch layout [out, in]
    if kind in ("final", "gating"):
        return torch.zeros(shape)
    if kind in ("default", "relu"):
        x = torch.randn(shape, generator=gen)
        while True:  # redraw outside +-2
            out = x.abs() > 2.0
            if not out.any():
                break
            x[out] = torch.randn(int(out.sum()), generator=gen)
        scale = 1.0 if kind == "default" else 2.0
        return x * (math.sqrt(scale / max(1, fan_in)) / _TRUNC_STD)
    if kind == "glorot":
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit
    if kind == "normal":
        return torch.randn(shape, generator=gen) / math.sqrt(fan_in)
    raise ValueError(f"unknown w_init {kind!r}")


def init_state_dict(model: torch.nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The JAX package's initialization of ``model`` (``model.init``): each
    weight matrix from the zoo by its layer's w_init, LayerNorm scales 1,
    biases 0 (1 after a "gating" matrix), the IPA point weights
    softplus^{-1}(1). Drawn from ``generator`` (a CPU Generator) in
    state_dict order."""
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if any(u in name for u in _UNREAD):
            sd[name] = torch.zeros(shape)
        elif name.endswith("head_weights"):
            sd[name] = torch.full(shape, IPA_POINT_WEIGHTS_INIT)
        elif name.endswith("bias"):
            gating = _w_init_of(name.removesuffix("bias") + "weight") == "gating"
            sd[name] = torch.full(shape, 1.0 if gating else 0.0)
        elif len(shape) == 1:  # LayerNorm scale
            sd[name] = torch.ones(shape)
        else:
            sd[name] = _zoo_matrix(_w_init_of(name), shape, generator)
    return sd


# Layers the reference zero-initializes: with them at full scale the
# per-block rigid-update feedback makes the network chaotic.
_FINAL_LAYER_PAT = ("bb_update", "torsion_pred.linear_final")
_W_SCALE = 0.3
_FINAL_SCALE = 0.05


def synth_value(name: str, shape: tuple[int, ...], seed: int = 0) -> np.ndarray:
    """Deterministic parameter values seeded per name (crc32): 1-D
    ``.weight`` tensors (LayerNorm scales) near 1, biases small noise,
    matrices fan-in scaled, the final layers damped."""
    rng = np.random.default_rng((zlib.crc32(name.encode()) << 1) ^ seed)
    shape = tuple(int(s) for s in shape)
    damp = _FINAL_SCALE if any(p in name for p in _FINAL_LAYER_PAT) else 1.0
    if name.endswith("head_weights"):
        return (0.5 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name.endswith(".weight") and len(shape) == 1:
        return (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    if name.endswith(".bias"):
        return (damp * 0.02 * rng.standard_normal(shape)).astype(np.float32)
    fan_in = shape[-1] if len(shape) >= 2 else 1
    return (damp * _W_SCALE * rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def synth_state_dict(model: torch.nn.Module, seed: int = 0) -> dict[str, torch.Tensor]:
    """Deterministic random weights for every parameter of ``model``."""
    return {
        name: torch.as_tensor(synth_value(name, tuple(t.shape), seed))
        for name, t in model.state_dict().items()
    }


def cancelled_entries(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """Boolean masks, by parameter name, of the entries whose gradient is 0
    in exact arithmetic: the IPA's key biases (the k half of each head of
    ``linear_kv``), ``linear_b``'s bias and the sequence transformer's key
    bias (the middle third of ``in_proj_bias``). Each adds one term to a
    whole softmax row, which the softmax cancels, so its computed gradient
    is float32 rounding noise, whose sign Adam follows with a step of lr."""
    heads, c_hidden = model.conf.ipa.no_heads, model.conf.ipa.c_hidden
    masks = {}
    for name, p in model.named_parameters():
        mask = np.zeros(tuple(p.shape), bool)
        if name.endswith("linear_b.bias"):
            mask[:] = True
        elif name.endswith("linear_kv.bias"):
            mask.reshape(heads, 2, c_hidden)[:, 0] = True
        elif name.endswith("in_proj_bias"):
            d = mask.shape[0] // 3
            mask[d:2 * d] = True
        else:
            continue
        masks[name] = mask
    return masks
