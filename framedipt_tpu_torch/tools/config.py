"""Typed configuration: the dataclasses the inpainting service and the train
step need, with the JAX package's defaults and its dotted-override loader.

``use_pallas_kernel`` / ``use_pallas_embedder`` / ``use_pallas_ipa`` keep
their names so configs carry over; here they mean "run the hand-written CUDA
kernel". For the first two ``None`` resolves to True on a CUDA device and
False on the CPU (:func:`resolve_kernel_flags`): the model always calls
their wrappers, which take the plain PyTorch versions only for CPU tensors,
so on the card those kernels are the only path and an explicit False there
is refused. ``use_pallas_ipa`` chooses between two formulations of the IPA
attention, the fused kernel and einsums; ``None`` resolves to False on
every device, as in the JAX package. True runs the kernel on the card (or
raises) and its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class R3Config:
    """VP-SDE translation diffusion."""

    min_b: float = 0.1
    max_b: float = 20.0
    coordinate_scaling: float = 0.1


@dataclass
class SO3Config:
    """IGSO(3) rotation diffusion."""

    num_omega: int = 1000
    num_sigma: int = 1000
    min_sigma: float = 0.1
    max_sigma: float = 1.5
    schedule: str = "logarithmic"
    cache_dir: str | None = ".cache/"


@dataclass
class DiffuserConfig:
    diffuse_trans: bool = True
    diffuse_rot: bool = True
    r3: R3Config = field(default_factory=R3Config)
    so3: SO3Config = field(default_factory=SO3Config)


@dataclass
class EmbedConfig:
    index_embed_size: int = 32
    embed_self_conditioning: bool = True
    num_bins: int = 22
    min_bin: float = 1e-5
    max_bin: float = 20.0


@dataclass
class IPAConfig:
    c_s: int = 256
    c_z: int = 128
    c_hidden: int = 256
    c_skip: int = 64
    no_heads: int = 8
    no_qk_points: int = 8
    no_v_points: int = 12
    seq_tfmr_num_heads: int = 4
    seq_tfmr_num_layers: int = 2
    num_blocks: int = 4
    coordinate_scaling: float = 0.1
    # Edge transitions through the pair-MLP CUDA kernel (csrc/pair_mlp.cu).
    use_pallas_kernel: bool | None = None
    # Embedder edge branch through the edge-embedder CUDA kernel
    # (csrc/edge_embedder.cu).
    use_pallas_embedder: bool | None = None
    # IPA attention through the fused attention CUDA kernel
    # (csrc/ipa_attention.cu) instead of einsums. Off unless asked for.
    use_pallas_ipa: bool | None = None
    # Backward of the embedder edge branch: "xla" recomputes its plain
    # formulation and takes its VJP; "pallas" (the backward kernel) is not
    # ported yet.
    pallas_emb_bwd_impl: str = "pallas"


@dataclass
class ModelConfig:
    input_aatype: bool = False
    node_embed_size: int = 256
    edge_embed_size: int = 128
    # Compute dtype of the trunk's dense math ("float32"/"bfloat16"). Frame
    # algebra, attention softmax and score conversions stay float32.
    compute_dtype: str = "float32"
    embed: EmbedConfig = field(default_factory=EmbedConfig)
    ipa: IPAConfig = field(default_factory=IPAConfig)


@dataclass
class InferenceDiffusionConfig:
    num_t: int = 100
    min_t: float = 0.01
    noise_scale: float = 0.1


@dataclass
class InferenceConfig:
    seed: int = 123
    weights_path: str = "./weights/inpainting.pth"
    diffusion: InferenceDiffusionConfig = field(
        default_factory=InferenceDiffusionConfig
    )


@dataclass
class DataConfig:
    """The fields of the JAX DataConfig that the train step reads."""

    min_t: float = 0.01
    num_t: int = 100


@dataclass
class RecycleConfig:
    enabled: bool = False
    mode: str = "max"  # "max" or "next"


@dataclass
class ExperimentConfig:
    """The fields of the JAX ExperimentConfig that the train step reads:
    learning rate, recycling, loss weights and thresholds."""

    inpainting: bool = False
    learning_rate: float = 1e-4
    recycle: RecycleConfig = field(default_factory=RecycleConfig)
    trans_loss_weight: float = 1.0
    separate_rot_loss: bool = True
    rot_loss_weight: float = 0.5
    rot_loss_t_threshold: float = 0.2
    trans_x0_threshold: float = 1.0
    coordinate_scaling: float = 0.1
    bb_atom_loss_weight: float = 1.0
    bb_atom_loss_t_filter: float = 0.25
    dist_mat_loss_weight: float = 1.0
    dist_mat_loss_t_filter: float = 0.25
    aux_loss_weight: float = 0.25


@dataclass
class Config:
    diffuser: DiffuserConfig = field(default_factory=DiffuserConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    data: DataConfig = field(default_factory=DataConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)


def _apply_dict(obj: Any, updates: dict[str, Any], path: str = "") -> None:
    for key, value in updates.items():
        if not hasattr(obj, key):
            raise KeyError(f"Unknown config key: {path}{key}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _apply_dict(current, value, path=f"{path}{key}.")
        else:
            setattr(obj, key, value)


def parse_value(raw: str) -> Any:
    """Value of a ``key=value`` override: null/true/false, a number, a JSON
    list or object, else the string itself."""
    low = raw.strip().lower()
    if low in ("null", "none", "~", ""):
        return None
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if raw.strip()[:1] in ("[", "{"):
        return json.loads(raw)
    return raw


def load_config(overrides: list[str] | None = None) -> Config:
    """Defaults plus CLI-style dotted overrides (``model.ipa.num_blocks=2``)."""
    cfg = Config()
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = getattr(node, p)
        if not hasattr(node, leaf):
            raise KeyError(f"Unknown config key: {key}")
        setattr(node, leaf, parse_value(raw))
    return cfg


# The flags whose kernels are the only path on the card.
ALWAYS_ON_FLAGS = ("use_pallas_kernel", "use_pallas_embedder")
# Run settings, not the model's: a checkpoint's config does not set them.
KERNEL_FLAGS = ALWAYS_ON_FLAGS + ("use_pallas_ipa", "pallas_emb_bwd_impl")


def merge_checkpoint_config(cfg: Config, ckpt_conf: dict[str, Any]) -> Config:
    """A checkpoint's saved model/diffuser sections win over the runtime
    config; keys this port does not know are ignored, and so are the kernel
    flags, which choose how this run computes, not the model."""
    new = Config()
    _apply_dict(new, dataclasses.asdict(cfg))
    for section in ("model", "diffuser"):
        if section in ckpt_conf:
            known = _known_only(getattr(new, section), dict(ckpt_conf[section]))
            if section == "model" and isinstance(known.get("ipa"), dict):
                for flag in KERNEL_FLAGS:
                    known["ipa"].pop(flag, None)
            _apply_dict(getattr(new, section), known)
    return new


def _known_only(obj: Any, updates: dict[str, Any]) -> dict[str, Any]:
    out = {}
    for key, value in updates.items():
        if not hasattr(obj, key):
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and hasattr(value, "items"):
            out[key] = _known_only(current, dict(value))
        else:
            out[key] = value
    return out


def resolve_kernel_flags(cfg: Config, device) -> None:
    """Resolve auto (None) kernel flags in place: the edge-stack kernels run
    iff the model runs on a CUDA device, and an explicit False for them on a
    CUDA device raises (the port has no plain path on the card). The IPA
    attention kernel runs only when asked for."""
    on_cuda = getattr(device, "type", str(device)).startswith("cuda")
    ipa = cfg.model.ipa
    if ipa.use_pallas_ipa is None:
        ipa.use_pallas_ipa = False
    for flag in ALWAYS_ON_FLAGS:
        if getattr(ipa, flag) is None:
            setattr(ipa, flag, on_cuda)
        elif on_cuda and not getattr(ipa, flag):
            raise ValueError(
                f"model.ipa.{flag}=False on {device}: on a CUDA device the model "
                "runs its CUDA kernels; the plain versions take CPU tensors only"
            )


def check_emb_bwd_impl(cfg: Config) -> None:
    """Check the embedder's backward setting for a train step, on every
    device: it must be "xla" (its backward kernel is not ported yet). The
    pair MLP's backward has no setting: it is its kernel on CUDA tensors and
    its plain version on CPU tensors, as the forward is."""
    impl = cfg.model.ipa.pallas_emb_bwd_impl
    if impl not in ("xla", "pallas"):
        raise ValueError(f"model.ipa.pallas_emb_bwd_impl must be 'xla' or 'pallas', got {impl!r}")
    if impl == "pallas":
        raise NotImplementedError(
            "model.ipa.pallas_emb_bwd_impl='pallas': the edge-embedder backward kernel "
            "is not ported yet (ROADMAP queue 2 item 2); set it to 'xla'"
        )
