"""Typed configuration: the dataclasses the inpainting service, the train
step and the train CLI need, with the JAX package's defaults and its
dotted-override loader. Configs are read and written as JSON (or as the
plain dict a checkpoint carries); there is no YAML.

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

from framedipt_tpu_torch.tools.log import get_logger


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
    # Gather the score from the score-norm table instead of evaluating the
    # truncated series (SO3Diffuser.score).
    use_cached_score: bool = False


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
    # Edge transitions through the pair-MLP CUDA kernels (csrc/pair_mlp_wg*.cu).
    use_pallas_kernel: bool | None = None
    # Embedder edge branch through the edge-embedder CUDA kernel
    # (csrc/edge_embedder.cu).
    use_pallas_embedder: bool | None = None
    # IPA attention through the fused attention CUDA kernel
    # (csrc/ipa_attention.cu) instead of einsums. Off unless asked for.
    use_pallas_ipa: bool | None = None
    # Backward of the embedder edge branch: "pallas" runs the backward kernel
    # (csrc/edge_embedder_bwd.cu) on a CUDA device and its plain version on
    # the CPU; "xla" recomputes the plain forward and takes its VJP.
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
class InferenceSamplesConfig:
    """The de novo grid: lengths min_length..max_length by length_step,
    samples_per_length backbones each, seq_per_sample ProteinMPNN sequences
    a backbone for the self-consistency check."""

    samples_per_length: int = 10
    seq_per_sample: int = 8
    min_length: int = 100
    max_length: int = 500
    length_step: int = 100


@dataclass
class InpaintingSamplesConfig:
    samples: int = 5
    # All samples of a test case in one sampler call (batch of ``samples``);
    # False runs them one at a time.
    batch_samples: bool = True
    # CDR-loop masks over the TCR database's complexes (TCRSampler); False
    # draws a random redaction per chain (ConditionalSampler).
    tcr: bool = True
    # CDR3 flank ablations: diffuse the region just before or after the loop.
    shifted_region: str | None = None
    # An ESMFold prediction beside the ground truth; the port has no ESMFold
    # weights, so the CLI logs a skip.
    run_esmfold: bool = False
    cdr_loops: list[str] = field(default_factory=lambda: ["beta_3"])
    # An explicit diffused window [start_idx, end_idx] of the first chain.
    start_idx: int | None = None
    end_idx: int | None = None
    # The database flow (the inference CLI without --cif_dir, with ``tcr``
    # and ``download_dir`` set): the structures listed in the TCR database
    # CSV ``data_path`` are downloaded into ``download_dir/cifs``, filtered
    # by the settings below into a cached ``download_dir/processed/
    # metadata.csv`` (rebuilt when ``overwrite``), and the survivors sampled.
    data_path: str | None = None
    download_dir: str | None = None
    first_assembly: bool = True
    overwrite: bool = False
    max_resolution: float | None = None
    max_len: int | None = None
    min_len: int | None = None
    chain_max_len: int | None = None
    chain_min_len: int | None = None
    max_num_chains: int | None = None
    check_valid_resolution: bool = False
    num_workers_download: int = 4


@dataclass
class InferenceConfig:
    name: str | None = None
    seed: int = 123
    inpainting: bool = True
    input_aatype: bool = False
    confidence_score: str | None = None
    output_dir: str = "./inference_outputs/"
    weights_path: str = "./weights/inpainting.pth"
    # De novo self-consistency: the in-process ProteinMPNN's weights (a
    # reference .pt or an .npz of the same names), and a ProteinMPNN checkout
    # whose runner is the fallback when those weights are missing.
    mpnn_weights_path: str = "./weights/mpnn/v_48_020.pt"
    pmpnn_dir: str | None = None
    save_backbone_trajectory: bool = True
    save_pred_x0_trajectory: bool = True
    diffusion: InferenceDiffusionConfig = field(
        default_factory=InferenceDiffusionConfig
    )
    samples: InferenceSamplesConfig = field(default_factory=InferenceSamplesConfig)
    inpainting_samples: InpaintingSamplesConfig = field(
        default_factory=InpaintingSamplesConfig
    )


@dataclass
class FilteringConfig:
    max_len: int = 512
    min_len: int = 60
    chain_max_len: int = 512
    subset: int | None = None
    allowed_oligomer: list[str] = field(default_factory=list)
    max_helix_percent: float = 1.0
    max_loop_percent: float = 0.5
    min_beta_percent: float = -1.0
    rog_quantile: float = 0.96


@dataclass
class RedactionConfig:
    redact_min_len: int = 8
    redact_max_len: int = 50


@dataclass
class DataConfig:
    csv_path: str | None = None
    cluster_file: str | None = None
    num_clusters: int | None = None
    single_chain: bool = False
    filtering: FilteringConfig = field(default_factory=FilteringConfig)
    min_t: float = 0.01
    samples_per_eval_length: int = 4
    num_eval_lengths: int = 10
    num_t: int = 100
    redaction: RedactionConfig = field(default_factory=RedactionConfig)


@dataclass
class RecycleConfig:
    enabled: bool = False
    mode: str = "max"  # "max" or "next"


@dataclass
class ExperimentConfig:
    """The JAX ExperimentConfig's fields that the train step and the train
    CLI read, with its defaults. ``dp_size`` x ``fsdp_size`` is the number of
    processes, one per GPU (``parallel.make_mesh``; -1: all of them)."""

    name: str = "baseline"
    inpainting: bool = False
    seed: int = 0
    log_freq: int = 1000
    batch_size: int = 128
    eval_batch_size: int = 4
    num_epoch: int = 95
    learning_rate: float = 1e-4
    max_squared_res: int = 1_000_000
    recycle: RecycleConfig = field(default_factory=RecycleConfig)
    ckpt_freq: int = 10_000
    early_ckpt: bool = True
    early_ckpt_step: int = 100
    eval_freq: int = 50_000
    resume_ckpt_dir: str | None = None
    use_ckpt_conf: bool = False
    ckpt_dir: str = "./ckpt/"
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
    use_importance_sampling: bool = False
    num_bins: int = 100
    history_per_term: int = 10
    eval_dir: str = "./eval_outputs"
    num_parameters: int | None = None
    dp_size: int = -1
    fsdp_size: int = 1
    prefetch_buffer: int = 4


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


def load_config(overrides: list[str] | None = None, json_path: str | None = None) -> Config:
    """Defaults, then the JSON file ``json_path`` if given (a config as
    :func:`save_config` writes it; a key the port does not know is dropped
    with a warning, as :func:`merge_checkpoint_config` drops it, since the
    JAX package's configs carry fields the port leaves out), then CLI-style
    dotted overrides (``model.ipa.num_blocks=2``; every key must be known)."""
    cfg = Config()
    if json_path is not None:
        with open(json_path, encoding="utf-8") as f:
            _apply_dict(cfg, _known_only(cfg, json.load(f), ""))
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
    config. The kernel flags are skipped: they choose how this run computes,
    not the model. A key this port does not know is dropped with a warning
    that names its dotted path (published checkpoints carry keys the port
    has no use for, so it is not an error)."""
    new = Config()
    _apply_dict(new, dataclasses.asdict(cfg))
    for section in ("model", "diffuser"):
        if section in ckpt_conf:
            known = _known_only(getattr(new, section), dict(ckpt_conf[section]), f"{section}.")
            if section == "model" and isinstance(known.get("ipa"), dict):
                for flag in KERNEL_FLAGS:
                    known["ipa"].pop(flag, None)
            _apply_dict(getattr(new, section), known)
    return new


def _known_only(obj: Any, updates: dict[str, Any], path: str) -> dict[str, Any]:
    out = {}
    for key, value in updates.items():
        if not hasattr(obj, key):
            get_logger().warning("config key %s%s is not used by this port; dropped", path, key)
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and hasattr(value, "items"):
            out[key] = _known_only(current, dict(value), f"{path}{key}.")
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
    """Check the embedder's backward setting for a train step: "pallas" (the
    backward kernel on CUDA tensors, its plain version on CPU tensors) or
    "xla" (the VJP of the plain forward). The pair MLP's backward has no
    setting: it is its kernel on CUDA tensors and its plain version on CPU
    tensors, as the forward is."""
    impl = cfg.model.ipa.pallas_emb_bwd_impl
    if impl not in ("xla", "pallas"):
        raise ValueError(f"model.ipa.pallas_emb_bwd_impl must be 'xla' or 'pallas', got {impl!r}")


def to_dict(cfg: Any) -> dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path) -> None:
    """The config as JSON."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_dict(cfg), f, indent=1)
