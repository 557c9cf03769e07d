"""Sequence design with the port's ProteinMPNN, in process.

    python -m framedipt_tpu_torch.tools.mpnn_design --pdb_dir=<dir> --out_folder=<dir> \
        [--weights_path=weights/mpnn/v_48_020.pt] [--device=cpu] [flags ...]

Per input structure it writes ``seqs/{name}.fa`` in ProteinMPNN's own
format: the native record first (``>{name}, score=..., global_score=...,
fixed_chains=[...], designed_chains=[...], model_name=..., seed=...``), then
one record a sample (``>T=..., sample=n, score=..., global_score=...,
seq_recovery=...``), the chains of a sequence joined by '/'. All the
sequences of one temperature sample as one batch, each row in its own
decoding order, then are scored by one teacher-forced pass in their own
orders (the native sequence in the first sample's order).

The side modes: ``--score_only`` (:func:`score_backbones`),
``--conditional_probs_only`` [``--conditional_probs_only_backbone``] and
``--unconditional_probs_only`` (:func:`probs_backbones`), and the
``--save_score`` / ``--save_probs`` sidecars of the design mode.

Chains keep the letters of the input: the restraint files and
``--design_chains`` name a chain by its letter in the PDB (chains B and C
are B and C, not A and B). ``--backbone_noise`` draws fresh noise for
every batch, each batch row its own, which its sampling and scoring pass
share. Runs on CUDA unless ``--device`` asks for another device.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.protein import chain_id_to_int, from_pdb_string
from framedipt_tpu_torch.model import mpnn
from framedipt_tpu_torch.tools import mpnn_restraints as restraints
from framedipt_tpu_torch.tools.device import (
    resolve_device,
    seeded_generator,
    set_full_precision_matmul,
)
from framedipt_tpu_torch.tools.external import ToolUnavailable
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()

_BACKBONE37 = [rc.atom_order[a] for a in ("N", "CA", "C", "O")]
DEFAULT_WEIGHTS = "weights/mpnn/v_48_020.pt"

Chains = list[tuple[str, np.ndarray]]  # (sequence, coords [L, 4 or 1, 3]) a chain


def load_mpnn_params(weights_path: str | pathlib.Path,
                     device: str | torch.device | None = None) -> mpnn.ProteinMPNN:
    """A ProteinMPNN model from a reference ``.pt`` checkpoint
    (``model_state_dict``, read with ``weights_only``) or an ``.npz`` of the
    same names, on ``device`` (CUDA by default). The neighbour count comes
    from the checkpoint's ``num_edges`` (48 without one); CA-only, hidden
    width and layer counts from the weights. A CA-only checkpoint without
    the vestigial tensors (the JAX training CLI writes none) loads with
    zeros there."""
    path = pathlib.Path(weights_path)
    if not path.exists():
        raise ToolUnavailable(
            f"ProteinMPNN weights not found at {path}; set inference.mpnn_weights_path"
        )
    if path.suffix == ".npz":
        data = np.load(path, allow_pickle=False)
        k = int(data["num_edges"]) if "num_edges" in data else 48
        sd = {n: torch.as_tensor(data[n]) for n in data.files if n != "num_edges"}
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        k = int(ckpt.get("num_edges", 48))
        sd = ckpt["model_state_dict"]
    model = mpnn.ProteinMPNN(mpnn.config_from_state_dict(sd, k_neighbors=k))
    model.load_state_dict(mpnn.with_unused_tensors(sd), strict=True)
    set_full_precision_matmul()
    return model.to(resolve_device(device)).eval()


def _chains_from_pdb(pdb_path: pathlib.Path) -> tuple[list[str], Chains]:
    """PDB -> (chain letters, [(sequence, coords [L, 4, 3])]) in sorted chain
    order; a residue missing a backbone atom gets NaN coordinates (masked by
    featurize_chains)."""
    text = pdb_path.read_text()
    prot = from_pdb_string(text)
    letter_of = {chain_id_to_int(line[21]): line[21] for line in text.splitlines()
                 if line.startswith(("ATOM  ", "HETATM"))}
    letters, chains = [], []
    for cid in sorted(np.unique(prot.chain_index)):
        sel = prot.chain_index == cid
        seq = "".join(rc.restypes[a] if a < len(rc.restypes) else "X" for a in prot.aatype[sel])
        xyz = prot.atom_positions[sel][:, _BACKBONE37, :].astype(np.float64)
        xyz[~(prot.atom_mask[sel][:, _BACKBONE37] > 0.5)] = np.nan
        letters.append(letter_of[int(cid)])
        chains.append((seq, xyz))
    return letters, chains


def _ca_only_chains(chains: Chains) -> Chains:
    """Full-backbone [L, 4, 3] chains cut to their CA column [L, 1, 3] for
    the CA-only models, whose validity mask then depends on CA alone."""
    return [(seq, xyz if xyz.shape[1] == 1 else xyz[:, 1:2, :]) for seq, xyz in chains]


def chains_from_parsed_entry(entry: dict) -> tuple[str, list[str], Chains]:
    """One entry of ProteinMPNN's parse_multiple_chains.py jsonl ->
    (name, chain letters, chains): ``seq_chain_{X}`` strings and
    ``coords_chain_{X}`` dicts of per-atom [L, 3] lists (N, CA, C, O, or CA
    alone); a '-' gap becomes X, its NaN coordinates mask the residue."""
    letters = sorted(k.removeprefix("seq_chain_") for k in entry if k.startswith("seq_chain_"))
    if not letters:
        raise ToolUnavailable(f"parsed entry {entry.get('name', '?')!r}: no seq_chain_ keys")
    chains = []
    for ltr in letters:
        seq = entry[f"seq_chain_{ltr}"].replace("-", "X")
        cd = entry[f"coords_chain_{ltr}"]
        if f"N_chain_{ltr}" in cd:
            xyz = np.stack([np.asarray(cd[f"{a}_chain_{ltr}"], np.float64)
                            for a in ("N", "CA", "C", "O")], axis=1)
        else:
            xyz = np.asarray(cd[f"CA_chain_{ltr}"], np.float64)[:, None, :]
        if len(seq) != len(xyz):
            raise ToolUnavailable(f"parsed entry {entry.get('name', '?')!r} chain {ltr}: "
                                  f"seq len {len(seq)} != coords {len(xyz)}")
        chains.append((seq, xyz))
    return str(entry.get("name", "entry")), letters, chains


def iter_cases(
    pdb_dir: pathlib.Path | str | None = None,
    jsonl_path: pathlib.Path | str | None = None,
) -> list[tuple[str, list[str], Chains]]:
    """(name, chain letters, chains) of every ``*.pdb`` of ``pdb_dir``, or
    of every entry of a parse_multiple_chains.py jsonl."""
    if (pdb_dir is None) == (jsonl_path is None):
        raise ToolUnavailable("give exactly one of pdb_dir / jsonl_path")
    if jsonl_path is not None:
        path = pathlib.Path(jsonl_path)
        if not path.exists():
            raise ToolUnavailable(f"no parsed jsonl at {path}")
        cases = [chains_from_parsed_entry(json.loads(line))
                 for line in path.read_text().splitlines() if line.strip()]
        if not cases:
            raise ToolUnavailable(f"{path}: empty parsed jsonl")
        return cases
    pdbs = sorted(pathlib.Path(pdb_dir).glob("*.pdb"))
    if not pdbs:
        raise ToolUnavailable(f"no .pdb files under {pdb_dir}")
    return [(p.stem, *_chains_from_pdb(p)) for p in pdbs]


def aa_omit_vector(omit_aas: str) -> np.ndarray:
    """``--omit_AAs`` letters -> a one-hot omit vector over the alphabet."""
    vec = np.zeros((len(mpnn.MPNN_ALPHABET),), np.float32)
    for a in omit_aas:
        vec[mpnn.MPNN_ALPHABET.index(a)] = 1.0
    return vec


def aa_bias_vector(bias: dict[str, float] | None) -> np.ndarray:
    """``--bias_AA_jsonl``'s {letter: logit bias} -> a dense vector."""
    vec = np.zeros((len(mpnn.MPNN_ALPHABET),), np.float32)
    for a, v in (bias or {}).items():
        vec[mpnn.MPNN_ALPHABET.index(a)] = float(v)
    return vec


def homomer_tied_positions(chain_lengths: list[int]) -> tuple[tuple[int, ...], ...]:
    """Residue i tied across every chain (the homo-oligomer pattern), in
    featurize_chains' concatenated positions."""
    offsets = np.concatenate([[0], np.cumsum(chain_lengths)[:-1]])
    n = min(chain_lengths)
    return tuple(tuple(int(off + i) for off in offsets) for i in range(n))


def _order_keys(generator: torch.Generator, shape, device) -> torch.Tensor:
    """The Gaussian keys whose order is a batch's decoding order."""
    return torch.randn(shape, generator=generator, device=device)


@torch.inference_mode()
def _design_batch(model: mpnn.ProteinMPNN, generator: torch.Generator,
                  feats: dict[str, torch.Tensor], num_seqs: int, temperature: float,
                  omit_aas=None, bias_aas=None, tied_pos=None, chain_m_pos=None,
                  omit_aa_mask=None, bias_by_res=None, tied_beta=None, pssm_coef=None,
                  pssm_bias=None, pssm_multi: float = 0.0, pssm_log_odds_mask=None,
                  backbone_noise: float = 0.0) -> dict[str, np.ndarray]:
    """Sample ``num_seqs`` sequences as one batch, then score them with the
    teacher-forced pass in each sample's own order: score over the designed
    positions (chain_M * chain_M_pos), global score over all, recovery, and
    the native sequence's scores. The [1, L, ...] inputs are repeated over
    the batch; with ``backbone_noise`` each row gets its own Gaussian noise
    on its coordinates, from this batch's generator."""
    def rep(a):
        return None if a is None else a.repeat_interleave(num_seqs, dim=0)

    x, s = rep(feats["X"]), rep(feats["S"])
    mask, chain_m = rep(feats["mask"]), rep(feats["chain_M"])
    res_idx, enc = rep(feats["residue_idx"]), rep(feats["chain_encoding_all"])
    cmp_ = rep(chain_m_pos) if chain_m_pos is not None else torch.ones_like(chain_m)
    kw = dict(omit_aa_mask=rep(omit_aa_mask), bias_by_res=rep(bias_by_res),
              pssm_coef=rep(pssm_coef), pssm_bias=rep(pssm_bias), pssm_multi=pssm_multi,
              pssm_log_odds_mask=rep(pssm_log_odds_mask))
    randn = _order_keys(generator, s.shape, x.device)
    if backbone_noise > 0.0:
        x = x + backbone_noise * torch.randn(x.shape, generator=generator, device=x.device) \
            * mask[..., None, None]
    if tied_pos:
        out = mpnn.mpnn_tied_sample(
            model, generator, x, randn, s, chain_m, enc, res_idx, mask, tied_pos,
            temperature=temperature, omit_aas=omit_aas, bias_aas=bias_aas, chain_m_pos=cmp_,
            tied_beta=tied_beta, **kw)
    else:
        out = mpnn.mpnn_sample(
            model, generator, x, randn, s, chain_m, enc, res_idx, mask,
            temperature=temperature, omit_aas=omit_aas, bias_aas=bias_aas, chain_m_pos=cmp_,
            **kw)
    lp = mpnn.mpnn_log_probs(model, x, out["S"], mask, chain_m, res_idx, enc,
                             decoding_order=out["decoding_order"])
    mask_for_loss = mask * chain_m * cmp_
    recovery = torch.sum((out["S"] == s).to(torch.float32) * mask_for_loss, dim=-1) \
        / torch.sum(mask_for_loss, dim=-1)
    lp_native = mpnn.mpnn_log_probs(model, x[:1], s[:1], mask[:1], chain_m[:1], res_idx[:1],
                                    enc[:1], decoding_order=out["decoding_order"][:1])
    result = {
        "S": out["S"], "score": mpnn.mpnn_scores(out["S"], lp, mask_for_loss),
        "global_score": mpnn.mpnn_scores(out["S"], lp, mask), "recovery": recovery,
        "native_score": mpnn.mpnn_scores(s[:1], lp_native, mask_for_loss[:1]),
        "native_global_score": mpnn.mpnn_scores(s[:1], lp_native, mask[:1]),
        "probs": out["probs"], "log_probs": lp, "mask_for_loss": mask_for_loss,
    }
    return {k: v.cpu().numpy() for k, v in result.items()}


def _seq_str(s_row: np.ndarray, chain_lengths: list[int]) -> str:
    parts, off = [], 0
    for ln in chain_lengths:
        parts.append("".join(mpnn.MPNN_ALPHABET[i] for i in s_row[off : off + ln]))
        off += ln
    return "/".join(parts)


def _on_device(feats: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in feats.items()}


def _model(model, weights_path, device) -> mpnn.ProteinMPNN:
    if model is None:
        model = load_mpnn_params(weights_path or DEFAULT_WEIGHTS, device)
    return model


def score_backbones(
    pdb_dir: pathlib.Path | str | None,
    output_dir: pathlib.Path | str,
    num_scores: int = 8,
    seed: int = 38,
    model: mpnn.ProteinMPNN | None = None,
    weights_path: str | pathlib.Path | None = None,
    jsonl_path: pathlib.Path | str | None = None,
    device: str | torch.device | None = None,
) -> pathlib.Path:
    """Score each structure's native sequence under ``num_scores`` random
    decoding orders, one batched pass, writing ``score_only/{name}.npz``
    (``score``, ``global_score``)."""
    model = _model(model, weights_path, device)
    dev = next(model.parameters()).device
    out = pathlib.Path(output_dir) / "score_only"
    out.mkdir(parents=True, exist_ok=True)
    for i, (name, _, chains) in enumerate(iter_cases(pdb_dir, jsonl_path)):
        if model.cfg.ca_only:
            chains = _ca_only_chains(chains)
        f = {k: v.repeat_interleave(num_scores, dim=0)
             for k, v in _on_device(mpnn.featurize_chains(chains), dev).items()}
        randn = _order_keys(seeded_generator(dev, seed, i), f["S"].shape, dev)
        with torch.inference_mode():
            lp = mpnn.mpnn_log_probs(model, f["X"], f["S"], f["mask"], f["chain_M"],
                                     f["residue_idx"], f["chain_encoding_all"], randn=randn)
            score = mpnn.mpnn_scores(f["S"], lp, f["mask"] * f["chain_M"]).cpu().numpy()
            global_score = mpnn.mpnn_scores(f["S"], lp, f["mask"]).cpu().numpy()
        np.savez(out / f"{name}.npz", score=score, global_score=global_score)
        logger.info(f"scored {name}: mean {score.mean():.4f} "
                    f"global {global_score.mean():.4f} (n={num_scores})")
    return out


def design_sequences(
    pdb_dir: pathlib.Path | str | None,
    output_dir: pathlib.Path | str,
    num_seq_per_target: int = 8,
    sampling_temp: float | str | list[float] = 0.1,
    seed: int = 38,
    model: mpnn.ProteinMPNN | None = None,
    weights_path: str | pathlib.Path | None = None,
    omit_aas: str = "X",
    bias_aa: dict[str, float] | None = None,
    save_score: bool = False,
    save_probs: bool = False,
    tie_chains: bool = False,
    design_chains: list[str] | None = None,
    chain_id_dict: dict | None = None,
    fixed_positions: dict[str, list[int]] | None = None,
    omit_aa_dict: dict | None = None,
    bias_by_res_dict: dict | None = None,
    tied_positions: list | dict | None = None,
    pssm_dict: dict | None = None,
    pssm_multi: float = 0.0,
    pssm_threshold: float = 0.0,
    pssm_log_odds_flag: bool = False,
    pssm_bias_flag: bool = False,
    backbone_noise: float = 0.0,
    jsonl_path: pathlib.Path | str | None = None,
    batch_size: int | None = None,
    max_length: int | None = None,
    model_name: str = "v_48_020",
    device: str | torch.device | None = None,
) -> pathlib.Path:
    """Design sequences for every ``*.pdb`` of ``pdb_dir`` (or every entry
    of ``jsonl_path``); returns the ``seqs`` directory.

    ``sampling_temp``: one temperature or several ("0.2 0.25 0.5"), each
    giving ``num_seq_per_target`` sequences, numbered from 1 per
    temperature. ``batch_size`` splits them into batches of that size (the
    remainder of the division dropped, with a warning); None samples them
    as one batch. ``max_length`` skips longer structures.

    Which chains are designed: all, or ``design_chains`` (letters), or per
    structure ``chain_id_dict`` ({name: [designed, fixed]}, which wins; a
    name missing from it is an error). ``fixed_positions`` ({letter:
    1-based positions}) keeps native residues inside designed chains. The
    restraint dicts take ProteinMPNN's jsonl shapes (``tools/
    mpnn_restraints.py``, with or without the {name: ...} level):
    ``omit_aa_dict``, ``bias_by_res_dict``, ``tied_positions`` (not with
    ``tie_chains``, which ties residue i of every chain), ``pssm_dict`` with
    the four PSSM settings. ``save_score`` / ``save_probs`` write
    ``scores/{name}.npz`` and ``probs/{name}.npz`` across all temperatures.

    The generator of structure i is seeded from (``seed``, i), that of its
    other batches from (``seed``, i, 7919 * temperature index + batch)."""
    model = _model(model, weights_path, device)
    dev = next(model.parameters()).device
    cfg = model.cfg
    if isinstance(sampling_temp, str):
        temps = [float(t) for t in sampling_temp.split()]
    elif isinstance(sampling_temp, (list, tuple)):
        temps = [float(t) for t in sampling_temp]
    else:
        temps = [float(sampling_temp)]
    if batch_size is None:
        batch_sizes = [num_seq_per_target]
    else:
        n_batches = num_seq_per_target // batch_size
        if n_batches == 0:
            raise ToolUnavailable(
                f"batch_size {batch_size} > num_seq_per_target {num_seq_per_target}: zero batches"
            )
        if n_batches * batch_size != num_seq_per_target:
            logger.warning(
                f"num_seq_per_target {num_seq_per_target} is not a multiple of batch_size "
                f"{batch_size}: generating {n_batches * batch_size} per temperature"
            )
        batch_sizes = [batch_size] * n_batches
    if tie_chains and tied_positions:
        raise ToolUnavailable("tie_chains and tied_positions are mutually exclusive")
    seqs_dir = pathlib.Path(output_dir) / "seqs"
    seqs_dir.mkdir(parents=True, exist_ok=True)
    omit_vec = torch.as_tensor(aa_omit_vector(omit_aas), device=dev)
    bias_vec = torch.as_tensor(aa_bias_vector(bias_aa), device=dev)
    res = restraints

    def dense(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    for i, (name, letters, chains) in enumerate(iter_cases(pdb_dir, jsonl_path)):
        if cfg.ca_only:
            chains = _ca_only_chains(chains)
        lens = [len(seq) for seq, _ in chains]
        if max_length is not None and sum(lens) > max_length:
            logger.info(f"skipping {name}: length {sum(lens)} > max_length {max_length}")
            continue
        case_design = design_chains
        if chain_id_dict is not None:
            inner = chain_id_dict.get(name)
            if inner is None:
                raise ToolUnavailable(f"{name} missing from chain_id_dict")
            case_design = [str(c) for c in inner[0]]
        designed_flags = ([ltr in case_design for ltr in letters]
                          if case_design is not None else [True] * len(chains))
        if case_design is not None and not any(designed_flags):
            raise ToolUnavailable(
                f"{name}: none of designed chains {case_design} present (chains: {letters})")
        feats = mpnn.featurize_chains(chains, designed=designed_flags)
        cmp_arr = omit_mask_arr = bias_res_arr = tied_beta_arr = None
        if fixed_positions:
            cmp_arr = res.chain_m_pos_from_dict(
                res.resolve_name(fixed_positions, name), letters, lens)
        if omit_aa_dict:
            omit_mask_arr = res.omit_aa_mask_from_dict(
                res.resolve_name(omit_aa_dict, name), letters, lens)
        if bias_by_res_dict:
            bias_res_arr = res.bias_by_res_from_dict(
                res.resolve_name(bias_by_res_dict, name), letters, lens)
        tied_pos = homomer_tied_positions(lens) if tie_chains else None
        if tied_positions:
            tied_pos, tied_beta_arr = res.tied_positions_from_list(
                res.resolve_name(tied_positions, name), letters, lens)
        pssm_kwargs: dict = {}
        if pssm_dict and (pssm_bias_flag or pssm_log_odds_flag):
            coef, pbias, lo_mask = res.pssm_tensors_from_dict(
                res.resolve_name(pssm_dict, name), letters, lens, threshold=pssm_threshold)
            if pssm_bias_flag:
                pssm_kwargs.update(pssm_coef=dense(coef), pssm_bias=dense(pbias),
                                   pssm_multi=float(pssm_multi))
            if pssm_log_odds_flag:
                pssm_kwargs["pssm_log_odds_mask"] = dense(lo_mask)
        f = _on_device(feats, dev)
        des = [ltr for ltr, d in zip(letters, designed_flags) if d]
        fixed = [ltr for ltr, d in zip(letters, designed_flags) if not d]
        lines: list[str] = []
        acc: dict[str, list[np.ndarray]] = {
            k: [] for k in ("score", "global_score", "probs", "log_probs", "S", "mask_for_loss")
        }
        n_written = 0
        for ti, temp in enumerate(temps):
            for j, bs in enumerate(batch_sizes):
                gen = (seeded_generator(dev, seed, i) if ti == 0 and j == 0
                       else seeded_generator(dev, seed, i, 7919 * ti + j))
                out = _design_batch(
                    model, gen, f, bs, float(temp), omit_aas=omit_vec, bias_aas=bias_vec,
                    tied_pos=tied_pos, chain_m_pos=dense(cmp_arr),
                    omit_aa_mask=dense(omit_mask_arr), bias_by_res=dense(bias_res_arr),
                    tied_beta=dense(tied_beta_arr), backbone_noise=backbone_noise,
                    **pssm_kwargs,
                )
                if not lines:  # the native record once, with the first batch's scores
                    lines = [
                        ">{}, score={:.4f}, global_score={:.4f}, fixed_chains={}, "
                        "designed_chains={}, {}={}, seed={}".format(
                            name, float(out["native_score"][0]),
                            float(out["native_global_score"][0]), fixed, des,
                            "CA_model_name" if cfg.ca_only else "model_name", model_name, seed,
                        ),
                        _seq_str(feats["S"][0], lens),
                    ]
                for b in range(bs):
                    lines.append(
                        ">T={}, sample={}, score={:.4f}, global_score={:.4f}, "
                        "seq_recovery={:.4f}".format(
                            temp, j * bs + b + 1, float(out["score"][b]),
                            float(out["global_score"][b]), float(out["recovery"][b]),
                        )
                    )
                    lines.append(_seq_str(out["S"][b], lens))
                    n_written += 1
                for k in acc:
                    acc[k].append(out[k])
        (seqs_dir / f"{name}.fa").write_text("\n".join(lines) + "\n")
        cat = {k: np.concatenate(v, axis=0) for k, v in acc.items()}
        if save_score:
            sc_dir = pathlib.Path(output_dir) / "scores"
            sc_dir.mkdir(parents=True, exist_ok=True)
            np.savez(sc_dir / f"{name}.npz", score=cat["score"].astype(np.float32),
                     global_score=cat["global_score"].astype(np.float32))
        if save_probs:
            pr_dir = pathlib.Path(output_dir) / "probs"
            pr_dir.mkdir(parents=True, exist_ok=True)
            np.savez(pr_dir / f"{name}.npz", probs=cat["probs"].astype(np.float32),
                     log_probs=cat["log_probs"].astype(np.float32),
                     S=cat["S"].astype(np.int64), mask=cat["mask_for_loss"].astype(np.float32),
                     chain_order=np.array(letters))
        logger.info(f"designed {n_written} sequences for {name} "
                    f"(L={sum(lens)}, chains={letters})")
    return seqs_dir


def probs_backbones(
    pdb_dir: pathlib.Path | str | None,
    output_dir: pathlib.Path | str,
    conditional: bool = False,
    backbone_only: bool = False,
    num_repeats: int = 1,
    seed: int = 38,
    model: mpnn.ProteinMPNN | None = None,
    weights_path: str | pathlib.Path | None = None,
    jsonl_path: pathlib.Path | str | None = None,
    device: str | torch.device | None = None,
) -> pathlib.Path:
    """Per structure an npz of ``log_p`` ([R, L, 21]: the conditional
    log-probabilities under R decoding orders, or the unconditional ones,
    R = 1), ``S``, ``mask`` and ``design_mask``, under
    ``conditional_probs_only/`` or ``unconditional_probs_only/``;
    ``backbone_only`` gives log p(s_i | backbone) in the conditional mode."""
    model = _model(model, weights_path, device)
    dev = next(model.parameters()).device
    sub = "conditional_probs_only" if conditional else "unconditional_probs_only"
    out_dir = pathlib.Path(output_dir) / sub
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, (name, _, chains) in enumerate(iter_cases(pdb_dir, jsonl_path)):
        if model.cfg.ca_only:
            chains = _ca_only_chains(chains)
        feats = mpnn.featurize_chains(chains)
        f = _on_device(feats, dev)
        with torch.inference_mode():
            if conditional:
                reps = []
                for r in range(num_repeats):
                    randn = _order_keys(seeded_generator(dev, seed, i, r), f["S"].shape, dev)
                    reps.append(mpnn.mpnn_conditional_log_probs(
                        model, f["X"], f["S"], f["mask"], f["chain_M"], f["residue_idx"],
                        f["chain_encoding_all"], randn=randn, backbone_only=backbone_only,
                    ).cpu().numpy())
                log_p = np.concatenate(reps, axis=0)
            else:
                log_p = mpnn.mpnn_unconditional_log_probs(
                    model, f["X"], f["mask"], f["residue_idx"], f["chain_encoding_all"],
                ).cpu().numpy()
        np.savez(
            out_dir / f"{name}.npz", log_p=log_p.astype(np.float32),
            S=feats["S"][0].astype(np.int64), mask=feats["mask"][0].astype(np.float32),
            design_mask=(feats["chain_M"] * feats["mask"])[0].astype(np.float32),
        )
        logger.info(f"{sub}: wrote {name}.npz log_p{log_p.shape}")
    return out_dir


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="ProteinMPNN sequence design (PyTorch)")
    p.add_argument("--pdb_dir", type=str, default="", help="Folder of .pdb backbones to design")
    p.add_argument("--pdb_path", type=str, default="",
                   help="Single PDB to design (alternative to --pdb_dir)")
    p.add_argument("--jsonl_path", type=str, default="",
                   help="parse_multiple_chains.py-format parsed dataset")
    p.add_argument("--out_folder", type=str, required=True,
                   help="Output folder (seqs/ or score_only/ created inside)")
    p.add_argument("--weights_path", type=str, default=DEFAULT_WEIGHTS,
                   help=".pt or .npz ProteinMPNN checkpoint")
    p.add_argument("--path_to_model_weights", type=str, default="",
                   help="Folder holding {model_name}.pt/.npz (overrides --weights_path)")
    p.add_argument("--model_name", type=str, default="",
                   help="Checkpoint name inside --path_to_model_weights, e.g. v_48_020; "
                        "also written into the fasta header")
    p.add_argument("--ca_only", action="store_true",
                   help="Require a CA-only checkpoint (the checkpoint decides)")
    p.add_argument("--pdb_path_chains", type=str, default="",
                   help="With --pdb_path: space-separated chains to design")
    p.add_argument("--num_seq_per_target", type=int, default=8)
    p.add_argument("--sampling_temp", type=str, default="0.1",
                   help="One or more temperatures, e.g. '0.2 0.25 0.5'")
    p.add_argument("--batch_size", type=int, default=0,
                   help="Samples per sampling call; 0 samples all of a temperature as one batch")
    p.add_argument("--max_length", type=int, default=200000,
                   help="Skip structures longer than this")
    p.add_argument("--seed", type=int, default=38, help="0 picks a random seed")
    p.add_argument("--score_only", action="store_true",
                   help="Score the native sequences (score_only/{name}.npz)")
    p.add_argument("--conditional_probs_only", action="store_true",
                   help="Write log p(s_i | s_rest, backbone) (conditional_probs_only/{name}.npz)")
    p.add_argument("--conditional_probs_only_backbone", action="store_true",
                   help="With --conditional_probs_only: log p(s_i | backbone)")
    p.add_argument("--unconditional_probs_only", action="store_true",
                   help="Write one-pass log p(s_i | backbone) (unconditional_probs_only/)")
    p.add_argument("--save_score", action="store_true",
                   help="Also write scores/{name}.npz in design mode")
    p.add_argument("--save_probs", action="store_true",
                   help="Also write probs/{name}.npz in design mode")
    p.add_argument("--omit_AAs", type=str, default="X", help="Letters never sampled, e.g. 'XC'")
    p.add_argument("--bias_AA_jsonl", type=str, default="",
                   help="JSON file {letter: logit bias}")
    p.add_argument("--tie_chains", action="store_true",
                   help="Homo-oligomer design: tie residue i across all chains")
    p.add_argument("--design_chains", type=str, default="",
                   help="Comma-separated chain letters to design; the others stay fixed")
    p.add_argument("--chain_id_jsonl", type=str, default="",
                   help="Per-PDB designed/fixed split: {name: [[designed], [fixed]]}")
    p.add_argument("--fixed_positions_jsonl", type=str, default="",
                   help="JSON file {chain: [1-based positions]} kept native")
    p.add_argument("--omit_AA_jsonl", type=str, default="",
                   help="Per-position forbidden letters: {chain: [[[positions], 'LETTERS'], ...]}")
    p.add_argument("--bias_by_res_jsonl", type=str, default="",
                   help="Per-position logit bias: {chain: [[21 floats] x chain_len]}")
    p.add_argument("--tied_positions_jsonl", type=str, default="",
                   help="Tie groups: [{chain: [pos]} | {chain: [[pos], [beta]]}, ...]")
    p.add_argument("--pssm_jsonl", type=str, default="",
                   help="PSSM restraints {chain: {pssm_coef, pssm_bias, pssm_log_odds}}")
    p.add_argument("--pssm_multi", type=float, default=0.0,
                   help="[0,1]: 0 ignores the PSSM, 1 the model's predictions")
    p.add_argument("--pssm_threshold", type=float, default=0.0,
                   help="log-odds cutoff of the per-position mask")
    p.add_argument("--pssm_log_odds_flag", type=int, default=0)
    p.add_argument("--pssm_bias_flag", type=int, default=0)
    p.add_argument("--backbone_noise", type=float, default=0.0,
                   help="Gaussian std added to the backbone coordinates, fresh for every batch")
    p.add_argument("--device", type=str, default=None,
                   help="Device to run on (default cuda; cpu runs on the CPU)")
    args = p.parse_args(argv)

    if sum(map(bool, (args.pdb_dir, args.pdb_path, args.jsonl_path))) != 1:
        p.error("give exactly one of --pdb_dir / --pdb_path / --jsonl_path")
    if args.pdb_path_chains and not args.pdb_path:
        p.error("--pdb_path_chains needs --pdb_path")
    jsonl_path = pathlib.Path(args.jsonl_path) if args.jsonl_path else None
    pdb_dir = None
    stage = None
    if args.pdb_path:
        import shutil
        import tempfile

        # One PDB alone in a directory, so that the directory walk sees it only.
        stage = pathlib.Path(tempfile.mkdtemp(prefix="mpnn_single_"))
        shutil.copy(args.pdb_path, stage)
        pdb_dir = stage
    elif args.pdb_dir:
        pdb_dir = pathlib.Path(args.pdb_dir)

    if args.seed == 0:
        import random

        args.seed = random.randint(1, 999)
        logger.info(f"seed 0 -> random seed {args.seed}")
    weights = pathlib.Path(args.weights_path)
    if args.path_to_model_weights:
        folder = pathlib.Path(args.path_to_model_weights)
        name = args.model_name or "v_48_020"
        for ext in (".npz", ".pt"):
            if (folder / f"{name}{ext}").exists():
                weights = folder / f"{name}{ext}"
                break
        else:
            raise ToolUnavailable(f"no {name}.npz/.pt under {folder}")
    model = load_mpnn_params(weights, args.device)
    if args.ca_only and not model.cfg.ca_only:
        raise ToolUnavailable(f"--ca_only given but {weights} is a full-backbone checkpoint")
    design_chains = ([c.strip() for c in args.design_chains.split(",") if c.strip()]
                     or args.pdb_path_chains.split() or None)

    def jsonl(path: str):
        return restraints.load_jsonl(path) if path else None

    try:
        if args.score_only:
            out = score_backbones(pdb_dir, args.out_folder, num_scores=args.num_seq_per_target,
                                  seed=args.seed, model=model, jsonl_path=jsonl_path)
        elif args.conditional_probs_only or args.unconditional_probs_only:
            out = probs_backbones(
                pdb_dir, args.out_folder, conditional=args.conditional_probs_only,
                backbone_only=args.conditional_probs_only_backbone,
                num_repeats=args.num_seq_per_target, seed=args.seed, model=model,
                jsonl_path=jsonl_path)
        else:
            bias = (json.loads(pathlib.Path(args.bias_AA_jsonl).read_text())
                    if args.bias_AA_jsonl else None)
            out = design_sequences(
                pdb_dir, args.out_folder, num_seq_per_target=args.num_seq_per_target,
                sampling_temp=args.sampling_temp, seed=args.seed, model=model,
                omit_aas=args.omit_AAs, bias_aa=bias, save_score=args.save_score,
                save_probs=args.save_probs, tie_chains=args.tie_chains,
                design_chains=design_chains, chain_id_dict=jsonl(args.chain_id_jsonl),
                fixed_positions=jsonl(args.fixed_positions_jsonl),
                omit_aa_dict=jsonl(args.omit_AA_jsonl),
                bias_by_res_dict=jsonl(args.bias_by_res_jsonl),
                tied_positions=jsonl(args.tied_positions_jsonl),
                pssm_dict=jsonl(args.pssm_jsonl), pssm_multi=args.pssm_multi,
                pssm_threshold=args.pssm_threshold,
                pssm_log_odds_flag=bool(args.pssm_log_odds_flag),
                pssm_bias_flag=bool(args.pssm_bias_flag), backbone_noise=args.backbone_noise,
                jsonl_path=jsonl_path, batch_size=args.batch_size or None,
                max_length=args.max_length, model_name=args.model_name or weights.stem,
            )
    finally:
        if stage is not None:
            import shutil

            shutil.rmtree(stage, ignore_errors=True)
    print(out)


if __name__ == "__main__":
    main()
