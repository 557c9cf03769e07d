"""Batch inference CLI: inpainting over every structure of a directory of
mmCIF files (or the TCR complexes of a database CSV found there, or, without
``--cif_dir``, downloaded into ``inference.inpainting_samples.download_dir``
and filtered there), or de novo design (``inference.inpainting=false``); it
writes the output tree that evaluation reads.

    python -m framedipt_tpu_torch.experiments.inference --cif_dir=<dir> \
        [--config=conf.json] [--device=cuda] [key=value ...]
    python -m framedipt_tpu_torch.experiments.inference \
        inference.inpainting_samples.download_dir=<dir> \
        inference.inpainting_samples.data_path=<TCR database CSV> [key=value ...]
    python -m framedipt_tpu_torch.experiments.inference inference.inpainting=false \
        [--config=conf.json] [--device=cuda] [key=value ...]

Under ``inference.output_dir/inference.name`` (a timestamp when unnamed;
``_job<N>`` appended under ``FRAMEDIPT_JOB_NUM``) it writes the config as
``inference_conf.json`` and, per structure, ``{pdb}_length_{L}/`` (L the
number of diffused residues) holding the ground truth ``{pdb}_1.pdb`` with
b-factor 100 on the diffused residues, ``diffusion_info.csv`` and, per
sample s, ``sample_<s>/sample_<s>_1.pdb`` with the backbone trajectory
``bb_traj_<s>_1.pdb``, the model's x0 predictions ``x0_traj_<s>_1.pdb``
and, with ``inference.confidence_score=eigenfold``,
``confidence_score.txt``. A sample whose ``sample_<s>_1.pdb`` exists is
skipped, so a second run over the same tree resumes the first.

De novo, over the grid of ``inference.samples``, it writes per length L and
sample i ``length_{L}/sample_{i}/`` with ``sample_{i}_1.pdb``,
``bb_traj_{i}_1.pdb`` and ``x0_traj_{i}_1.pdb`` (every residue diffused,
b-factor 100), then the self-consistency check under
``self_consistency/``: ProteinMPNN designs ``inference.samples.
seq_per_sample`` sequences for the sample's structure in process
(``seqs/sample_{i}_1.fa``; weights ``inference.mpnn_weights_path``; without
them ProteinMPNN's own runner from ``inference.pmpnn_dir``; without both
a warning and no check), ESMFold refolds each sequence
(``esmf_sample_{k}.pdb``; without ESMFold a warning ends the sample's
check) and ``sc_results.csv`` holds each refold's TM-score and aligned
RMSD against the sample. A sample whose directory exists is skipped.

``inference.weights_path`` is a reference ``.pth`` file, or a directory of
the train CLI's checkpoints (a ``step_<N>`` directory or the run directory
holding them); their model and diffuser config wins over the runtime
config. Without weights the model takes the JAX package's initialization,
seeded from ``inference.seed``. It runs on CUDA unless the caller asks for
another device; on the card the model runs its CUDA kernels, built at first
use.
"""
from __future__ import annotations

import copy
import os
import pathlib
import shutil
import sys
import tempfile
from datetime import datetime

import numpy as np
import torch

from framedipt_tpu_torch.analysis import metrics as analysis_metrics
from framedipt_tpu_torch.analysis import utils as analysis_utils
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.protein import from_pdb_string
from framedipt_tpu_torch.diffusion import SE3Diffuser
from framedipt_tpu_torch.eval.table import write_csv
from framedipt_tpu_torch.experiments import utils as exp_utils
from framedipt_tpu_torch.experiments.samplers import (
    ConditionalSampler,
    TCRSampler,
    UnconditionalSampler,
)
from framedipt_tpu_torch.geometry import frames
from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.model import ScoreNetwork
from framedipt_tpu_torch.model.kernels.build import build_all
from framedipt_tpu_torch.model.weights import init_state_dict, load_reference_checkpoint
from framedipt_tpu_torch.sampling import sample
from framedipt_tpu_torch.sampling.confidence import logp_confidence_score
from framedipt_tpu_torch.tools import external, mpnn_design
from framedipt_tpu_torch.tools.config import (
    Config,
    load_config,
    merge_checkpoint_config,
    resolve_kernel_flags,
    save_config,
)
from framedipt_tpu_torch.tools.device import (
    resolve_device,
    seeded_generator,
    set_full_precision_matmul,
)
from framedipt_tpu_torch.tools.log import get_logger
from framedipt_tpu_torch.train.checkpoints import CKPT_FILE, latest_checkpoint, load_checkpoint

logger = get_logger()

# Features the host keeps for bookkeeping; the model reads none of them.
_HOST_ONLY = ("chain_idx", "residue_index", "residx_atom14_to_atom37", "rigidgroups_0",
              "atom37_pos", "atom37_mask", "atom14_pos")


class Inference:
    def __init__(
        self,
        cfg: Config,
        cif_dir: str | pathlib.Path | None = None,
        state_dict: dict[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        set_full_precision_matmul()
        cfg, ckpt_state_dict = self._load_checkpoint(copy.deepcopy(cfg))
        self.cfg = cfg
        self.inpainting = cfg.inference.inpainting

        name = cfg.inference.name or datetime.now().strftime("%d_%m_%Y_%H_%M_%S")
        job_num = os.environ.get("FRAMEDIPT_JOB_NUM")
        if job_num is not None:
            name = f"{name}_job{job_num}"
        self.output_dir = pathlib.Path(cfg.inference.output_dir) / name
        self.output_dir.mkdir(parents=True, exist_ok=True)
        save_config(cfg, self.output_dir / "inference_conf.json")

        resolve_kernel_flags(cfg, self.device)
        if self.device.type == "cuda":
            build_all()
        self.diffuser = SE3Diffuser(cfg.diffuser, device=self.device)
        self.model = ScoreNetwork(cfg.model, self.diffuser, inpainting=self.inpainting)
        if state_dict is None:
            state_dict = ckpt_state_dict
        if state_dict is None:
            logger.warning("initializing model with RANDOM weights")
            state_dict = init_state_dict(
                self.model, torch.Generator().manual_seed(cfg.inference.seed))
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.cif_dir = pathlib.Path(cif_dir) if cif_dir else None
        self.sampler = self._create_sampler()
        self._mpnn = None  # the self-consistency check's ProteinMPNN, loaded at first use

    def _load_checkpoint(self, cfg: Config) -> tuple[Config, dict | None]:
        """(config, state_dict or None) from ``inference.weights_path``."""
        weights_path = cfg.inference.weights_path
        path = pathlib.Path(weights_path) if weights_path else None
        if path and path.is_dir():
            ckpt_dir = path if (path / CKPT_FILE).exists() else latest_checkpoint(path)
            if ckpt_dir is None:
                logger.warning(f"no checkpoints under {path}; using random init")
                return cfg, None
            payload = load_checkpoint(ckpt_dir)
            logger.info(f"loaded checkpoint {ckpt_dir}")
            return merge_checkpoint_config(cfg, payload["conf"]), payload["model"]
        if path and path.exists():
            state_dict, ckpt_conf = load_reference_checkpoint(weights_path)
            logger.info(f"loaded checkpoint {path}")
            if ckpt_conf:
                cfg = merge_checkpoint_config(cfg, ckpt_conf)
            return cfg, state_dict
        if weights_path:
            logger.warning(f"weights not found at {weights_path}; using random init")
        return cfg, None

    def _create_sampler(self) -> ConditionalSampler | UnconditionalSampler:
        cfg = self.cfg
        if not self.inpainting:
            return UnconditionalSampler(cfg, self.diffuser, seed=cfg.inference.seed)
        if self.cif_dir is None:
            isc = cfg.inference.inpainting_samples
            if isc.tcr and isc.download_dir:
                return TCRSampler.from_database(cfg, self.diffuser, seed=cfg.inference.seed)
            raise ValueError(
                "conditional sampling requires cif_dir (or inference.inpainting_samples."
                "download_dir for the database-driven TCR flow)"
            )
        if cfg.inference.inpainting_samples.tcr:
            return TCRSampler(cfg, self.diffuser, cif_dir=self.cif_dir,
                              csv_path=cfg.data.csv_path or "database/TCR.csv",
                              seed=cfg.inference.seed)
        return ConditionalSampler(cfg, self.diffuser, sorted(self.cif_dir.glob("*.cif")),
                                  seed=cfg.inference.seed)

    def run_sampling(self) -> None:
        if not self.inpainting:
            self.run_unconditional_sampling()
        elif self.cfg.inference.inpainting_samples.batch_samples:
            self._run_conditional_batched()
        else:
            self._run_conditional_serial()

    def _generator(self, *streams: int) -> torch.Generator:
        """The reverse sampler's and the confidence score's generator for
        ``streams``: seeded from ``inference.seed + 1``, as the service's
        sampler is, so that its draws never repeat those of the initial
        frames, which the sampler seeds from ``inference.seed``."""
        return seeded_generator(self.device, self.cfg.inference.seed + 1, *streams)

    def _sample(self, label: str, feats: dict[str, np.ndarray],
                generator: torch.Generator) -> dict:
        d = self.cfg.inference.diffusion
        with exp_utils.Timer() as timer:
            out = sample(
                self.model, self.diffuser, self._to_device(feats), generator,
                num_t=d.num_t, min_t=d.min_t, noise_scale=d.noise_scale,
                inpainting=self.inpainting,
                input_aatype=self.cfg.inference.input_aatype, aux_traj=True,
            )
            out = {k: v.cpu().numpy() for k, v in out.items()}
        logger.info(f"{label}: {len(feats['res_mask'])} sample(s) x {d.num_t} steps "
                    f"in {timer.elapsed:.2f}s")
        return out

    def _run_conditional_batched(self) -> None:
        """All samples of a structure in one sampler call of batch
        ``samples``; the generator is seeded from (seed + 1, case)."""
        samples_per_case = self.cfg.inference.inpainting_samples.samples
        for ex in range(len(self.sampler) // samples_per_case):
            items = [self.sampler[ex * samples_per_case + s] for s in range(samples_per_case)]
            pdb_name = items[0][0]
            batched = {k: np.concatenate([it[2][k] for it in items], axis=0)
                       for k in items[0][2]}
            length_dir = self._write_case_context(pdb_name, batched)
            todo = [s for s in range(samples_per_case)
                    if not (length_dir / f"sample_{s}" / f"sample_{s}_1.pdb").exists()]
            if not todo:
                continue
            out = self._sample(pdb_name, batched, self._generator(ex))
            for s in todo:
                self._save_sample(out, s, s, length_dir, batched)
                if self.cfg.inference.confidence_score == "eigenfold":
                    self._write_confidence(
                        {k: v[s : s + 1] for k, v in batched.items()},
                        out["final_rigids"][s : s + 1], length_dir / f"sample_{s}",
                        self._generator(ex, 1000 + s),
                    )

    def _run_conditional_serial(self) -> None:
        """One sample at a time; the generator is seeded from (seed + 1, item)."""
        for item_idx, (pdb_name, sample_i, feats) in enumerate(self.sampler):
            length_dir = self._write_case_context(pdb_name, feats)
            if (length_dir / f"sample_{sample_i}" / f"sample_{sample_i}_1.pdb").exists():
                continue
            out = self._sample(f"{pdb_name} sample {sample_i}", feats, self._generator(item_idx))
            self._save_sample(out, 0, sample_i, length_dir, feats)
            if self.cfg.inference.confidence_score == "eigenfold":
                self._write_confidence(
                    feats, out["final_rigids"], length_dir / f"sample_{sample_i}",
                    self._generator(item_idx, 1),
                )

    def run_unconditional_sampling(self) -> None:
        """One sample at a time over the de novo grid, each followed by its
        self-consistency check; the generator is seeded from (seed + 1,
        item)."""
        for item_idx, (name, sample_i, feats) in enumerate(self.sampler):
            sample_dir = self.output_dir / name / f"sample_{sample_i}"
            if sample_dir.exists():
                continue
            sample_dir.mkdir(parents=True)
            out = self._sample(f"{name} sample {sample_i}", feats, self._generator(item_idx))
            length = feats["res_mask"].shape[1]
            paths = self.save_traj(out["prot_traj"][:, 0], out["rigid_0_traj"][:, 0],
                                   np.ones(length), output_dir=sample_dir, sample_idx=sample_i)
            self.run_self_consistency(sample_dir, paths["sample_path"])
            logger.info(f"done {name} sample {sample_i}: {paths['sample_path']}")

    def _design(self, pdb_dir: pathlib.Path, sc_dir: pathlib.Path) -> pathlib.Path:
        """ProteinMPNN's sequences for the structures of ``pdb_dir`` under
        ``sc_dir/seqs``: in process, else through ProteinMPNN's runner."""
        n_seqs = self.cfg.inference.samples.seq_per_sample
        try:
            if self._mpnn is None:
                self._mpnn = mpnn_design.load_mpnn_params(
                    self.cfg.inference.mpnn_weights_path, self.device)
            return mpnn_design.design_sequences(pdb_dir, sc_dir, num_seq_per_target=n_seqs,
                                                model=self._mpnn)
        except external.ToolUnavailable as e_inproc:
            try:
                return external.run_protein_mpnn(pdb_dir=pdb_dir, output_dir=sc_dir,
                                                 mpnn_repo=self.cfg.inference.pmpnn_dir,
                                                 num_seq_per_target=n_seqs)
            except external.ToolUnavailable as e:
                raise external.ToolUnavailable(f"{e_inproc}; fallback: {e}") from e

    def run_self_consistency(self, sample_dir: pathlib.Path, sample_pdb: pathlib.Path) -> None:
        """ProteinMPNN's sequences for the sample's structure, each refolded
        by ESMFold and scored against the sample (TM-score, aligned RMSD of
        the CA) into ``self_consistency/sc_results.csv``. A missing tool
        logs a warning and ends the check."""
        sc_dir = sample_dir / "self_consistency"
        sc_dir.mkdir(exist_ok=True)
        # The sample's structure alone, so that its trajectories are not designed.
        with tempfile.TemporaryDirectory(prefix="sc_design_") as stage:
            shutil.copy(sample_pdb, stage)
            try:
                seqs_dir = self._design(pathlib.Path(stage), sc_dir)
            except external.ToolUnavailable as e:
                logger.warning(f"self-consistency skipped: {e}")
                return

        sample_ca = from_pdb_string(pathlib.Path(sample_pdb).read_text()).atom_positions[
            :, rc.CA_IDX]
        rows = []
        for fasta in sorted(pathlib.Path(seqs_dir).glob("*.fa")):
            seqs = [line.strip() for line in fasta.read_text().splitlines()
                    if line and not line.startswith(">")]
            for i, seq in enumerate(seqs):
                try:
                    pdb_str = external.esmfold_predict(seq)
                except external.ToolUnavailable as e:
                    logger.warning(f"ESMFold unavailable: {e}")
                    return
                pred_path = sc_dir / f"esmf_sample_{i}.pdb"
                pred_path.write_text(pdb_str)
                pred_ca = from_pdb_string(pdb_str).atom_positions[:, rc.CA_IDX]
                if len(pred_ca) != len(sample_ca):
                    continue
                _, tm = analysis_metrics.calc_tm_score(pred_ca, sample_ca)
                rmsd = analysis_metrics.calc_aligned_rmsd(pred_ca, sample_ca)
                rows.append({"sequence": seq, "sample": str(pred_path), "rmsd": rmsd,
                             "tm_score": tm})
        if rows:
            write_csv(rows, sc_dir / "sc_results.csv")

    def _to_device(self, feats: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        out = {}
        for k, v in feats.items():
            if k in _HOST_ONLY:
                continue
            dtype = torch.int64 if k in ("aatype", "seq_idx") else torch.float32
            out[k] = torch.as_tensor(v, dtype=dtype, device=self.device)
        return out

    def _length_dir(self, pdb_name: str, feats: dict) -> pathlib.Path:
        res_mask = feats["res_mask"][0].astype(bool)
        num_diffused = int(((~feats["fixed_mask"][0].astype(bool)) & res_mask).sum())
        d = self.output_dir / f"{pdb_name}_length_{num_diffused}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _write_case_context(self, pdb_name: str, feats: dict) -> pathlib.Path:
        """The case's directory, with the ground-truth PDB and
        diffusion_info.csv written if absent; returns the directory."""
        res_mask = feats["res_mask"][0].astype(bool)
        diffused_mask = (~feats["fixed_mask"][0].astype(bool)) & res_mask
        aatype = feats["aatype"][0].astype(np.int64)
        length_dir = self._length_dir(pdb_name, feats)
        if not (length_dir / f"{pdb_name}_1.pdb").exists():
            gt_atom37, gt_mask37, _, _ = frames.compute_backbone(
                Rigid.from_tensor7(torch.as_tensor(feats["rigids_0"][:1], dtype=torch.float32)),
                torch.as_tensor(feats["torsion_angles_sin_cos"][:1, :, 2, :], dtype=torch.float32),
                aatype=torch.as_tensor(feats["aatype"][:1], dtype=torch.int64),
            )
            gt_prot = (gt_atom37 * gt_mask37[..., None]).numpy()[0]
            b_factors = np.tile((diffused_mask * 100.0)[:, None], (1, 37))
            analysis_utils.write_prot_to_pdb(
                gt_prot[res_mask],
                length_dir / pdb_name,
                aatype=aatype[res_mask],
                b_factors=b_factors[res_mask],
                residue_index=feats["residue_index"][0][res_mask],
                chain_index=feats["chain_idx"][0][res_mask],
            )
        if not (length_dir / "diffusion_info.csv").exists():
            exp_utils.save_diffusion_info(
                length_dir, pdb_name, rc.aatype_to_sequence(aatype[res_mask]),
                diffused_mask[res_mask], feats["chain_idx"][0][res_mask],
            )
        if self.cfg.inference.inpainting_samples.run_esmfold:
            logger.warning("ESMFold prediction skipped: the port has no ESMFold weights")
        return length_dir

    def _save_sample(self, out: dict, b: int, sample_idx: int, length_dir: pathlib.Path,
                     feats: dict) -> None:
        """Write batch entry ``b`` of ``out`` as sample ``sample_idx``."""
        res_mask = feats["res_mask"][0].astype(bool)
        diffused_mask = (~feats["fixed_mask"][0].astype(bool)) & res_mask
        sample_dir = length_dir / f"sample_{sample_idx}"
        sample_dir.mkdir(parents=True, exist_ok=True)
        self.save_traj(
            out["prot_traj"][:, b][:, res_mask],
            out["rigid_0_traj"][:, b][:, res_mask],
            diffused_mask[res_mask],
            output_dir=sample_dir,
            sample_idx=sample_idx,
            aatype=feats["aatype"][0].astype(np.int64)[res_mask],
            residue_index=feats["residue_index"][0][res_mask],
            chain_index=feats["chain_idx"][0][res_mask],
        )

    def _write_confidence(self, feats: dict, final_rigids: np.ndarray,
                          sample_dir: pathlib.Path, generator: torch.Generator) -> None:
        res_mask = feats["res_mask"][0].astype(bool)
        diffused_mask = ((~feats["fixed_mask"][0].astype(bool)) & res_mask).astype(np.float32)
        d = self.cfg.inference.diffusion
        score = logp_confidence_score(
            self.model, self.diffuser, self._to_device(feats),
            torch.as_tensor(final_rigids, device=self.device),
            torch.as_tensor(diffused_mask[None], device=self.device),
            num_t=d.num_t, min_t=d.min_t, generator=generator,
        )
        (sample_dir / "confidence_score.txt").write_text(f"{float(score)}\n")

    def save_traj(
        self,
        bb_prot_traj: np.ndarray,
        x0_traj: np.ndarray,
        diffuse_mask: np.ndarray,
        output_dir: pathlib.Path,
        sample_idx: int,
        aatype: np.ndarray | None = None,
        residue_index: np.ndarray | None = None,
        chain_index: np.ndarray | None = None,
    ) -> dict[str, pathlib.Path | None]:
        """Write the final structure (the trajectory's t = 0 frame) and, as
        configured, the backbone and x0 trajectories as multi-model PDBs;
        b-factor 100 marks the diffused residues."""
        b_factors = np.tile((diffuse_mask.astype(bool) * 100.0)[:, None], (1, 37))
        common = dict(aatype=aatype, residue_index=residue_index, chain_index=chain_index,
                      b_factors=b_factors)
        sample_path = analysis_utils.write_prot_to_pdb(
            bb_prot_traj[0], output_dir / f"sample_{sample_idx}", **common)
        traj_path = x0_path = None
        if self.cfg.inference.save_backbone_trajectory:
            traj_path = analysis_utils.write_prot_to_pdb(
                bb_prot_traj, output_dir / f"bb_traj_{sample_idx}", **common)
        if self.cfg.inference.save_pred_x0_trajectory:
            x0_path = analysis_utils.write_prot_to_pdb(
                x0_traj, output_dir / f"x0_traj_{sample_idx}", **common)
        return {"sample_path": sample_path, "traj_path": traj_path, "x0_traj_path": x0_path}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    json_path, cif_dir, device, overrides = None, None, None, []
    for arg in argv:
        if arg.startswith("--config="):
            json_path = arg.split("=", 1)[1]
        elif arg.startswith("--cif_dir="):
            cif_dir = arg.split("=", 1)[1]
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    cfg = load_config(overrides, json_path=json_path)
    with exp_utils.Timer() as t:
        Inference(cfg, cif_dir=cif_dir, device=device).run_sampling()
    logger.info(f"inference finished in {t.elapsed:.1f}s")


if __name__ == "__main__":
    main()
