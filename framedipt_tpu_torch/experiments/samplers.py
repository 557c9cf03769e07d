"""The inference CLI's samplers: each item is (name, sample_idx, feats),
the features of one sample with a batch dim of 1. Host-side numpy; the
inference CLI moves a case's items to the device.

``UnconditionalSampler`` is the de novo grid of lengths, every residue
diffused from frames of the reference distribution. The inpainting
samplers run over real structures, padded to the structure's length
bucket, the fixed region imputed from the ground truth in the initial
frames: ``ConditionalSampler`` redacts a random region per chain (or an
explicit window of the first chain); ``TCRSampler`` diffuses CDR loops of
the TCR chains of the complexes listed in a TCR database CSV, found in a
directory or (``TCRSampler.from_database``) downloaded into
``inference.inpainting_samples.download_dir`` and filtered there by
``init_database_metadata``.
"""
from __future__ import annotations

import csv
import dataclasses
import pathlib
from typing import Iterator

import numpy as np
import torch

from framedipt_tpu_torch.data import download as download_lib
from framedipt_tpu_torch.data import features as feature_lib
from framedipt_tpu_torch.data import pipeline as pipeline_lib
from framedipt_tpu_torch.data import tcr as tcr_lib
from framedipt_tpu_torch.data.mmcif import parse_mmcif
from framedipt_tpu_torch.diffusion import SE3Diffuser
from framedipt_tpu_torch.eval import table
from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.tools import errors
from framedipt_tpu_torch.tools.config import Config
from framedipt_tpu_torch.tools.device import seeded_generator
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()

SampleItem = tuple[str, int, dict[str, np.ndarray]]


def init_database_metadata(
    cfg: Config,
    pdb_ids: list[str],
    chains_per_structure: list[list[str] | None],
    cif_dir: pathlib.Path | None = None,
) -> tuple[list[pathlib.Path], list[list[str] | None]]:
    """The database flow's structures: download the listed structures into
    ``download_dir/cifs`` (or ``cif_dir``) where missing (best effort: a file
    present is kept, and offline the files present are used), build
    ``download_dir/processed/metadata.csv`` with the inference filters
    (resolution, total and per-chain length, chain count) unless it exists
    and ``overwrite`` is off, and return the surviving (cif_path, chains)
    pairs in the order of ``pdb_ids``. An empty ``metadata.csv`` means no
    survivor."""
    isc = cfg.inference.inpainting_samples
    download_dir = pathlib.Path(isc.download_dir)
    cifs_dir = pathlib.Path(cif_dir) if cif_dir else download_dir / "cifs"
    processed_dir = download_dir / "processed"
    metadata_path = processed_dir / "metadata.csv"

    missing = [pid for pid in pdb_ids
               if not (cifs_dir / download_lib.cif_name(pid, isc.first_assembly)).exists()]
    if missing:
        try:
            download_lib.download_cifs(missing, cifs_dir, first_assembly=isc.first_assembly,
                                       max_workers=isc.num_workers_download)
        except Exception as e:  # noqa: BLE001 - offline is a supported mode
            logger.warning(f"structure download unavailable: {e}")

    candidates: list[tuple[str, pathlib.Path, list[str] | None]] = []
    for pid, chains in zip(pdb_ids, chains_per_structure):
        path = cifs_dir / download_lib.cif_name(pid, isc.first_assembly)
        if path.exists():
            candidates.append((pid.lower(), path, chains))
        else:
            logger.warning(f"missing structure file {path}; skipping")

    if metadata_path.exists() and not isc.overwrite:
        with open(metadata_path, newline="", encoding="utf-8") as f:
            kept = {row["pdb_name"] for row in csv.DictReader(f)}
        logger.info(f"reusing cached metadata ({len(kept)} entries)")
    else:
        rows = []
        for pid, path, chains in candidates:
            opts = pipeline_lib.ProcessOptions(
                output_dir=processed_dir,
                filtering=dataclasses.replace(cfg.data.filtering, max_len=isc.max_len or 10**9,
                                              min_len=isc.min_len or 0),
                max_resolution=isc.max_resolution,
                first_assembly=isc.first_assembly,
                chains=list(chains) if chains else None,
                chain_min_len=isc.chain_min_len,
                chain_max_len=isc.chain_max_len,
                max_num_chains=isc.max_num_chains,
                check_valid_resolution=isc.check_valid_resolution,
                ss_filters=False,
            )
            try:
                rows.append(pipeline_lib.process_mmcif(path, opts))
            except errors.DataError as e:
                logger.info(f"filtered out {path.name}: {e}")
        processed_dir.mkdir(parents=True, exist_ok=True)
        if rows:
            table.write_csv(rows, metadata_path)
        else:
            metadata_path.write_text("pdb_name\n")
        kept = {str(row["pdb_name"]) for row in rows}
        logger.info(f"processed {len(kept)}/{len(candidates)} structures")

    survivors = [(path, chains) for pid, path, chains in candidates if pid in kept]
    return [p for p, _ in survivors], [c for _, c in survivors]


class UnconditionalSampler:
    """The de novo grid: ``inference.samples`` lengths (min_length to
    max_length by length_step), samples_per_length samples each, named
    ``length_{L}``. Every residue is diffused; the initial frames of (L,
    sample) come from a generator seeded from (seed, L, sample)."""

    def __init__(self, cfg: Config, diffuser: SE3Diffuser, seed: int = 123) -> None:
        self.cfg = cfg
        self.diffuser = diffuser
        self.seed = seed
        s = cfg.inference.samples
        self.lengths = list(range(s.min_length, s.max_length + 1, s.length_step))
        self.samples_per_length = s.samples_per_length

    def __len__(self) -> int:
        return len(self.lengths) * self.samples_per_length

    def sample_initial_rigids(self, length: int, sample_idx: int) -> np.ndarray:
        """Frames at t = 1 [L, 7] from the reference distribution."""
        rigids_t = self.diffuser.sample_ref(
            seeded_generator(self.diffuser.device, self.seed, length, sample_idx),
            n_samples=length,
        )
        return rigids_t.to_tensor7().cpu().numpy().astype(np.float32)

    def __iter__(self) -> Iterator[SampleItem]:
        for length in self.lengths:
            for sample_idx in range(self.samples_per_length):
                feats = {
                    "res_mask": np.ones((length,), np.float32),
                    "fixed_mask": np.zeros((length,), np.float32),
                    "seq_idx": np.arange(length, dtype=np.int64),
                    "chain_idx": np.zeros((length,), np.int64),
                    "residue_index": np.arange(1, length + 1, dtype=np.int64),
                    "sc_ca_t": np.zeros((length, 3), np.float32),
                    "rigids_t": self.sample_initial_rigids(length, sample_idx),
                    "torsion_angles_sin_cos": np.zeros((length, 7, 2), np.float32),
                }
                feats = {k: v[None] for k, v in feats.items()}
                feats["t"] = np.ones((1,), np.float32)
                yield f"length_{length}", sample_idx, feats


class ConditionalSampler:
    """Inpainting over the mmCIF files ``cif_paths``, each restricted to
    its chains in ``chains_per_structure`` (all chains for None), with
    ``inference.inpainting_samples.samples`` samples a structure."""

    def __init__(
        self,
        cfg: Config,
        diffuser: SE3Diffuser,
        cif_paths: list[pathlib.Path],
        chains_per_structure: list[list[str] | None] | None = None,
        seed: int = 123,
    ) -> None:
        self.cfg = cfg
        self.diffuser = diffuser
        self.cif_paths = [pathlib.Path(p) for p in cif_paths]
        self.chains_per_structure = chains_per_structure or [None] * len(self.cif_paths)
        self.samples = cfg.inference.inpainting_samples.samples
        self.seed = seed
        self._mask_cache: dict[int, np.ndarray] = {}
        self._feat_cache: dict[int, dict[str, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.cif_paths) * self.samples

    def create_diffusion_mask(
        self, chain_feats: dict[str, np.ndarray], example_idx: int
    ) -> np.ndarray:
        """The window [start_idx, end_idx] of the first chain when
        ``inpainting_samples`` sets both; else one random contiguous region
        per chain, drawn from ``np.random.default_rng(example_idx)``."""
        if example_idx in self._mask_cache:
            return self._mask_cache[example_idx]
        start = self.cfg.inference.inpainting_samples.start_idx
        end = self.cfg.inference.inpainting_samples.end_idx
        if start is not None and end is not None:
            mask = np.zeros_like(chain_feats["res_mask"])
            first_chain = chain_feats["chain_idx"] == np.unique(chain_feats["chain_idx"])[0]
            mask[np.where(first_chain)[0][start : end + 1]] = 1
        else:
            mask = feature_lib.create_redacted_regions(
                chain_feats["chain_idx"],
                chain_feats["res_mask"],
                np.random.default_rng(example_idx),
                redact_min_len=self.cfg.data.redaction.redact_min_len,
                redact_max_len=self.cfg.data.redaction.redact_max_len,
            )
        self._mask_cache[example_idx] = mask
        return mask

    def load_features(self, example_idx: int) -> dict[str, np.ndarray]:
        if example_idx in self._feat_cache:
            return self._feat_cache[example_idx]
        path = self.cif_paths[example_idx]
        mmcif_obj = parse_mmcif(path)
        chains = self.chains_per_structure[example_idx]
        missing = [c for c in (chains or []) if c not in mmcif_obj.chains]
        if missing:
            raise ValueError(f"{path.name}: chains {missing} not in structure")
        raw = feature_lib.structure_to_features(mmcif_obj, chain_ids=chains)
        feats = feature_lib.build_model_features(raw)
        self._feat_cache[example_idx] = feats
        return feats

    def sample_initial_rigids(
        self, idx: int, impute: Rigid, diffuse_mask: torch.Tensor
    ) -> np.ndarray:
        """Frames at t = 1 for item ``idx`` [N, 7]: drawn from the reference
        distribution in the diffused region, ``impute`` elsewhere; the
        generator is seeded from (seed, idx)."""
        rigids_t = self.diffuser.sample_ref(
            seeded_generator(self.diffuser.device, self.seed, idx),
            n_samples=diffuse_mask.shape[0],
            impute=impute,
            diffuse_mask=diffuse_mask,
        )
        return rigids_t.to_tensor7().cpu().numpy().astype(np.float32)

    def __iter__(self) -> Iterator[SampleItem]:
        for idx in range(len(self)):
            yield self[idx]

    def __getitem__(self, idx: int) -> SampleItem:
        example_idx, sample_idx = divmod(idx, self.samples)
        pdb_name = self.cif_paths[example_idx].stem[:4]
        chain_feats = dict(self.load_features(example_idx))

        diffused_mask = self.create_diffusion_mask(chain_feats, example_idx)
        if diffused_mask.sum() < 1:
            raise ValueError(f"{pdb_name}: the diffusion mask selects no residue")
        chain_feats["fixed_mask"] = (1 - diffused_mask).astype(np.float32)
        chain_feats["sc_ca_t"] = np.zeros_like(chain_feats["rigids_0"][:, 4:])
        dev = self.diffuser.device
        chain_feats["rigids_t"] = self.sample_initial_rigids(
            idx,
            impute=Rigid.from_tensor7(torch.as_tensor(chain_feats["rigids_0"], device=dev)),
            diffuse_mask=torch.as_tensor(diffused_mask, dtype=torch.float32, device=dev),
        )
        chain_feats["t"] = np.asarray(1.0, np.float32)

        # Pad to the length bucket and add the batch dim.
        bucket = feature_lib.length_bucket(len(chain_feats["res_mask"]))
        chain_feats = feature_lib.pad_feats(chain_feats, bucket)
        final = {
            k: (v[None] if np.ndim(v) >= 1 else np.asarray([v], np.float32))
            for k, v in chain_feats.items()
        }
        return pdb_name, sample_idx, final


class TCRSampler(ConditionalSampler):
    """CDR-loop inpainting over the complexes of a TCR database CSV whose
    ``<pdb_id>-assembly1.cif`` is in ``cif_dir`` (a listed complex without
    its file is skipped with a warning), or over ``cif_paths`` with their
    ``chains_list`` when given."""

    def __init__(
        self,
        cfg: Config,
        diffuser: SE3Diffuser,
        cif_dir: str | pathlib.Path | None = None,
        csv_path: str | pathlib.Path | None = None,
        seed: int = 123,
        cif_paths: list[pathlib.Path] | None = None,
        chains_list: list[list[str] | None] | None = None,
    ) -> None:
        if cif_paths is None:
            pdb_ids, all_chains = _read_tcr_csv(csv_path)
            cif_dir = pathlib.Path(cif_dir)
            cif_paths, chains_list = [], []
            for pid, chains in zip(pdb_ids, all_chains):
                path = cif_dir / f"{pid}-assembly1.cif"
                if not path.exists():
                    logger.warning(f"missing structure file {path}; skipping")
                    continue
                cif_paths.append(path)
                chains_list.append(chains)
        super().__init__(cfg, diffuser, cif_paths, chains_list, seed=seed)
        self.cdr_loops = [_canonical_loop(c) for c in cfg.inference.inpainting_samples.cdr_loops]
        self.shifted_region = cfg.inference.inpainting_samples.shifted_region

    @classmethod
    def from_database(cls, cfg: Config, diffuser: SE3Diffuser, seed: int = 123) -> "TCRSampler":
        """The database flow: the TCR database CSV (``inpainting_samples
        .data_path``, else ``data.csv_path``, else ``database/TCR.csv``)
        drives the download into ``inpainting_samples.download_dir``, the
        inference filters build the cached ``metadata.csv``, and sampling
        runs over the survivors."""
        csv_path = cfg.inference.inpainting_samples.data_path or cfg.data.csv_path or (
            "database/TCR.csv")
        pdb_ids, all_chains = _read_tcr_csv(csv_path)
        cif_paths, chains_list = init_database_metadata(cfg, pdb_ids, all_chains)
        return cls(cfg, diffuser, seed=seed, cif_paths=cif_paths, chains_list=chains_list)

    def create_diffusion_mask(
        self, chain_feats: dict[str, np.ndarray], example_idx: int
    ) -> np.ndarray:
        if example_idx in self._mask_cache:
            return self._mask_cache[example_idx]
        mask = tcr_lib.create_diffusion_mask(
            chain_indexes=chain_feats["chain_idx"],
            aatype=np.asarray(chain_feats["aatype"]),
            tcr_chains=list(self.chains_per_structure[example_idx][:2]),
            cdr_loops=self.cdr_loops,
            shifted_region=self.shifted_region,
        )
        self._mask_cache[example_idx] = mask
        return mask


def _read_tcr_csv(path: str | pathlib.Path) -> tuple[list[str], list[list[str]]]:
    with open(path, newline="", encoding="utf-8") as f:
        return _tcr_rows(list(csv.DictReader(f)))


def _tcr_rows(rows: list[dict[str, str]]) -> tuple[list[str], list[list[str]]]:
    """(pdb_ids, chains to process) of the TCR database's rows: TCR alpha and
    beta first (the CDR masks take the first two chains processed as the
    TCR's), then the peptide and MHC chains a row names."""
    pdb_ids: list[str] = []
    all_chains: list[list[str]] = []
    for row in rows:
        chains = [row["tcr_alpha_chain"], row["tcr_beta_chain"]]
        chains += [row[col] for col in ("peptide_chain", "mhc_alpha_chain", "mhc_beta_chain")
                   if row.get(col)]
        pdb_ids.append(str(row["pdb_id"]).lower())
        all_chains.append(chains)
    return pdb_ids, all_chains


def _canonical_loop(name: str) -> str:
    """A config loop name ('beta_3', 'alpha_3', 'CDR3') as its CDR id."""
    name = str(name)
    if name.upper().startswith("CDR"):
        return name.upper()
    digit = name.split("_")[-1]
    return {"1": "CDR1", "2": "CDR2", "2.5": "CDR2.5", "3": "CDR3"}.get(digit, "CDR3")
