"""Adapters for the external tools of the de novo and evaluation flows:
ProteinMPNN as a subprocess (the fallback of the in-process design in
``tools/mpnn_design.py``), ESMFold, foldseek, MaxCluster and cg2all.

Each adapter raises :class:`ToolUnavailable` when its binary, checkout or
weights are missing, so that a pipeline logs the skip and goes on. None of
them reaches the network: ESMFold loads only weights already on the disk.
"""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess

from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


class ToolUnavailable(RuntimeError):
    pass


def _require_binary(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise ToolUnavailable(
            f"external tool '{name}' not found on PATH; install it or skip "
            f"the step that needs it"
        )
    return path


def run_protein_mpnn(
    pdb_dir: pathlib.Path,
    output_dir: pathlib.Path,
    mpnn_repo: pathlib.Path | str | None = None,
    num_seq_per_target: int = 8,
    sampling_temp: float = 0.1,
    seed: int = 38,
    ca_only: bool = False,
    python: str = "python",
) -> pathlib.Path:
    """ProteinMPNN's own runner as a subprocess over the PDBs of
    ``pdb_dir`` (parse_multiple_chains.py, then protein_mpnn_run.py with a
    batch of one, tried up to five times). Returns the directory of the
    fasta files it writes."""
    if mpnn_repo is None:
        raise ToolUnavailable("no ProteinMPNN checkout configured (inference.pmpnn_dir)")
    mpnn_repo = pathlib.Path(mpnn_repo)
    parse_script = mpnn_repo / "helper_scripts" / "parse_multiple_chains.py"
    run_script = mpnn_repo / "protein_mpnn_run.py"
    if not run_script.exists():
        raise ToolUnavailable(f"protein_mpnn_run.py not found under {mpnn_repo}")

    output_dir.mkdir(parents=True, exist_ok=True)
    parsed_jsonl = output_dir / "parsed_pdbs.jsonl"
    subprocess.run(
        [python, str(parse_script), f"--input_path={pdb_dir}",
         f"--output_path={parsed_jsonl}"],
        check=True,
    )
    args = [
        python, str(run_script),
        "--out_folder", str(output_dir),
        "--jsonl_path", str(parsed_jsonl),
        "--num_seq_per_target", str(num_seq_per_target),
        "--sampling_temp", str(sampling_temp),
        "--seed", str(seed),
        "--batch_size", "1",
    ]
    if ca_only:
        args.append("--ca_only")
    for attempt in range(5):
        try:
            subprocess.run(args, check=True)
            break
        except subprocess.CalledProcessError:
            if attempt == 4:
                raise
            logger.warning(f"ProteinMPNN failed (attempt {attempt + 1}); retrying")
    return output_dir / "seqs"


_ESMFOLD = None


# fair-esm's ESMFold downloads these into torch.hub's checkpoint directory
# when they are not there; the adapter takes it only when both are.
_FAIR_ESM_FILES = ("esmfold_3B_v1.pt", "esm2_t36_3B_UR50D.pt")
_HF_ESMFOLD = "facebook/esmfold_v1"


def esmfold_predict(sequence: str) -> str:
    """Fold ``sequence`` with ESMFold and return the PDB text: fair-esm's
    model when its weights are in torch.hub's checkpoint directory, else
    transformers' ``facebook/esmfold_v1`` when the local Hugging Face cache
    holds it, loaded with ``local_files_only``. No download is tried."""
    global _ESMFOLD
    import torch

    if _ESMFOLD is None:
        hub = pathlib.Path(torch.hub.get_dir()) / "checkpoints"
        try:
            if not all((hub / f).exists() for f in _FAIR_ESM_FILES):
                raise FileNotFoundError(f"fair-esm weights not under {hub}")
            import esm  # type: ignore

            _ESMFOLD = ("fair-esm", esm.pretrained.esmfold_v1().eval())
        except Exception:
            try:
                os.environ.setdefault("HF_HUB_OFFLINE", "1")  # the hub's own switch: no request
                from huggingface_hub import try_to_load_from_cache

                # Looked up before transformers is imported, which takes
                # seconds (tens on some hosts) only to find no weights.
                if not isinstance(try_to_load_from_cache(_HF_ESMFOLD, "config.json"), str):
                    raise FileNotFoundError(f"{_HF_ESMFOLD} is not in the local Hugging Face cache")
                from transformers import AutoTokenizer, EsmForProteinFolding

                tok = AutoTokenizer.from_pretrained(_HF_ESMFOLD, local_files_only=True)
                model = EsmForProteinFolding.from_pretrained(_HF_ESMFOLD, local_files_only=True)
                _ESMFOLD = ("transformers", (tok, model))
            except Exception as e:
                raise ToolUnavailable(
                    f"ESMFold unavailable (no fair-esm model and no local transformers "
                    f"weights): {e}"
                ) from e
    kind, model = _ESMFOLD
    with torch.no_grad():
        if kind == "fair-esm":
            return model.infer_pdb(sequence)
        tok, hf_model = model
        inputs = tok([sequence], return_tensors="pt", add_special_tokens=False)
        return hf_model.output_to_pdb(hf_model(**inputs))[0]


def run_foldseek_easy_search(
    query_pdbs: pathlib.Path,
    target_db: pathlib.Path,
    output_tsv: pathlib.Path,
    tmp_dir: pathlib.Path,
) -> pathlib.Path:
    """foldseek easy-search of ``query_pdbs`` against ``target_db``, the
    alignment TM-score of each hit written to ``output_tsv`` (novelty)."""
    binary = _require_binary("foldseek")
    subprocess.run(
        [
            binary, "easy-search", str(query_pdbs), str(target_db),
            str(output_tsv), str(tmp_dir),
            "--format-output", "query,target,alntmscore",
        ],
        check=True,
    )
    return output_tsv


def run_maxcluster_align(
    pdb_list_file: pathlib.Path, align_score_file: pathlib.Path
) -> pathlib.Path:
    """MaxCluster's all-against-all alignment of the PDBs listed in
    ``pdb_list_file``, its scores written to ``align_score_file``."""
    binary = _require_binary("maxcluster")
    subprocess.run(
        [binary, "-l", str(pdb_list_file), "-in", "-Rl", str(align_score_file)],
        check=True,
        capture_output=True,
        text=True,
    )
    return align_score_file


def run_maxcluster_cluster(
    align_score_file: pathlib.Path, threshold: float = 0.5
) -> str:
    """MaxCluster's clustering of the recorded alignment scores at
    ``threshold``; returns its standard output."""
    binary = _require_binary("maxcluster")
    out = subprocess.run(
        [binary, "-C", "1", "-M", str(align_score_file),
         "-T", str(threshold), "-Tm", str(threshold)],
        check=True,
        capture_output=True,
        text=True,
    )
    return out.stdout


def run_cg2all(input_pdb: pathlib.Path, output_pdb: pathlib.Path) -> pathlib.Path:
    """cg2all's CA trace to all-atom conversion of ``input_pdb``."""
    binary = shutil.which("convert_cg2all")
    if binary is None:
        raise ToolUnavailable("cg2all (convert_cg2all) not found on PATH")
    subprocess.run(
        [binary, "-p", str(input_pdb), "-o", str(output_pdb), "--cg", "ca"],
        check=True,
    )
    return output_pdb
