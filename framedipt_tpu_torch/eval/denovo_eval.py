"""De novo design evaluation CLI over the de novo CLI's output tree.

The port's copy of the JAX package's ``eval/denovo_eval.py``, on the host
with numpy only: designability (the self-consistency scRMSD / scTM of each
sample's ``self_consistency/sc_results.csv``, best and median), diversity
(single-linkage clustering of the pairwise TM-scores with scipy, or
MaxCluster's two-stage flow when its binary is on PATH), novelty (the best
foldseek TM-score against a reference database, when foldseek is
installed) and the helix/strand composition of the samples, with the
composition plot. Every CSV is the text pandas writes for the same rows
(``eval.table``).

Usage:
    python -m framedipt_tpu_torch.eval.denovo_eval --prediction_dir=... \
        [--output_dir=...] [--foldseek_db=...] [--diversity=auto|maxcluster|scipy]
"""
from __future__ import annotations

import argparse
import pathlib
import re

import numpy as np

from framedipt_tpu_torch.analysis import dssp as dssp_lib
from framedipt_tpu_torch.analysis import metrics as analysis_metrics
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data.protein import from_pdb_string
from framedipt_tpu_torch.eval import plots
from framedipt_tpu_torch.eval import table
from framedipt_tpu_torch.tools.external import (
    ToolUnavailable,
    run_foldseek_easy_search,
    run_maxcluster_align,
    run_maxcluster_cluster,
)
from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


def collect_samples(prediction_dir: pathlib.Path) -> list[pathlib.Path]:
    return sorted(prediction_dir.glob("**/sample_*/sample_*_1.pdb"))


def designability(prediction_dir: pathlib.Path) -> list[dict]:
    """One row a sample with a ``self_consistency/sc_results.csv``: its best
    and median scRMSD and scTM over the refolded sequences (NaN cells
    skipped) and whether the best scRMSD is under 2 A."""
    rows = []
    for sc_csv in sorted(prediction_dir.glob("**/self_consistency/sc_results.csv")):
        sc = table.read_csv(sc_csv)
        rmsd, tm = table.column(sc, "rmsd"), table.column(sc, "tm_score")
        best_rmsd = _nan_or(np.nanmin, rmsd)
        rows.append({
            "sample_dir": str(sc_csv.parent.parent),
            "best_sc_rmsd": best_rmsd,
            "median_sc_rmsd": _nan_or(np.nanmedian, rmsd),
            "best_sc_tm": _nan_or(np.nanmax, tm),
            "median_sc_tm": _nan_or(np.nanmedian, tm),
            "designable": bool(best_rmsd < 2.0),
        })
    return rows


def _nan_or(reduce, values: np.ndarray) -> float:
    """``reduce`` over the non-NaN values, NaN when there are none."""
    return np.nan if np.isnan(values).all() else float(reduce(values))


def pairwise_tm_matrix(sample_paths: list[pathlib.Path]) -> np.ndarray:
    """Symmetric pairwise TM matrix over CA traces (equal lengths only are
    compared; unequal pairs get TM=0)."""
    cas = [from_pdb_string(p.read_text()).atom_positions[:, rc.CA_IDX] for p in sample_paths]
    n = len(cas)
    tm = np.eye(n)
    for i in range(n):
        for j in range(i + 1, n):
            if len(cas[i]) == len(cas[j]):
                _, t = analysis_metrics.calc_tm_score(cas[i], cas[j])
            else:
                t = 0.0
            tm[i, j] = tm[j, i] = t
    return tm


def diversity_clusters(
    sample_paths: list[pathlib.Path], tm_threshold: float = 0.5
) -> dict[str, float]:
    """Cluster samples by TM > threshold (single linkage over 1 - TM);
    diversity = clusters / samples."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    if len(sample_paths) < 2:
        return {"num_clusters": len(sample_paths), "diversity": 1.0}
    dist = 1.0 - pairwise_tm_matrix(sample_paths)
    np.fill_diagonal(dist, 0.0)
    z = linkage(squareform(dist, checks=False), method="single")
    labels = fcluster(z, t=1.0 - tm_threshold, criterion="distance")
    num = int(labels.max())
    return {"num_clusters": num, "diversity": num / len(sample_paths)}


_SIZE_RE = re.compile(r"^SIZE : (\d+)")
_CLUSTERS_RE = re.compile(r"^.* (\d+) Clusters @ Threshold")
_ASSIGN_RE = re.compile(r"^INFO\s*:\s*(\d+)\s*:\s*(\d+)\s+(\S+)\s*$")
_CSIZE_RE = re.compile(r"^INFO\s*:\s*(\d+)\s*:\s*(\d+)\s+(\d+)\s")


def parse_maxcluster_size(align_text: str) -> int:
    """``SIZE : N`` from MaxCluster's -Rl alignment-score file."""
    for line in align_text.splitlines():
        m = _SIZE_RE.match(line)
        if m:
            return int(m.group(1))
    raise ValueError("no 'SIZE : N' line in MaxCluster align output")


def parse_maxcluster_clusters(cluster_text: str) -> dict:
    """``maxcluster -C 1``'s output: the cluster count, the item table
    (``INFO : <item> : <cluster>  <path>``) as {path: cluster} and the
    cluster table (``INFO : <cluster> : <centroid> <size> ...``) as
    {cluster: size}."""
    num_clusters = None
    assignments: dict[str, int] = {}
    sizes: dict[int, int] = {}
    in_sizes = False
    for line in cluster_text.splitlines():
        m = _CLUSTERS_RE.match(line)
        if m and num_clusters is None:
            num_clusters = int(m.group(1))
            continue
        if "Centroid" in line and "Size" in line:
            in_sizes = True
            continue
        if in_sizes:
            m = _CSIZE_RE.match(line)
            if m:
                sizes[int(m.group(1))] = int(m.group(3))
                continue
        m = _ASSIGN_RE.match(line)
        if m:
            assignments[m.group(3)] = int(m.group(2))
    if num_clusters is None:
        raise ValueError("no 'N Clusters @ Threshold' line in MaxCluster output")
    return {"num_clusters": num_clusters, "assignments": assignments, "cluster_sizes": sizes}


def maxcluster_diversity(
    sample_paths: list[pathlib.Path],
    outdir: pathlib.Path,
    tm_threshold: float = 0.5,
) -> dict:
    """MaxCluster's diversity: write the PDB list, run the alignment stage
    (skipped when its score file exists), run the clustering stage, parse.
    Returns num_clusters, diversity, assignments, cluster_sizes and size."""
    outdir.mkdir(parents=True, exist_ok=True)
    list_file = outdir / "maxcluster_pdb_list.txt"
    list_file.write_text("".join(f"{p}\n" for p in sample_paths))
    align_file = outdir / "maxcluster_align_scores.txt"
    if not align_file.exists():
        run_maxcluster_align(list_file, align_file)
    size = parse_maxcluster_size(align_file.read_text())
    stdout = run_maxcluster_cluster(align_file, threshold=tm_threshold)
    (outdir / "maxcluster_clusters.txt").write_text(stdout)
    parsed = parse_maxcluster_clusters(stdout)
    parsed["diversity"] = parsed["num_clusters"] / size
    parsed["size"] = size
    return parsed


def novelty(
    sample_dir: pathlib.Path, foldseek_db: pathlib.Path | None, tmp: pathlib.Path
) -> list[dict] | None:
    """foldseek's best alignment TM-score of each query against
    ``foldseek_db``, one row a query in sorted order; None without a
    database or without foldseek."""
    if foldseek_db is None:
        return None
    try:
        out = run_foldseek_easy_search(sample_dir, foldseek_db, tmp / "novelty.tsv",
                                       tmp / "fs_tmp")
    except ToolUnavailable as e:
        logger.warning(str(e))
        return None
    hits: dict = {}
    for row in table.read_csv(out, delimiter="\t", names=["query", "target", "alntmscore"]):
        if row["query"] is not None:
            hits.setdefault(row["query"], []).append(row["alntmscore"])
    rows = []
    for query, scores in sorted(hits.items()):
        present = [s for s in scores if not np.isnan(s)]
        rows.append({"query": query, "pdbTM": max(present) if present else np.nan})
    return rows


def ss_composition(sample_paths: list[pathlib.Path]) -> list[dict]:
    rows = []
    for p in sample_paths:
        prot = from_pdb_string(p.read_text())
        m = dssp_lib.ss_metrics_from_atom37(prot.atom_positions, prot.atom_mask)
        rows.append({"path": str(p), "length": len(prot.aatype), **m})
    return rows


def run(
    prediction_dir: pathlib.Path,
    output_dir: pathlib.Path | None = None,
    foldseek_db: pathlib.Path | None = None,
    diversity_backend: str = "auto",
) -> dict:
    """Evaluate the samples under ``prediction_dir`` into ``output_dir``
    (``prediction_dir/evaluation`` by default). ``diversity_backend``:
    "maxcluster", "scipy", or "auto" (MaxCluster when its binary runs, else
    scipy). Raises ValueError when the tree holds no sample."""
    prediction_dir = pathlib.Path(prediction_dir)
    output_dir = pathlib.Path(output_dir or prediction_dir / "evaluation")
    output_dir.mkdir(parents=True, exist_ok=True)

    samples = collect_samples(prediction_dir)
    logger.info(f"found {len(samples)} samples")
    if not samples:
        raise ValueError(f"no sample_*/sample_*_1.pdb under {prediction_dir}")
    results: dict = {"num_samples": len(samples)}

    comp = ss_composition(samples)
    table.write_csv(comp, output_dir / "ss_composition.csv")
    helix, strand = table.column(comp, "helix_percent"), table.column(comp, "strand_percent")
    results["helix_percent_mean"] = float(np.mean(helix))
    results["strand_percent_mean"] = float(np.mean(strand))
    plots.length_colored_scatter(strand * 100.0, helix * 100.0, table.column(comp, "length"),
                                 "Sheet percentage", "Helix percentage",
                                 output_dir / "helix_sheet.png")

    div: dict = {}
    if diversity_backend in ("auto", "maxcluster") and len(samples) >= 2:
        try:
            mc = maxcluster_diversity(samples, output_dir / "maxcluster")
            div = {"num_clusters": mc["num_clusters"], "diversity": mc["diversity"]}
            table.write_csv([{"path": p, "cluster": c} for p, c in mc["assignments"].items()],
                            output_dir / "cluster_assignments.csv")
        except Exception as e:  # noqa: BLE001 - any MaxCluster failure means scipy
            if diversity_backend == "maxcluster":
                raise
            logger.info(f"maxcluster unavailable ({e}); scipy diversity")
    if not div:
        div = diversity_clusters(samples)
    results.update(div)

    desig = designability(prediction_dir)
    if desig:
        table.write_csv(desig, output_dir / "designability.csv")
        results["designable_fraction"] = float(np.mean([r["designable"] for r in desig]))
        results["best_sc_rmsd_mean"] = _nan_or(np.nanmean, table.column(desig, "best_sc_rmsd"))

    nov = novelty(prediction_dir, foldseek_db, output_dir)
    if nov is not None:
        table.write_csv(nov, output_dir / "novelty.csv")
        results["pdbTM_mean"] = _nan_or(np.nanmean, table.column(nov, "pdbTM"))

    table.write_csv([results], output_dir / "denovo_summary.csv")
    logger.info(f"de novo eval: {results}")
    return results


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prediction_dir", required=True)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--foldseek_db", default=None)
    ap.add_argument("--diversity", default="auto", choices=["auto", "maxcluster", "scipy"])
    args = ap.parse_args(argv)
    run(
        pathlib.Path(args.prediction_dir),
        pathlib.Path(args.output_dir) if args.output_dir else None,
        pathlib.Path(args.foldseek_db) if args.foldseek_db else None,
        diversity_backend=args.diversity,
    )


if __name__ == "__main__":
    main()
