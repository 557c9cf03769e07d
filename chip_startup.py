#!/usr/bin/env python3
"""Time the one-card CLIs' process start and chip_smoke.py's phases 7 and
12(e) on one CUDA card, for this checkout beside earlier trees.

    python3 chip_startup.py --tree parent=DIR [--tree NAME=DIR ...]
        [--eager_imports] [--rounds 2] [--out FILE]

A tree is a directory unpacked from a commit (``git archive <rev> | tar -x
-C DIR``); this checkout is the tree ``this``. ``--eager_imports`` adds the
tree ``eager``: a copy of this checkout whose ``train/checkpoints.py``
imports ``torch.distributed.checkpoint.state_dict`` and
``torch.distributed.tensor`` at module level, as every CLI did before
those imports moved into the code that runs only in a process group.

Each round runs every tree once, in a fresh process whose working directory
and import path are that tree (rounds alternate the order: parent, this,
this, parent for two trees), and measures there:

- a fresh ``python -c "import <module>"`` of ``experiments.inference`` and
  ``experiments.train``, twice each, beside ``import torch``; and whether
  the import loaded ``torch.distributed.tensor`` or
  ``torch.distributed.checkpoint``;
- the tree's own chip_smoke.py phase 7 (``check_training_cli``: the training
  CLI in process, its resumed run's steps a second) and phase 12(e)
  (``check_sweep``: ``tools.sweep`` over two de novo CLI processes, each
  job's seconds), after ``build_all`` of the tree's kernels.

Prints the card's name and power limit, then what those print, each line
after its tree and round, then a summary; writes the numbers as JSON to
``--out`` and each sweep job's log beside it. Exits non-zero if a phase
fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
MODULES = ("framedipt_tpu_torch.experiments.inference", "framedipt_tpu_torch.experiments.train")
IMPORT_REPS = 2
IMPORT_CODE = (
    "import sys, time; t = time.perf_counter(); import importlib; "
    "importlib.import_module(sys.argv[1]); s = time.perf_counter() - t; "
    "print(s, sorted({m.split('.')[2] for m in sys.modules if m.startswith('torch.distributed.') "
    "and m.split('.')[2] in ('tensor', 'checkpoint', 'fsdp')}))")
EAGER_LINE = "import torch.distributed.checkpoint.state_dict  # noqa: F401\n" \
             "import torch.distributed.tensor  # noqa: F401\n"


def time_imports(tree: pathlib.Path) -> dict:
    """Seconds of each fresh import (``torch`` first) and the distributed
    submodules each loaded."""
    out = {}
    for module in ("torch",) + MODULES:
        runs = [subprocess.run([sys.executable, "-c", IMPORT_CODE, module], cwd=tree, check=True,
                               capture_output=True, text=True, timeout=300).stdout.split(" ", 1)
                for _ in range(IMPORT_REPS)]
        out[module] = {"s": [float(r[0]) for r in runs], "loaded": runs[-1][1].strip()}
        print(f"import {module}: {[round(float(r[0]), 3) for r in runs]} s, "
              f"loads {out[module]['loaded']}", flush=True)
    return out


def child(tree: pathlib.Path, logs: pathlib.Path) -> None:
    """One tree's measurements, in this process (started by :func:`main`)."""
    sys.path.insert(0, str(tree))
    import chip_smoke
    from framedipt_tpu_torch.model.kernels.build import build_all
    from framedipt_tpu_torch.tools.device import set_full_precision_matmul

    assert pathlib.Path(chip_smoke.__file__).resolve().parent == tree.resolve()
    time_imports(tree)
    set_full_precision_matmul()
    t0 = time.perf_counter()
    build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    chip_smoke.check_training_cli()
    print(f"phase 7: {time.perf_counter() - t0:.2f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_startup_") as tmp:
        t0 = time.perf_counter()
        chip_smoke.check_sweep(pathlib.Path(tmp))
        print(f"phase 12(e): {time.perf_counter() - t0:.2f} s", flush=True)
        logs.mkdir(parents=True, exist_ok=True)
        for f in (pathlib.Path(tmp) / "sweep_logs").glob("*.log"):
            shutil.copy(f, logs / f.name)


def parse(text: str) -> dict:
    """The numbers of one child's output."""
    def grab(pattern: str) -> list[float]:
        return [float(x) for x in re.findall(pattern, text)]

    imports = {m: [float(x) for x in re.findall(rf"import {re.escape(m)}: \[([^\]]*)\]", text)[0]
                   .split(",")]
               for m in ("torch",) + MODULES}
    sweep = re.search(r"sweep of 2 de novo CLI jobs on CUDA device 0: ([\d.]+) s in all, "
                      r"job 0 ([\d.]+) s, job 1 ([\d.]+) s", text)
    return {
        "imports_s": imports,
        "phase7_s": grab(r"phase 7: ([\d.]+) s")[0],
        "resumed_steps_per_s": grab(r"resumed run: steps \d+ -> \d+; ([\d.]+) steps/s")[0],
        "resumed_in_memory_steps_per_s": grab(r"s waiting for batches\), ([\d.]+) steps/s")[0],
        "resumed_busy_share": grab(r"busy share [\d.]+ without the pipeline, ([\d.]+) of")[0],
        "sweep_s": float(sweep.group(1)),
        "sweep_jobs_s": [float(sweep.group(2)), float(sweep.group(3))],
        "phase12e_s": grab(r"phase 12\(e\): ([\d.]+) s")[0],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--eager_imports", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=pathlib.Path, default=REPO / "chiprun_out" / "startup.json")
    ap.add_argument("--child", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--logs", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.logs)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_startup: no CUDA device; this script runs on the GPU only", flush=True)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    trees = {"this": REPO}
    trees.update({name: pathlib.Path(path).resolve()
                  for name, path in (t.split("=", 1) for t in args.tree)})
    with tempfile.TemporaryDirectory(prefix="chip_startup_trees_") as tmp:
        if args.eager_imports:
            eager = pathlib.Path(tmp) / "eager"
            shutil.copytree(REPO, eager, ignore=shutil.ignore_patterns(
                ".git", "chiprun_out", "_trees", "_build", "__pycache__"))
            ckpt = eager / "framedipt_tpu_torch" / "train" / "checkpoints.py"
            text = ckpt.read_text()
            ckpt.write_text(text.replace("import torch\n", "import torch\n" + EAGER_LINE, 1))
            trees["eager"] = eager
        names = [n for n in trees if n != "this"] + ["this"]
        results: dict[str, list[dict]] = {n: [] for n in trees}
        for rnd in range(args.rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                logs = args.out.parent / f"{args.out.stem}_logs" / f"{name}_round{rnd}"
                proc = subprocess.run(
                    [sys.executable, str(REPO / "chip_startup.py"), "--child", str(trees[name]),
                     "--logs", str(logs)], cwd=trees[name], capture_output=True, text=True,
                    timeout=900)
                for line in proc.stdout.splitlines():
                    print(f"[{name} {rnd}] {line}", flush=True)
                if proc.returncode != 0:
                    print(proc.stderr[-4000:], flush=True)
                    return 1
                results[name].append(parse(proc.stdout))
    for name, runs in results.items():
        print(f"{name}: phase 7 resumed steps/s {[r['resumed_steps_per_s'] for r in runs]} "
              f"(busy share {[r['resumed_busy_share'] for r in runs]}); sweep jobs s "
              f"{[r['sweep_jobs_s'] for r in runs]}; import inference s "
              f"{[r['imports_s'][MODULES[0]] for r in runs]} beside torch "
              f"{[r['imports_s']['torch'] for r in runs]}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
