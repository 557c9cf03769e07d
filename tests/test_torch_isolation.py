"""The port stands alone: no module of ``framedipt_tpu_torch`` and not
``chip_smoke.py`` imports jax, flax or the JAX package, nor pandas, PyYAML or
orbax (which the card's machine lacks), at runtime or in its source."""
import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "framedipt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "framedipt_tpu", "pandas", "yaml")


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names += [a.value for a in node.args if isinstance(a, ast.Constant)]
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_serving_entry_point_loads_without_jax():
    code = (
        "import sys\n"
        "import framedipt_tpu_torch.experiments.serve\n"
        "import framedipt_tpu_torch.sampling, framedipt_tpu_torch.model.weights\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_training_entry_points_load_without_jax_pandas_yaml_orbax():
    """The preprocessing, training and batch inpainting CLIs (with the
    inpainting CLI's samplers, TCR masks and confidence score) import in a
    fresh interpreter with none of jax, pandas, yaml or orbax loaded."""
    code = (
        "import sys\n"
        "import framedipt_tpu_torch.data.pipeline, framedipt_tpu_torch.experiments.train\n"
        "import framedipt_tpu_torch.experiments.inference, framedipt_tpu_torch.data.tcr\n"
        "import framedipt_tpu_torch.sampling.confidence\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_evaluation_entry_points_load_without_jax_pandas_yaml_matplotlib():
    """The TCR, de novo and cg2all evaluation CLIs, residue renumbering, the
    sweep, the monomer PDB preprocessing and the native libraries' loader
    import in a fresh interpreter with none of jax, pandas, yaml, orbax,
    matplotlib or seaborn loaded (the plots import the last two when they
    draw)."""
    banned = FORBIDDEN + ("matplotlib", "seaborn")
    code = (
        "import sys\n"
        "import framedipt_tpu_torch.eval.tcr_eval, framedipt_tpu_torch.eval.residue_reindex\n"
        "import framedipt_tpu_torch.eval.denovo_eval, framedipt_tpu_torch.eval.cg2all_eval\n"
        "import framedipt_tpu_torch.tools.sweep, framedipt_tpu_torch.data.process_pdb_files\n"
        "import framedipt_tpu_torch.tools.profiling, framedipt_tpu_torch.data.download\n"
        "import framedipt_tpu_torch.native, framedipt_tpu_torch.analysis.utils\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{banned!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the script exits non-zero and prints no result line;
    alone in a directory it fails too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
