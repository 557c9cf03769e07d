"""The port's de novo path on the CPU against the JAX package's:

- the de novo CLI (``inference.inpainting=false``) against the JAX CLI at
  the small test config with the same synthesised weights: lengths 12 and
  16, one sample each, num_t 2, noise_scale 0, the initial frames handed
  across from the JAX ``UnconditionalSampler``: the same paths, every PDB's
  records equal apart from coordinates, coordinates within 2e-3 A (the PDB
  text rounds them to 1e-3 A); without ProteinMPNN weights or a ProteinMPNN
  checkout both log the skip of the self-consistency check and go on;
- the self-consistency check with ProteinMPNN on synthesised weights and
  ESMFold mocked in both packages to return the sample itself:
  ``sc_results.csv`` with TM-score 1 and RMSD 0 in both, the same columns
  and rows; one ``seqs/*.fa`` a sample;
- the sampler's features against JAX's, resume, CUDA unless asked for the
  CPU;
- the de novo forward of ``recorded_denovo_parity.npz`` (the reference
  model at the default width, N=128, weights synthesised from its manifest)
  within the JAX test's 5e-3.
"""
import csv
import logging
import pathlib
import shutil

import jax
import numpy as np
import pytest
import torch

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.experiments.inference import Inference as JInference
from framedipt_tpu.experiments.samplers import UnconditionalSampler as JUnconditionalSampler
from framedipt_tpu.model import mpnn as j_mpnn
from framedipt_tpu.model.import_torch import convert_state_dict
from framedipt_tpu.tools import external as j_external
from framedipt_tpu.tools import mpnn_design as j_mpnn_design

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.experiments import inference as t_inference
from framedipt_tpu_torch.experiments.inference import Inference as TInference
from framedipt_tpu_torch.experiments.inference import main as t_main
from framedipt_tpu_torch.experiments.samplers import UnconditionalSampler as TUnconditionalSampler
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.model import mpnn as t_mpnn
from framedipt_tpu_torch.tools import external as t_external
from framedipt_tpu_torch.tools.config import Config as TConfig
from framedipt_tpu_torch.tools.log import get_logger

from tests.parity import fixture_lib
from tests.test_torch_inference import COORD_TOL, _atoms, _files
from tests.test_torch_model import TINY, rel_err, tiny_configs
from tests.torch_threads import one_torch_thread  # noqa: F401

LENGTHS = (12, 16)
SEQS = 2


def _configs(out_dir: pathlib.Path, name: str):
    """(JAX, port) configs: the small model, de novo at lengths 12 and 16,
    one sample each of num_t 2 at noise_scale 0, no ProteinMPNN weights."""
    jc, tc = tiny_configs()
    jc.experiment.compilation_cache_dir = None
    for cfg in (jc, tc):
        inf = cfg.inference
        inf.inpainting = False
        s = inf.samples
        s.min_length, s.max_length, s.length_step = LENGTHS[0], LENGTHS[1], LENGTHS[1] - LENGTHS[0]
        s.samples_per_length, s.seq_per_sample = 1, SEQS
        inf.diffusion.num_t = 2
        inf.diffusion.noise_scale = 0.0
        inf.weights_path = ""
        inf.mpnn_weights_path = str(out_dir / "no_mpnn_weights.pt")
        inf.output_dir = str(out_dir)
        inf.name = name
    return jc, tc


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One JAX CLI run, then the port's with the JAX sampler's initial
    frames; returns both run directories, the port's Inference and its
    warnings."""
    root = tmp_path_factory.mktemp("denovo")
    jc, tc = _configs(root / "jax", "run")
    manifest = [(k, list(v.shape)) for k, v in
                TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=False)
                .state_dict().items()]
    sd = fixture_lib.synth_state_dict(manifest)
    params = jax.tree_util.tree_map(
        jax.numpy.asarray, convert_state_dict(sd, num_blocks=2, seq_tfmr_layers=1))
    j_inf = JInference(jc, params=params)
    j_inf.run_sampling()
    initial = {(name, i): np.array(feats["rigids_t"][0]) for name, i, feats in j_inf.sampler}

    def handed(self, length, sample_idx):
        return initial[(f"length_{length}", sample_idx)]

    state_dict = {k: torch.as_tensor(v) for k, v in sd.items()}
    handler = _Messages()
    get_logger().addHandler(handler)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TUnconditionalSampler, "sample_initial_rigids", handed)
            _, tc = _configs(root / "port", "run")
            port = TInference(tc, state_dict=state_dict, device="cpu")
            port.run_sampling()
    finally:
        get_logger().removeHandler(handler)
    return {"jax": j_inf, "port": port, "root": root, "state_dict": state_dict,
            "warnings": handler.messages}


def test_tree_matches_jax_cli(trees):
    want, got = _files(trees["jax"].output_dir), _files(trees["port"].output_dir)
    assert set(got) - {"inference_conf.json"} == set(want) - {"inference_conf.yaml"}
    pdbs = sorted(k for k in want if k.endswith(".pdb"))
    assert pdbs == [f"length_{n}/sample_0/{f}_0_1.pdb" for n in LENGTHS
                    for f in ("bb_traj", "sample", "x0_traj")]
    worst = 0.0
    for k in pdbs:
        rec_g, xyz_g = _atoms(got[k].read_text())
        rec_w, xyz_w = _atoms(want[k].read_text())
        assert rec_g == rec_w, k
        assert xyz_g.shape == xyz_w.shape and len(xyz_g) > 0, k
        worst = max(worst, float(np.abs(xyz_g - xyz_w).max()))
    assert worst <= COORD_TOL, worst
    for n in LENGTHS:
        assert (trees["port"].output_dir / f"length_{n}/sample_0/self_consistency").is_dir()
    # No ProteinMPNN weights and no checkout: one warning a sample, no check.
    skips = [m for m in trees["warnings"] if m.startswith("self-consistency skipped")]
    assert len(skips) == len(LENGTHS) and "ProteinMPNN weights not found" in skips[0]
    assert "no ProteinMPNN checkout configured" in skips[0]


def test_sampler_features_match_jax():
    jc, tc = _configs(pathlib.Path("unused"), "unused")
    j_items = list(JUnconditionalSampler(jc, JSE3(jc.diffuser), seed=5))
    t_sampler = TUnconditionalSampler(tc, TSE3(tc.diffuser, device="cpu"), seed=5)
    t_items = list(t_sampler)
    assert [(n, i) for n, i, _ in t_items] == [(n, i) for n, i, _ in j_items] == [
        ("length_12", 0), ("length_16", 0)]
    for (_, _, ft), (_, _, fj) in zip(t_items, j_items):
        assert set(ft) == set(fj)
        for k in ft:
            assert ft[k].shape == np.shape(fj[k]) and ft[k].dtype == np.asarray(fj[k]).dtype, k
            if k != "rigids_t":
                np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
        np.testing.assert_allclose(np.linalg.norm(ft["rigids_t"][0, :, :4], axis=-1), 1.0,
                                   atol=1e-6)
    # Seeded from (seed, length, sample): the same frames again.
    np.testing.assert_array_equal(t_sampler.sample_initial_rigids(16, 0), t_items[1][2]["rigids_t"][0])


def _mpnn_weights(path: pathlib.Path):
    """JAX's ProteinMPNN initialization at 12 neighbours: (JAX params, JAX
    config, the same weights as an .npz of the reference names)."""
    cfg = j_mpnn.MPNNConfig(k_neighbors=12)
    params = j_mpnn.init_mpnn_params(jax.random.PRNGKey(0), cfg)
    sd = t_mpnn.mpnn_state_dict_from_jax(params)
    np.savez(path, num_edges=np.asarray(12), **{k: v.numpy() for k, v in sd.items()})
    return params, cfg


def _read_csv(path: pathlib.Path) -> list[dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_self_consistency_matches_jax(trees, tmp_path, monkeypatch):
    """ProteinMPNN (synthesised weights, in process) designs SEQS sequences
    for the 12-residue sample; ESMFold, mocked, returns the sample itself, so
    every refold scores TM 1 and RMSD 0. Each package checks its own copy of
    the sample's directory."""
    sample_pdb = trees["port"].output_dir / "length_12/sample_0/sample_0_1.pdb"
    params, cfg = _mpnn_weights(tmp_path / "mpnn.npz")
    monkeypatch.setattr(j_mpnn_design, "load_mpnn_params", lambda _p: (params, cfg))
    for ext in (j_external, t_external):
        monkeypatch.setattr(ext, "esmfold_predict", lambda seq: sample_pdb.read_text())
    _, tc = _configs(tmp_path / "out", "sc")
    tc.inference.mpnn_weights_path = str(tmp_path / "mpnn.npz")
    port = TInference(tc, state_dict=trees["state_dict"], device="cpu")
    results = {}
    for label, inf in (("jax", trees["jax"]), ("port", port)):
        sample_dir = tmp_path / label / "sample_0"
        sample_dir.mkdir(parents=True)
        shutil.copy(sample_pdb, sample_dir)
        inf.run_self_consistency(sample_dir, sample_dir / sample_pdb.name)
        sc = sample_dir / "self_consistency"
        assert [p.name for p in (sc / "seqs").glob("*.fa")] == ["sample_0_1.fa"], label
        lines = (sc / "seqs" / "sample_0_1.fa").read_text().splitlines()
        assert len(lines) == 2 * (1 + SEQS)
        assert all(len(s) == LENGTHS[0] and set(s) <= set(t_mpnn.MPNN_ALPHABET[:20])
                   for s in lines[3::2])
        results[label] = _read_csv(sc / "sc_results.csv")
    assert list(results["port"][0]) == list(results["jax"][0]) == [
        "sequence", "sample", "rmsd", "tm_score"]
    assert len(results["port"]) == len(results["jax"]) == 1 + SEQS
    for a, b in zip(results["port"], results["jax"]):
        assert pathlib.Path(a["sample"]).name == pathlib.Path(b["sample"]).name
        assert float(a["tm_score"]) == pytest.approx(1.0, abs=1e-6)
        assert float(b["tm_score"]) == pytest.approx(1.0, abs=1e-6)
        assert abs(float(a["rmsd"])) < 1e-5 and abs(float(b["rmsd"])) < 1e-5
    assert results["port"][0]["sequence"] == results["jax"][0]["sequence"] == "A" * LENGTHS[0]


def test_fallback_checkout_missing_logs_and_goes_on(trees, tmp_path, monkeypatch):
    """No weights and a ProteinMPNN checkout without its runner: the check
    logs one warning and writes nothing."""
    monkeypatch.setattr(get_logger(), "propagate", True)
    port = trees["port"]
    monkeypatch.setattr(port.cfg.inference, "pmpnn_dir", str(tmp_path / "ProteinMPNN"))
    sample_dir = tmp_path / "sample_0"
    sample_dir.mkdir()
    shutil.copy(port.output_dir / "length_12/sample_0/sample_0_1.pdb", sample_dir)
    handler = _Messages()
    get_logger().addHandler(handler)
    try:
        port.run_self_consistency(sample_dir, sample_dir / "sample_0_1.pdb")
    finally:
        get_logger().removeHandler(handler)
    assert len(handler.messages) == 1 and "protein_mpnn_run.py not found" in handler.messages[0]
    assert list((sample_dir / "self_consistency").iterdir()) == []


def test_resume_writes_nothing_new(trees, monkeypatch):
    """A second run over the tree, through the CLI's main, samples nothing
    and touches no file but the config."""
    run_dir = trees["port"].output_dir
    before = {k: p.stat().st_mtime_ns for k, p in _files(run_dir).items()}
    calls = []
    monkeypatch.setattr(t_inference, "sample", lambda *a, **k: calls.append(1))
    overrides = [f"model.{k}={v}" for k, v in TINY.items()] + [
        "diffuser.so3.num_omega=50", "diffuser.so3.num_sigma=20", "diffuser.so3.cache_dir=null",
        "inference.inpainting=false", f"inference.samples.min_length={LENGTHS[0]}",
        f"inference.samples.max_length={LENGTHS[1]}",
        f"inference.samples.length_step={LENGTHS[1] - LENGTHS[0]}",
        "inference.samples.samples_per_length=1", "inference.diffusion.num_t=2",
        "inference.weights_path=", f"inference.output_dir={run_dir.parent}",
        f"inference.name={run_dir.name}",
    ]
    t_main(["--device=cpu", *overrides])
    assert calls == []
    after = {k: p.stat().st_mtime_ns for k, p in _files(run_dir).items()}
    assert set(after) == set(before)
    assert {k: v for k, v in after.items() if k != "inference_conf.json"} == {
        k: v for k, v in before.items() if k != "inference_conf.json"}


def test_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_main(["inference.inpainting=false", f"inference.output_dir={tmp_path / 'out'}"])
    assert not (tmp_path / "out").exists()


def test_denovo_forward_matches_recorded_reference():
    """Default config at inpainting=False (the embedder without aatype),
    N=128, weights synth_state_dict(param_manifest) loaded with
    strict=True, against the recorded reference activations at the JAX
    test's tolerances (tests/parity/test_recorded_parity.py)."""
    npz = np.load(fixture_lib.FIXTURE_DENOVO)
    cfg = TConfig()
    net = TNet(cfg.model, TSE3(cfg.diffuser, device="cpu"), inpainting=False)
    net.load_state_dict(
        {k: torch.as_tensor(v) for k, v in
         fixture_lib.synth_state_dict(fixture_lib.load_manifest(npz)).items()},
        strict=True,
    )
    assert net.embedding_layer.c_t == cfg.model.embed.index_embed_size + 1
    feats = {k[len("feat::"):]: torch.as_tensor(npz[k]) for k in npz.files
             if k.startswith("feat::")}
    assert "aatype" not in feats
    with torch.no_grad():
        out = net(feats)
    for key in ("psi", "atom37", "rot_score", "trans_score"):
        assert rel_err(out[key], npz[f"out::{key}"]) < 5e-3, key
