"""The port's batch inpainting CLI against the JAX package's, on the CPU at a
small config with the same synthesized weights: the output tree for the
1fyt fixture (num_t 2, noise_scale 0, two samples, the initial frames
handed across from the JAX sampler) from the batched and the serial loop,
held against one JAX run: the same paths, diffusion_info.csv equal, every
PDB's records equal apart from coordinates, coordinates within 2e-3 A (the
PDB text rounds them to 1e-3 A). At noise_scale 0 the two loops compute the
same trajectories from the same initial frames. Also: the TCR masks on the
three fixtures against the JAX sampler's, resume, empty windows, the
random streams of the initial frames and the sampler, the trajectory
writer, the device policy and the JSON config loader."""
import copy
import json
import logging
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.experiments.inference import Inference as JInference
from framedipt_tpu.experiments.samplers import ConditionalSampler as JConditionalSampler
from framedipt_tpu.experiments.samplers import TCRSampler as JTCRSampler
from framedipt_tpu.model.import_torch import convert_state_dict

from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.experiments import inference as t_inference
from framedipt_tpu_torch.experiments.inference import Inference as TInference
from framedipt_tpu_torch.experiments.inference import main as t_main
from framedipt_tpu_torch.experiments.samplers import ConditionalSampler as TConditionalSampler
from framedipt_tpu_torch.experiments.samplers import TCRSampler as TTCRSampler
from framedipt_tpu_torch.experiments.utils import save_diffusion_info
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.tools.config import load_config
from framedipt_tpu_torch.tools.log import get_logger

from tests.parity import fixture_lib
from tests.test_torch_model import tiny_configs
from tests.torch_threads import one_torch_thread  # noqa: F401


REPO = pathlib.Path(__file__).resolve().parent.parent
CIF_DIR = REPO / "tests" / "data" / "cifs"
TCR_CSV = REPO / "database" / "TCR_pMHC_II.csv"
COORD_TOL = 2e-3


def _configs(out_dir: pathlib.Path, name: str):
    """(JAX, port) configs: the small model, random redaction over the CIF
    directory, two samples of num_t 2 at noise_scale 0."""
    jc, tc = tiny_configs()
    jc.experiment.compilation_cache_dir = None  # no XLA cache outside the test's directories
    for cfg in (jc, tc):
        inf = cfg.inference
        inf.inpainting = True
        inf.inpainting_samples.tcr = False
        inf.inpainting_samples.samples = 2
        inf.diffusion.num_t = 2
        inf.diffusion.noise_scale = 0.0
        inf.weights_path = ""
        inf.output_dir = str(out_dir)
        inf.name = name
    return jc, tc


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One JAX CLI run (batched) over 1fyt, then the port's batched and
    serial runs with the JAX sampler's initial frames; returns the three
    run directories and the port's batched Inference."""
    root = tmp_path_factory.mktemp("cli")
    cif_dir = root / "cifs"
    cif_dir.mkdir()
    (cif_dir / "1fyt-assembly1.cif").write_bytes((CIF_DIR / "1fyt-assembly1.cif").read_bytes())

    jc, tc = _configs(root / "jax", "run")
    manifest = [(k, list(v.shape)) for k, v in
                TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
                .state_dict().items()]
    sd = fixture_lib.synth_state_dict(manifest)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert_state_dict(sd, num_blocks=2, seq_tfmr_layers=1))
    j_inf = JInference(jc, cif_dir=cif_dir, params=params)
    j_inf.run_sampling()
    # The initial frames of each JAX item, unpadded.
    initial = {}
    for idx in range(len(j_inf.sampler)):
        initial[idx] = np.asarray(j_inf.sampler[idx][2]["rigids_t"][0])

    def handed(self, idx, impute, diffuse_mask):
        return initial[idx][: diffuse_mask.shape[0]]

    runs = {}
    state_dict = {k: torch.as_tensor(v) for k, v in sd.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TConditionalSampler, "sample_initial_rigids", handed)
        for loop, batched in (("batched", True), ("serial", False)):
            _, tc = _configs(root / "port", loop)
            tc.inference.inpainting_samples.batch_samples = batched
            inf = TInference(tc, cif_dir=cif_dir, state_dict=state_dict, device="cpu")
            inf.run_sampling()
            runs[loop] = inf
    return {"jax": j_inf.output_dir, "root": root, "cif_dir": cif_dir, "state_dict": state_dict,
            **runs}


def _files(run_dir: pathlib.Path) -> dict[str, pathlib.Path]:
    return {str(p.relative_to(run_dir)): p for p in sorted(run_dir.rglob("*")) if p.is_file()}


def _atoms(text: str) -> tuple[list[str], np.ndarray]:
    """(every line with its coordinates blanked, ATOM coordinates [A, 3])."""
    records, coords = [], []
    for line in text.splitlines():
        if line.startswith(("ATOM", "HETATM")):
            coords.append([float(line[30:38]), float(line[38:46]), float(line[46:54])])
            line = line[:30] + " " * 24 + line[54:]
        records.append(line)
    return records, np.asarray(coords)


@pytest.mark.parametrize("loop", ["batched", "serial"])
def test_output_tree_matches_jax_cli(trees, loop):
    want, got = _files(trees["jax"]), _files(trees[loop].output_dir)
    assert set(got) - {"inference_conf.json"} == set(want) - {"inference_conf.yaml"}
    pdbs = [k for k in want if k.endswith(".pdb")]
    # The ground truth, and per sample the structure and both trajectories.
    assert len(pdbs) == 1 + 2 * 3, sorted(want)
    info = next(k for k in want if k.endswith("diffusion_info.csv"))
    assert got[info].read_text() == want[info].read_text()
    worst = 0.0
    for k in pdbs:
        rec_g, xyz_g = _atoms(got[k].read_text())
        rec_w, xyz_w = _atoms(want[k].read_text())
        assert rec_g == rec_w, k
        assert xyz_g.shape == xyz_w.shape and len(xyz_g) > 0, k
        worst = max(worst, float(np.abs(xyz_g - xyz_w).max()))
    assert worst <= COORD_TOL, worst
    conf = json.loads(got["inference_conf.json"].read_text())
    assert conf["inference"]["diffusion"]["num_t"] == 2
    assert conf["model"]["ipa"]["use_pallas_kernel"] is None  # a run setting, saved unresolved


def test_resume_writes_nothing_new(trees, monkeypatch):
    """A second run over the batched tree (through the CLI's main) finds
    every sample written: it samples nothing and touches no file but the
    config, which every run writes (as the JAX CLI does)."""
    run_dir = trees["batched"].output_dir
    before = {k: p.stat().st_mtime_ns for k, p in _files(run_dir).items()}
    calls = []
    monkeypatch.setattr(t_inference, "sample", lambda *a, **k: calls.append(1))
    cfg = trees["batched"].cfg
    (trees["root"] / "conf.json").write_text(json.dumps({"model": {"ipa": {
        "num_blocks": cfg.model.ipa.num_blocks}}}))
    overrides = [
        "model.node_embed_size=32", "model.edge_embed_size=16", "model.ipa.c_s=32",
        "model.ipa.c_z=16", "model.ipa.c_hidden=16", "model.ipa.c_skip=8", "model.ipa.no_heads=2",
        "model.ipa.no_qk_points=4", "model.ipa.no_v_points=4",
        "model.ipa.seq_tfmr_num_layers=1", "model.ipa.seq_tfmr_num_heads=2",
        "diffuser.so3.num_omega=50", "diffuser.so3.num_sigma=20", "diffuser.so3.cache_dir=null",
        "inference.inpainting_samples.tcr=false", "inference.inpainting_samples.samples=2",
        "inference.diffusion.num_t=2", "inference.weights_path=",
        f"inference.output_dir={run_dir.parent}", f"inference.name={run_dir.name}",
    ]
    t_main(["--device=cpu", f"--cif_dir={trees['cif_dir']}",
            f"--config={trees['root'] / 'conf.json'}", *overrides])
    assert calls == []
    after = {k: p.stat().st_mtime_ns for k, p in _files(run_dir).items()}
    assert set(after) == set(before)
    assert {k: v for k, v in after.items() if k != "inference_conf.json"} == {
        k: v for k, v in before.items() if k != "inference_conf.json"}


def test_checkpoint_directory_config_and_weights(trees, tmp_path):
    """A directory of the train CLI's checkpoints: its newest step's weights
    and model config win over the runtime config."""
    from framedipt_tpu_torch.train.checkpoints import CKPT_FILE

    cfg = trees["batched"].cfg
    step = tmp_path / "ckpt" / "step_7"
    step.mkdir(parents=True)
    conf = json.loads((trees["batched"].output_dir / "inference_conf.json").read_text())
    torch.save({"model": trees["state_dict"], "conf": conf, "step": 7}, step / CKPT_FILE)
    _, tc = _configs(tmp_path / "out", "ckpt")
    tc.model.ipa.num_blocks = 4  # the checkpoint's 2 wins
    tc.inference.weights_path = str(tmp_path / "ckpt")
    inf = TInference(tc, cif_dir=trees["cif_dir"], device="cpu")
    assert inf.cfg.model.ipa.num_blocks == cfg.model.ipa.num_blocks == 2
    for k, v in inf.model.state_dict().items():
        torch.testing.assert_close(v, trees["state_dict"][k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def tcr_feats():
    """Per fixture complex, the JAX and port samplers' features (chains as
    the TCR database lists them)."""
    jc, tc = tiny_configs()
    j_s = JTCRSampler(jc, JSE3(jc.diffuser), cif_dir=CIF_DIR, csv_path=TCR_CSV)
    t_s = TTCRSampler(tc, TSE3(tc.diffuser, device="cpu"), cif_dir=CIF_DIR, csv_path=TCR_CSV)
    assert [p.name for p in t_s.cif_paths] == [p.name for p in j_s.cif_paths]
    assert t_s.chains_per_structure == j_s.chains_per_structure
    assert len(t_s.cif_paths) == 3
    return [(j_s.load_features(i), t_s.load_features(i)) for i in range(len(t_s.cif_paths))]


@pytest.mark.parametrize("shifted_region", [None, "before", "after"])
@pytest.mark.parametrize("cdr_loops", [["beta_3"], ["alpha_3"]])
def test_tcr_masks_match_jax(tcr_feats, cdr_loops, shifted_region):
    jc, tc = tiny_configs()
    for cfg in (jc, tc):
        cfg.inference.inpainting_samples.cdr_loops = cdr_loops
        cfg.inference.inpainting_samples.shifted_region = shifted_region
    j_s = JTCRSampler(jc, JSE3(jc.diffuser), cif_dir=CIF_DIR, csv_path=TCR_CSV)
    t_s = TTCRSampler(tc, TSE3(tc.diffuser, device="cpu"), cif_dir=CIF_DIR, csv_path=TCR_CSV)
    for i, (jf, tf) in enumerate(tcr_feats):
        np.testing.assert_array_equal(tf["aatype"], jf["aatype"])
        np.testing.assert_array_equal(tf["chain_idx"], jf["chain_idx"])
        want = j_s.create_diffusion_mask(jf, i)
        got = t_s.create_diffusion_mask(tf, i)
        np.testing.assert_array_equal(got, want)
        # Both TCR chains (A and B after re-lettering) get one loop each.
        assert set(np.unique(tf["chain_idx"][got > 0])) == {0, 1}


def test_empty_window_raises_in_both(tmp_path):
    jc, tc = _configs(tmp_path, "empty")
    for cfg in (jc, tc):
        cfg.inference.inpainting_samples.start_idx = 5000
        cfg.inference.inpainting_samples.end_idx = 5010
    paths = [CIF_DIR / "1fyt-assembly1.cif"]
    j_s = JConditionalSampler(jc, JSE3(jc.diffuser), paths)
    t_s = TConditionalSampler(tc, TSE3(tc.diffuser, device="cpu"), paths)
    with pytest.raises(ValueError):
        j_s[0]
    with pytest.raises(ValueError):
        t_s[0]
    # A window inside the first chain diffuses just those rows.
    for cfg in (jc, tc):
        cfg.inference.inpainting_samples.start_idx = 3
        cfg.inference.inpainting_samples.end_idx = 9
    t_s = TConditionalSampler(tc, TSE3(tc.diffuser, device="cpu"), paths)
    feats = t_s[0][2]
    diffused = np.where((1 - feats["fixed_mask"][0]) * feats["res_mask"][0] > 0)[0]
    np.testing.assert_array_equal(diffused, np.arange(3, 10))


def test_diffusion_info_drops_nonstandard_residues(tmp_path):
    """Regions count standard residues only: an X before the region shifts
    its indices; the file is tab-separated with one header row."""
    mask = np.asarray([0, 0, 0, 1, 1, 0, 0, 1, 0, 0])
    chain = np.asarray([0, 0, 0, 0, 0, 0, 1, 1, 1, 1])
    path = save_diffusion_info(tmp_path, "abcd", "AXAAAAAAAA", mask, chain)
    assert path.read_text() == "pdb_name\tseq\tchain\tstart\tend\nabcd\tAXAAAAAAAA\tA,B\t2,1\t3,1\n"
    with pytest.raises(ValueError):
        save_diffusion_info(tmp_path, "abcd", "AA", mask, chain[:3])


def test_sampler_noise_never_repeats_the_initial_frames_draw(trees, tmp_path, monkeypatch):
    """Per item, in both loops, the reverse sampler's first normals (the
    first step's z_rot, at the item's row of the batch) differ from the
    normals that drew the item's initial rotation axes, and no generator of
    the sampler is seeded like one of the initial frames'."""
    from framedipt_tpu_torch.experiments import samplers as t_samplers

    real_gen, real_init = t_samplers.seeded_generator, TConditionalSampler.sample_initial_rigids
    made, first, seeds, reverse = [], {}, [], []

    def recording_gen(*args):
        g = real_gen(*args)
        made.append(g.get_state())
        return g

    def recording_init(self, idx, impute, diffuse_mask):
        out = real_init(self, idx, impute, diffuse_mask)
        g = torch.Generator().set_state(made[-1])
        first[idx] = torch.randn((diffuse_mask.shape[0], 3), generator=g)
        return out

    def recording_sample(model, diffuser, feats, generator, **kwargs):
        seeds.append(generator.initial_seed())
        reverse.append(torch.randn((*feats["res_mask"].shape, 3), generator=generator))
        return {}

    monkeypatch.setattr(t_samplers, "seeded_generator", recording_gen)
    monkeypatch.setattr(TConditionalSampler, "sample_initial_rigids", recording_init)
    monkeypatch.setattr(t_inference, "sample", recording_sample)
    monkeypatch.setattr(TInference, "_save_sample", lambda *args, **kwargs: None)
    for batched in (True, False):
        for record in (made, first, seeds, reverse):
            record.clear()
        _, tc = _configs(tmp_path, f"rng_{batched}")
        tc.inference.inpainting_samples.batch_samples = batched
        inf = TInference(tc, cif_dir=trees["cif_dir"], state_dict=trees["state_dict"],
                         device="cpu")
        inf.run_sampling()
        samples = tc.inference.inpainting_samples.samples
        assert sorted(first) == list(range(samples)) and len(reverse) == (1 if batched else 2)
        for idx, want in first.items():
            call, row = (0, idx) if batched else (idx, 0)
            got = reverse[call][row, : len(want)]
            assert not torch.allclose(got, want), (batched, idx)
        init_seeds = {torch.Generator().set_state(s).initial_seed() for s in made}
        assert init_seeds.isdisjoint(seeds), (batched, init_seeds, seeds)


def test_save_traj_writes_the_configured_trajectories(trees, tmp_path):
    """The final frame always; each trajectory only when configured, one
    MODEL a step."""
    inf = copy.copy(trees["batched"])
    inf.cfg = copy.deepcopy(inf.cfg)
    inf.cfg.inference.save_backbone_trajectory = False
    rng = np.random.default_rng(0)
    n, steps = 5, 3
    traj = rng.normal(size=(steps, n, 37, 3)).astype(np.float32)
    paths = inf.save_traj(traj, traj + 1.0, np.asarray([0, 1, 1, 0, 0]), tmp_path, 4,
                          aatype=np.zeros(n, np.int64), residue_index=np.arange(1, n + 1),
                          chain_index=np.zeros(n, np.int64))
    assert paths["traj_path"] is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sample_4_1.pdb", "x0_traj_4_1.pdb"]
    assert paths["x0_traj_path"].read_text().count("MODEL") == steps
    _, xyz = _atoms(paths["sample_path"].read_text())
    np.testing.assert_allclose(xyz[0], traj[0, 0, 0], atol=1e-3)


def test_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    """With no device given the CLI takes CUDA, and raises without a card
    before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tc = _configs(tmp_path / "out", "device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TInference(tc, cif_dir=CIF_DIR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_main([f"--cif_dir={CIF_DIR}", f"inference.output_dir={tmp_path / 'out'}"])
    assert not (tmp_path / "out").exists()


def test_json_config_drops_left_out_fields_with_a_warning(tmp_path, caplog, monkeypatch):
    """A JSON config carrying fields the port leaves out (the JAX CLI's
    ``inference.gpu_id`` and compilation cache) loads; the database flow's
    fields, which the port has, load too; a dotted override of an unknown
    key still raises."""
    monkeypatch.setattr(get_logger(), "propagate", True)
    path = tmp_path / "conf.json"
    path.write_text(json.dumps({
        "inference": {"seed": 7, "gpu_id": 0, "inpainting_samples": {
            "samples": 3, "download_dir": "/data", "num_workers_download": 2}},
        "experiment": {"compilation_cache_dir": "/cache"}}))
    with caplog.at_level(logging.WARNING, logger="framedipt_tpu_torch"):
        cfg = load_config(["inference.diffusion.num_t=9"], json_path=str(path))
    assert (cfg.inference.seed, cfg.inference.inpainting_samples.samples) == (7, 3)
    assert cfg.inference.diffusion.num_t == 9 and cfg.inference.diffusion.noise_scale == 0.1
    isc = cfg.inference.inpainting_samples
    assert (isc.download_dir, isc.num_workers_download) == ("/data", 2)
    dropped = " ".join(r.getMessage() for r in caplog.records)
    assert "inference.gpu_id" in dropped and "experiment.compilation_cache_dir" in dropped
    assert "download_dir" not in dropped
    with pytest.raises(KeyError):
        load_config(["inference.gpu_id=0"])
