"""The port's in-process ProteinMPNN design (framedipt_tpu_torch/tools/
mpnn_design.py) against the JAX package's (framedipt_tpu/tools/
mpnn_design.py), on the CPU, with synthesised weights (JAX's
initialization at 12 neighbours, written once as an .npz of the reference
names that both packages load) and two 20-residue helices, one chain and two.
The two draw their decoding orders from other generators, so the port's
keys are handed the JAX keys where a test compares numbers:

- design at temperature 1e-4: every ``.fa`` line equal (the sequences, the
  header text) but the scores, which agree within 2e-4;
- the CLI (``main``) in design mode with the sidecars and in
  ``--score_only`` mode: the same files, headers and scores; the probability
  modes' files hold the port's functions' log-probabilities;
- the restraint converters against JAX's;
- chains named by their PDB letters (chains B and C designed by letter,
  where JAX relabels them A and B by position), and backbone noise drawn
  afresh for every batch and row (JAX draws it once a structure): both
  intended divergences from the JAX package;
- CUDA unless asked for the CPU.
"""
import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from framedipt_tpu.model import mpnn as J
from framedipt_tpu.tools import mpnn_design as j_design
from framedipt_tpu.tools import mpnn_restraints as j_res

from framedipt_tpu_torch.analysis.utils import prot_pos_to_pdb
from framedipt_tpu_torch.model import mpnn as T
from framedipt_tpu_torch.tools import mpnn_design as t_design
from framedipt_tpu_torch.tools import mpnn_restraints as t_res
from framedipt_tpu_torch.tools.external import ToolUnavailable

from tests.unit.geom_helpers import nerf_backbone
from tests.torch_threads import one_torch_thread  # noqa: F401

L = 20
K = 12
SEED = 38
NUM = 2
TEMP = 1e-4
NUMBER = re.compile(r"(score|global_score|seq_recovery)=(-?[\d.]+)")


def _pdb_text(chain_lengths: list[int], seed: int) -> str:
    atom37, mask = nerf_backbone(sum(chain_lengths))
    aatype = np.random.default_rng(seed).integers(0, 20, sum(chain_lengths))
    chain_index = np.repeat(np.arange(len(chain_lengths)), chain_lengths)
    return prot_pos_to_pdb(atom37 * mask[..., None], aatype=aatype, chain_index=chain_index)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpnn_design")
    cfg = J.MPNNConfig(k_neighbors=K)
    params = J.init_mpnn_params(jax.random.PRNGKey(0), cfg)
    sd = T.mpnn_state_dict_from_jax(params)
    weights = root / "v_test.npz"
    np.savez(weights, num_edges=np.asarray(K), **{k: v.numpy() for k, v in sd.items()})
    pdb_dir = root / "pdbs"
    pdb_dir.mkdir()
    (pdb_dir / "a.pdb").write_text(_pdb_text([L], 0))
    (pdb_dir / "b.pdb").write_text(_pdb_text([L // 2, L // 2], 1))
    model = t_design.load_mpnn_params(weights, device="cpu")
    return {"root": root, "params": params, "cfg": cfg, "weights": weights, "pdb_dir": pdb_dir,
            "model": model}


def _jax_keys(seed: int, streams: list[tuple[int, ...]], shape, split: bool) -> list[np.ndarray]:
    """The JAX runner's decoding-order keys for each case's stream: the
    design batches split their key in three and take the first."""
    out = []
    for stream in streams:
        key = jax.random.PRNGKey(seed)
        for s in stream:
            key = jax.random.fold_in(key, s)
        if split:
            key = jax.random.split(key, 3)[0]
        out.append(np.asarray(jax.random.normal(key, shape)))
    return out


@pytest.fixture
def jax_order_keys(monkeypatch):
    """Hand the given JAX keys, in call order, to the port's decoding
    orders."""
    queue = []

    def handed(generator, shape, device):
        return torch.as_tensor(np.array(queue.pop(0)), device=device).reshape(shape)

    monkeypatch.setattr(t_design, "_order_keys", handed)
    return queue


def _records(path: pathlib.Path):
    """(lines with the numbers blanked, the numbers) of a .fa file."""
    lines = path.read_text().splitlines()
    numbers = [float(m.group(2)) for line in lines for m in NUMBER.finditer(line)]
    return [NUMBER.sub(r"\1=#", line) for line in lines], np.asarray(numbers)


def _same_fasta(got: pathlib.Path, want: pathlib.Path) -> None:
    text_g, num_g = _records(got)
    text_w, num_w = _records(want)
    assert text_g == text_w, got.name
    # Each printed to 4 decimals: 1e-4 of rounding on top of 2e-4.
    np.testing.assert_allclose(num_g, num_w, atol=3e-4, rtol=0)


def test_design_matches_jax_at_near_zero_temperature(setup, jax_order_keys, tmp_path):
    out_j = j_design.design_sequences(setup["pdb_dir"], tmp_path / "jax", num_seq_per_target=NUM,
                                      sampling_temp=TEMP, seed=SEED, params=setup["params"],
                                      cfg=setup["cfg"], model_name="v_test")
    jax_order_keys.extend(_jax_keys(SEED, [(0,), (1,)], (NUM, L), split=True))
    out_t = t_design.design_sequences(setup["pdb_dir"], tmp_path / "port",
                                      num_seq_per_target=NUM, sampling_temp=TEMP, seed=SEED,
                                      model=setup["model"], model_name="v_test")
    assert sorted(p.name for p in out_t.iterdir()) == ["a.fa", "b.fa"]
    for name in ("a.fa", "b.fa"):
        _same_fasta(out_t / name, out_j / name)
    lines = (out_t / "b.fa").read_text().splitlines()
    assert len(lines) == 2 * (1 + NUM)
    assert lines[0].startswith(">b, score=") and "fixed_chains=[], designed_chains=['A', 'B'], " \
        "model_name=v_test, seed=38" in lines[0]
    assert re.fullmatch(r">T=0\.0001, sample=1, score=[\d.]+, global_score=[\d.]+, "
                        r"seq_recovery=[\d.]+", lines[2])
    assert all(re.fullmatch(rf"[ACDEFGHIKLMNPQRSTVWY]{{{L // 2}}}/[ACDEFGHIKLMNPQRSTVWY]"
                            rf"{{{L // 2}}}", s) for s in lines[3::2])


def test_cli_matches_jax(setup, jax_order_keys, tmp_path, monkeypatch):
    """Design with both sidecars and --score_only through each package's
    main: the same files, headers, scores and sidecars. The probability
    modes through the port's main: their files hold the port's functions'
    log-probabilities (held against JAX's and the recording in
    tests/test_torch_mpnn.py)."""
    common = [f"--pdb_dir={setup['pdb_dir']}", f"--weights_path={setup['weights']}",
              f"--num_seq_per_target={NUM}", f"--sampling_temp={TEMP}"]
    modes = {"design": ["--save_score", "--save_probs"], "score": ["--score_only"]}
    keys = {"design": _jax_keys(SEED, [(0,), (1,)], (NUM, L), split=True),
            "score": _jax_keys(SEED, [(0,), (1,)], (NUM, L), split=False)}
    for mode, flags in modes.items():
        j_design.main([*common, f"--out_folder={tmp_path / 'jax' / mode}", *flags])
        jax_order_keys.extend(keys[mode])
        t_design.main([*common, f"--out_folder={tmp_path / 'port' / mode}", "--device=cpu",
                       *flags])
        assert not jax_order_keys
    files_j = sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*.*"))
    files_t = sorted(str(p.relative_to(tmp_path / "port")) for p in
                     (tmp_path / "port").rglob("*.*"))
    assert files_t == files_j and len(files_t) == 2 * 4
    for rel in files_t:
        got, want = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.endswith(".fa"):
            _same_fasta(got, want)
            continue
        zg, zw = np.load(got), np.load(want)
        assert sorted(zg.files) == sorted(zw.files), rel
        for k in zw.files:
            if zw[k].dtype.kind in "fc":
                np.testing.assert_allclose(zg[k], zw[k], atol=2e-4, rtol=2e-4, err_msg=rel + k)
            else:
                np.testing.assert_array_equal(zg[k], zw[k], err_msg=rel + k)

    monkeypatch.undo()  # the port's own decoding-order keys again
    model = setup["model"]
    for flag, sub, reps in (("--unconditional_probs_only", "unconditional_probs_only", 1),
                            ("--conditional_probs_only", "conditional_probs_only", NUM)):
        t_design.main([*common, f"--out_folder={tmp_path / 'probs'}", "--device=cpu", flag])
        for i, (name, _, chains) in enumerate(t_design.iter_cases(setup["pdb_dir"])):
            z = np.load(tmp_path / "probs" / sub / f"{name}.npz")
            f = {k: torch.as_tensor(v) for k, v in T.featurize_chains(chains).items()}
            assert z["log_p"].shape == (reps, L, 21)
            np.testing.assert_array_equal(z["S"], f["S"][0].numpy())
            np.testing.assert_array_equal(z["design_mask"], (f["chain_M"] * f["mask"])[0].numpy())
            with torch.no_grad():
                if reps == 1:
                    want = T.mpnn_unconditional_log_probs(
                        model, f["X"], f["mask"], f["residue_idx"], f["chain_encoding_all"])
                else:  # the last repeat's order, seeded from (seed, case, repeat)
                    randn = torch.randn(f["S"].shape, generator=t_design.seeded_generator(
                        "cpu", SEED, i, reps - 1))
                    want = T.mpnn_conditional_log_probs(
                        model, f["X"], f["S"], f["mask"], f["chain_M"], f["residue_idx"],
                        f["chain_encoding_all"], randn)
            np.testing.assert_allclose(z["log_p"][-1:], want.numpy(), atol=1e-6, rtol=0)


def test_restraint_converters_match_jax(tmp_path):
    letters, lens = ["A", "B"], [5, 4]
    fixed = {"B": [1, 4]}
    omit = {"A": [[[1, 3], "CW"]], "B": [[[2], "G"]]}
    bias = {"B": np.random.default_rng(0).normal(size=(4, 21)).tolist()}
    tied = [{"A": [1, 2], "B": [1, 2]}, {"A": [[4], [0.5]], "B": [[3], [-1.0]]}]
    pssm = {"A": {"pssm_coef": [0.1] * 5, "pssm_bias": np.full((5, 21), 1 / 21).tolist(),
                  "pssm_log_odds": np.linspace(-2, 2, 105).reshape(5, 21).tolist()}}
    for fn, arg in (("chain_m_pos_from_dict", fixed), ("omit_aa_mask_from_dict", omit),
                    ("bias_by_res_from_dict", bias)):
        np.testing.assert_array_equal(getattr(t_res, fn)(arg, letters, lens),
                                      getattr(j_res, fn)(arg, letters, lens))
    for got, want in zip(t_res.pssm_tensors_from_dict(pssm, letters, lens, threshold=0.5),
                         j_res.pssm_tensors_from_dict(pssm, letters, lens, threshold=0.5)):
        np.testing.assert_array_equal(got, want)
    g_t, b_t = t_res.tied_positions_from_list(tied, letters, lens)
    g_j, b_j = j_res.tied_positions_from_list(tied, letters, lens)
    assert g_t == g_j and g_t == ((0, 1, 5, 6), (3, 7))
    np.testing.assert_array_equal(b_t, b_j)
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps({"x": fixed}) + "\n" + json.dumps({"y": omit}) + "\n")
    assert t_res.load_jsonl(path) == j_res.load_jsonl(path) == {"y": omit}
    assert t_res.resolve_name({"y": omit}, "y") == omit
    with pytest.raises(ToolUnavailable):
        t_res.chain_m_pos_from_dict({"C": [1]}, letters, lens)


def test_chains_designed_by_their_pdb_letters(setup, tmp_path):
    """A PDB whose chains are B and C: the port designs chain C by its
    letter, keeps B native and fixes C's first two residues. The JAX
    package relabels the chains A and B by position, so it finds no chain C
    (the divergence is intended)."""
    pdb_dir = tmp_path / "bc"
    pdb_dir.mkdir()
    text = (setup["pdb_dir"] / "b.pdb").read_text()
    relabel = {"A": "B", "B": "C"}
    (pdb_dir / "bc.pdb").write_text("".join(
        line[:21] + relabel[line[21]] + line[22:] if line.startswith(("ATOM", "TER")) else line
        for line in text.splitlines(keepends=True)))
    out = t_design.design_sequences(pdb_dir, tmp_path / "port", num_seq_per_target=3,
                                    model=setup["model"], design_chains=["C"],
                                    fixed_positions={"C": [1, 2]})
    lines = (out / "bc.fa").read_text().splitlines()
    assert "fixed_chains=['B'], designed_chains=['C']" in lines[0]
    native_b, native_c = lines[1].split("/")
    for seq in lines[3::2]:
        b, c = seq.split("/")
        assert b == native_b and c[:2] == native_c[:2] and "X" not in c
    with pytest.raises(j_design.ToolUnavailable, match="none of designed chains"):
        j_design.design_sequences(pdb_dir, tmp_path / "jax", num_seq_per_target=3,
                                  params=setup["params"], cfg=setup["cfg"], design_chains=["C"])


def test_backbone_noise_fresh_for_every_batch(setup, tmp_path, monkeypatch):
    """With --backbone_noise each batch (and each row of a batch) samples
    on its own noised coordinates; the JAX package reuses one draw for every
    batch of a structure (the divergence is intended)."""
    seen = []
    real = T.mpnn_sample

    def spy(model, generator, x, *args, **kwargs):
        seen.append(x.clone())
        return real(model, generator, x, *args, **kwargs)

    monkeypatch.setattr(T, "mpnn_sample", spy)
    pdb_dir = tmp_path / "one"
    pdb_dir.mkdir()
    (pdb_dir / "a.pdb").write_text((setup["pdb_dir"] / "a.pdb").read_text())
    x0 = torch.as_tensor(T.featurize_chains(t_design.iter_cases(pdb_dir)[0][2])["X"])
    t_design.design_sequences(pdb_dir, tmp_path / "out", num_seq_per_target=4,
                              model=setup["model"], backbone_noise=0.3, batch_size=2)
    assert len(seen) == 2 and all(x.shape == (2, L, 4, 3) for x in seen)
    rows = torch.cat(seen)
    for i in range(4):
        assert 0.1 < float((rows[i] - x0[0]).std()) < 0.5
        for j in range(i):
            assert not torch.allclose(rows[i], rows[j])


def test_cuda_unless_asked_for_the_cpu(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_design.load_mpnn_params(setup["weights"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_design.main([f"--pdb_dir={setup['pdb_dir']}", f"--out_folder={tmp_path}",
                       f"--weights_path={setup['weights']}"])
    with pytest.raises(ToolUnavailable, match="not found"):
        t_design.load_mpnn_params(tmp_path / "missing.pt", device="cpu")
