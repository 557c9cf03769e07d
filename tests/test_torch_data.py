"""The port's data pipeline against the JAX package's, on the three fixture
mmCIF files: parsing, raw and model features, frames, atom14, redaction
masks, length batching, secondary structure, radius of gyration, the
preprocessing rows and ``metadata.csv`` read across the two packages.
Integer and float64 arrays must be equal; the same seeds give the same
draws."""
import csv
import pathlib

import numpy as np
import pytest
import torch

from framedipt_tpu.analysis import dssp as j_dssp
from framedipt_tpu.data import features as j_feat
from framedipt_tpu.data import mmcif as j_mmcif
from framedipt_tpu.data import pipeline as j_pipe
from framedipt_tpu.data import transforms as j_tf
from framedipt_tpu.tools.config import FilteringConfig as JFiltering

from framedipt_tpu_torch.analysis import dssp as t_dssp
from framedipt_tpu_torch.data import features as t_feat
from framedipt_tpu_torch.data import mmcif as t_mmcif
from framedipt_tpu_torch.data import pipeline as t_pipe
from framedipt_tpu_torch.data import transforms as t_tf
from framedipt_tpu_torch.tools.config import FilteringConfig as TFiltering

CIF_DIR = pathlib.Path(__file__).resolve().parent / "data" / "cifs"
CIFS = sorted(CIF_DIR.glob("*.cif"))
FILTER = dict(max_len=2000, min_len=10, chain_max_len=2000)


def assert_feats_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.fixture(scope="module")
def parsed():
    """{name: (JAX MmcifObject, port MmcifObject)}."""
    return {p.stem: (j_mmcif.parse_mmcif(p), t_mmcif.parse_mmcif(p)) for p in CIFS}


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """Both packages' process_serially over the fixtures, each into its own
    directory, and each metadata.csv as its package writes it."""
    out = {}
    for name, pipe, filtering in (("jax", j_pipe, JFiltering), ("port", t_pipe, TFiltering)):
        d = tmp_path_factory.mktemp(f"processed_{name}")
        rows = pipe.process_serially(CIFS, pipe.ProcessOptions(output_dir=d,
                                                               filtering=filtering(**FILTER)))
        out[name] = (d, rows)
    import pandas as pd

    pd.DataFrame(out["jax"][1]).to_csv(out["jax"][0] / "metadata.csv", index=False)
    t_pipe.write_metadata(out["port"][1], out["port"][0] / "metadata.csv")
    return out


def test_parse_mmcif_matches_jax(parsed):
    for name, (want, got) in parsed.items():
        assert got.file_id == want.file_id
        assert got.header.__dict__ == want.header.__dict__, name
        assert list(got.chains) == list(want.chains), name
        for cid, wc in want.chains.items():
            gc = got.chains[cid]
            for field in ("aatype", "atom_positions", "atom_mask", "residue_index", "b_factors"):
                np.testing.assert_array_equal(getattr(gc, field), getattr(wc, field),
                                              err_msg=f"{name} {cid} {field}")
            assert gc.insertion_codes == wc.insertion_codes
            assert gc.sequence == wc.sequence


def test_cif_tokenizer_matches_jax_on_quoting():
    text = (
        "data_x\n_a.b 'it''s ok'\n_a.c \"x y\"\nloop_\n_l.one\n_l.two\n1 'q r'\n"
        ";multi\nline\n;\n3 4 # comment\n_s.v ?\n"
    )
    assert t_mmcif.parse_cif_categories_py(text) == j_mmcif.parse_cif_categories_py(text)


def test_structure_to_features_matches_jax(parsed):
    for name, (want, got) in parsed.items():
        assert_feats_equal(t_feat.structure_to_features(got), j_feat.structure_to_features(want))
        cids = sorted(want.chains)[1:3]
        assert_feats_equal(t_feat.structure_to_features(got, chain_ids=cids, center=False),
                           j_feat.structure_to_features(want, chain_ids=cids, center=False))


@pytest.mark.parametrize("single_chain,chain_max_len", [(False, None), (True, None), (True, 64),
                                                        (False, 100)])
def test_build_model_features_matches_jax(parsed, single_chain, chain_max_len):
    """The same Generator seed gives the same chain pick and crops."""
    for k, (name, (want, got)) in enumerate(parsed.items()):
        raw = j_feat.structure_to_features(want)
        j_rng, t_rng = np.random.default_rng(k), np.random.default_rng(k)
        for _ in range(3):  # several draws from one stream
            w = j_feat.build_model_features(raw, extract_single_chain=single_chain, rng=j_rng,
                                            chain_max_len=chain_max_len)
            g = t_feat.build_model_features(raw, extract_single_chain=single_chain, rng=t_rng,
                                            chain_max_len=chain_max_len)
            assert_feats_equal(g, w)
        assert j_rng.integers(1 << 30) == t_rng.integers(1 << 30)


def test_interior_unk_residue_fails_alike_in_both(parsed):
    """ROADMAP queue 3: an unknown residue (aatype 20) inside a chain's
    modeled region reaches atom37_to_torsion_angles, which raises
    IndexError in both packages (the fixtures hold none; this one is
    synthetic). Leading and trailing ones are trimmed and pass."""
    want, _ = next(iter(parsed.values()))
    raw = j_feat.structure_to_features(want)
    assert not (raw["aatype"] == 20).any()
    lo, hi = int(raw["min_modeled_idxs"][0]), int(raw["max_modeled_idxs"][0])
    interior = dict(raw, aatype=raw["aatype"].copy())
    interior["aatype"][(lo + hi) // 2] = 20
    errors = []
    for build in (j_feat.build_model_features, t_feat.build_model_features):
        with pytest.raises(IndexError) as info:
            build(interior)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    # An unknown first residue is trimmed by the modeled-region bounds.
    edge = dict(raw, aatype=raw["aatype"].copy())
    edge["aatype"][lo] = 20
    edge["min_modeled_idxs"] = raw["min_modeled_idxs"].copy()
    edge["min_modeled_idxs"][0] = lo + 1
    assert_feats_equal(t_feat.build_model_features(edge), j_feat.build_model_features(edge))


def test_transforms_match_jax(parsed):
    want, _ = next(iter(parsed.values()))
    raw = j_feat.structure_to_features(want)
    aatype, pos, mask = raw["aatype"], raw["atom_positions"], raw["atom_mask"]
    assert_feats_equal(t_tf.atom37_to_frames(aatype, pos, mask),
                       j_tf.atom37_to_frames(aatype, pos, mask))
    assert_feats_equal(t_tf.make_atom14_positions(aatype, pos, mask),
                       j_tf.make_atom14_positions(aatype, pos, mask))
    np.testing.assert_array_equal(t_tf.backbone_rigid_tensor7(aatype, pos, mask),
                                  j_tf.backbone_rigid_tensor7(aatype, pos, mask))


def test_redaction_masks_match_jax():
    chain_idx = np.repeat([0, 1, 2], [40, 25, 7])
    res_mask = np.ones(72, np.float32)
    res_mask[:3] = 0.0
    res_mask[60:62] = 0.0
    for seed in range(5):
        j_rng, t_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        for lo, hi in ((8, 50), (3, 5), (None, None)):
            want = j_feat.create_redacted_regions(chain_idx, res_mask, j_rng, lo, hi)
            got = t_feat.create_redacted_regions(chain_idx, res_mask, t_rng, lo, hi)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            t_feat.create_single_redacted_region(res_mask, t_rng, 2, 9),
            j_feat.create_single_redacted_region(res_mask, j_rng, 2, 9))


def test_length_batching_and_buckets_match_jax():
    lengths = np.random.default_rng(0).integers(10, 900, size=40)
    for cap in (1_000_000, 100_000, 10):
        assert t_feat.length_batching(lengths, cap) == j_feat.length_batching(lengths, cap)
    for n in (1, 64, 65, 511, 512, 513, 900):
        assert t_feat.length_bucket(n) == j_feat.length_bucket(n)


def test_secondary_structure_and_rog_match_jax(parsed):
    for name, (want, _) in parsed.items():
        raw = j_feat.structure_to_features(want)
        bb = raw["bb_mask"].astype(bool)
        pos, mask = raw["atom_positions"][bb][:300], raw["atom_mask"][bb][:300]
        np.testing.assert_array_equal(t_dssp.assign_secondary_structure(pos, mask),
                                      j_dssp.assign_secondary_structure(pos, mask))
        assert t_dssp.radius_of_gyration(pos, mask) == j_dssp.radius_of_gyration(pos, mask)
        assert t_dssp.ss_metrics_from_atom37(pos, mask) == j_dssp.ss_metrics_from_atom37(pos, mask)
    assert len(t_dssp.assign_secondary_structure(pos[:4], mask[:4])) == 4


def test_process_serially_rows_match_jax(preprocessed):
    (j_dir, j_rows), (t_dir, t_rows) = preprocessed["jax"], preprocessed["port"]
    assert len(t_rows) == len(j_rows) == 3
    for got, want in zip(t_rows, j_rows):
        assert list(got) == list(want) == list(t_pipe.METADATA_COLUMNS)
        for k in want:
            if k == "processed_path":
                assert got[k] == want[k].replace(str(j_dir), str(t_dir))
            else:
                assert got[k] == want[k], k
        import pickle

        with open(got["processed_path"], "rb") as f, open(want["processed_path"], "rb") as g:
            assert_feats_equal(pickle.load(f), pickle.load(g))
    rows = [dict(r, radius_gyration=x) for r, x in zip(t_rows, (1.0, 3.0, 2.0))]
    assert t_pipe.apply_rog_quantile(rows, 0.5) == j_pipe.apply_rog_quantile(rows, 0.5)


def test_metadata_csv_matches_pandas_and_reads_across(preprocessed, tmp_path):
    """The port writes metadata.csv with the csv module as pandas writes it;
    the JAX TrainDataset reads the port's file and the port's reads the
    JAX one, to the same examples."""
    import pandas as pd

    from framedipt_tpu.experiments.train import TrainDataset as JDataset
    from framedipt_tpu.tools.config import Config as JConfig

    from framedipt_tpu_torch.experiments.train import TrainDataset as TDataset
    from framedipt_tpu_torch.tools.config import Config as TConfig

    (j_dir, j_rows), (t_dir, t_rows) = preprocessed["jax"], preprocessed["port"]
    pd.DataFrame(t_rows).to_csv(tmp_path / "pandas.csv", index=False)
    assert (t_dir / "metadata.csv").read_text() == (tmp_path / "pandas.csv").read_text()

    for csv_path in (j_dir / "metadata.csv", t_dir / "metadata.csv"):
        jc, tc = JConfig(), TConfig()
        for c in (jc, tc):
            c.data.csv_path = str(csv_path)
            c.data.filtering.min_len = 10
            c.data.filtering.max_len = 2000
        jd = JDataset(jc, np.random.default_rng(0))
        td = TDataset(tc, np.random.default_rng(0))
        assert len(td.meta) == len(jd.meta) == 3
        for i in range(3):
            assert td.meta[i]["processed_path"] == jd.meta.iloc[i]["processed_path"]
            assert int(td.meta[i]["modeled_seq_len"]) == int(jd.meta.iloc[i]["modeled_seq_len"])
        assert_feats_equal(td.example(1), jd.example(1))


def test_pipeline_cli_writes_metadata_and_refuses_without_a_card(tmp_path):
    """The CLI as the JAX one runs it: the radius-of-gyration quantile (0.96)
    drops the largest of the three; without a CUDA device it needs
    --device=cpu."""
    args = [f"--cif_dir={CIF_DIR}", f"--output_dir={tmp_path}", "--min_len=10", "--max_len=2000"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_pipe.main(args)
    t_pipe.main(["--device=cpu"] + args)
    with open(tmp_path / "metadata.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["pdb_name"] for r in rows] == ["1fyt", "7t2d"]
    assert list(rows[0]) == list(t_pipe.METADATA_COLUMNS)
