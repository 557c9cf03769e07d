"""The port's inpainting service on the CPU: one /inpaint over HTTP at a
small config (as tests/integration/test_serve.py drives the JAX server), the
device policy, and the config loader."""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from framedipt_tpu_torch.data.protein import Protein, from_pdb_string, to_pdb
from framedipt_tpu_torch.diffusion import SE3Diffuser
from framedipt_tpu_torch.experiments.serve import InpaintingService, make_handler
from framedipt_tpu_torch.tools.config import (
    Config,
    load_config,
    merge_checkpoint_config,
    parse_value,
    resolve_kernel_flags,
)
from framedipt_tpu_torch.tools.device import resolve_device

from tests.unit.geom_helpers import nerf_backbone

TINY_OVERRIDES = [
    "model.node_embed_size=32", "model.edge_embed_size=16", "model.ipa.c_s=32",
    "model.ipa.c_z=16", "model.ipa.c_hidden=16", "model.ipa.c_skip=8",
    "model.ipa.no_heads=2", "model.ipa.no_qk_points=4", "model.ipa.no_v_points=4",
    "model.ipa.num_blocks=2", "model.ipa.seq_tfmr_num_layers=1",
    "model.ipa.seq_tfmr_num_heads=2", "diffuser.so3.num_omega=50",
    "diffuser.so3.num_sigma=20", "diffuser.so3.cache_dir=null",
]


def _helix_pdb(n_res: int) -> tuple[str, np.ndarray]:
    atom37, mask = nerf_backbone(n_res)
    atom37 = atom37 + np.asarray([40.0, -25.0, 12.0])  # far from the origin
    text = to_pdb(Protein(
        atom_positions=atom37 * mask[..., None], atom_mask=mask,
        aatype=np.arange(n_res) % 20, residue_index=np.arange(1, n_res + 1),
        chain_index=np.zeros(n_res, np.int64), b_factors=np.zeros((n_res, 37)),
    ))
    return text, from_pdb_string(text).atom_positions


@pytest.fixture(scope="module")
def http_service():
    """The CPU service at the tiny width (random weights: the JAX package's
    initialization) behind an HTTP server; yields (service, base URL)."""
    cfg = load_config(TINY_OVERRIDES)
    cfg.inference.weights_path = ""
    service = InpaintingService(cfg, device="cpu")
    assert cfg.model.ipa.use_pallas_kernel is None  # the service resolves a copy
    assert service.cfg.model.ipa.use_pallas_kernel is False
    server = __import__("http.server").server.ThreadingHTTPServer(
        ("127.0.0.1", 0), make_handler(service)
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield service, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _post(base, payload, timeout=120):
    req = urllib.request.Request(base + "/inpaint", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def test_inpaint_over_http_on_cpu(http_service):
    _, base = http_service
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert json.load(r) == {"status": "ok", "device": "cpu"}
    pdb, ref_pos = _helix_pdb(24)
    reply = _post(base, {"pdb": pdb, "chain": "A", "start": 8, "end": 15,
                         "samples": 2, "num_t": 3})
    assert len(reply["samples"]) == 2
    in_mask = from_pdb_string(pdb).atom_mask
    fixed = np.ones(24, bool)
    fixed[8:16] = False
    for text in reply["samples"]:
        got = from_pdb_string(text)
        assert len(got.aatype) == 24
        assert (got.atom_mask >= in_mask).all()  # every atom of the input comes back
        assert np.isfinite(got.atom_positions).all()
        # Fixed residues come back in the input frame, CA unchanged.
        np.testing.assert_allclose(got.atom_positions[fixed, 1], ref_pos[fixed, 1], atol=1e-3)
        # The resampled loop stays near its neighbours, not at the origin.
        ca = got.atom_positions[:, 1]
        assert np.linalg.norm(ca[~fixed] - ca[fixed].mean(0), axis=-1).max() < 60.0
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, {"pdb": pdb, "chain": "Q", "start": 0, "end": 3}, timeout=60)
    assert err.value.code == 400


@pytest.mark.parametrize("start,end", [(30, 35), (10, 5)], ids=["past_the_end", "start_after_end"])
def test_empty_window_is_refused(http_service, start, end):
    """A window that selects no residue of the chain is a client error (HTTP
    400, before sampling), not an empty PDB: the reverse step would divide
    by a diffused count of 0 (a deliberate divergence from the JAX
    service)."""
    service, base = http_service
    pdb, _ = _helix_pdb(24)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, {"pdb": pdb, "chain": "A", "start": start, "end": end, "num_t": 3},
              timeout=60)
    assert err.value.code == 400
    assert "selects no residue" in json.load(err.value)["error"]
    with pytest.raises(ValueError, match="selects no residue"):
        service.inpaint(pdb, chain="A", start=start, end=end, samples=1, num_t=3)


def test_entry_points_run_on_cuda_unless_asked_for_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InpaintingService(load_config(TINY_OVERRIDES))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SE3Diffuser(load_config(TINY_OVERRIDES).diffuser)


def test_kernel_flags_resolve_by_device():
    for dev, expect in (("cpu", False), ("cuda", True), (torch.device("cuda", 0), True)):
        cfg = Config()
        resolve_kernel_flags(cfg, dev)
        assert cfg.model.ipa.use_pallas_kernel is expect
        assert cfg.model.ipa.use_pallas_embedder is expect
    # On the CPU the wrappers take their plain versions whatever the flags
    # say; on the card the kernels are the only path.
    cfg = load_config(["model.ipa.use_pallas_kernel=false", "model.ipa.use_pallas_embedder=true"])
    resolve_kernel_flags(cfg, "cpu")
    assert cfg.model.ipa.use_pallas_kernel is False
    assert cfg.model.ipa.use_pallas_embedder is True
    for flag in ("use_pallas_kernel", "use_pallas_embedder"):
        cfg = load_config([f"model.ipa.{flag}=false"])
        with pytest.raises(ValueError, match=f"{flag}=False"):
            resolve_kernel_flags(cfg, "cuda")


def test_config_overrides_and_checkpoint_merge():
    assert [parse_value(v) for v in ("null", "True", "3", "1e-5", "[1, 2]", "abc")] == [
        None, True, 3, 1e-5, [1, 2], "abc"]
    cfg = load_config(["model.ipa.num_blocks=2", "inference.diffusion.num_t=7"])
    assert cfg.model.ipa.num_blocks == 2 and cfg.inference.diffusion.num_t == 7
    with pytest.raises(KeyError):
        load_config(["model.no_such_key=1"])
    merged = merge_checkpoint_config(cfg, {"model": {"node_embed_size": 64, "ipa": {
        "c_s": 64, "pallas_tile_i": 8, "use_pallas_kernel": False}}, "experiment": {"seed": 1}})
    assert merged.model.node_embed_size == 64 and merged.model.ipa.c_s == 64
    assert merged.model.ipa.num_blocks == 2  # runtime value kept where unsaved
    assert merged.model.ipa.use_pallas_kernel is None  # a run setting, not the model's
