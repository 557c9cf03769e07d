"""The fused IPA attention of the port against the JAX package, at narrow
widths (c_s 32, c_z 16, c_hidden 16, 2 heads, 4/4 points): the point inputs,
the kernel's plain version against the Pallas kernel in interpret mode, the
IPA module, a ScoreNetwork forward and a sampler run with
``model.ipa.use_pallas_ipa`` on, and the flag's config and service
plumbing. On the CPU the wrapper takes the plain version; the CUDA kernel
itself is held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: point inputs 1e-6; plain version against the Pallas kernel
float32 atol 1e-5, bf16 5e-2 (the edge-stack kernels' bf16 tolerance); the IPA
module against the JAX Pallas branch atol 1e-5, against the JAX XLA branch
on unmasked rows atol 2e-4 rtol 1e-3 (tests/unit/test_pallas_kernels.py);
ScoreNetwork 1e-4 relative on max(1, |ref|) (tests/test_torch_model.py);
sampler CA-RMSD 0.01 A (tests/test_torch_sampling.py)."""
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.diffusion import SE3Diffuser as JSE3
from framedipt_tpu.geometry.rigid import Rigid as JRigid
from framedipt_tpu.model import ScoreNetwork as JNet
from framedipt_tpu.model.import_torch import convert_state_dict
from framedipt_tpu.model.ipa import InvariantPointAttention as JIPA
from framedipt_tpu.model.pallas import ipa_attention as j_ipa
from framedipt_tpu.sampling import build_inference_fn

from framedipt_tpu_torch.data.protein import from_pdb_string
from framedipt_tpu_torch.diffusion import SE3Diffuser as TSE3
from framedipt_tpu_torch.experiments.serve import InpaintingService
from framedipt_tpu_torch.geometry.rigid import Rigid as TRigid
from framedipt_tpu_torch.model import ScoreNetwork as TNet
from framedipt_tpu_torch.model.ipa import InvariantPointAttention as TIPA
from framedipt_tpu_torch.model.kernels import ipa_attention as t_ipa
from framedipt_tpu_torch.sampling import sample
from framedipt_tpu_torch.tools.config import (
    Config,
    load_config,
    merge_checkpoint_config,
    resolve_kernel_flags,
)

from tests.parity import fixture_lib
from tests.test_torch_cuda import ipa_args, ipa_to_torch
from tests.test_torch_model import (
    _assert_outputs_close,
    jax_params_and_models,  # noqa: F401 - a fixture
    make_feats,
    tiny_configs,
)
from tests.test_torch_serve import TINY_OVERRIDES, _helix_pdb
from tests.torch_threads import one_torch_thread  # noqa: F401


H, C, PQ, PV, CZ = 2, 16, 4, 4, 16


def _useful_pt_lanes(opt_jax, B, N, width):
    """The JAX kernel's 128-lane point rows, cut to the port's lanes."""
    return np.asarray(opt_jax).reshape(B, N, H, j_ipa.PT_PAD)[..., :width]


@pytest.mark.parametrize("heads,pq,pv", [(H, PQ, PV), (8, 8, 12)])
def test_build_point_inputs_match_jax(heads, pq, pv):
    """The augmented points, lane for lane, at the test widths and at the
    default ones (28 and 36 lanes per head)."""
    rng = np.random.default_rng(heads)
    B, N = 2, 11
    qp, kp = (rng.normal(size=(B, N, heads, pq, 3)).astype(np.float32) * 4 for _ in range(2))
    vp = rng.normal(size=(B, N, heads, pv, 3)).astype(np.float32) * 4
    w = np.log1p(np.exp(rng.normal(size=heads))).astype(np.float32) * 0.2
    got = t_ipa.build_point_inputs(*(torch.as_tensor(x) for x in (qp, kp, vp, w)))
    want = j_ipa.build_point_inputs(*(jnp.asarray(x) for x in (qp, kp, vp, w)))
    qw, vw = got[0].shape[-1] // heads, got[2].shape[-1] // heads
    if (heads, pq, pv) == (8, 8, 12):
        assert (qw, vw) == (t_ipa.PQW, t_ipa.PVW)
    for g, j, width in zip(got, want, (qw, qw, vw)):
        g = g.numpy().reshape(B, N, heads, width)
        j = np.asarray(j).reshape(B, N, heads, j_ipa.PT_PAD)
        np.testing.assert_allclose(g, j[..., :width], atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(j[..., width:], 0.0)


def _jax_kernel_args(args, dtype):
    q, k, v, qp, kp, vp, w, z, mask, wb, wdz = args
    qhat, khat, vpad = j_ipa.build_point_inputs(*(jnp.asarray(x) for x in (qp, kp, vp, w)))
    return [jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype), qhat, khat,
            vpad, jnp.asarray(z, dtype), jnp.asarray(mask), jnp.asarray(wb, dtype),
            jnp.asarray(wdz, dtype)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("n", [13, 20])
def test_plain_version_matches_pallas_interpret(n, dtype, tol):
    """o, o_pt (useful lanes) and o_pair of the plain version against the
    Pallas kernel in interpret mode, with a padded tail, a fully masked row
    (exactly zero in both) and N not a multiple of any tile."""
    B = 2
    args = ipa_args(np.random.default_rng(n), B, n, H, C, PQ, PV, CZ)
    t_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    got = t_ipa.ipa_attention(*ipa_to_torch(args, t_dtype), no_heads=H, no_v_points=PV)
    with pltpu.force_tpu_interpret_mode():
        o, opt, opair = j_ipa.fused_ipa_attention(
            *_jax_kernel_args(args, getattr(jnp, dtype)), no_heads=H, c_hidden=C, tile_i=8
        )
    want = (np.asarray(o), _useful_pt_lanes(opt, B, n, 3 * PV).reshape(B, n, H * PV, 3),
            np.asarray(opair))
    for name, g, w in zip(("o", "o_pt", "o_pair"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0 if tol < 1e-4 else tol,
                                   err_msg=name)
        np.testing.assert_array_equal(g.numpy()[0, 1], 0.0)  # fully masked row
        np.testing.assert_array_equal(g.numpy()[:, -3:], 0.0)  # padded tail


def _ipa_inputs(seed, B=2, N=17):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(B, N, 32)).astype(np.float32)
    z = rng.normal(size=(B, N, N, 16)).astype(np.float32)
    qs = rng.normal(size=(B, N, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    tr = (rng.normal(size=(B, N, 3)) * 3).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[B - 1, -5:] = 0.0
    mask[0, 3] = 0.0
    return s, z, qs, tr, mask


def test_ipa_module_with_kernel_matches_jax(jax_params_and_models):  # noqa: F811
    """The port's IPA with the flag on (CPU: the plain version) against the
    JAX module's Pallas branch in interpret mode on every row, and against
    its XLA branch on the unmasked rows."""
    jc, tc, params, _, tnet = jax_params_and_models
    s, z, qs, tr, mask = _ipa_inputs(6)
    ipa = TIPA(tc.model.ipa, torch.float32, use_kernel=True)
    ipa.load_state_dict(tnet.score_model.trunk["ipa_0"].state_dict())
    with torch.no_grad():
        got = ipa(torch.as_tensor(s), torch.as_tensor(z),
                  TRigid(torch.as_tensor(qs), torch.as_tensor(tr)), torch.as_tensor(mask)).numpy()
    p = {"params": params["params"]["score_model"]["ipa_0"]}
    jargs = (jnp.asarray(s), jnp.asarray(z), JRigid(jnp.asarray(qs), jnp.asarray(tr)),
             jnp.asarray(mask))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(one_dispatch(JIPA(jc.model.ipa, use_pallas=True).apply, p, *jargs))
    want_xla = np.asarray(JIPA(jc.model.ipa, use_pallas=False).apply(p, *jargs))
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=0)
    m = mask[..., None]
    np.testing.assert_allclose(got * m, want_xla * m, atol=2e-4, rtol=1e-3)


def test_ipa_module_with_kernel_matches_jax_bf16(jax_params_and_models):  # noqa: F811
    jc, tc, params, _, tnet = jax_params_and_models
    s, z, qs, tr, mask = _ipa_inputs(8, B=1, N=16)
    ipa = TIPA(tc.model.ipa, torch.bfloat16, use_kernel=True)
    ipa.load_state_dict(tnet.score_model.trunk["ipa_0"].state_dict())
    with torch.no_grad():
        got = ipa(torch.as_tensor(s).bfloat16(), torch.as_tensor(z).bfloat16(),
                  TRigid(torch.as_tensor(qs), torch.as_tensor(tr)), torch.as_tensor(mask))
    p = {"params": params["params"]["score_model"]["ipa_0"]}
    with pltpu.force_tpu_interpret_mode():
        want = one_dispatch(
            JIPA(jc.model.ipa, dtype=jnp.bfloat16, use_pallas=True).apply,
            p, jnp.asarray(s, jnp.bfloat16), jnp.asarray(z, jnp.bfloat16),
            JRigid(jnp.asarray(qs), jnp.asarray(tr)), jnp.asarray(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)


def one_dispatch(fn, *args):
    """``fn(*args)`` as one jitted call, its result ready. Run op by op, a
    JAX module's operations after a Pallas kernel in interpret mode can queue
    behind the kernel, whose callbacks dispatch JAX operations from another
    thread: under the CPU client's asynchronous dispatch the two threads can
    wait on each other for good. The arguments are closed over, so they need
    not be pytrees."""
    return jax.block_until_ready(jax.jit(lambda: fn(*args))())


def _kernel_configs(self_conditioning=True):
    jc, tc = tiny_configs(self_conditioning)
    jc.model.ipa.use_pallas_ipa = tc.model.ipa.use_pallas_ipa = True
    return jc, tc


def _synth_weights(tc):
    tnet = TNet(tc.model, TSE3(tc.diffuser, device="cpu"), inpainting=True)
    sd = fixture_lib.synth_state_dict([(k, list(v.shape)) for k, v in tnet.state_dict().items()])
    tnet.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return tnet, sd


# The score network's JAX reference runs op by op (jitted, XLA's fusions move
# the trunk's outputs past this test's 1e-4), its Pallas kernel in interpret
# mode, whose callbacks dispatch JAX operations from another thread: under
# the CPU client's asynchronous dispatch the main thread and the callback's
# can wait on each other for good (the parallel test suite stalled so). So it
# runs in a child process that turns jax_cpu_enable_async_dispatch off before
# its CPU client is made, as tests/test_torch_train.py's reference does,
# under a time limit, its output to a log file.
REPO = pathlib.Path(__file__).resolve().parent.parent
SCORE_OUTPUTS = ("psi", "rot_score", "trans_score", "atom37", "rigids")
_SCORE_CHILD = """
import sys
import jax
jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_device", jax.devices("cpu")[0])
from tests.test_torch_ipa_attention import write_score_network_reference
write_score_network_reference(sys.argv[1])
"""
SCORE_CHILD_TIMEOUT_S = 300


def write_score_network_reference(path) -> None:
    """The JAX ScoreNetwork forward with use_pallas_ipa on (op by op, the
    kernel in interpret mode) on make_feats(7), from _synth_weights's
    state_dict; its SCORE_OUTPUTS to the .npz file ``path``."""
    jc, tc = _kernel_configs()
    _, sd = _synth_weights(tc)
    jnet = JNet(jc.model, JSE3(jc.diffuser), inpainting=True)
    feats = make_feats(7)
    with pltpu.force_tpu_interpret_mode():
        want = jnet.apply(convert_state_dict(sd, num_blocks=2, seq_tfmr_layers=1),
                          {k: jnp.asarray(v) for k, v in feats.items()})
    np.savez(path, **{k: np.asarray(want[k]) for k in SCORE_OUTPUTS})


def test_score_network_with_kernel_matches_jax(tmp_path):
    """A ScoreNetwork forward with use_pallas_ipa on in both packages (the
    JAX one op by op, its Pallas kernel in interpret mode, in a child
    process), from one torch-layout state_dict."""
    ref, log = tmp_path / "score_network.npz", tmp_path / "score_network.log"
    with open(log, "w") as f:
        child = subprocess.Popen([sys.executable, "-c", _SCORE_CHILD, str(ref)], cwd=REPO,
                                 stdout=f, stderr=subprocess.STDOUT)
    try:
        jc, tc = _kernel_configs()
        tnet, _ = _synth_weights(tc)
        assert all(tnet.score_model.trunk[f"ipa_{b}"].use_kernel for b in range(2))
        with torch.no_grad():
            got = tnet({k: torch.as_tensor(v) for k, v in make_feats(7).items()})
        child.wait(timeout=SCORE_CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert child.returncode == 0, log.read_text()[-4000:]
    with np.load(ref) as f:
        want = dict(f)
    _assert_outputs_close(got, want)


def _ca_rmsd(a, b):
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


def test_sampler_with_kernel_matches_jax():
    """A deterministic (noise_scale=0) 3-step trajectory with the flag on in
    both packages, as tests/test_torch_sampling.py runs it."""
    jc, tc = _kernel_configs()
    tnet, sd = _synth_weights(tc)
    jd = JSE3(jc.diffuser)
    jnet = JNet(jc.model, jd, inpainting=True)
    feats = make_feats(11, B=1, N=24)
    feats["t"] = np.ones((1,), np.float32)
    feats["sc_ca_t"] = np.zeros_like(feats["sc_ca_t"])
    run = build_inference_fn(jnet, jd, num_t=3, min_t=0.01, noise_scale=0.0, inpainting=True)
    with pltpu.force_tpu_interpret_mode():
        want = run(jax.tree_util.tree_map(jnp.asarray,
                                          convert_state_dict(sd, num_blocks=2, seq_tfmr_layers=1)),
                   {k: jnp.asarray(v) for k, v in feats.items()}, jax.random.PRNGKey(0))
    got = sample(tnet, tnet.diffuser, {k: torch.as_tensor(v) for k, v in feats.items()},
                 torch.Generator().manual_seed(0), num_t=3, min_t=0.01, noise_scale=0.0,
                 inpainting=True)
    traj_j, traj_t = np.asarray(want["prot_traj"]), got["prot_traj"].numpy()
    assert traj_t.shape == traj_j.shape == (3, 1, 24, 37, 3)
    for step in range(3):
        assert _ca_rmsd(traj_t[step, 0, :, 1], traj_j[step, 0, :, 1]) < 0.01, step
    np.testing.assert_allclose(got["psi_pred"].numpy(), np.asarray(want["psi_pred"]), atol=1e-3)


def test_use_pallas_ipa_flag_resolution():
    """None resolves to False on every device; an explicit value stays (on
    the card False runs the einsum branch, no error); a checkpoint's value
    is dropped; the dotted override parses."""
    for dev in ("cpu", "cuda", torch.device("cuda", 0)):
        cfg = Config()
        assert cfg.model.ipa.use_pallas_ipa is None
        resolve_kernel_flags(cfg, dev)
        assert cfg.model.ipa.use_pallas_ipa is False
        for value in (True, False):
            cfg = load_config([f"model.ipa.use_pallas_ipa={str(value).lower()}"])
            assert cfg.model.ipa.use_pallas_ipa is value
            resolve_kernel_flags(cfg, dev)
            assert cfg.model.ipa.use_pallas_ipa is value
    cfg = load_config(["model.ipa.use_pallas_ipa=true"])
    merged = merge_checkpoint_config(
        cfg, {"model": {"ipa": {"c_s": 64, "use_pallas_ipa": False}}})
    assert merged.model.ipa.c_s == 64
    assert merged.model.ipa.use_pallas_ipa is True  # the run's choice, not the checkpoint's
    merged = merge_checkpoint_config(Config(), {"model": {"ipa": {"use_pallas_ipa": True}}})
    assert merged.model.ipa.use_pallas_ipa is None
    assert dataclasses.asdict(Config())["model"]["ipa"]["use_pallas_ipa"] is None


def test_service_serves_with_the_kernel_flag_on_cpu():
    """The service with model.ipa.use_pallas_ipa=true: every IPA block takes
    the kernel branch (its wrapper's plain version on the CPU) and a request
    comes back with the fixed residues in place; without the override the
    blocks take the einsum branch."""
    cfg = load_config(TINY_OVERRIDES + ["model.ipa.use_pallas_ipa=true"])
    cfg.inference.weights_path = ""
    service = InpaintingService(cfg, device="cpu")
    assert service.cfg.model.ipa.use_pallas_ipa is True
    blocks = [m for m in service.model.modules() if isinstance(m, TIPA)]
    assert len(blocks) == 2 and all(m.use_kernel for m in blocks)
    pdb, ref_pos = _helix_pdb(20)
    samples = service.inpaint(pdb, "A", 6, 12, samples=1, num_t=2)
    got = from_pdb_string(samples[0])
    fixed = np.ones(20, bool)
    fixed[6:13] = False
    assert np.isfinite(got.atom_positions).all()
    np.testing.assert_allclose(got.atom_positions[fixed, 1], ref_pos[fixed, 1], atol=1e-3)
    default = InpaintingService(load_config(TINY_OVERRIDES + ["inference.weights_path="]),
                                device="cpu")
    assert default.cfg.model.ipa.use_pallas_ipa is False
    assert not any(m.use_kernel for m in default.model.modules() if isinstance(m, TIPA))
