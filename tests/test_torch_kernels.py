"""The kernels' plain versions against the JAX package: the XLA twins and the
Pallas kernels in interpret mode (small tiles), with ragged N, zeroed masks
and the d = 0 diagonal; and the dispatch, read from the wrappers' code and
from the model's calls to them. (The IPA attention's plain version is held
against JAX in tests/test_torch_ipa_attention.py.)

Tolerances: float32 atol/rtol 1e-4, bf16 5e-2 (tests/unit/test_pallas_kernels.py).
The CUDA kernels themselves are checked on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""
import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb
from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.model import embed as t_embed_mod
from framedipt_tpu_torch.model import ipa as t_ipa_mod
from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from framedipt_tpu_torch.model.kernels import ipa_attention as t_ipa
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

from tests.test_torch_cuda import (
    emb_args,
    emb_to_torch,
    ipa_args,
    ipa_to_torch,
    pair_args,
    pair_to_torch,
)


def _to_jax(args, dtype):
    return [None if x is None else jnp.asarray(x, jnp.float32 if i in (11, 12) else dtype)
            for i, x in enumerate(args)]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("n", [13, 24])
def test_pair_mlp_plain_matches_xla_twin_f32(residual, n):
    args = pair_args(np.random.default_rng(n), 2, n, 16, 48, 16, residual)
    got = t_pair.pair_mlp(*pair_to_torch(args, torch.float32))  # CPU -> plain version
    want = j_pair._xla_pair_mlp(*_to_jax(args, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.numpy()[:, -3:], 0.0)  # masked rows


def test_pair_mlp_plain_matches_xla_twin_bf16():
    args = pair_args(np.random.default_rng(5), 1, 16, 16, 32, 16, True)
    got = t_pair.pair_mlp(*pair_to_torch(args, torch.bfloat16))
    want = j_pair._xla_pair_mlp(*_to_jax(args, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("residual", [True, False])
def test_pair_mlp_plain_matches_pallas_interpret(residual):
    """Against the Pallas kernel itself, run in interpret mode on the CPU
    with small tiles; N=20 is not a tile multiple (padded edge)."""
    args = pair_args(np.random.default_rng(7), 1, 20, 16, 32, 16, residual)
    got = t_pair.pair_mlp(*pair_to_torch(args, torch.float32))
    ja = _to_jax(args, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = j_pair.fused_pair_mlp(*ja[:13], fi=ja[13], fj=ja[14], wfe=ja[15],
                                     tile_i=8, tile_j=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _emb_jax(args, dtype):
    return [jnp.asarray(x, jnp.float32 if i in (2, 3, 15, 16) else dtype)
            for i, x in enumerate(args)]


@pytest.mark.parametrize("n", [17, 32])
def test_edge_embedder_plain_matches_xla_twin_f32(n):
    args, bins = emb_args(np.random.default_rng(n), 2, n, 24, 22)
    got = t_emb.edge_embedder(*emb_to_torch(args, torch.float32), *bins)
    want = j_emb._xla_edge_embedder(*_emb_jax(args, jnp.float32), *bins)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.numpy()[:, :, -3:], 0.0)  # masked columns


def test_edge_embedder_without_distogram_matches_xla_twin():
    """Zero distance bins (a model without self-conditioning): no pair gets
    a distogram term."""
    args, bins = emb_args(np.random.default_rng(4), 2, 19, 24, 0)
    assert bins == ((), ())
    got = t_emb.edge_embedder(*emb_to_torch(args, torch.float32), *bins)
    want = j_emb._xla_edge_embedder(*_emb_jax(args, jnp.float32), *bins)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_edge_embedder_plain_matches_xla_twin_bf16():
    args, bins = emb_args(np.random.default_rng(3), 1, 20, 16, 22, same_pos=False)
    got = t_emb.edge_embedder(*emb_to_torch(args, torch.bfloat16), *bins)
    want = j_emb._xla_edge_embedder(*_emb_jax(args, jnp.bfloat16), *bins)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=5e-2, rtol=5e-2)


def test_edge_embedder_plain_matches_pallas_interpret():
    args, bins = emb_args(np.random.default_rng(9), 1, 20, 16, 22)
    got = t_emb.edge_embedder(*emb_to_torch(args, torch.float32), *bins)
    with pltpu.force_tpu_interpret_mode():
        want = j_emb.fused_edge_embedder(
            *_emb_jax(args, jnp.float32), bins_lower=bins[0], bins_upper=bins[1],
            tile_i=8, tile_j=16,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_distance_bins_are_open_intervals():
    """d = 0 and a distance exactly on an edge fall in no bin: the first
    layer then gets no distogram term."""
    rng = np.random.default_rng(11)
    args, _ = emb_args(rng, 1, 6, 8, 4)
    pos = np.zeros((1, 6, 3), np.float32)
    pos[0, 1, 0] = 2.0  # d(0, 1) = 2.0: exactly on an edge below
    pos[0, 2, 0] = 3.0  # d(0, 2) = 3.0: inside bin 1
    args[2] = args[3] = pos
    lower, upper = (0.5, 2.0, 4.0, 6.0), (2.0, 4.0, 6.0, 1e8)
    w_dist = np.eye(4, 8, dtype=np.float32) * 100.0
    base = list(args)
    base[9] = np.zeros_like(w_dist)
    with_dist = list(args)
    with_dist[9] = w_dist
    t = [t_emb.edge_embedder(*emb_to_torch(a, torch.float32), lower, upper).numpy()
         for a in (base, with_dist)]
    same = np.isclose(t[0], t[1]).all(-1)[0]
    assert same[0, 0] and same[0, 1] and same[1, 0]  # d = 0, d on an edge
    assert not same[0, 2]


def test_rel_cp_factors_match_jax():
    seq_idx = np.random.default_rng(12).integers(0, 500, size=(2, 33))
    g, h = t_emb.rel_cp_factors(torch.as_tensor(seq_idx), 32)
    jg, jh = j_emb.rel_cp_factors(jnp.asarray(seq_idx, jnp.int32), 32)
    # Angles reach ~500 pi: float32 sin/cos of such arguments differ between
    # libraries by a few 1e-5.
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4)
    w = np.random.default_rng(13).normal(size=(32, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        t_emb.expand_w_rel(torch.as_tensor(w)).numpy(), np.asarray(j_emb.expand_w_rel(jnp.asarray(w)))
    )


def _wrapper_ast(fn):
    tree = ast.parse(inspect.getsource(fn))
    return tree.body[0]


@pytest.mark.parametrize("wrapper,plain", [
    (t_pair.pair_mlp, "pair_mlp_plain"),
    (t_emb.edge_embedder, "edge_embedder_plain"),
    (t_ipa.ipa_attention, "ipa_attention_plain"),
])
def test_cuda_tensors_never_reach_the_plain_version(wrapper, plain):
    """Read from the dispatch code: the plain version is called in exactly
    one place, the body of ``if <x>.device.type == "cpu": return ...``; no
    ``try`` can fall back to it; the launch count grows only after the C
    function returned 0."""
    fn = _wrapper_ast(wrapper)
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == plain]
    assert len(calls) == 1
    guard = fn.body[1]  # after the docstring
    assert isinstance(guard, ast.If)
    test = guard.test
    assert isinstance(test, ast.Compare) and isinstance(test.ops[0], ast.Eq)
    assert ast.unparse(test.left).endswith(".device.type")
    assert test.comparators[0].value == "cpu"
    assert len(guard.body) == 1 and isinstance(guard.body[0], ast.Return)
    assert guard.body[0].value is calls[0]
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    src = ast.unparse(fn)
    assert src.index("if err != 0") < src.index(".launches += 1")


@pytest.mark.parametrize("module,kernel_mod,function,wrapper,cls", [
    (t_embed_mod, t_emb, "EdgeEmbedderFunction", "edge_embedder", "Embedder"),
    (t_ipa_mod, t_pair, "PairMLPFunction", "pair_mlp", "EdgeTransition"),
])
def test_model_reaches_the_kernels_only_through_the_wrappers(module, kernel_mod, function,
                                                             wrapper, cls):
    """Read from the model's code: the module calls the wrapper's autograd
    Function (``<Function>.apply``), once, in the forward of ``cls`` and
    under no condition, and names the wrapper nowhere else; the Function's
    forward calls the wrapper under no condition. So a CUDA tensor there
    goes to the kernel or raises, with or without gradients."""
    tree = ast.parse(inspect.getsource(module))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == f"{function}.apply"]
    assert len(calls) == 1
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Name) and n.id == wrapper]
    forward = next(f for c in tree.body if isinstance(c, ast.ClassDef) and c.name == cls
                   for f in c.body if isinstance(f, ast.FunctionDef) and f.name == "forward")
    assert any(n is calls[0] for n in ast.walk(forward))
    conditional = [n for n in ast.walk(forward) if isinstance(n, (ast.If, ast.IfExp, ast.Try))
                   and any(m is calls[0] for m in ast.walk(n))]
    assert not conditional
    fn_cls = next(c for c in ast.parse(inspect.getsource(kernel_mod)).body
                  if isinstance(c, ast.ClassDef) and c.name == function)
    fwd = next(f for f in fn_cls.body if isinstance(f, ast.FunctionDef) and f.name == "forward")
    assert [ast.unparse(c.func) for c in ast.walk(fwd) if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Name)] == [wrapper]
    assert not any(isinstance(n, (ast.If, ast.IfExp, ast.Try)) for n in ast.walk(fwd))


def _calls(tree, name):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and ((isinstance(n.func, ast.Name) and n.func.id == name)
                 or (isinstance(n.func, ast.Attribute) and n.func.attr == name))]


def test_ipa_reaches_the_kernel_only_through_its_wrapper():
    """Read from the model's code: ``ipa_attention`` is called once, in
    ``InvariantPointAttention.attend_kernel`` under no condition, and
    ``forward`` calls ``attend_kernel`` exactly when ``self.use_kernel``
    holds; so with the flag on a CUDA tensor reaches the kernel or raises,
    and no ``try`` gives way to the einsum branch."""
    tree = ast.parse(inspect.getsource(t_ipa_mod))
    cls = next(c for c in tree.body if isinstance(c, ast.ClassDef)
               and c.name == "InvariantPointAttention")
    methods = {f.name: f for f in cls.body if isinstance(f, ast.FunctionDef)}
    calls = _calls(tree, "ipa_attention")
    assert len(calls) == 1
    attend = methods["attend_kernel"]
    assert any(n is calls[0] for n in ast.walk(attend))
    assert not any(isinstance(n, (ast.If, ast.IfExp, ast.Try)) for n in ast.walk(attend))
    forward = methods["forward"]
    assert not any(isinstance(n, ast.Try) for n in ast.walk(forward))
    branch = [n for n in ast.walk(forward) if isinstance(n, ast.If)]
    assert len(branch) == 1 and ast.unparse(branch[0].test) == "self.use_kernel"
    assert [ast.unparse(c.func) for c in _calls(ast.Module(branch[0].body, []), "attend_kernel")] \
        == ["self.attend_kernel"]
    assert len(_calls(tree, "attend_kernel")) == 1
    assert not _calls(ast.Module(branch[0].orelse, []), "attend_kernel")


def test_no_port_module_outside_the_wrappers_names_a_plain_version():
    """The plain versions are reached only from their wrappers' CPU branch:
    no other module of the port imports or names them."""
    root = pathlib.Path(t_emb.__file__).resolve().parents[2]
    kernels = {pathlib.Path(m.__file__).resolve() for m in (t_emb, t_pair, t_ipa)}
    for path in sorted(root.rglob("*.py")):
        if path.resolve() in kernels:
            continue
        tree = ast.parse(path.read_text())
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        names |= {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) for a in n.names}
        assert not {"pair_mlp_plain", "edge_embedder_plain", "ipa_attention_plain"} & names, path


@pytest.mark.parametrize("wrapper", ["pair", "emb", "ipa"])
def test_other_devices_raise(wrapper):
    """A tensor on a device that is neither the CPU nor CUDA is refused."""
    if wrapper == "ipa":
        args = ipa_to_torch(ipa_args(np.random.default_rng(0), 1, 6, 2, 8, 4, 4, 16), torch.float32)
        args = [a.to("meta") for a in args]
        with pytest.raises(ValueError, match="unsupported device"):
            t_ipa.ipa_attention(*args, no_heads=2, no_v_points=4)
    elif wrapper == "pair":
        args = pair_to_torch(pair_args(np.random.default_rng(0), 1, 4, 8, 8, 8, True), torch.float32)
        args = [None if a is None else a.to("meta") for a in args]
        with pytest.raises(ValueError, match="unsupported device"):
            t_pair.pair_mlp(*args)
    else:
        args, bins = emb_args(np.random.default_rng(0), 1, 4, 8, 4)
        args = [a.to("meta") for a in emb_to_torch(args, torch.float32)]
        with pytest.raises(ValueError, match="unsupported device"):
            t_emb.edge_embedder(*args, *bins)
