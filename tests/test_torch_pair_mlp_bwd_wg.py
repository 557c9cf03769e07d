"""The float32 pair-MLP backward's kernel A on wgmma and TMA
(``csrc/pair_mlp_bwd_wg.cu``), emulated in torch on the CPU, and what its
route and build rest on.

The emulation takes kernel A's arithmetic: every product (the recompute's
and the input-gradient chain's) as 32-deep slices of 3xTF32 k steps, each
slice summed into a fresh accumulator whose sums the tensor cores truncate
and then added to the running sum with round to nearest
(``tests/test_torch_pair_mlp_tc.py``'s ``product_wgmma_3xtf32``), B's hi
and lo from the weights as stored (elementwise, so the chain's split of W
is that of W^T); the relu decisions are the recompute's. The rest of the
call (row and column sums, kernel B, the ordered sums) is
``tests/test_torch_pair_mlp_bwd_split.py``'s. It is held against the plain
backward through the same relu decisions, against float64 and against the
JAX backward kernel in interpret mode, every gradient within 1e-4 of
max(1, its max-abs). The kernel itself is held against the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

    python -m pytest tests/test_torch_pair_mlp_bwd_wg.py -s   # prints the errors
"""
import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.model.kernels import build
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair

from tests.test_torch_cuda import assert_grads_close, pair_args, pair_to_torch
from tests.test_torch_pair_mlp_bwd_split import NAMES, emulate_split_bwd, kernel_a_float32, rows_cap
from tests.test_torch_pair_mlp_tc import product_wgmma_3xtf32

F32 = torch.float32


@pytest.fixture
def one_thread():
    """The emulation on one torch thread (the suite runs beside others)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def wgmma_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w as kernel A's products compute it: a's rows flattened, w [K, N]
    (a stored weight or its transpose)."""
    flat = product_wgmma_3xtf32(a.reshape(-1, a.shape[-1]).contiguous(), w.contiguous())
    return flat.reshape(*a.shape[:-1], w.shape[1])


def bwd_float64(g, args, relu_masks):
    """Every gradient of the forward in float64 through autograd, the relus
    replaced by the given decisions (y0 > 0, y1 > 0)."""
    (pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj,
     wfe) = [None if a is None else a.double().requires_grad_(i not in (3, 4))
             for i, a in enumerate(args)]
    m0, m1 = (m.double() for m in relu_masks)
    y0 = (pair @ w0 + i_term[:, :, None] + j_term[:, None] + b0) * m0
    y1 = (y0 @ w1 + b1) * m1
    out = y1 @ wf + bf
    if wfe is not None:
        out = out + pair @ wfe + fi[:, :, None] + fj[:, None]
    mean = out.mean(-1, keepdim=True)
    var = ((out - mean) ** 2).mean(-1, keepdim=True)
    y = ((out - mean) / torch.sqrt(var + 1e-6) * ln_scale + ln_bias) \
        * (row_mask[:, :, None] * col_mask[:, None])[..., None]
    ins = [pair, i_term, j_term, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj, wfe]
    grads = torch.autograd.grad(y, [t for t in ins if t is not None], g.double(),
                                allow_unused=True)
    by_name = dict(zip([n for n, t in zip(("pair", "i_term", "j_term", "w0", "b0", "w1", "b1",
                                            "wf", "bf", "ln_scale", "ln_bias", "fi", "fj", "wfe"),
                                           ins) if t is not None], grads))
    # The mask gradients: yln . g summed over the other mask's side.
    yln = ((out - mean) / torch.sqrt(var + 1e-6) * ln_scale + ln_bias).detach()
    dem = (yln * g.double()).sum(-1)
    d_rm = (dem * col_mask.double()[:, None]).sum(2)
    d_cm = (dem * row_mask.double()[:, :, None]).sum(1)
    return (by_name["pair"], by_name["i_term"], by_name["j_term"], d_rm, d_cm, by_name["w0"],
            by_name["b0"], by_name["w1"], by_name["b1"], by_name["wf"], by_name["bf"],
            by_name["ln_scale"], by_name["ln_bias"], by_name.get("fi"), by_name.get("fj"),
            by_name.get("wfe"))


@pytest.mark.parametrize("residual", [True, False])
def test_wgmma_kernel_a_matches_plain_float64_and_jax(residual, one_thread):
    """B=2 N=20 at the kernels' widths, the last rows masked, in 5 chunks of
    8 grid rows: kernel A's arithmetic emulated, with the rest of the split
    backward, against the plain backward through the emulated recompute's
    relu decisions, against float64 through them, and against the JAX
    backward kernel in interpret mode (its own decisions), all 16
    gradients within 1e-4 of max(1, their max-abs)."""
    B, N = 2, 20
    rng = np.random.default_rng(93)
    np_args = pair_args(rng, B, N, 128, 384, 128, residual)
    args = pair_to_torch(np_args, F32)
    g = torch.as_tensor(rng.normal(size=(B, N, N, 128)).astype(np.float32))
    chunks, got = emulate_split_bwd(g, *args, cap=rows_cap(8, N), matmul=wgmma_matmul)
    assert chunks == [(0, 8), (8, 16), (16, 24), (24, 32), (32, 40)]
    a = kernel_a_float32(g, *args, matmul=wgmma_matmul)
    masks = (a["y0"] > 0, a["y1"] > 0)
    plain = t_pair.pair_mlp_bwd_plain(g, *args, relu_masks=masks)
    exact = bwd_float64(g, args, masks)
    ja = [None if x is None else jnp.asarray(x) for x in np_args]
    with pltpu.force_tpu_interpret_mode():
        jax_grads = j_pair.fused_pair_mlp_bwd(jnp.asarray(g.numpy()), *ja, tile_i=8, tile_j=16)
    for label, want in (("plain", plain), ("float64", exact), ("JAX interpret", jax_grads)):
        want = [None if y is None else np.asarray(y.detach() if isinstance(y, torch.Tensor) else y,
                                                  np.float64) for y in want]
        worst = max(float(np.abs(x.double().numpy() - y).max()) / max(1.0, float(np.abs(y).max()))
                    for x, y in zip(got, want) if y is not None)
        print(f"residual={residual}: emulated kernel A against {label}: worst error "
              f"{worst:.3e} of max(1, max-abs)")
        assert_grads_close(got, want, 1e-4, NAMES)
    # The emulated recompute's relu decisions are the plain forward's here.
    y0, y1, _ = t_pair._pre_norm(*args[:3], *args[5:11], *args[13:])
    assert torch.equal(masks[0], y0 > 0) and torch.equal(masks[1], y1 > 0)


def test_chain_weight_split_laid_back_gives_each_stored_weight():
    """The chain's TF32 split (what kernel A's first step writes for the
    input-gradient chain) holds, slot by slot, Wf, W1, W0 and Wfe as stored
    ([in, out], K-major for their transposes): hi and lo TF32 values, hi +
    lo within 2^-22 of each weight's element; it is the forward's split of
    the transposed weights, and Wfe's part is zero without the residual."""
    rng = np.random.default_rng(8)
    args = pair_to_torch(pair_args(rng, 1, 3, 128, 384, 128, True), F32)
    w0, w1, wf, wfe = args[5], args[7], args[9], args[15]
    split = t_pair.chain_weight_split(w0, w1, wf, wfe)
    assert split.shape == (t_pair.WG_SPLIT_FLOATS,)
    off = 0
    for w in (wf, w1, w0, wfe):
        n = w.numel()
        hi, lo = split[off:off + n].view(w.shape), split[off + n:off + 2 * n].view(w.shape)
        assert torch.equal(hi, t_pair.tf32_rna(hi)) and torch.equal(lo, t_pair.tf32_rna(lo))
        err = (hi.double() + lo.double() - w.double()).abs()
        assert bool((err <= 2.0**-22 * w.double().abs()).all())
        off += 2 * n
    assert off == t_pair.WG_SPLIT_FLOATS
    assert torch.equal(split, t_pair.wgmma_weight_split(wf.t(), w1.t(), w0.t(), wfe.t()))
    no_res = t_pair.chain_weight_split(w0, w1, wf)
    assert torch.equal(no_res[:off - 2 * wfe.numel()], split[:off - 2 * wfe.numel()])
    assert not no_res[off - 2 * wfe.numel():].any()


def test_float32_backward_launches_the_wgmma_kernel_a_or_raises():
    """Read from the wrapper: after the CPU branch ``pair_mlp_bwd`` takes
    its route from the dtype once, by the forward's rule
    (``forward_route``: "wgmma" for float32); the "wgmma" route calls
    csrc/pair_mlp_bwd_wg.cu's entry (``_bwd_wg_kernel``) and nothing else,
    the other route csrc/pair_mlp_bwd_wg_bf16.cu's
    (``_bwd_wg_bf16_kernel``); no ``try``. And the C sources: the bf16
    backward's entry and the bf16 forward's take bf16 only (no dtype
    argument)."""
    fn = ast.parse(inspect.getsource(t_pair.pair_mlp_bwd)).body[0]
    routes = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
              and [ast.unparse(t) for t in n.targets] == ["route"]]
    assert [ast.unparse(n.value) for n in routes] == ["forward_route(dtype)"]
    assert t_pair.forward_route(torch.float32) == "wgmma"
    branches = [n for n in ast.walk(fn) if isinstance(n, ast.If)
                and ast.unparse(n.test) == "route == 'wgmma'"]
    assert len(branches) == 2  # the scratch, then the launch

    def called(nodes):
        return {ast.unparse(n.func) for body in nodes for s in body for n in ast.walk(s)
                if isinstance(n, ast.Call)}

    launch = [b for b in branches if "_bwd_wg_kernel()" in called([b.body])]
    assert len(launch) == 1
    assert "_bwd_wg_bf16_kernel()" not in called([launch[0].body])
    assert "_bwd_wg_bf16_kernel()" in called([launch[0].orelse])
    assert "_bwd_wg_kernel()" not in called([launch[0].orelse])
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    bwd = (build.CSRC / "pair_mlp_bwd_wg_bf16.cu").read_text()
    assert 'extern "C" int fdk_pair_mlp_bwd_wg_bf16(int residual, const void* g' in bwd
    assert "int dtype" not in bwd
    fwd = (build.CSRC / "pair_mlp_wg_bf16.cu").read_text()
    assert 'extern "C" int fdk_pair_mlp_wg_bf16(int residual, const void* pair' in fwd
    assert "int dtype" not in fwd


def test_build_names_the_wgmma_backward_source():
    """The build compiles csrc/pair_mlp_bwd_wg.cu into its own library, every
    header it includes (the forward's tile, the split backward's rest) is
    hashed with it (the bf16 backward's file likewise), and neither
    includes mma.sync tile code."""
    assert build.SOURCES["pair_mlp_bwd_wg"] == "pair_mlp_bwd_wg.cu"
    for name in ("pair_mlp_bwd_wg.cu", "pair_mlp_wg.cu", "pair_mlp_bwd_wg_bf16.cu"):
        includes = [line.split('"')[1] for line in (build.CSRC / name).read_text().splitlines()
                    if line.startswith('#include "')]
        assert includes and all(f in build.HEADERS for f in includes), name
    wg = (build.CSRC / "pair_mlp_bwd_wg.cu").read_text()
    assert '#include "pair_mlp_wg.cuh"' in wg and '#include "pair_mlp_split.cuh"' in wg
    assert "pair_mlp_tc.cuh" not in wg and "tc_product.cuh" not in wg
    bf = (build.CSRC / "pair_mlp_bwd_wg_bf16.cu").read_text()
    assert '#include "pair_mlp_wg_bf16.cuh"' in bf and '#include "pair_mlp_split.cuh"' in bf
    assert "tc_product.cuh" not in bf and "mma.sync" not in bf
