"""The decomposition of the IPA attention kernels (``csrc/ipa_attention.cu``)
checked on the CPU: kernel P's plain version (the pair projection) composed
with kernel S's (the attention given zb and pz) against the one-piece plain
version and the JAX Pallas kernel in interpret mode; a numpy emulation of
kernel S's online softmax over key tiles of 32 and of the combine of a key
split, a tile wholly past N included; the point term's error in TF32 and
3xTF32 at spread points, which puts it on the CUDA cores; the split planner.
The kernels themselves are held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).

    python -m pytest tests/test_torch_ipa_tc.py -s   # prints the point-term errors

Tolerances: composition against the one-piece plain version float32 1e-6
(the same products, in another association); against the Pallas kernel
float32 1e-5, bf16 5e-2 (as tests/test_torch_ipa_attention.py); the
emulated walk against the one-piece softmax 1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import ipa_attention as j_ipa

from framedipt_tpu_torch.model.kernels import ipa_attention as t_ipa
from tests.test_torch_cuda import ipa_args, ipa_to_torch
from tests.test_torch_pair_mlp_tc import product_1xtf32, product_3xtf32
from tests.torch_threads import one_torch_thread  # noqa: F401


H, C, PQ, PV, CZ = 2, 16, 4, 4, 16


def _composed(args):
    q, k, v, qhat, khat, vpt, z, mask, wb, wdz = args
    zb, pz = t_ipa.ipa_pair_projection_plain(z, wb, wdz)
    assert zb.dtype == torch.float32 and zb.shape == (q.shape[0], H, q.shape[1], q.shape[1])
    assert pz.dtype == z.dtype
    return t_ipa.ipa_attend_plain(q, k, v, qhat, khat, vpt, zb, pz, mask, no_heads=H,
                                  no_v_points=PV)


@pytest.mark.parametrize("n", [13, 20])
def test_composition_matches_the_one_piece_plain_version(n):
    args = ipa_to_torch(ipa_args(np.random.default_rng(n), 2, n, H, C, PQ, PV, CZ),
                        torch.float32)
    got = _composed(args)
    want = t_ipa.ipa_attention_plain(*args, no_heads=H, no_v_points=PV)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g.numpy()[0, 1], 0.0)  # fully masked row
        np.testing.assert_array_equal(g.numpy()[:, -3:], 0.0)  # padded tail


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("n", [13, 20])
def test_composition_matches_pallas_interpret(n, dtype, tol):
    B = 2
    args = ipa_args(np.random.default_rng(n + 1), B, n, H, C, PQ, PV, CZ)
    got = _composed(ipa_to_torch(args, getattr(torch, dtype)))
    q, k, v, qp, kp, vp, w, z, mask, wb, wdz = args
    qhat, khat, vpad = j_ipa.build_point_inputs(*(jnp.asarray(x) for x in (qp, kp, vp, w)))
    jd = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        o, opt, opair = j_ipa.fused_ipa_attention(
            jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), qhat, khat, vpad,
            jnp.asarray(z, jd), jnp.asarray(mask), jnp.asarray(wb, jd), jnp.asarray(wdz, jd),
            no_heads=H, c_hidden=C, tile_i=8)
    opt = np.asarray(opt).reshape(B, n, H, j_ipa.PT_PAD)[..., : 3 * PV].reshape(B, n, H * PV, 3)
    for name, g, w in zip(("o", "o_pt", "o_pair"), got, (np.asarray(o), opt, np.asarray(opair))):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0 if tol < 1e-4 else tol,
                                   err_msg=name)
        np.testing.assert_array_equal(g.numpy()[0, 1], 0.0)
        np.testing.assert_array_equal(w[0, 1], 0.0)


def walk(logits, values, splits, per_split, tile=t_ipa.KEY_TILE):
    """Kernel S's arithmetic for one row tile, in float32: each split walks
    its key tiles with a running max m, a running sum l and an unnormalized
    accumulator (rescaled by exp(m_old - m_new) when the max moves; a tile
    with no key yet measures from 0, so exp gives 0 and not NaN); then the
    combine weighs split s by exp(m_s - max m) (0 for a split with no key)
    in split order. Keys past N (logits' width) are -inf."""
    rows, n = logits.shape
    states = []
    for s in range(splits):
        m = np.full(rows, -np.inf, np.float32)
        l = np.zeros(rows, np.float32)
        acc = np.zeros((rows, values.shape[1]), np.float32)
        for t in range(s * per_split, (s + 1) * per_split):
            j = np.arange(t * tile, (t + 1) * tile)
            inside = j < n
            x = np.full((rows, tile), -np.inf, np.float32)
            x[:, inside] = logits[:, j[inside]]
            vt = np.zeros((tile, values.shape[1]), np.float32)
            vt[inside] = values[j[inside]]
            m_new = np.maximum(m, x.max(axis=1))
            m_use = np.where(m_new == -np.inf, np.float32(0), m_new)
            corr = np.exp(m - m_use)
            p = np.exp(x - m_use[:, None])
            l = l * corr + p.sum(axis=1, dtype=np.float32)
            acc = acc * corr[:, None] + p @ vt
            m = m_new
        states.append((m, l, acc))
    if splits == 1:
        m, l, acc = states[0]
        return acc / l[:, None]
    mx = np.max([m for m, _, _ in states], axis=0)
    out = np.zeros_like(states[0][2])
    lsum = np.zeros(rows, np.float32)
    weights = []
    for m, l, _ in states:
        w = np.where(m == -np.inf, np.float32(0), np.exp(m - np.where(mx == -np.inf, 0, mx)))
        weights.append(w)
        lsum = lsum + w * l
    for w, (_, _, acc) in zip(weights, states):
        out = out + (w / lsum)[:, None] * acc
    return out


@pytest.mark.parametrize("n,splits,per_split", [
    (20, 1, 1),    # one ragged tile
    (70, 1, 3),    # three tiles, the last ragged
    (70, 2, 2),    # a split of two tiles and one of one
    (70, 4, 1),    # the fourth split lies wholly past N
    (64, 1, 3),    # one split whose last tile lies wholly past N
    (96, 3, 1),    # tiles that divide N
])
def test_online_softmax_walk_matches_the_one_piece_softmax(n, splits, per_split):
    rng = np.random.default_rng(n + splits)
    rows = 6
    logits = (rng.normal(size=(rows, n)) * 4).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-3:] = 0
    logits += np.float32(1e5) * (mask[None] - 1)  # masked keys, as the mask term gives
    logits[2] -= np.float32(1e5)  # a fully masked row: every logit shifted by -inf = -1e5
    values = rng.normal(size=(n, 5)).astype(np.float32)
    with np.errstate(invalid="raise"):  # any exp(-inf - -inf) would raise
        got = walk(logits, values, splits, per_split)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    want = (e / e.sum(axis=1, keepdims=True)) @ values
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_point_term_needs_float32_on_the_cuda_cores():
    """qhat . khat at the default widths (8 points, 28 lanes) with points as
    the global frame places them (residues ~10 A from the origin, points 3 A
    around them): the augmented sum cancels terms of hundreds. Against the
    plain version's float32 sum (what the kernel is gated on, 1e-4), the
    kernel's float32 fma chain is inside the gate; 3xTF32 (~21 bits) is not,
    and one TF32 product is thousands of times over it."""
    rng = np.random.default_rng(0)
    N, Hh, Pq = 64, 8, 8
    centre = rng.normal(size=(1, N, 1, 1, 3)) * 10.0
    q_pts, k_pts = (torch.as_tensor(centre + rng.normal(size=(1, N, Hh, Pq, 3)) * 3.0,
                                    dtype=torch.float32) for _ in range(2))
    w = torch.nn.functional.softplus(torch.as_tensor(rng.normal(size=Hh), dtype=torch.float32))
    w = w * (3 * Pq * 9.0 / 2) ** -0.5
    qhat, khat, _ = t_ipa.build_point_inputs(q_pts, k_pts, torch.zeros(1, N, Hh, 12, 3), w)
    qhat, khat = qhat[0].reshape(N, Hh, -1), khat[0].reshape(N, Hh, -1)
    plain = torch.einsum("ihe,jhe->ijh", qhat, khat)
    exact = torch.einsum("ihe,jhe->ijh", qhat.double(), khat.double())
    errs = {}
    for name, prod in (("float32 fma chain", None), ("1xTF32", product_1xtf32),
                       ("3xTF32", product_3xtf32)):
        to_plain = to_exact = 0.0
        for h in range(Hh):
            a, b = qhat[:, h], khat[:, h]
            if prod is None:
                got = torch.zeros(N, N)
                for e in range(a.shape[1]):  # the kernel's order: one fma per lane
                    got = (got.double() + a[:, e:e + 1].double() * b[:, e].double()[None]).float()
            else:
                got = prod(a, b.T.contiguous())
            to_plain = max(to_plain, float((got - plain[..., h]).abs().max()))
            to_exact = max(to_exact, float((got.double() - exact[..., h]).abs().max()))
        errs[name] = to_plain
        print(f"point term, {name}: max abs error {to_plain:.3e} against the plain version, "
              f"{to_exact:.3e} against float64 (|logit| up to {float(exact.abs().max()):.0f})")
    assert errs["float32 fma chain"] < 1e-4 / 4
    assert errs["3xTF32"] > 1e-4
    assert errs["1xTF32"] > 1e-2


@pytest.mark.parametrize("N", [1, 17, 31, 32, 33, 100, 128, 200, 256, 384, 512, 640, 768, 1000])
@pytest.mark.parametrize("B", [1, 2, 5])
def test_split_planner_covers_every_key_tile_once(B, N):
    splits, per = t_ipa.plan_ipa_splits(B, N)
    n_tiles = -(-N // t_ipa.KEY_TILE)
    ranges = [range(s * per, min((s + 1) * per, n_tiles)) for s in range(splits)]
    assert all(len(r) for r in ranges)  # no split is empty
    assert [t for r in ranges for t in r] == list(range(n_tiles))
    assert 1 <= splits <= t_ipa.MAX_SPLITS

    def cost(s):  # waves of one-block-an-SM launches x (key tiles + the query tile)
        per_s = -(-n_tiles // s)
        blocks = B * t_ipa.H * -(-N // t_ipa.ROW_TILE) * -(-n_tiles // per_s)
        return -(-blocks // t_ipa.H100_SMS) * (per_s + 1)

    others = range(1, min(n_tiles, t_ipa.MAX_SPLITS) + 1)
    assert cost(splits) == min(cost(s) for s in others)
    assert all(cost(s) > cost(splits) for s in others if s < splits)


@pytest.mark.parametrize("B,N,splits,blocks", [
    (2, 128, 4, 128),  # bucket 128, two samples: one wave
    (2, 256, 2, 128),  # bucket 256, two samples: one wave
    (1, 256, 4, 128),
    (2, 200, 2, 128),
    (1, 512, 2, 128),
    (1, 768, 4, 384),  # three waves of 6 key tiles, not one of 24
])
def test_split_plan_at_the_serving_shapes(B, N, splits, blocks):
    got, per = t_ipa.plan_ipa_splits(B, N)
    assert got == splits
    assert B * t_ipa.H * -(-N // t_ipa.ROW_TILE) * got == blocks
