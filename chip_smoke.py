#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. print the card (``nvidia-smi`` name and power limit); refuse to run
   without CUDA;
2. build the CUDA kernels from ``framedipt_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, in
   float32 (tolerance 1e-4) and bf16 (5e-2), at B=1 N=256, B=2 N=200 (ragged)
   and B=2 N=128 and 256 (the serving shapes), and the IPA attention also at
   B=1 N=768 (a bucket past the JAX kernel's N <= 640 gate) with a fully
   masked row, with random non-zero weights; time the kernel, the plain
   version and compute the bound; the pair MLP without its residual terms
   and the edge embedder without distance bins; and the IPA module's kernel
   branch against its einsum branch at B=2 N=256, both timed (CUDA events,
   and their summed device time under torch.profiler);
4. one full-width forward (default config, N=128) against the recorded
   reference activations in ``tests/parity/fixtures/recorded_full_parity.npz``,
   with the IPA attention as einsums and again through its kernel
   (``model.ipa.use_pallas_ipa``);
5. start the inpainting HTTP service in-process on 127.0.0.1 at the full
   default width with seeded random weights, send three /inpaint requests
   (buckets 256 and 128, two samples each, num_t=100 for two of them), and
   check residue count, finite coordinates, the fixed residues' CA against the
   input, and the kernels' launch counts per request (no IPA launch); then a
   second service with ``model.ipa.use_pallas_ipa=true`` and two requests
   (bucket 256 num_t=100, bucket 128 num_t=25), 4 (num_t + 1) IPA launches
   each, and the first request once more on the default service (request
   times in the order default, IPA, default); then time one model forward
   at the serving shape with the IPA
   kernel off, on, and on with every kernel's plain version, and profile a
   short sampler run with the IPA kernel off and on (device busy share, the
   kernels that take the device's time);
6. the train step at the full default width (float32, inpainting,
   ``model.ipa.pallas_emb_bwd_impl=xla``), B=2 N=256 on helix frames with a
   15-residue diffused loop: the first step against the same step with
   every kernel's plain version (loss and every gradient), then 10 steps at
   lr 1e-4 (finite loss and grad norm, parameters moved, 3 pair-MLP
   backward launches a step), the step time, examples/s, peak memory and
   the device's busy share over 5 steps; and on the card the refusals: a
   pair-MLP backward other than its kernel, the embedder backward kernel
   (not ported yet), the IPA attention kernel under autograd.

Phase 3 also holds the pair-MLP backward kernel against its plain version
(every gradient, float32 and bf16, B=1 N=256, B=2 N=200 ragged with masked
rows, B=2 N=256, residual and not), checks that two launches give the same
bits, and times it at B=2 N=256.

The last two lines are a JSON object with one entry per kernel and the
contract line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# H100 SXM peaks (dense): float32 on the CUDA cores, bf16 on the tensor
# cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
NUM_BLOCKS = 4  # ModelConfig default: edge transitions run num_blocks - 1 times


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_violation(got: torch.Tensor, ref: torch.Tensor, tol: float) -> tuple[float, float]:
    """(max |got - ref|, max of |got - ref| - tol * (1 + |ref|))."""
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()), float((diff - tol * (1.0 + ref.float().abs())).max())


# -- phase 3: kernels against their plain versions -------------------------


def pair_mlp_inputs(B, N, dtype, gen, residual=True):
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype).contiguous()

    mask = torch.ones(B, N, device="cuda")
    mask[:, N - N // 10 :] = 0.0  # padded tail, as a length bucket gives
    mask = mask.to(dtype)
    args = [
        r(B, N, N, 128), r(B, N, 384, scale=0.3), r(B, N, 384, scale=0.3), mask, mask,
        r(128, 384, scale=128**-0.5), r(384, scale=0.1), r(384, 384, scale=384**-0.5),
        r(384, scale=0.1), r(384, 128, scale=384**-0.5), r(128, scale=0.1),
        (1.0 + 0.1 * torch.randn(128, generator=gen, device="cuda")).float(),
        (0.1 * torch.randn(128, generator=gen, device="cuda")).float(),
    ]
    if residual:
        args += [r(B, N, 128, scale=0.3), r(B, N, 128, scale=0.3), r(128, 128, scale=128**-0.5)]
    else:
        args += [None, None, None]
    return args


def pair_mlp_cost(B, N, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    flops = B * N * N * 2 * (128 * 384 + 384 * 384 + 384 * 128 + 128 * 128)
    weights = 128 * 384 + 384 * 384 + 384 * 128 + 128 * 128 + 384 * 2 + 128
    nbytes = es * (2 * B * N * N * 128 + B * N * (2 * 384 + 2 * 128 + 2) + weights) + 4 * 256
    return flops, nbytes


def edge_embedder_inputs(B, N, dtype, gen, n_bins=22):
    from framedipt_tpu_torch.model.kernels.edge_embedder import expand_w_rel, rel_cp_factors

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype).contiguous()

    seq_idx = torch.arange(N, device="cuda")[None].repeat(B, 1)
    seq_idx[:, N // 2 :] += 40  # a chain break
    g, h = rel_cp_factors(seq_idx, 32)
    ca = (torch.randn(B, N, 3, generator=gen, device="cuda") * 8.0).float()
    ca[:, 5] = ca[:, 4]  # a d=0 pair off the diagonal
    mask = torch.ones(B, N, device="cuda")
    mask[:, N - N // 10 :] = 0.0
    mask = mask.to(dtype)
    lower = np.linspace(1e-5, 20.0, n_bins)
    upper = np.concatenate([lower[1:], [1e8]]) if n_bins else lower
    return [
        g.to(dtype).contiguous(), h.to(dtype).contiguous(), ca, ca,
        r(B, N, 128, scale=0.3), r(B, N, 128, scale=0.3), mask, mask,
        expand_w_rel(r(32, 128, scale=0.3)).contiguous(), r(n_bins, 128, scale=0.3),
        r(128, scale=0.1), r(128, 128, scale=128**-0.5), r(128, scale=0.1),
        r(128, 128, scale=128**-0.5), r(128, scale=0.1),
        (1.0 + 0.1 * torch.randn(128, generator=gen, device="cuda")).float(),
        (0.1 * torch.randn(128, generator=gen, device="cuda")).float(),
        tuple(float(x) for x in lower), tuple(float(x) for x in upper),
    ]


def edge_embedder_cost(B, N, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    flops = B * N * N * 2 * (64 * 128 + 128 * 128 + 128 * 128)
    weights = 64 * 128 + 22 * 128 + 2 * 128 * 128 + 3 * 128
    nbytes = (
        es * (B * N * N * 128 + B * N * (2 * 64 + 2 * 128 + 2) + weights)
        + 4 * (B * N * 3 + 2 * 22 + 256)
    )
    return flops, nbytes


IPA_H, IPA_C, IPA_PQ, IPA_PV, IPA_CZ, IPA_DZ = 8, 256, 8, 12, 128, 32


def ipa_attention_inputs(B, N, dtype, gen):
    """The wrapper's arguments at the default widths: q pre-scaled as the
    module scales it, points spread as frames place them, a padded tail and
    one fully masked row (N // 3) inside the chain."""
    from framedipt_tpu_torch.model.kernels.ipa_attention import build_point_inputs

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    H, C, Pq, Pv = IPA_H, IPA_C, IPA_PQ, IPA_PV
    mask = torch.ones(B, N, device="cuda")
    mask[:, N - N // 10 :] = 0.0
    mask[0, N // 3] = 0.0
    w = torch.nn.functional.softplus(r(H)) * (3 * Pq * 9.0 / 2) ** -0.5
    qhat, khat, vpt = build_point_inputs(
        r(B, N, H, Pq, 3, scale=3.0), r(B, N, H, Pq, 3, scale=3.0), r(B, N, H, Pv, 3, scale=3.0), w
    )
    return [
        r(B, N, H * C, scale=(3 * C) ** -0.5).to(dtype), r(B, N, H * C).to(dtype),
        r(B, N, H * C).to(dtype), qhat, khat, vpt, r(B, N, N, IPA_CZ).to(dtype), mask,
        r(IPA_CZ, H, scale=(3 * IPA_CZ) ** -0.5).to(dtype),
        r(IPA_CZ, IPA_DZ, scale=IPA_CZ**-0.5).to(dtype),
    ]


def ipa_attention_cost(B, N, dtype):
    """Operations and bytes of one launch: the scalar and point logits and
    the p.v, p.v_pts products on the useful lanes (3 Pq + 2 = 26, 3 Pv =
    36), the single pair projection onto H + dz lanes, and o_pair; each
    input read once and each output written once."""
    es = torch.tensor([], dtype=dtype).element_size()
    H, C = IPA_H, IPA_C
    pairs = B * N * N
    flops = 2 * pairs * (H * (2 * C + 3 * IPA_PQ + 2 + 3 * IPA_PV)
                         + IPA_CZ * (H + IPA_DZ) + H * IPA_DZ)
    nbytes = (
        es * (3 * B * N * H * C + pairs * IPA_CZ + IPA_CZ * (H + IPA_DZ))
        + 4 * (B * N * H * (2 * 28 + 36) + B * N)
        + 4 * B * N * H * (C + 3 * IPA_PV + IPA_DZ)
    )
    return flops, nbytes


def compare(got, ref, tol: float) -> tuple[float, float]:
    """max_violation over one output or a tuple of outputs."""
    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    errs = [max_violation(g, r, tol) for g, r in pairs]
    return max(e for e, _ in errs), max(x for _, x in errs)


def check_kernels() -> dict[str, dict]:
    from framedipt_tpu_torch.model.kernels.edge_embedder import (
        edge_embedder,
        edge_embedder_plain,
    )
    from framedipt_tpu_torch.model.kernels.ipa_attention import (
        ipa_attention,
        ipa_attention_plain,
    )
    from framedipt_tpu_torch.model.kernels.pair_mlp import pair_mlp, pair_mlp_plain

    ipa_kw = {"no_heads": IPA_H, "no_v_points": IPA_PV}
    serving_shapes = ((1, 256), (2, 200), (2, 128), (2, 256))
    kernels = {
        "edge_embedder": (edge_embedder, edge_embedder_plain, edge_embedder_inputs,
                          edge_embedder_cost, serving_shapes),
        "pair_mlp": (pair_mlp, pair_mlp_plain, pair_mlp_inputs, pair_mlp_cost, serving_shapes),
        "ipa_attention": (lambda *a: ipa_attention(*a, **ipa_kw),
                          lambda *a: ipa_attention_plain(*a, **ipa_kw),
                          ipa_attention_inputs, ipa_attention_cost,
                          serving_shapes + ((1, 768),)),
    }
    serving = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (kernel, plain, make, cost, shapes) in kernels.items():
        for dtype in (torch.float32, torch.bfloat16):
            # (2, 128) and (2, 256) are the serving shapes of phase 5.
            for B, N in shapes:
                args = make(B, N, dtype, gen)
                got = kernel(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                err, excess = compare(got, ref, TOL[dtype])
                outs = got if isinstance(got, tuple) else (got,)
                if not all(torch.isfinite(g.float()).all() for g in outs):
                    raise AssertionError(f"{name} {dtype} B={B} N={N}: non-finite output")
                if name == "ipa_attention" and any((g[0, N // 3] != 0).any() for g in outs):
                    raise AssertionError(f"{name} {dtype} B={B} N={N}: masked row not zero")
                ms = cuda_time_ms(lambda: kernel(*args), 20)
                plain_ms = cuda_time_ms(lambda: plain(*args), 5)
                flops, nbytes = cost(B, N, dtype)
                bound_ms = 1e3 * max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
                bound_by = "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES else "bytes"
                log(
                    f"{name} {str(dtype)[6:]} B={B} N={N}: max_abs_err={err:.3e} "
                    f"(tol {TOL[dtype]} abs+rel) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}), "
                    f"{flops / ms / 1e9:.2f} TFLOP/s"
                )
                if excess > 0:
                    raise AssertionError(f"{name} {dtype} B={B} N={N}: error {err} over tolerance")
                if dtype == torch.float32 and (B, N) == (2, 256):
                    serving[name] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    }
    # The plain-MLP variant (no residual terms) of the pair-MLP kernel, and
    # the edge embedder with no distance bins (a model without the
    # self-conditioning distogram).
    for label, kernel, plain, args in (
        ("pair_mlp residual=False", pair_mlp, pair_mlp_plain,
         pair_mlp_inputs(2, 200, torch.float32, gen, residual=False)),
        ("edge_embedder n_bins=0", edge_embedder, edge_embedder_plain,
         edge_embedder_inputs(2, 200, torch.float32, gen, n_bins=0)),
    ):
        err, excess = max_violation(kernel(*args), plain(*args), TOL[torch.float32])
        log(f"{label} float32 B=2 N=200: max_abs_err={err:.3e}")
        if excess > 0:
            raise AssertionError(f"{label}: error {err} over tolerance")
    torch.cuda.synchronize()
    return serving


def pair_mlp_bwd_cost(B, N, dtype):
    """Operations and bytes of one backward launch: the forward recompute
    and two products per forward product (d-input, d-weight); pair,
    cotangent and d_pair, the O(N) inputs once, the float32 gradients."""
    es = torch.tensor([], dtype=dtype).element_size()
    mlp = 128 * 384 + 384 * 384 + 384 * 128 + 128 * 128
    flops = B * N * N * 3 * 2 * mlp
    nbytes = (es * (3 * B * N * N * 128 + B * N * (2 * 384 + 2 * 128 + 2) + 2 * mlp + 2 * 384 + 128)
              + 4 * (B * N * (2 * 384 + 2 * 128 + 2) + mlp + 2 * 384 + 3 * 128))
    return flops, nbytes


def check_pair_mlp_bwd() -> dict:
    """The pair-MLP backward kernel against its plain version on the card:
    every gradient within tol of its own max-abs (float32 1e-4, bf16 5e-2),
    residual and not; two launches bit-identical; times at B=2 N=256."""
    from framedipt_tpu_torch.model.kernels.pair_mlp import (
        bwd_workspace_floats,
        pair_mlp_bwd,
        pair_mlp_bwd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, N, residual in ((1, 256, True), (2, 200, True), (2, 256, True), (2, 200, False)):
            args = pair_mlp_inputs(B, N, dtype, gen, residual=residual)
            g = torch.randn(B, N, N, 128, generator=gen, device="cuda").to(dtype)
            got = pair_mlp_bwd(g, *args)
            again = pair_mlp_bwd(g, *args)
            ref = pair_mlp_bwd_plain(g, *args)
            torch.cuda.synchronize()
            same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
            worst_rel, worst_abs = 0.0, 0.0
            for i, (a, r) in enumerate(zip(got, ref)):
                if r is None:
                    continue
                if not torch.isfinite(a.float()).all():
                    raise AssertionError(f"pair_mlp_bwd {dtype} B={B} N={N}: gradient {i} not finite")
                err = float((a.float() - r.float()).abs().max())
                rel = err / max(float(r.float().abs().max()), 1e-30)
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            label = f"pair_mlp_bwd {str(dtype)[6:]} B={B} N={N} residual={residual}"
            line = (f"{label}: max err {worst_abs:.3e} abs, {worst_rel:.3e} of the gradient's "
                    f"max-abs (tol {TOL[dtype]}); two launches bit-identical: {same}")
            if (B, N, residual) == (2, 256, True):
                ms = cuda_time_ms(lambda: pair_mlp_bwd(g, *args), 20)
                plain_ms = cuda_time_ms(lambda: pair_mlp_bwd_plain(g, *args), 5)
                flops, nbytes = pair_mlp_bwd_cost(B, N, dtype)
                bound_ms = 1e3 * max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
                bound_by = ("operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES
                            else "bytes")
                blocks = torch.cuda.get_device_properties(0).multi_processor_count
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}), {flops / ms / 1e9:.2f} TFLOP/s, workspace "
                         f"{4 * bwd_workspace_floats(B, N, N, blocks)} bytes ({blocks} blocks)")
                if dtype == torch.float32:
                    out = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            log(line)
            if worst_rel > TOL[dtype] or not same:
                raise AssertionError(f"{label}: error {worst_rel} over tolerance or not deterministic")
    return out


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn``: the summed time of the kernels it
    launches under torch.profiler, over ``iters`` calls (idle gaps left
    out, unlike cuda_time_ms); 0.0 if the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / iters


def compare_ipa_branches(B: int = 2, N: int = 256) -> None:
    """The IPA module's two attention branches on the same call at the
    default widths (random weights, random frames, padded tail): the kernel
    branch (point augmentation, weight preparation, the kernel) against the
    einsum branch (linear_b and down_z over z, logits, softmax, products) on
    the unmasked rows, float32 tolerance; both timed with CUDA events (idle
    gaps included) and by their summed device time."""
    from framedipt_tpu_torch.geometry.rigid import Rigid
    from framedipt_tpu_torch.model.ipa import InvariantPointAttention
    from framedipt_tpu_torch.tools.config import IPAConfig

    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.manual_seed(3)
    ipa = InvariantPointAttention(IPAConfig(), torch.float32).to("cuda").eval()
    qs = torch.randn(B, N, 4, generator=gen, device="cuda")
    rigids = Rigid(qs / qs.norm(dim=-1, keepdim=True),
                   torch.randn(B, N, 3, generator=gen, device="cuda") * 2.0)
    s = torch.randn(B, N, 256, generator=gen, device="cuda")
    z = torch.randn(B, N, N, 128, generator=gen, device="cuda")
    mask = torch.ones(B, N, device="cuda")
    mask[:, 230:] = 0.0
    with torch.inference_mode():
        heads = ipa.project(s, rigids.rot_mats(), rigids.trans)
        got = ipa.attend_kernel(*heads, z, mask)
        ref = ipa.attend_einsum(*heads, z, mask)
        rows = mask[..., None]
        err, excess = compare(tuple(g * (rows if g.dim() == 3 else rows[..., None]) for g in got),
                              tuple(r * (rows if r.dim() == 3 else rows[..., None]) for r in ref),
                              TOL[torch.float32])
        times, dev = {}, {}
        for label in ("einsum", "kernel", "kernel", "einsum"):
            fn = ipa.attend_kernel if label == "kernel" else ipa.attend_einsum
            times.setdefault(label, []).append(cuda_time_ms(lambda: fn(*heads, z, mask), 10))
            dev.setdefault(label, []).append(device_ms(lambda: fn(*heads, z, mask)))
    log(f"IPA module branches float32 B={B} N={N}: max_abs_err={err:.3e} on unmasked rows; "
        f"kernel branch {min(times['kernel']):.4f} ms, einsum branch {min(times['einsum']):.4f} ms "
        f"(best of 2 interleaved runs of 10: {times}); device time per call: kernel branch "
        f"{min(dev['kernel']):.4f} ms, einsum branch {min(dev['einsum']):.4f} ms ({dev})")
    if excess > 0:
        raise AssertionError(f"IPA kernel branch against einsum branch: error {err} over tolerance")


# -- phase 4: full-width forward against the recorded reference ------------


def check_recorded_forward(use_pallas_ipa: bool) -> None:
    from framedipt_tpu_torch.diffusion import SE3Diffuser
    from framedipt_tpu_torch.model import ScoreNetwork
    from framedipt_tpu_torch.model.weights import synth_value
    from framedipt_tpu_torch.tools.config import Config, resolve_kernel_flags

    z = np.load(REPO / "tests" / "parity" / "fixtures" / "recorded_full_parity.npz")
    manifest = json.loads(str(z["param_manifest"]))
    cfg = Config()
    cfg.model.ipa.use_pallas_ipa = use_pallas_ipa
    resolve_kernel_flags(cfg, torch.device("cuda"))
    diffuser = SE3Diffuser(cfg.diffuser, device="cuda")
    net = ScoreNetwork(cfg.model, diffuser, inpainting=True)
    net.load_state_dict(
        {n: torch.as_tensor(synth_value(n, tuple(s))) for n, s in manifest}, strict=True
    )
    net.to("cuda").eval()
    feats = {k[6:]: torch.as_tensor(z[k], device="cuda") for k in z.files if k.startswith("feat::")}
    with torch.inference_mode():
        out = net(feats)
    torch.cuda.synchronize()
    for key, tol in (("psi", 1e-3), ("atom37", 5e-3), ("rot_score", 5e-3), ("trans_score", 5e-3)):
        ref = z[f"out::{key}"]
        got = out[key].float().cpu().numpy()
        rel = float(np.abs(got - ref).max() / max(1.0, float(np.abs(ref).max())))
        log(f"recorded forward N=128 use_pallas_ipa={use_pallas_ipa} {key}: "
            f"rel err {rel:.3e} (tol {tol})")
        if not rel < tol:
            raise AssertionError(f"recorded forward {key}: rel err {rel} >= {tol}")


# -- phase 5: the inpainting service ----------------------------------------


def helix_atom37(n_res: int) -> tuple[np.ndarray, np.ndarray]:
    """atom37 positions + mask of an ideal alpha helix, built by NeRF from
    ideal bond lengths and angles (phi -57, psi -47, omega 180)."""
    from framedipt_tpu_torch.data import constants as rc

    def place(a, b, c, bond, angle_deg, dihedral_deg):
        angle, dihedral = np.radians(angle_deg), np.radians(dihedral_deg)
        bc = (c - b) / np.linalg.norm(c - b)
        n = np.cross(b - a, bc)
        n /= np.linalg.norm(n)
        m = np.cross(n, bc)
        d2 = np.asarray([
            -bond * np.cos(angle),
            bond * np.sin(angle) * np.cos(dihedral),
            bond * np.sin(angle) * np.sin(dihedral),
        ])
        return c + d2[0] * bc + d2[1] * m + d2[2] * n

    phi, psi, omega = -57.0, -47.0, 180.0
    ang = np.radians(180.0 - 111.2)
    atoms = [np.zeros(3), np.asarray([1.458, 0.0, 0.0])]
    atoms.append(atoms[1] + 1.525 * np.asarray([np.cos(ang), np.sin(ang), 0.0]))
    for _ in range(1, n_res):
        n_prev, ca_prev, c_prev = atoms[-3], atoms[-2], atoms[-1]
        n_new = place(n_prev, ca_prev, c_prev, 1.329, 116.2, psi)
        ca_new = place(ca_prev, c_prev, n_new, 1.458, 121.7, omega)
        c_new = place(c_prev, n_new, ca_new, 1.525, 111.2, phi)
        atoms.extend([n_new, ca_new, c_new])
    a = rc.atom_order
    atom37 = np.zeros((n_res, 37, 3))
    mask = np.zeros((n_res, 37))
    for i in range(n_res):
        n_xyz, ca, c = atoms[3 * i], atoms[3 * i + 1], atoms[3 * i + 2]
        atom37[i, a["N"]], atom37[i, a["CA"]], atom37[i, a["C"]] = n_xyz, ca, c
        atom37[i, a["O"]] = place(n_xyz, ca, c, 1.231, 120.8, psi + 180.0)
        mask[i, [a["N"], a["CA"], a["C"], a["O"]]] = 1.0
    return atom37, mask


def helix_pdb(n_res: int, seed: int) -> str:
    from framedipt_tpu_torch.data.protein import Protein, to_pdb

    atom37, mask = helix_atom37(n_res)
    rng = np.random.default_rng(seed)
    return to_pdb(Protein(
        atom_positions=atom37, atom_mask=mask,
        aatype=rng.integers(0, 20, size=n_res), residue_index=np.arange(1, n_res + 1),
        chain_index=np.zeros(n_res, np.int64), b_factors=np.zeros((n_res, 37)),
    ))


KERNEL_NAMES = ("edge_embedder", "pair_mlp", "ipa_attention", "pair_mlp_bwd")


def kernel_wrappers() -> dict:
    from framedipt_tpu_torch.model.kernels.edge_embedder import edge_embedder
    from framedipt_tpu_torch.model.kernels.ipa_attention import ipa_attention
    from framedipt_tpu_torch.model.kernels.pair_mlp import pair_mlp, pair_mlp_bwd

    return {"edge_embedder": edge_embedder, "pair_mlp": pair_mlp,
            "ipa_attention": ipa_attention, "pair_mlp_bwd": pair_mlp_bwd}


def serve_requests(service, requests) -> dict[str, int]:
    """Serve ``requests`` ((length, loop window, num_t), two samples each)
    from ``service`` over HTTP and check every reply and every request's
    launches. The launch counts are set to 0 just before the first request
    and read just after the last; returns them."""
    from http.server import ThreadingHTTPServer

    from framedipt_tpu_torch.data.protein import from_pdb_string
    from framedipt_tpu_torch.experiments.serve import make_handler

    wrappers = kernel_wrappers()
    ipa_on = bool(service.cfg.model.ipa.use_pallas_ipa)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.load(r)["status"] == "ok"
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        for k, (n_res, (start, end), num_t) in enumerate(requests):
            pdb = helix_pdb(n_res, seed=k)
            before = {name: fn.launches for name, fn in wrappers.items()}
            body = json.dumps({
                "pdb": pdb, "chain": "A", "start": start, "end": end,
                "samples": 2, "num_t": num_t,
            }).encode()
            req = urllib.request.Request(
                base + "/inpaint", data=body, headers={"Content-Type": "application/json"}
            )
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=900) as r:
                reply = json.load(r)
            took = time.perf_counter() - t0
            if "samples" not in reply:
                raise AssertionError(f"request {k} failed: {reply}")
            got_launches = {name: fn.launches - before[name] for name, fn in wrappers.items()}
            want = {
                "edge_embedder": num_t + 1,
                "pair_mlp": (NUM_BLOCKS - 1) * (num_t + 1),
                "ipa_attention": NUM_BLOCKS * (num_t + 1) if ipa_on else 0,
                "pair_mlp_bwd": 0,
            }
            if got_launches != want:
                raise AssertionError(f"request {k}: launches {got_launches}, expected {want}")
            ref = from_pdb_string(pdb)
            fixed = np.ones(n_res, bool)
            fixed[start : end + 1] = False
            worst = 0.0
            for s, text in enumerate(reply["samples"]):
                got = from_pdb_string(text)
                if len(got.aatype) != n_res:
                    raise AssertionError(f"request {k} sample {s}: {len(got.aatype)} residues")
                if not np.isfinite(got.atom_positions).all():
                    raise AssertionError(f"request {k} sample {s}: non-finite coordinates")
                ca_err = np.abs(got.atom_positions[fixed, 1] - ref.atom_positions[fixed, 1]).max()
                worst = max(worst, float(ca_err))
                if not ca_err <= 1e-3 + 1e-9:
                    raise AssertionError(f"request {k} sample {s}: fixed CA moved {ca_err} A")
            log(
                f"request {k} (use_pallas_ipa={ipa_on}): N={n_res} "
                f"(bucket {256 if n_res > 128 else 128}), samples=2, num_t={num_t}: "
                f"{took:.3f} s (server {reply['seconds']:.3f} s), launches "
                + " ".join(f"{name}={n}" for name, n in got_launches.items())
                + f", fixed CA max dev {worst:.1e} A"
            )
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def drive_service() -> dict[str, int]:
    """Phase 5: the default service, then one with the IPA attention kernel
    on. Returns each kernel's launches on the path that runs it (the edge
    kernels' from the default service, the IPA kernel's from the second)."""
    from framedipt_tpu_torch.experiments.serve import InpaintingService
    from framedipt_tpu_torch.tools.config import Config, load_config

    cfg = Config()  # full default width: 4 blocks, c_s 256, edge width 128
    cfg.inference.weights_path = ""  # seeded random weights, final layers damped
    t0 = time.perf_counter()
    service = InpaintingService(cfg, device="cuda")
    log(f"service up in {time.perf_counter() - t0:.2f} s")
    # (length, loop window, num_t): lengths land in buckets 256 and 128.
    default = serve_requests(
        service, [(230, (100, 112), 100), (100, (40, 51), 100), (120, (60, 70), 25)]
    )
    log(f"default service launches: {default}")

    cfg_ipa = load_config(["model.ipa.use_pallas_ipa=true"])
    cfg_ipa.inference.weights_path = ""
    t0 = time.perf_counter()
    service_ipa = InpaintingService(cfg_ipa, device="cuda")
    log(f"service (model.ipa.use_pallas_ipa=true) up in {time.perf_counter() - t0:.2f} s")
    with_ipa = serve_requests(service_ipa, [(230, (100, 112), 100), (120, (60, 70), 25)])
    log(f"use_pallas_ipa service launches: {with_ipa}")
    del service_ipa
    torch.cuda.empty_cache()
    # The first request once more on the default service, so the two
    # configurations' request times come in the order default, IPA, default.
    serve_requests(service, [(230, (100, 112), 100)])

    time_forward(service.model)
    for on in (False, True):
        with ipa_kernel(service.model, on):
            profile_sampler(service.model, service.diffuser)
    return {"edge_embedder": default["edge_embedder"], "pair_mlp": default["pair_mlp"],
            "ipa_attention": with_ipa["ipa_attention"]}


@contextlib.contextmanager
def ipa_kernel(model: torch.nn.Module, on: bool):
    """For a timing only: every IPA block of ``model`` takes its kernel
    branch (``on``) or its einsum branch, as ``use_pallas_ipa`` would set."""
    from framedipt_tpu_torch.model.ipa import InvariantPointAttention

    blocks = [m for m in model.modules() if isinstance(m, InvariantPointAttention)]
    saved = [m.use_kernel for m in blocks]
    for m in blocks:
        m.use_kernel = on
    try:
        yield
    finally:
        for m, was in zip(blocks, saved):
            m.use_kernel = was


def serving_feats(B: int = 2, N: int = 256) -> dict[str, torch.Tensor]:
    """Model inputs at the serving shape: a 230-residue chain padded to the
    256 bucket, a 13-residue loop diffused, random frames."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    qs = torch.randn(B, N, 4, generator=gen, device="cuda")
    qs = qs / qs.norm(dim=-1, keepdim=True)
    fixed = torch.ones(B, N, device="cuda")
    fixed[:, 100:113] = 0.0
    res = torch.ones(B, N, device="cuda")
    res[:, 230:] = 0.0
    return {
        "res_mask": res, "fixed_mask": fixed,
        "seq_idx": torch.arange(N, device="cuda")[None].repeat(B, 1),
        "t": torch.full((B,), 0.5, device="cuda"),
        "sc_ca_t": torch.randn(B, N, 3, generator=gen, device="cuda") * 10,
        "rigids_t": torch.cat([qs, torch.randn(B, N, 3, generator=gen, device="cuda") * 10], -1),
        "torsion_angles_sin_cos": torch.randn(B, N, 7, 2, generator=gen, device="cuda"),
        "aatype": torch.randint(0, 20, (B, N), generator=gen, device="cuda"),
    }


@contextlib.contextmanager
def plain_versions_in_model():
    """For a timing or a reference only: the model (and the autograd
    Functions it calls) call the kernels' plain versions in place of the
    wrappers (the library has no such path)."""
    from framedipt_tpu_torch.model import ipa
    from framedipt_tpu_torch.model.kernels import edge_embedder as emb
    from framedipt_tpu_torch.model.kernels import pair_mlp as pm
    from framedipt_tpu_torch.model.kernels.ipa_attention import ipa_attention_plain

    swaps = [(emb, "edge_embedder", emb.edge_embedder_plain),
             (pm, "pair_mlp", pm.pair_mlp_plain), (pm, "pair_mlp_bwd", pm.pair_mlp_bwd_plain),
             (ipa, "ipa_attention", ipa_attention_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def time_forward(model: torch.nn.Module) -> None:
    """One ScoreNetwork forward at the serving shape with the IPA attention
    as einsums ("ipa off"), through its kernel ("ipa on"), and with the IPA
    kernel on and every kernel swapped for its plain version ("plain"); same
    weights, same inputs, interleaved."""
    feats = serving_feats()
    times = {}
    with torch.inference_mode():
        for label in ("ipa off", "ipa on", "plain", "plain", "ipa on", "ipa off"):
            plain = plain_versions_in_model() if label == "plain" else contextlib.nullcontext()
            with ipa_kernel(model, label != "ipa off"), plain:
                times.setdefault(label, []).append(cuda_time_ms(lambda: model(feats), 10))
    log(
        "forward B=2 N=256 float32: "
        + ", ".join(f"{label} {min(t):.3f} ms" for label, t in times.items())
        + f" (best of 2 interleaved runs of 10 forwards each: {times})"
    )


def profile_sampler(model: torch.nn.Module, diffuser, num_t: int = 10) -> None:
    """A short sampler run at the serving shape: its wall time, the device
    time of every kernel in a second run under torch.profiler, and the
    device's busy share (summed device time / unprofiled wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from framedipt_tpu_torch.model.ipa import InvariantPointAttention
    from framedipt_tpu_torch.sampling import sample

    ipa_on = any(m.use_kernel for m in model.modules() if isinstance(m, InvariantPointAttention))
    feats = serving_feats()

    def run() -> None:
        sample(model, diffuser, feats, torch.Generator(device="cuda").manual_seed(2),
               num_t=num_t, min_t=0.01, noise_scale=0.1, inpainting=True)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    device_ms: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device_ms[e.name] = device_ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not device_ms:
        log("sampler profile: torch.profiler recorded no device time (busy share not measured)")
        return
    busy = sum(device_ms.values())
    log(f"sampler B=2 N=256 num_t={num_t} ({num_t + 1} forwards, use_pallas_ipa={ipa_on}): "
        f"{wall_ms:.1f} ms wall, "
        f"{busy:.1f} ms of device time, busy share {busy / wall_ms:.3f}")
    for name, ms in sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:9.3f} ms  {name[:100]}")


# -- phase 6: the train step -------------------------------------------------


# Kernel step against plain-version step, per gradient on the scale of
# max(its own max-abs, 1e-3 x the largest): the kernels sum in other orders
# than cuBLAS (measured worst 3.7e-6 at full width).
TRAIN_TOL = 1e-4


def train_batch(B: int = 2, N: int = 256) -> dict[str, torch.Tensor]:
    """A synthetic training batch: ideal-helix frames centred on the CA
    centroid, torsions from the port's transforms, random residue types, a
    15-residue diffused loop (a different window per sample), the rest
    fixed."""
    from framedipt_tpu_torch.data import transforms

    atom37, mask = helix_atom37(N)
    atom37 = atom37 - atom37[:, 1].mean(axis=0)
    rng = np.random.default_rng(6)
    aatype = rng.integers(0, 20, size=(B, N))
    rigids = np.stack([transforms.backbone_rigid_tensor7(a, atom37, mask) for a in aatype])
    tors = np.stack([transforms.atom37_to_torsion_angles(a, atom37, mask)["torsion_angles_sin_cos"]
                     for a in aatype])
    fixed = np.ones((B, N), np.float32)
    for b in range(B):
        start = 100 + 30 * b
        fixed[b, start : start + 15] = 0.0
    batch = {
        "rigids_0": rigids, "res_mask": np.ones((B, N), np.float32), "fixed_mask": fixed,
        "seq_idx": np.tile(np.arange(N), (B, 1)), "torsion_angles_sin_cos": tors,
        "aatype": aatype,
    }
    return {k: torch.as_tensor(np.asarray(v), device="cuda") for k, v in batch.items()}


def train_config():
    from framedipt_tpu_torch.tools.config import load_config

    cfg = load_config(["model.ipa.pallas_emb_bwd_impl=xla"])  # full default width, float32
    cfg.experiment.inpainting = True
    return cfg


def step_launches(trainer, batch, seed: int) -> tuple[dict, dict[str, int]]:
    """One train step; the launch counts set to 0 just before it and read
    just after."""
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    metrics = trainer.step(batch, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return metrics, {name: fn.launches for name, fn in wrappers.items()}


def expected_launches(self_conditioned: bool) -> dict[str, int]:
    forwards = 2 if self_conditioned else 1  # the coin's forward runs without gradients
    return {"edge_embedder": forwards, "pair_mlp": (NUM_BLOCKS - 1) * forwards,
            "ipa_attention": 0, "pair_mlp_bwd": NUM_BLOCKS - 1}


def check_training_refusals() -> None:
    """On the card: a pair-MLP backward other than its kernel cannot be
    asked for (the override is refused), a trainer with the embedder
    backward kernel ("pallas") raises NotImplementedError until it is
    ported, and the IPA attention kernel refuses to run where autograd
    records."""
    from framedipt_tpu_torch.geometry.rigid import Rigid
    from framedipt_tpu_torch.model.ipa import InvariantPointAttention
    from framedipt_tpu_torch.tools.config import IPAConfig, load_config
    from framedipt_tpu_torch.train.loop import make_trainer

    with expect_raise(KeyError, "pallas_bwd_impl"):
        load_config(["model.ipa.pallas_bwd_impl=xla"])
    cfg = train_config()
    cfg.model.ipa.pallas_emb_bwd_impl = "pallas"
    with expect_raise(NotImplementedError, "ROADMAP queue 2 item 2"):
        make_trainer(cfg, device="cuda")
    ipa = InvariantPointAttention(IPAConfig(), torch.float32).to("cuda")
    B, N = 1, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    qs = torch.randn(B, N, 4, generator=gen, device="cuda")
    rigids = Rigid(qs / qs.norm(dim=-1, keepdim=True), torch.randn(B, N, 3, generator=gen, device="cuda"))
    heads = ipa.project(torch.randn(B, N, 256, generator=gen, device="cuda"), rigids.rot_mats(),
                        rigids.trans)
    with expect_raise(RuntimeError, "forward-only"):
        ipa.attend_kernel(*heads, torch.randn(B, N, N, 128, generator=gen, device="cuda"),
                          torch.ones(B, N, device="cuda"))
    log("training refusals on the card: a pallas_bwd_impl override is refused, "
        "pallas_emb_bwd_impl=pallas raises NotImplementedError, the IPA kernel branch "
        "raises under autograd")


@contextlib.contextmanager
def expect_raise(kind: type, text: str):
    try:
        yield
    except kind as e:
        if text not in str(e):
            raise AssertionError(f"{kind.__name__} without {text!r}: {e}") from e
    else:
        raise AssertionError(f"expected {kind.__name__} ({text})")


def check_train_step() -> int:
    """Phase 6. Returns the pair-MLP backward kernel's launches over the 10
    timed-for-correctness steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from framedipt_tpu_torch.train.loop import make_trainer

    B, N = 2, 256
    batch = train_batch(B, N)
    kern = make_trainer(train_config(), device="cuda")
    plain = make_trainer(train_config(), device="cuda")  # the same seeded weights
    m_k, launches = step_launches(kern, batch, seed=0)
    if launches != expected_launches(m_k["self_conditioned"]):
        raise AssertionError(f"first train step: launches {launches}")
    with plain_versions_in_model():
        m_p = plain.step(batch, torch.Generator(device="cuda").manual_seed(0))
    if m_p["self_conditioned"] != m_k["self_conditioned"]:
        raise AssertionError("the plain step drew another self-conditioning coin")
    grads_k = {n: p.grad for n, p in kern.model.named_parameters() if p.grad is not None}
    grads_p = {n: p.grad for n, p in plain.model.named_parameters() if p.grad is not None}
    if grads_k.keys() != grads_p.keys():
        raise AssertionError("kernel and plain steps give gradients to different parameters")
    largest = max(float(g.abs().max()) for g in grads_p.values())
    worst, worst_name = 0.0, ""
    for name, g in grads_k.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"first train step: gradient of {name} not finite")
        ref = grads_p[name]
        scale = max(float(ref.abs().max()), 1e-3 * largest)
        rel = float((g - ref).abs().max()) / scale
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(float(m_k["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"]))
    log(f"train step B={B} N={N} float32, first step (self_conditioned="
        f"{m_k['self_conditioned']}): loss {float(m_k['loss']):.6f} kernels / "
        f"{float(m_p['loss']):.6f} plain versions (rel {loss_rel:.2e}); grad norm "
        f"{float(m_k['grad_norm']):.4f} / {float(m_p['grad_norm']):.4f}; {len(grads_k)} gradients, "
        f"worst {worst:.2e} of max(own max-abs, 1e-3 x largest) ({worst_name}; tol {TRAIN_TOL}); "
        f"launches {launches}")
    if loss_rel > TRAIN_TOL or worst > TRAIN_TOL:
        raise AssertionError("first train step: kernels and plain versions disagree")
    del plain
    torch.cuda.empty_cache()

    # 10 steps at lr 1e-4: finite, parameters move, 3 backward launches each.
    start = {n: p.detach().clone() for n, p in kern.model.named_parameters()}
    bwd_launches = 0
    for i in range(10):
        m, launches = step_launches(kern, batch, seed=100 + i)
        if not (np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))):
            raise AssertionError(f"train step {i}: loss {m['loss']} grad norm {m['grad_norm']}")
        if launches != expected_launches(m["self_conditioned"]):
            raise AssertionError(f"train step {i}: launches {launches}")
        bwd_launches += launches["pair_mlp_bwd"]
        log(f"  step {i}: loss {float(m['loss']):.4f}, grad norm {float(m['grad_norm']):.4f}, "
            f"t {[round(float(x), 3) for x in m['t']]}, self_conditioned {m['self_conditioned']}")
    # Every parameter the forward reads moves (linear_rbf and linear_3 are
    # kept for checkpoint loading and get no gradient).
    trained = [n for n, p in kern.model.named_parameters() if p.grad is not None]
    still = [n for n, p in kern.model.named_parameters() if n in trained and torch.equal(p, start[n])]
    log(f"  after 10 steps: {len(trained) - len(still)} of {len(trained)} trained parameters "
        f"moved ({len(start) - len(trained)} never read by the forward)")
    if still:
        raise AssertionError(f"parameters did not move: {still}")

    # Step time (CUDA events, after 3 warm steps), peak memory, busy share.
    gen = torch.Generator(device="cuda").manual_seed(200)
    for _ in range(3):
        kern.step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    coins = []
    start_ev.record()
    for _ in range(5):
        coins.append(kern.step(batch, gen)["self_conditioned"])
    end_ev.record()
    torch.cuda.synchronize()
    step_ms = start_ev.elapsed_time(end_ev) / 5
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    for _ in range(5):
        kern.step(batch, gen)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kern.step(batch, gen)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        # Kernels and copies only: the optimizer's record_function range
        # also lands on the device timeline.
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    log(f"train step B={B} N={N} float32 (pallas_emb_bwd_impl=xla): {step_ms:.3f} ms a step "
        f"(CUDA events over 5 steps after 3 warm; self-conditioned {sum(coins)} of 5), "
        f"{1e3 * B / step_ms:.2f} examples/s, peak memory {peak_gb:.3f} GB; 5 more steps "
        f"{wall_ms:.1f} ms wall, " + (f"{busy:.1f} ms of device time, busy share "
                                       f"{busy / wall_ms:.3f}" if by_name else
                                       "torch.profiler recorded no device time (busy share not measured)"))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:9.3f} ms  {name[:100]}")
    return bwd_launches


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 2
    sys.path.insert(0, str(REPO))
    from framedipt_tpu_torch.model.kernels.build import build_all
    from framedipt_tpu_torch.tools.device import set_full_precision_matmul

    set_full_precision_matmul()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    info = build_all()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.2f} s")
    for name, entry in info.items():
        for line in entry["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    torch.cuda.synchronize()

    log("phase 3: kernels against their plain versions")
    serving = check_kernels()
    serving["pair_mlp_bwd"] = check_pair_mlp_bwd()
    compare_ipa_branches()
    log("phase 4: full-width forward against the recorded reference")
    check_recorded_forward(use_pallas_ipa=False)
    check_recorded_forward(use_pallas_ipa=True)
    log("phase 5: inpainting service")
    launches = drive_service()
    log("phase 6: train step")
    check_training_refusals()
    launches["pair_mlp_bwd"] = check_train_step()

    replaces = {
        "edge_embedder": "framedipt_tpu/model/pallas/edge_embedder.py:76",
        "pair_mlp": "framedipt_tpu/model/pallas/pair_mlp.py:78",
        "ipa_attention": "framedipt_tpu/model/pallas/ipa_attention.py:65",
        "pair_mlp_bwd": "framedipt_tpu/model/pallas/pair_mlp.py:349",
    }
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": f"framedipt_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            **serving[name],
        }
        for name in KERNEL_NAMES
    ]
    log(card_line())  # name and power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
