#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. print the card (``nvidia-smi`` name and power limit); refuse to run
   without CUDA;
2. build the CUDA kernels from ``framedipt_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, in
   float32 (tolerance 1e-4) and bf16 (5e-2), at B=1 N=256, B=2 N=200 (ragged)
   and B=2 N=128 and 256 (the serving shapes), with random non-zero weights;
   time the kernel, the plain version and compute the bound; and the
   pair MLP without its residual terms and the edge embedder without
   distance bins;
4. one full-width forward (default config, N=128) through the kernels
   against the recorded reference activations in
   ``tests/parity/fixtures/recorded_full_parity.npz``;
5. start the inpainting HTTP service in-process on 127.0.0.1 at the full
   default width with seeded random weights, send three /inpaint requests
   (buckets 256 and 128, two samples each, num_t=100 for two of them), and
   check residue count, finite coordinates, the fixed residues' CA against the
   input, and the kernels' launch counts per request; then time one model
   forward at the serving shape through the kernels and through their plain
   versions, and profile a short sampler run (device busy share, the
   kernels that take the device's time).

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


def check_kernels() -> dict[str, dict]:
    from framedipt_tpu_torch.model.kernels.edge_embedder import (
        edge_embedder,
        edge_embedder_plain,
    )
    from framedipt_tpu_torch.model.kernels.pair_mlp import pair_mlp, pair_mlp_plain

    kernels = {
        "edge_embedder": (edge_embedder, edge_embedder_plain, edge_embedder_inputs,
                          edge_embedder_cost),
        "pair_mlp": (pair_mlp, pair_mlp_plain, pair_mlp_inputs, pair_mlp_cost),
    }
    serving = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (kernel, plain, make, cost) in kernels.items():
        for dtype in (torch.float32, torch.bfloat16):
            # (2, 128) and (2, 256) are the serving shapes of phase 5.
            for B, N in ((1, 256), (2, 200), (2, 128), (2, 256)):
                args = make(B, N, dtype, gen)
                got = kernel(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                err, excess = max_violation(got, ref, TOL[dtype])
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{name} {dtype} B={B} N={N}: non-finite output")
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


# -- phase 4: full-width forward against the recorded reference ------------


def check_recorded_forward() -> None:
    from framedipt_tpu_torch.diffusion import SE3Diffuser
    from framedipt_tpu_torch.model import ScoreNetwork
    from framedipt_tpu_torch.model.weights import synth_value
    from framedipt_tpu_torch.tools.config import Config, resolve_kernel_flags

    z = np.load(REPO / "tests" / "parity" / "fixtures" / "recorded_full_parity.npz")
    manifest = json.loads(str(z["param_manifest"]))
    cfg = Config()
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
        log(f"recorded forward N=128 {key}: rel err {rel:.3e} (tol {tol})")
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


def drive_service() -> tuple[int, int, list[float]]:
    from http.server import ThreadingHTTPServer

    from framedipt_tpu_torch.data.protein import from_pdb_string
    from framedipt_tpu_torch.experiments.serve import InpaintingService, make_handler
    from framedipt_tpu_torch.model.kernels.edge_embedder import edge_embedder
    from framedipt_tpu_torch.model.kernels.pair_mlp import pair_mlp
    from framedipt_tpu_torch.tools.config import Config

    cfg = Config()  # full default width: 4 blocks, c_s 256, edge width 128
    cfg.inference.weights_path = ""  # seeded random weights, final layers damped
    t0 = time.perf_counter()
    service = InpaintingService(cfg, device="cuda")
    log(f"service up in {time.perf_counter() - t0:.2f} s "
        f"(kernels: embedder={service.cfg.model.ipa.use_pallas_embedder}, "
        f"edge transition={service.cfg.model.ipa.use_pallas_kernel})")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    # (length, loop window, num_t): lengths land in buckets 256 and 128.
    requests = [(230, (100, 112), 100), (100, (40, 51), 100), (120, (60, 70), 25)]
    seconds = []
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.load(r)["status"] == "ok"
        torch.cuda.synchronize()
        edge_embedder.launches = 0
        pair_mlp.launches = 0
        for k, (n_res, (start, end), num_t) in enumerate(requests):
            pdb = helix_pdb(n_res, seed=k)
            emb0, pair0 = edge_embedder.launches, pair_mlp.launches
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
            seconds.append(took)
            if "samples" not in reply:
                raise AssertionError(f"request {k} failed: {reply}")
            d_emb = edge_embedder.launches - emb0
            d_pair = pair_mlp.launches - pair0
            if (d_emb, d_pair) != (num_t + 1, (NUM_BLOCKS - 1) * (num_t + 1)):
                raise AssertionError(
                    f"request {k}: launches embedder={d_emb} pair_mlp={d_pair}, expected "
                    f"{num_t + 1} and {(NUM_BLOCKS - 1) * (num_t + 1)}"
                )
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
                f"request {k}: N={n_res} (bucket {256 if n_res > 128 else 128}), samples=2, "
                f"num_t={num_t}: {took:.3f} s (server {reply['seconds']:.3f} s), "
                f"launches embedder={d_emb} pair_mlp={d_pair}, fixed CA max dev {worst:.1e} A"
            )
        torch.cuda.synchronize()
        launches = edge_embedder.launches, pair_mlp.launches
        time_forward(service.model)
        profile_sampler(service.model, service.diffuser)
        return launches[0], launches[1], seconds
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


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
    """For a timing only: the model's modules call the kernels' plain
    versions in place of the wrappers (the library has no such path)."""
    from framedipt_tpu_torch.model import embed, ipa
    from framedipt_tpu_torch.model.kernels.edge_embedder import edge_embedder_plain
    from framedipt_tpu_torch.model.kernels.pair_mlp import pair_mlp_plain

    wrappers = embed.edge_embedder, ipa.pair_mlp
    embed.edge_embedder, ipa.pair_mlp = edge_embedder_plain, pair_mlp_plain
    try:
        yield
    finally:
        embed.edge_embedder, ipa.pair_mlp = wrappers


def time_forward(model: torch.nn.Module) -> None:
    """One ScoreNetwork forward at the serving shape, through the kernels
    and through their plain versions (same weights, same inputs)."""
    feats = serving_feats()
    times = {}
    with torch.inference_mode():
        for label in ("kernels", "plain", "plain", "kernels"):
            with plain_versions_in_model() if label == "plain" else contextlib.nullcontext():
                times.setdefault(label, []).append(cuda_time_ms(lambda: model(feats), 10))
    log(
        f"forward B=2 N=256 float32: kernels {min(times['kernels']):.3f} ms, "
        f"plain versions {min(times['plain']):.3f} ms (best of 2 interleaved runs "
        f"of 10 forwards each: {times})"
    )


def profile_sampler(model: torch.nn.Module, diffuser, num_t: int = 10) -> None:
    """A short sampler run at the serving shape: its wall time, the device
    time of every kernel in a second run under torch.profiler, and the
    device's busy share (summed device time / unprofiled wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from framedipt_tpu_torch.sampling import sample

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
    log(f"sampler B=2 N=256 num_t={num_t} ({num_t + 1} forwards): {wall_ms:.1f} ms wall, "
        f"{busy:.1f} ms of device time, busy share {busy / wall_ms:.3f}")
    for name, ms in sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:9.3f} ms  {name[:100]}")


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
    log("phase 4: full-width forward against the recorded reference")
    check_recorded_forward()
    log("phase 5: inpainting service")
    emb_launches, pair_launches, _ = drive_service()

    replaces = {
        "edge_embedder": "framedipt_tpu/model/pallas/edge_embedder.py:76",
        "pair_mlp": "framedipt_tpu/model/pallas/pair_mlp.py:78",
    }
    launches = {"edge_embedder": emb_launches, "pair_mlp": pair_launches}
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": f"framedipt_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            **serving[name],
        }
        for name in ("edge_embedder", "pair_mlp")
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
