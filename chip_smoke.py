#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. print the card (``nvidia-smi`` name and power limit); refuse to run
   without CUDA;
2. build the CUDA kernels from ``framedipt_tpu_torch/csrc`` (nvcc, sm_90a)
   and the native PDB writer and CIF tokenizer (``framedipt_tpu_torch/
   native``, the host's g++), which must load;
3. hold each kernel against its plain PyTorch version on the card, in
   float32 (tolerance 1e-4) and bf16 (5e-2), at B=1 N=256, B=2 N=200 (ragged)
   and B=2 N=128 and 256 (the serving shapes), the pair MLP and the edge
   embedder also at B=2 and B=1 N=896 (phase 8's batch and its confidence
   score's sample), B=1 N=100 and N=500 (phase 10's de novo samples; 500 a
   partial tile), B=1 N=1 and B=1 N=17 (one partial tile), the pair MLP
   also without its residual terms, and the IPA attention also at B=1 N=1,
   N=17, N=512 and N=768 (a bucket past the JAX kernel's N <= 640 gate) with
   a fully masked row, every kernel with two launches giving the same bits,
   with random non-zero weights; time the kernel, the plain version and
   compute the bound (on the tensor cores, 3xTF32 in float32, with the
   CUDA-core bound beside it; the IPA attention's device ms also by CUDA
   kernel: pair projection, attention, the splits merged with o_pair); the
   pair MLP's two forwards, each at every shape: the wgmma kernel
   (``csrc/pair_mlp_wg.cu``, every float32 forward, differentiated or not)
   and the bf16 wgmma kernel (``csrc/pair_mlp_wg_bf16.cu``, every bf16
   forward, differentiated or not; with and without the residual terms, its
   time beside its bound at B=2 N=256, N=896 and B=1 N=100, its SASS's
   HGMMA, UTMALDG, generic and local LD/ST counts and ptxas's spill report:
   a gate); how the
   tensor cores read a raw float32 operand as TF32 (a probe), the wgmma
   kernel's weight split against ``wgmma_weight_split`` bit for bit, the
   float32 backward's two splits (``wgmma_weight_split``,
   ``chain_weight_split``) likewise, and the HGMMA and UTMALDG instruction
   counts of the wgmma libraries, both backwards' included (float32 kernel B
   is ``csrc/wgrad_wg.cuh`` in each) (``cuobjdump -sass``), and of bf16
   kernel B (``csrc/wgrad_bf16.cuh``'s ``wgrad_bf16_kernel``) in both bf16
   backwards' libraries, with its generic LD/ST (0); the edge
   embedder's two forwards likewise, each at every shape: the wgmma kernel
   (``csrc/edge_embedder_wg.cu``, every float32 forward, differentiated or
   not: both give the same bits) and the mma.sync kernel
   (``csrc/edge_embedder.cu``, every bf16 one), the wgmma kernel at B=2
   N=256 and N=896 with the card's name and power limit, its weight split
   against ``wgmma_weight_split`` bit for bit, the float32 backward's kernel
   A's two splits (``wgmma_weight_split``, ``chain_weight_split``) likewise,
   the HGMMA and UTMALDG counts of its library and kernel A's and their
   generic (non-shared) LD/ST counts; the edge embedder without distance
   bins, in both dtypes; and the IPA
   module's kernel branch against its einsum branch at
   B=2 N=256, both timed (CUDA events, and their summed device time under
   torch.profiler);
4. one full-width forward (default config, N=128) against the recorded
   reference activations in ``tests/parity/fixtures/recorded_full_parity.npz``,
   with the IPA attention as einsums and again through its kernel
   (``model.ipa.use_pallas_ipa``);
5. start the inpainting HTTP service in-process on 127.0.0.1 at the full
   default width with random weights (the JAX package's initialization,
   seeded), send three /inpaint requests
   (buckets 256 and 128, two samples each, num_t=100 for two of them), and
   check residue count, finite coordinates, the fixed residues' CA against the
   input, and the kernels' launch counts per request (no IPA launch; every
   pair-MLP and edge-embedder launch on its wgmma kernel); then a
   second service with ``model.ipa.use_pallas_ipa=true`` and two requests
   (bucket 256 num_t=100, bucket 128 num_t=25), 4 (num_t + 1) IPA launches
   each, and the first request once more on the default service (request
   times in the order default, IPA, default); then time one model forward
   at the serving shape with the IPA
   kernel off, on, and on with every kernel's plain version, and profile a
   short sampler run with the IPA kernel off and on (device busy share, the
   kernels that take the device's time); then a bf16 service
   (``model.compute_dtype=bfloat16``): one request (bucket 256, num_t=100),
   every pair-MLP launch on ``csrc/pair_mlp_wg_bf16.cu``, and a short bf16
   sampler run profiled;
6. the train step at the full default width (float32, inpainting, the
   default ``model.ipa.pallas_emb_bwd_impl=pallas``: the embedder's
   backward kernel; the test fixtures' weights, whose final layers are
   not 0, so every gradient is checked), B=2 N=256 on helix frames with a 15-residue diffused
   loop: the first step against the same step with every kernel's plain
   version and against the step with the ``xla`` embedder backward (loss
   and every gradient), then 10 steps at lr 1e-4 (finite loss and grad
   norm, parameters moved, 3 pair-MLP and 1 embedder backward launches a
   step, every pair-MLP and embedder forward and backward on the wgmma
   kernels (``csrc/pair_mlp_wg.cu``, ``csrc/pair_mlp_bwd_wg.cu``,
   ``csrc/edge_embedder_wg.cu``, ``csrc/edge_embedder_bwd_wg.cu``), the
   autograd forward's and the self-conditioning forward's alike); the same step
   in bf16 (``model.compute_dtype=bfloat16``; the pair-MLP forwards and
   backwards on the bf16 wgmma kernels, ``csrc/pair_mlp_wg_bf16.cu`` and
   ``csrc/pair_mlp_bwd_wg_bf16.cu``, the embedder's on mma.sync): its
   first step's loss within 5e-2 of the plain-version bf16 step's, each
   gradient's error against its max-abs printed, then 3 steps (finite, the
   same launches); the step time, examples/s and peak memory of the three
   settings and the device's busy share and device time by kernel over 5
   float32 and 5 bf16 steps; and on the card the refusals: a
   pair-MLP backward other than its kernel, the IPA attention kernel under
   autograd;
7. the training CLI at the full default width (float32, inpainting): the
   fixture mmCIF files preprocessed by the port's pipeline into a temporary
   directory (single chains of 11-242 residues, buckets 64-256), ``train()``
   from the JAX package's initialization for 14-21 steps with checkpoints (the early one included) and one eval
   inside the run, a resumed run of three more epochs (timed with the input
   pipeline), the same number of steps timed on batches already on the card
   and profiled for the device's busy share, and the last checkpoint
   loaded into the inpainting service for one /inpaint request: finite
   losses, one embedder backward launch a step, the checkpoint files, the
   resumed step count, the reply's residue count and fixed CA;
8. the batch inpainting CLI in-process at the full default width (float32,
   the JAX package's initialization): the TCR database's pMHC-II complexes
   in ``tests/data/cifs`` (801-819 residues, bucket 896), CDR3 of both TCR
   chains, 2 samples of num_t=100 in one sampler call a complex: the tree
   (ground truth with the diffused residues marked, diffusion_info.csv
   with its regions inside TCR chains A and B, each sample's structure and
   both trajectories), finite coordinates, the fixed CA equal to the ground
   truth's within 1e-3 A, and the launches of each case (edge embedder
   num_t+1, pair MLP 3 (num_t+1), no IPA); the seconds per structure, the
   writer's time and the device's busy share of one case; a second run over
   the tree writes nothing; the serial loop on one complex; then on the
   test fixtures' weights: the EigenFold confidence score on one sample at
   num_t=25 against the same score through every kernel's plain version
   (CONFIDENCE_TOL relative), and one structure at noise_scale=0, num_t=5,
   against the plain-version run (fixed CA within 1e-3 A, diffused CA
   within DIFFUSED_CA_TOL). The native PDB writer (``native/pdb_writer.cpp``,
   built by the host's g++) must load, so the CLI writes no text in Python;
   one real trajectory (the first case's sample 0 bb_traj, 100 models) is
   byte-equal as the CLI's file, the native text and the Python writer's
   text, both writers timed on it; the writer's seconds and the seconds a
   structure are printed beside those of the Python writer before it;
9. the TCR evaluation CLI (``python -m framedipt_tpu_torch.eval.tcr_eval``)
   over phase 8's batched tree, with ``--sasa`` and without, each timed:
   one row a sample (6) with a finite backbone RMSD overall and per TCR
   chain, one row a complex (3) in each of the five strategies' CSVs, the
   RSA columns with ``--sasa``, and the plots drawn where matplotlib and
   seaborn import, else skipped with the CLI's warning;
10. de novo design at the full default width (float32): (a) the reference
    model at the de novo config (``inpainting=False``: the embedder without
    aatype) with the weights of ``recorded_denovo_parity.npz``'s manifest,
    its N=128 forward through the kernels within 5e-3 relative and its
    100-step reverse trajectory at noise_scale 0 within 0.1 A CA-RMSD final
    and 0.5 A at the worst step; (b) the port's ProteinMPNN on the card
    against the recorded reference ProteinMPNN
    (``recorded_mpnn_parity.npz`` and ``recorded_mpnn_ca_parity.npz``):
    every log-probability variant and the scores within 2e-4 (the CA-only
    model's within 3e-2, its argmax equal), the near-greedy and tied
    samples equal, the tied and PSSM probs within 2e-4; (c) the de novo CLI
    in-process (``inference.inpainting=false``, the JAX package's
    initialization) at lengths 100 and 500, one sample each of num_t 100,
    with the self-consistency check's in-process ProteinMPNN on (b)'s
    vanilla weights (8 sequences a backbone) and no ESMFold (a warning a
    sample): the tree, each sample's residue count and finite coordinates,
    both trajectories, one ``seqs/*.fa`` a sample with 8 sequences of the
    sample's length over the alphabet without X, the launches of each
    sample (edge embedder num_t+1, pair MLP 3 (num_t+1), no IPA); the
    sampler's, the writer's and the design's seconds a sample, the
    design's seconds a backbone with the weights loaded, and the device's
    busy share of one N=500 sample and of one N=500 design; a second run
    writes nothing; (d) the TM-score and aligned RMSD of the N=500 sample
    against itself and a rotated, translated copy (TM 1, RMSD < 1e-3 A);
11. ProteinMPNN training at the published width (hidden 128, 3 + 3 layers,
    48 neighbours; float32, TF32 off): (a) the train step on the recorded
    ProteinMPNN's structure and weights (dropout 0, no noise, the
    recording's decoding order): its loss within 2e-4 (relative) of the
    smoothed loss of the recorded log-probabilities, every gradient within
    1e-4 of its max-abs of the same step on the CPU; then 20 steps with
    noise 0.2 and dropout 0.1: finite losses, the parameters moved, the
    loss without noise and dropout lower after than before; (b) the
    training CLI (``python -m framedipt_tpu_torch.experiments.train_mpnn``)
    in-process over the fixture complexes preprocessed without a chain
    length cap (801-820 residues, five chains each; crops of 512, batch 8),
    20 steps warm-started from (a)'s weights, an eval and a checkpoint every
    10: the metrics rows, finite values, ``step_10.npz``, ``step_20.npz``,
    ``last.npz``; ``last.npz`` through the designer, 8 sequences for one
    complex; a warm start whose neighbour count differs refused; (c) the
    train step at B=8 L=512 (crops of 512 of the complexes, every row
    valid): ms a step, valid residues a second, peak memory, the step's
    FLOP count and its bound at float32's CUDA-core peak, and the busy
    share and device time by kernel over 2 steps;
12. evaluation, the host tools and the CIF tokenizer, each timed: (a) the de
    novo evaluation (``eval/denovo_eval.py``) over phase 10's tree: scipy
    diversity, foldseek absent (a warning), 2 samples, 2 composition rows;
    (b) ``python -m framedipt_tpu_torch.eval.cg2all_eval --skip_convert``
    over phase 8's tree, each sample's ``_all_atom.pdb`` a copy of its
    backbone PDB (cg2all is not installed): 6 rows, finite RMSDs, the
    full-atom RMSD equal to the RMSD over the sample's N, CA, C, CB and O
    recomputed; (c) the monomer PDB preprocessing CLI over phase 10's two
    samples: 2 rows and their pickles; (d) the inpainting CLI's database
    flow in-process (``inference.inpainting_samples.download_dir`` with the
    three fixture CIFs in ``cifs/``, the pMHC-II database CSV, 1 sample of
    num_t 5; RCSB pointed at an empty local directory and every URL that
    is not a local file refused, so the 15 other listed complexes log the
    offline download warning): phase 8's tree checks and launches for the
    three cases, the cached ``metadata.csv`` reused by a second run; (e)
    ``python -m framedipt_tpu_torch.tools.sweep --devices 0`` over two de
    novo CLI jobs (length 100, num_t 2 and 5): rc 0, ``sweep_job0`` and
    ``sweep_job1`` with their samples; (f) ``tools/profiling.trace`` around
    a 3-step sampler run at B=1 N=256: the Chrome trace names the pair-MLP
    and edge-embedder CUDA kernels, as many times as they launch; (g) the
    fixture CIFs through the native and the Python CIF parser, 5 times
    each: equal dicts, the seconds of each and the ratio;
13. the multi-process paths (``parallel/``), their backend chosen before any
    rank starts (NCCL where every rank has a card of its own, else gloo with
    two ranks on the one card), each part spawned under a time limit of its
    own: (a) in one process, each rank's row block at sp 2 and 4 (B=2, N=896
    and the ragged N=230, float32 and bf16) through the pair-MLP kernels
    and edge-embedder kernels (the wgmma ones in float32; in bf16 the
    pair MLP's wgmma kernel, as the samplers run it, and the embedder's
    mma.sync one) against the same rows of the full launch (largest
    difference within the kernel tolerance, bits equal or not, padded rows
    0), each block timed beside the full launch; (b) the sequence-parallel
    sampler, two ranks at sp=2, full width, B=2, N=896, num_t 10, the test
    fixtures' weights, against the one-process sampler on the card
    (final_rigids 2e-5, prot_traj 2e-4), the ranks' final_rigids bit-equal,
    the launches a rank (the wgmma embedder num_t+1, the wgmma pair MLP 3
    (num_t+1), no mma.sync pair MLP or embedder, no IPA),
    each rank's peak memory beside the one process's, seconds a forward;
    (c) the train step at dp=2, global B=4, N=256, float32, 3 steps from the
    fixtures' weights with Adam's eps at 1e-3 against the one-process step
    on the whole batch (each step's loss and grad norm 1e-5 relative and
    gradients within 1e-4 of max(their max-abs, 1e-3 of the largest); the
    parameters after the first and the third step within 1e-5 of their
    max-abs but where the gradient is 0 in exact arithmetic, the key biases
    the softmax cancels), ms a step and peak memory a rank; at (dp=1,
    fsdp=2) only with two cards, else a line saying why not; (d) the training CLI under ``torchrun --standalone
    --nproc_per_node=1`` (2 with two cards) with ``experiment.dp_size``: a
    few steps, one line a step in metrics.jsonl, one eval, the checkpoint
    served for one /inpaint request.

Phase 3 also holds the two backward kernels against their plain versions
(every gradient, float32 and bf16, B=1 N=1, N=17 and 256, B=2 N=200 ragged
with masked rows, B=2 N=256; the pair MLP residual and not, the embedder
with 22 and 0 distance bins; B=2 N=200 also in 10 chunks under a small
workspace cap), checks that two launches give the same bits, and times them
at B=2 N=256 in both dtypes, also by part: kernel A (on wgmma and TMA:
``csrc/pair_mlp_bwd_wg.cu``, ``csrc/pair_mlp_bwd_wg_bf16.cu`` and
``csrc/edge_embedder_bwd_wg.cu``; the pair MLP's bound by the larger of
its operations and its bytes, the workspace it writes included),
its weight splits, kernel B (on wgmma and TMA; float32:
``csrc/wgrad_wg.cuh``, bf16: ``csrc/wgrad_bf16.cuh``), the row/column sums,
the ordered reductions, under torch.profiler, with the chunk count, workspace bytes and
each kernel's bound on the tensor cores (the embedder's kernel A and sums
also by their bytes); the embedder's also beside the ``xla`` setting's
backward, the VJP of its plain forward. Kernel B also runs alone
(``wgrad_f32``, ``wgrad_bf16``) against float64 at one pair, 289 pairs, a
ragged 80,000-pair chunk and the embedder's 64-row job, two launches
bit-identical, and its bound at each call site (float32 and bf16: the
larger of its operations and its distinct workspace rows' bytes) is printed
beside the same products as ``torch.mm`` calls in the dtype (float32 with
TF32 off; their device time under torch.profiler, comparable with kernel
B's, and their CUDA-event time, each the median of five rounds). The
backwards' recompute must equal the forward kernel's output bit for bit,
and their gradients are held against the plain backward through the
recompute's relu decisions, after every relu site where the plain forward
decides otherwise is shown to hold an activation within the dtype's
tolerance of 0 (float32 1e-4, bf16 5e-2; the count of such sites and the
largest there are printed).

The last two lines are a JSON object with one entry per kernel (its
``launches`` from the path that runs it first: phases 5, 6 and 7, the
pair MLP's backwards (float32 ``pair_mlp_bwd_wg``, bf16
``pair_mlp_bwd_wg_bf16``) and the bf16 embedder backward
``edge_embedder_bwd`` from phase 6's steps, the edge embedder's mma.sync
kernel from phase 5's bf16 request, the float32 embedder backward
``edge_embedder_bwd_wg`` from phase 7's; ``train_launches`` from phase 6's
float32 and bf16 steps;
``inference_cli_launches`` from phase 8's batched run,
``denovo_cli_launches`` from phase 10's de novo run,
``database_cli_launches`` from phase 12's database flow, ``sp_launches``
and ``dp_launches`` from phase 13's (b) and (c), both ranks together) and
the contract line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import re
import subprocess
import sys
import tempfile
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
# A kernel whose float32 products run on the tensor cores as 3xTF32 does
# three TF32 products (495 TFLOP/s) for each float32 one.
TENSOR_CORE_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
TENSOR_CORE_KERNELS = ("pair_mlp_wg", "pair_mlp_wg_bf16", "ipa_attention",
                       "edge_embedder", "edge_embedder_wg")
# The IPA attention's CUDA kernels by name: kernel P (pair projection),
# kernel S (attention), kernel F (the key splits merged, o_pair).
IPA_PARTS = (("P", "pair_proj_kernel"), ("S", "attend_kernel"), ("F", "finish_kernel"))
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
    if N > 5:
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


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes"): the larger of
    the operations over ``peak_flops`` and the bytes over the HBM rate."""
    ops_ms, bytes_ms = 1e3 * flops / peak_flops, 1e3 * nbytes / PEAK_BYTES
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def compare(got, ref, tol: float) -> tuple[float, float]:
    """max_violation over one output or a tuple of outputs."""
    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    errs = [max_violation(g, r, tol) for g, r in pairs]
    return max(e for e, _ in errs), max(x for _, x in errs)


def ipa_parts_line(kernel, args, B: int, N: int) -> str:
    """The IPA attention call's device ms (torch.profiler), whole and by
    CUDA kernel, with the key-split plan."""
    from framedipt_tpu_torch.model.kernels.ipa_attention import plan_ipa_splits

    total, by_name = device_time(lambda: kernel(*args))
    parts = {label: sum(ms for n, ms in by_name.items() if key in n) for label, key in IPA_PARTS}
    splits, per = plan_ipa_splits(B, N, torch.cuda.get_device_properties(0).multi_processor_count)
    return (f"; device {total:.4f} ms: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f" ({splits} key splits of {per} tiles)")


def check_kernels() -> dict[str, dict]:
    from framedipt_tpu_torch.model.kernels.edge_embedder import (
        EdgeEmbedderFunction,
        edge_embedder,
        edge_embedder_plain,
    )
    from framedipt_tpu_torch.model.kernels.ipa_attention import (
        ipa_attention,
        ipa_attention_plain,
    )
    from framedipt_tpu_torch.model.kernels.pair_mlp import pair_mlp, pair_mlp_plain

    def edge_embedder_differentiated(*args):
        """The forward autograd records: the Function on inputs that
        require gradients (float32: csrc/edge_embedder_wg.cu too)."""
        *tensors, lower, upper = args
        with torch.enable_grad():
            tensors = [t.detach().requires_grad_() for t in tensors]
            return EdgeEmbedderFunction.apply("pallas", lower, upper, *tensors).detach()

    ipa_kw = {"no_heads": IPA_H, "no_v_points": IPA_PV}
    both = (torch.float32, torch.bfloat16)
    serving_shapes = ((1, 256), (2, 200), (2, 128), (2, 256))
    # Phase 8's: the CLI's batch of two samples at bucket 896, and the
    # confidence score's one sample.
    cli_shapes = ((2, 896), (1, 896))
    # Phase 10's de novo samples: one structure of exactly N residues.
    denovo_shapes = ((1, 100), (1, 500))
    edge_shapes = serving_shapes + cli_shapes + denovo_shapes + ((1, 1), (1, 17))
    kernels = {
        # Tiny and ragged shapes too: one pair, one partial tile. The edge
        # embedder's two forwards: csrc/edge_embedder.cu (mma.sync; every
        # bf16 forward) and csrc/edge_embedder_wg.cu (wgmma; every float32
        # forward, differentiated or not), each as edge_embedder's route
        # picks it.
        "edge_embedder": (edge_embedder, edge_embedder_plain, edge_embedder_inputs,
                          edge_embedder_cost, edge_shapes, (torch.bfloat16,)),
        "edge_embedder_wg": (edge_embedder, edge_embedder_plain, edge_embedder_inputs,
                             edge_embedder_cost, edge_shapes, (torch.float32,)),
        # The pair MLP's two forwards: csrc/pair_mlp_wg_bf16.cu (wgmma;
        # every bf16 forward) and csrc/pair_mlp_wg.cu (wgmma; every float32
        # forward), differentiated or not, each as pair_mlp's route picks it.
        "pair_mlp_wg_bf16": (pair_mlp, pair_mlp_plain, pair_mlp_inputs, pair_mlp_cost,
                             edge_shapes, (torch.bfloat16,)),
        "pair_mlp_wg": (pair_mlp, pair_mlp_plain, pair_mlp_inputs, pair_mlp_cost, edge_shapes,
                        (torch.float32,)),
        "ipa_attention": (lambda *a: ipa_attention(*a, **ipa_kw),
                          lambda *a: ipa_attention_plain(*a, **ipa_kw),
                          ipa_attention_inputs, ipa_attention_cost,
                          serving_shapes + ((1, 1), (1, 17), (1, 512), (1, 768)), both),
    }
    serving = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (kernel, plain, make, cost, shapes, dtypes) in kernels.items():
        for dtype in dtypes:
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
                again = kernel(*args)
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(x, y) for x, y in zip(outs, again)):
                    raise AssertionError(f"{name} {dtype} B={B} N={N}: two launches differ")
                ms = cuda_time_ms(lambda: kernel(*args), 20)
                plain_ms = cuda_time_ms(lambda: plain(*args), 5)
                flops, nbytes = cost(B, N, dtype)
                tensor_cores = name in TENSOR_CORE_KERNELS
                bound_ms, bound_by = bound(
                    flops, nbytes, (TENSOR_CORE_FLOPS if tensor_cores else PEAK_FLOPS)[dtype])
                line = (f"{name} {str(dtype)[6:]} B={B} N={N}: max_abs_err={err:.3e} "
                        f"(tol {TOL[dtype]} abs+rel) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"bound {bound_ms:.4f} ms ({bound_by}), "
                        f"{flops / ms / 1e9:.2f} TFLOP/s")
                if tensor_cores and dtype == torch.float32:
                    line += (f"; 3xTF32 bound, CUDA-core bound "
                             f"{bound(flops, nbytes, PEAK_FLOPS[dtype])[0]:.4f} ms")
                if name == "pair_mlp_wg_bf16" and (B, N) in ((2, 256), (2, 896), (1, 100)):
                    line += f"; {ms / bound_ms:.2f}x the bound; {card_line()}"
                if name == "edge_embedder_wg":
                    # The differentiated float32 forward is the same kernel.
                    if not torch.equal(got, edge_embedder_differentiated(*args)):
                        raise AssertionError(f"{name} B={B} N={N}: the differentiated forward's "
                                             "bits differ")
                    line += "; the differentiated forward's bits equal"
                    if (B, N) in ((2, 256), (2, 896)):
                        line += f"; {ms / bound_ms:.2f}x the bound; {card_line()}"
                line += "; two launches bit-identical"
                if name == "ipa_attention":
                    line += ipa_parts_line(kernel, args, B, N)
                log(line)
                if excess > 0:
                    raise AssertionError(f"{name} {dtype} B={B} N={N}: error {err} over tolerance")
                if dtype == dtypes[0] and (B, N) == (2, 256):  # float32, else bf16
                    serving[name] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    }
    # The plain-MLP variant (no residual terms) of the pair-MLP kernel, and
    # the edge embedder with no distance bins (a model without the
    # self-conditioning distogram).
    checks = [(f"pair_mlp_wg_bf16 residual=False bfloat16 B={B} N={N}", pair_mlp,
                pair_mlp_plain, pair_mlp_inputs(B, N, torch.bfloat16, gen, residual=False),
                TOL[torch.bfloat16]) for B, N in edge_shapes]
    checks += [(f"pair_mlp_wg residual=False float32 B={B} N={N}", pair_mlp, pair_mlp_plain,
                pair_mlp_inputs(B, N, torch.float32, gen, residual=False), TOL[torch.float32])
               for B, N in ((1, 17), (2, 200))]
    checks += [("edge_embedder n_bins=0 bfloat16 B=2 N=200", edge_embedder,
                edge_embedder_plain, edge_embedder_inputs(2, 200, torch.bfloat16, gen, n_bins=0),
                TOL[torch.bfloat16])]
    checks += [("edge_embedder_wg n_bins=0 float32 B=2 N=200", edge_embedder, edge_embedder_plain,
                edge_embedder_inputs(2, 200, torch.float32, gen, n_bins=0), TOL[torch.float32])]
    for label, kernel, plain, args, tol in checks:
        got = kernel(*args)
        err, excess = max_violation(got, plain(*args), tol)
        log(f"{label}: max_abs_err={err:.3e} (tol {tol} abs+rel); two launches bit-identical")
        if excess > 0:
            raise AssertionError(f"{label}: error {err} over tolerance")
        if not torch.equal(got, kernel(*args)):
            raise AssertionError(f"{label}: two launches differ")
    torch.cuda.synchronize()
    check_wgmma_pieces(gen)
    check_bf16_forward_build()
    return serving


def check_bf16_forward_build() -> None:
    """The bf16 forward's kernel (pair_mlp_wg_bf16_kernel) as built: HGMMA
    and UTMALDG instructions, no generic load or store, and no spill in
    ptxas's report of either instance."""
    from framedipt_tpu_torch.model.kernels import build

    c = function_counts("pair_mlp_wg_bf16", "pair_mlp_wg_bf16_kernel",
                        ("HGMMA", "UTMALDG", "LD", "ST", "LDS", "STS", "LDL", "STL"))
    report, fn = [], ""
    for line in build.build_log.get("pair_mlp_wg_bf16", {}).get("log", "").splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
        elif "spill" in line and "pair_mlp_wg_bf16_kernel" in fn:
            report.append(line.strip())
    spilled = [r for r in report if "0 bytes spill stores, 0 bytes spill loads" not in r]
    log(f"pair_mlp_wg_bf16: pair_mlp_wg_bf16_kernel {c['HGMMA']} HGMMA and {c['UTMALDG']} UTMALDG "
        f"instructions, {c['LD']} generic LD and {c['ST']} generic ST, {c['LDS']} LDS and "
        f"{c['STS']} STS, {c['LDL']} LDL and {c['STL']} STL (cuobjdump -sass); ptxas: "
        + ("; ".join(report) or "no report (the library was built before this run)"))
    if not (c["HGMMA"] and c["UTMALDG"]) or c["LD"] or c["ST"] or c["LDL"] or c["STL"] or spilled:
        raise AssertionError("pair_mlp_wg_bf16_kernel lacks HGMMA or UTMALDG, has generic or "
                             f"local loads or stores, or spills: {spilled}")


def check_wgmma_pieces(gen) -> None:
    """The wgmma forwards' pieces on the card: how the tensor cores read a
    float32 operand that is not a TF32 value (one wgmma with b's raw values;
    the kernels hand it TF32 values, so either reading gives their bits), the
    weights' TF32 parts each kernel's first step writes (equal to its
    module's wgmma_weight_split, bit for bit), and the HGMMA and UTMALDG
    instructions in each library and in the bf16 libraries' kernel B, which
    has no generic load or store."""
    from framedipt_tpu_torch.model.kernels import edge_embedder as emb
    from framedipt_tpu_torch.model.kernels import pair_mlp as pm

    a = torch.zeros(64, 8, device="cuda")
    a[torch.arange(64), torch.arange(64) % 8] = 1.0  # d[r, n] = b'[n, r % 8]
    b = torch.randn(64, 8, generator=gen, device="cuda") * 3.0
    d = pm.wgmma_tf32_probe(a, b)
    read = torch.stack([d[r] for r in range(8)], 1)  # [n, k]
    if not all(torch.equal(d[r], d[r % 8]) for r in range(64)):
        raise AssertionError("wgmma TF32 probe: rows of d disagree (fragment layout)")
    bits = b.view(torch.int32)
    truncated = torch.equal(read, (bits & ~0x1FFF).view(torch.float32))
    rounded = torch.equal(read, pm.tf32_rna(b))
    log(f"wgmma TF32 probe: a raw float32 operand reads as TF32 "
        + ("truncated (low 13 bits dropped)" if truncated else
           "rounded to nearest, ties away" if rounded else "neither truncated nor rounded"))
    if not (truncated or rounded):
        raise AssertionError("wgmma TF32 probe: unexpected reading of a float32 operand")
    # The C entry with scratch of our own, to read what the first step wrote.
    args = pair_mlp_inputs(2, 17, torch.float32, gen)
    (pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj,
     wfe) = args
    split = torch.full((pm.WG_SPLIT_FLOATS,), float("nan"), device="cuda")
    out = torch.empty(2, 17, 17, 128, device="cuda")
    err = pm._wg_kernel()(
        1, *(t.data_ptr() for t in (pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0, w1,
                                    b1, wf, bf, wfe, ln_scale, ln_bias, out, split)),
        2, 17, 17, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want = pm.wgmma_weight_split(w0.cpu(), w1.cpu(), wf.cpu(), wfe.cpu())
    same_split = err == 0 and torch.equal(split.cpu().view(torch.int32), want.view(torch.int32))
    same_out = err == 0 and torch.equal(out, pm.pair_mlp(*args))
    log(f"wgmma forward's first step: the weights' TF32 parts equal wgmma_weight_split's bit for "
        f"bit: {same_split}; the output equals the wrapper's: {same_out}")
    if not (same_split and same_out):
        raise AssertionError(f"wgmma forward's scratch or output (cudaError_t {err})")
    # The edge embedder's: its weight split, through the C entry likewise.
    args = edge_embedder_inputs(2, 17, torch.float32, gen)
    *tensors, lower, upper = args
    edges = emb._edges(lower, upper, torch.device("cuda"))
    split = torch.full((emb.WG_SPLIT_FLOATS,), float("nan"), device="cuda")
    out = torch.empty(2, 17, 17, 128, device="cuda")
    ptrs = ([t.data_ptr() for t in tensors[:10]] + [edges[0].data_ptr(), edges[1].data_ptr()]
            + [t.data_ptr() for t in tensors[10:]] + [out.data_ptr(), split.data_ptr()])
    err = emb._wg_kernel()(*ptrs, len(lower), 2, 17, 17, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want = emb.wgmma_weight_split(tensors[8].cpu(), tensors[11].cpu(), tensors[13].cpu())
    same_split = err == 0 and torch.equal(split.cpu().view(torch.int32), want.view(torch.int32))
    same_out = err == 0 and torch.equal(out, emb.edge_embedder(*args))
    log(f"wgmma edge embedder's first step: the weights' TF32 parts equal wgmma_weight_split's "
        f"bit for bit: {same_split}; the output equals the wrapper's: {same_out}")
    if not (same_split and same_out):
        raise AssertionError(f"wgmma edge embedder's scratch or output (cudaError_t {err})")
    # The float32 backward's first step: the forward's split, then the
    # chain's (chain_weight_split), through its C entry likewise.
    args = pair_mlp_inputs(2, 17, torch.float32, gen)
    g = torch.randn(2, 17, 17, 128, generator=gen, device="cuda")
    split = torch.full((2 * pm.WG_SPLIT_FLOATS,), float("nan"), device="cuda")
    ws = torch.empty(pm.split_workspace_floats(2 * 17 * 17), device="cuda")
    sums = torch.zeros(pm.W_PART_FLOATS + 2 * 2 * 17 * pm.ROW_PART, device="cuda")
    d_pair = torch.empty(2, 17, 17, 128, device="cuda")
    (pair, i_term, j_term, row_mask, col_mask, w0, b0, w1, b1, wf, bf, ln_scale, ln_bias, fi, fj,
     wfe) = args
    wred = sums.data_ptr()
    err = pm._bwd_wg_kernel()(
        1, *(t.data_ptr() for t in (g, pair, i_term, j_term, fi, fj, row_mask, col_mask, w0, b0,
                                    w1, b1, wf, bf, wfe, ln_scale, ln_bias, d_pair, ws)),
        ws.numel(), split.data_ptr(), wred, wred + 4 * pm.W_PART_FLOATS,
        wred + 4 * (pm.W_PART_FLOATS + 2 * 17 * pm.ROW_PART), 2, 17, 17, 0, 2 * 17, None,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    cpu = [w.cpu() for w in (w0, w1, wf, wfe)]
    want = torch.cat([pm.wgmma_weight_split(*cpu), pm.chain_weight_split(*cpu)])
    same_split = err == 0 and torch.equal(split.cpu().view(torch.int32), want.view(torch.int32))
    same_out = err == 0 and torch.equal(d_pair, pm.pair_mlp_bwd(g, *args)[0])
    log(f"wgmma backward's first step: the forward's and the chain's TF32 weight parts equal "
        f"wgmma_weight_split's and chain_weight_split's bit for bit: {same_split}; d_pair equals "
        f"the wrapper's: {same_out}")
    if not (same_split and same_out):
        raise AssertionError(f"wgmma backward's scratch or d_pair (cudaError_t {err})")
    # The float32 embedder backward's kernel A likewise: the forward's split,
    # then the chain's, through its C entry.
    args = edge_embedder_inputs(2, 17, torch.float32, gen)
    *tensors, lower, upper = args
    edges = emb._edges(lower, upper, torch.device("cuda"))
    g = torch.randn(2, 17, 17, 128, generator=gen, device="cuda")
    split = torch.full((2 * emb.WG_SPLIT_FLOATS,), float("nan"), device="cuda")
    parts = emb.split_parts(2 * 17, 17)
    ws = torch.empty(emb.split_workspace_floats(2 * 17 * 17, len(lower), torch.float32, parts),
                     device="cuda")
    sums = torch.zeros(emb.W_PART_FLOATS + 2 * 2 * 17 * emb.ROW_PART, device="cuda")
    wred = sums.data_ptr()
    ptrs = ([g.data_ptr()] + [t.data_ptr() for t in tensors[:10]]
            + [edges[0].data_ptr(), edges[1].data_ptr()] + [t.data_ptr() for t in tensors[10:]])
    err = emb._bwd_wg_kernel()(
        *ptrs, ws.data_ptr(), ws.numel(), split.data_ptr(), wred, wred + 4 * emb.W_PART_FLOATS,
        wred + 4 * (emb.W_PART_FLOATS + 2 * 17 * emb.ROW_PART), len(lower), 2, 17, 17, 0, 2 * 17,
        None, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    cpu = [tensors[k].cpu() for k in (8, 11, 13)]
    want = torch.cat([emb.wgmma_weight_split(*cpu), emb.chain_weight_split(*cpu)])
    same_split = err == 0 and torch.equal(split.cpu().view(torch.int32), want.view(torch.int32))
    got = emb.edge_embedder_bwd(g, *tensors, bins_lower=lower, bins_upper=upper)
    same_out = err == 0 and torch.equal(sums[:emb.W_PART_FLOATS].view(-1)[:64 * 128],
                                        got[8].reshape(-1))
    log(f"wgmma embedder backward's first step: the forward's and the chain's TF32 weight parts "
        f"equal wgmma_weight_split's and chain_weight_split's bit for bit: {same_split}; d_w_rel "
        f"equals the wrapper's: {same_out}")
    if not (same_split and same_out):
        raise AssertionError(f"wgmma embedder backward's scratch or d_w_rel (cudaError_t {err})")
    for name in ("pair_mlp_wg", "edge_embedder_wg", "pair_mlp_bwd_wg", "edge_embedder_bwd_wg"):
        counts = sass_counts(name, ("HGMMA", "UTMALDG"))
        line = (f"{name}: {counts['HGMMA']} HGMMA and {counts['UTMALDG']} UTMALDG instructions "
                "(cuobjdump -sass)")
        if name.startswith("edge_embedder"):
            kernel = "emb_bwd_tile_kernel" if "bwd" in name else "edge_embedder_wg_kernel"
            generic = generic_ld_st(name, kernel)
            line += (f"; {kernel}: {generic['LD']} generic LD and {generic['ST']} generic ST, "
                     f"{generic['LDS']} LDS and {generic['STS']} STS")
        log(line)
        if not (counts["HGMMA"] and counts["UTMALDG"]):
            raise AssertionError(f"the {name} library has no HGMMA or no UTMALDG")
    for name in ("pair_mlp_bwd_wg_bf16", "edge_embedder_bwd"):
        c = function_counts(name, "wgrad_bf16_kernel",
                            ("HGMMA", "UTMALDG", "LD", "ST", "LDS", "STS"))
        log(f"{name}: bf16 kernel B (wgrad_bf16_kernel) {c['HGMMA']} HGMMA and {c['UTMALDG']} "
            f"UTMALDG instructions, {c['LD']} generic LD and {c['ST']} generic ST, {c['LDS']} "
            f"LDS and {c['STS']} STS (cuobjdump -sass)")
        if not (c["HGMMA"] and c["UTMALDG"]) or c["LD"] or c["ST"]:
            raise AssertionError(f"{name}: wgrad_bf16_kernel lacks HGMMA or UTMALDG, or has "
                                 "generic loads or stores")
    # bf16 kernel A (csrc/pair_mlp_bwd_wg_bf16.cu): wgmma and TMA, no mma.sync;
    # its local-memory traffic (LDL, STL: spills) printed beside ptxas's lines.
    c = function_counts("pair_mlp_bwd_wg_bf16", "bf16_bwd_tile_kernel",
                        ("HGMMA", "HMMA", "UTMALDG", "UTMASTG", "LD", "ST", "LDL", "STL", "LDS",
                         "STS"))
    log("pair_mlp_bwd_wg_bf16: bf16 kernel A (bf16_bwd_tile_kernel) " + ", ".join(
        f"{v} {k}" for k, v in c.items()) + " (cuobjdump -sass; LD/ST generic)")
    if not (c["HGMMA"] and c["UTMALDG"]) or c["HMMA"] or c["LD"] or c["ST"]:
        raise AssertionError("bf16_bwd_tile_kernel lacks HGMMA or UTMALDG, or has mma.sync or "
                             "generic loads or stores")


def library_sass(name: str) -> list[str]:
    """The SASS of kernel library ``name`` (``cuobjdump -sass``), by line."""
    from framedipt_tpu_torch.model.kernels import build

    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(build._lib_path(name))],
                          capture_output=True, text=True, timeout=120).stdout.splitlines()


def sass_counts(name: str, ops) -> dict[str, int]:
    """How many SASS instructions of each kind in ``ops`` kernel library
    ``name`` holds (``cuobjdump -sass``)."""
    sass = library_sass(name)
    return {op: sum(op in line for line in sass) for op in ops}


def function_counts(name: str, kernel: str, ops) -> dict[str, int]:
    """How many SASS instructions of each opcode in ``ops`` (with any
    modifiers) the functions of library ``name`` whose names hold ``kernel``
    hold."""
    counts = dict.fromkeys(ops, 0)
    inside = False
    for line in library_sass(name):
        if "Function : " in line:
            inside = kernel in line
        elif inside:
            for op in counts:
                counts[op] += re.search(rf"\s{op}(\.|\s)", line) is not None
    return counts


def generic_ld_st(name: str, kernel: str) -> dict[str, int]:
    """The generic-address loads and stores (LD, ST: shared memory reached
    through 64-bit generic addresses) beside the shared-memory ones (LDS,
    STS) in the SASS of the functions of library ``name`` whose names hold
    ``kernel``."""
    return function_counts(name, kernel, ("LD", "ST", "LDS", "STS"))


# The pair-MLP backward: kernel A (recompute and input-gradient chain) and
# kernel B (weight gradients) run their products on the tensor cores, as
# 3xTF32 in float32 and bf16 MMA in bf16. Its CUDA kernels by name: kernel A
# (on wgmma; float32: csrc/pair_mlp_bwd_wg.cu, bf16: csrc/pair_mlp_bwd_wg_bf16.cu),
# float32's weight splits (kernel A's first step), kernel B (on wgmma and
# TMA; float32: csrc/wgrad_wg.cuh's wgrad_wg_kernel, bf16:
# csrc/wgrad_bf16.cuh's wgrad_bf16_kernel), the sums.
BWD_PARTS = (("A", "bwd_tile_kernel"), ("weight splits", "prepare_weights"), ("B", "wgrad_wg_kernel"),
             ("B", "wgrad_bf16_kernel"), ("row/col sums", "_sums"),
             ("ordered reductions", "sum_partials"))


def pair_mlp_bwd_cost(B, N, dtype):
    """(kernel A's operations, kernel B's operations, bytes) of one call:
    the forward recompute and the input-gradient chain (two products per
    forward product), the weight gradients (one per forward product); pair,
    cotangent and d_pair, the O(N) inputs once, the float32 gradients."""
    es = torch.tensor([], dtype=dtype).element_size()
    mlp = 128 * 384 + 384 * 384 + 384 * 128 + 128 * 128
    pairs = B * N * N
    nbytes = (es * (3 * pairs * 128 + B * N * (2 * 384 + 2 * 128 + 2) + 2 * mlp + 2 * 384 + 128)
              + 4 * (B * N * (2 * 384 + 2 * 128 + 2) + mlp + 2 * 384 + 3 * 128))
    return pairs * 2 * 2 * mlp, pairs * 2 * mlp, nbytes


def pair_mlp_bwd_bound(B, N, dtype) -> tuple[float, str]:
    """Least ms of one call: the operations over the tensor cores' rate for
    the dtype (3xTF32 in float32), or the bytes over the HBM rate, the
    larger."""
    a_flops, b_flops, nbytes = pair_mlp_bwd_cost(B, N, dtype)
    return bound(a_flops + b_flops, nbytes, TENSOR_CORE_FLOPS[dtype])


def pair_mlp_bwd_a_bound(B, N, dtype) -> tuple[float, str]:
    """Kernel A's least ms: its operations (the recompute and the chain)
    over the tensor cores' rate for the dtype (3xTF32 in float32), or its
    bytes over the HBM rate, the larger. Its bytes a pair: the workspace it
    writes (split_workspace_floats' per-pair part: float32 6,660, bf16
    3,844), d_pair written, pair and g read."""
    from framedipt_tpu_torch.model.kernels.pair_mlp import SPLIT_PAIR_FLOATS

    es = torch.tensor([], dtype=dtype).element_size()
    a_flops, _, _ = pair_mlp_bwd_cost(B, N, dtype)
    nbytes = B * N * N * (4 * SPLIT_PAIR_FLOATS[dtype] + 3 * 128 * es)
    return bound(a_flops, nbytes, TENSOR_CORE_FLOPS[dtype])


def bwd_parts_ms(fn, kinds=BWD_PARTS) -> dict[str, float | None]:
    """Device ms of one call of ``fn`` by part of a split backward (its
    CUDA kernels by name: ``kinds``; torch.profiler): None for a part of
    which the profile holds no kernel (a route without it, or a record the
    profiler lost); {} if it records no device time."""
    _, by_name = device_time(fn)
    parts: dict[str, float | None] = {label: None for label, _ in kinds}
    parts["wrapper (transposes, zeroing, d_b0)"] = None
    for name, ms in by_name.items():
        label = next((lab for lab, key in kinds if key in name),
                     "wrapper (transposes, zeroing, d_b0)")
        parts[label] = (parts[label] or 0.0) + ms
    return parts if by_name else {}


def ms_text(ms: float | None) -> str:
    """A part's ms as text, a missing part as "not recorded"."""
    return "not recorded" if ms is None else f"{ms:.4f}"


def parts_text(parts: dict) -> str:
    """bwd_parts_ms's parts as text."""
    return ", ".join(f"{k} {ms_text(v)}" for k, v in parts.items()) or "not measured"


def part_ms(parts: dict, key: str, label: str) -> float:
    """Part ``key``'s ms of bwd_parts_ms's ``parts``; raises if the profile
    holds none of its kernels (a lost record or a launch on another route),
    so that no missing part is reported as measured."""
    if not parts.get(key):
        raise AssertionError(f"{label}: the profile holds no {key} ({parts_text(parts)})")
    return parts[key]


def grad_errors(got, ref, label: str) -> tuple[float, float]:
    """(worst |got - ref| over each gradient's own max-abs, worst |got - ref|)
    over the gradients that ref gives; raises on a non-finite gradient."""
    worst_rel, worst_abs = 0.0, 0.0
    for i, (a, r) in enumerate(zip(got, ref)):
        if r is None or r.numel() == 0:
            continue
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"{label}: gradient {i} not finite")
        err = float((a.float() - r.float()).abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(float(r.float().abs().max()), 1e-30))
    return worst_rel, worst_abs


def relu_flips(y0, y1, rec) -> tuple[int, float]:
    """(relu sites where the plain forward's activations y0, y1 and the
    kernels' recompute fall on different sides of 0, the largest activation
    at those sites)."""
    n, worst = 0, 0.0
    for plain_y, kern_y in ((y0, rec["y0"]), (y1, rec["y1"])):
        flip = (plain_y > 0) != (kern_y > 0)
        n += int(flip.sum())
        if flip.any():
            worst = max(worst, float(torch.maximum(plain_y[flip].float(),
                                                   kern_y[flip].float()).max()))
    return n, worst


def check_pair_mlp_bwd() -> dict:
    """The pair-MLP backward against its plain version on the card, in
    float32 and bf16: every gradient within tol of its own max-abs (float32
    1e-4, bf16 5e-2), residual and not, one pair, one partial tile, and a
    grid the wrapper runs in several chunks (a small workspace cap); two
    launches bit-identical; times at B=2 N=256 (the whole call, and by
    kernel).

    The kernels take their relu decisions from their recompute, which runs
    the forward kernel's code: the recompute's output is checked to equal
    the forward kernel's bit for bit, every site where the plain forward's
    relu falls on the other side of 0 must hold an activation within the
    dtype's rounding of 0 (tol: float32 1e-4, bf16 5e-2), and the gradients
    are held against the plain backward through the recompute's relu
    decisions (the gradient jumps at such a site; without them the error is
    printed too). Returns the numbers at B=2 N=256 by dtype (float32: kernel
    A on wgmma, csrc/pair_mlp_bwd_wg.cu; bf16: csrc/pair_mlp_bwd_wg_bf16.cu)."""
    from framedipt_tpu_torch.model.kernels.pair_mlp import (
        BWD_WORKSPACE_CAP,
        _pre_norm,
        pair_mlp,
        pair_mlp_bwd,
        pair_mlp_bwd_plain,
        plan_bwd_chunks,
        split_workspace_floats,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        small_cap = 4 * split_workspace_floats(40 * 200, dtype)  # 40 grid rows a chunk: 10 chunks
        shapes = ((1, 256, True, None), (2, 200, True, None), (2, 256, True, None),
                  (2, 200, False, None), (1, 1, True, None), (1, 17, True, None),
                  (2, 200, True, small_cap), (2, 200, False, small_cap))
        for B, N, residual, cap in shapes:
            kw = {} if cap is None else {"workspace_cap": cap}
            args = pair_mlp_inputs(B, N, dtype, gen, residual=residual)
            g = torch.randn(B, N, N, 128, generator=gen, device="cuda").to(dtype)
            rec = {}
            got = pair_mlp_bwd(g, *args, recompute=rec, **kw)
            again = pair_mlp_bwd(g, *args, **kw)
            ref = pair_mlp_bwd_plain(g, *args, relu_masks=(rec["y0"] > 0, rec["y1"] > 0))
            torch.cuda.synchronize()
            same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
            chunks = plan_bwd_chunks(B, N, N, cap or BWD_WORKSPACE_CAP, dtype)
            label = (f"pair_mlp_bwd {str(dtype)[6:]} B={B} N={N} residual={residual} "
                     f"chunks={len(chunks)} (workspace "
                     f"{4 * split_workspace_floats(max(b - a for a, b in chunks) * N, dtype)} bytes)")
            worst_rel, worst_abs = grad_errors(got, ref, label)
            # The forward that the training step launches (and differentiates).
            fwd = pair_mlp(*args)
            fwd_diff = float((rec["out"].float() - fwd.float()).abs().max())
            n_flips, flip_max = relu_flips(*_pre_norm(*args[:3], *args[5:11], *args[13:])[:2], rec)
            own_rel = grad_errors(got, pair_mlp_bwd_plain(g, *args), label)[0]
            line = (f"{label}: max err {worst_abs:.3e} abs, {worst_rel:.3e} of the gradient's "
                    f"max-abs (tol {TOL[dtype]}); two launches bit-identical: {same}; recompute vs "
                    f"forward kernel output: max diff {fwd_diff:.3e}; relu sites on the other side "
                    f"of 0 from the plain forward: {n_flips} (largest |activation| there "
                    f"{flip_max:.3e}); against the plain backward through its own relu decisions "
                    f"{own_rel:.3e}")
            if fwd_diff != 0 or flip_max > TOL[dtype]:
                log(line)
                raise AssertionError(f"{label}: the recompute is not the forward kernel's")
            if (B, N, residual, cap) == (2, 256, True, None):
                ms = cuda_time_ms(lambda: pair_mlp_bwd(g, *args), 20)
                plain_ms = cuda_time_ms(lambda: pair_mlp_bwd_plain(g, *args), 5)
                a_flops, b_flops, _ = pair_mlp_bwd_cost(B, N, dtype)
                bound_ms, bound_by = pair_mlp_bwd_bound(B, N, dtype)
                a_bound_ms, a_bound_by = pair_mlp_bwd_a_bound(B, N, dtype)
                parts = bwd_parts_ms(lambda: pair_mlp_bwd(g, *args))
                part_ms(parts, "A", label)  # each route's own kernel A
                peak = TENSOR_CORE_FLOPS[dtype]
                line += (f"; call {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}), {(a_flops + b_flops) / ms / 1e9:.2f} TFLOP/s; device ms "
                         "by part (profiler, one call): " + parts_text(parts)
                         + f"; kernel A bound {a_bound_ms:.4f} ms ({a_bound_by}; operations "
                         f"{1e3 * a_flops / peak:.4f} ms), kernel B bound "
                         f"{1e3 * b_flops / peak:.4f} ms (operations); {card_line()}")
                out[dtype] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                              "kernel_a_ms": parts.get("A"), "kernel_a_bound_ms": a_bound_ms,
                              "kernel_a_bound_by": a_bound_by, "kernel_b_ms": parts.get("B")}
            log(line)
            if worst_rel > TOL[dtype] or not same:
                raise AssertionError(f"{label}: error {worst_rel} over tolerance or not deterministic")
    return out


# Kernel B at B=2 N=256 at each call site (float32: csrc/wgrad_wg.cuh in the
# *_wg libraries; bf16: csrc/wgrad_bf16.cuh): the workspace's [P, width]
# arrays it reads, each once (its distinct rows: 4 bytes a value in float32,
# 2 in bf16), and its products as (A, Bm) of those arrays.
WGRAD_WIDTHS = {
    "pair_mlp_bwd_wg": {"pair": 128, "y0": 384, "y1": 384, "dy0": 384, "dy1": 384, "dx": 128},
    "edge_embedder_bwd_wg": {"m": 64, "y0": 128, "y1": 128, "dy0": 128, "dy1": 128, "dx": 128}}
WGRAD_PRODUCTS = {"pair_mlp_bwd_wg": (("pair", "dy0"), ("y0", "dy1"), ("y1", "dx"), ("pair", "dx")),
                  "edge_embedder_bwd_wg": (("m", "dy0"), ("y0", "dy1"), ("y1", "dx"))}
for _table in (WGRAD_WIDTHS, WGRAD_PRODUCTS):
    _table.update({"pair_mlp_bwd_wg_bf16": _table["pair_mlp_bwd_wg"],
                   "edge_embedder_bwd": _table["edge_embedder_bwd_wg"]})


def wgrad_products(name: str, dtype, gen):
    """A call of the same products as kernel B of call site ``name`` at
    B=2 N=256, as ``torch.mm(a.t(), b)`` in ``dtype`` over arrays of the
    workspace's shapes, one random array per workspace array (so they read
    its distinct rows, as the kernel does); the yardstick that the port
    never calls."""
    P = 2 * 256 * 256
    arrays = {a: torch.randn(P, w, generator=gen, device="cuda").to(dtype)
              for a, w in WGRAD_WIDTHS[name].items()}

    def products():
        for a, b in WGRAD_PRODUCTS[name]:
            torch.mm(arrays[a].t(), arrays[b])

    return products


def check_wgrad() -> dict[str, dict]:
    """Kernel B alone in both dtypes (float32: ``csrc/wgrad_wg.cuh`` through
    the ``wgrad_f32`` wrapper; bf16: ``csrc/wgrad_bf16.cuh`` through
    ``wgrad_bf16``) against float64 a^T b of the same operands: one pair, 289
    pairs (a partial step), a ragged chunk (80,000 pairs, the pair MLP's
    384-wide operands, 8 slices) and the embedder's 64-row job (289 and 5,000
    pairs, 44 slices), each within 1e-4 of the product's max-abs, two
    launches bit-identical. Then, for each call site at B=2 N=256 and each
    dtype (WGRAD_WIDTHS: float32 under the *_wg entries, bf16 under the
    others), kernel B's bound (the larger of its operations on the tensor
    cores, 3xTF32 in float32, and the distinct workspace rows' bytes) and the
    time of the same products as ``torch.mm(a.t(), b)`` calls in the dtype
    (float32 with TF32 off; the median of five rounds, the spread printed),
    the yardstick that the port never calls: its device ms under
    torch.profiler (kernel B's own ms are device ms from the backwards'
    profiles) and its CUDA-event ms, which hold the host's launch gaps too.
    Returns by kernel entry the ``kernel_b_*`` numbers."""
    from framedipt_tpu_torch.model.kernels.wgrad import wgrad_bf16, wgrad_f32

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the torch.mm yardstick needs TF32 off")
    gen = torch.Generator(device="cuda").manual_seed(24)
    worst = {}
    for dtype, fn in ((torch.float32, wgrad_f32), (torch.bfloat16, wgrad_bf16)):
        worst[dtype] = 0.0
        for P, M, N, slices in ((1, 128, 128, 8), (289, 384, 384, 8), (80_000, 384, 384, 8),
                                (289, 64, 128, 44), (5_000, 64, 128, 44)):
            a = torch.randn(P, M, generator=gen, device="cuda").to(dtype)
            b = torch.randn(P, N, generator=gen, device="cuda").to(dtype)
            got, again = fn(a, b, slices), fn(a, b, slices)
            ref = a.double().t() @ b.double()
            torch.cuda.synchronize()
            err = float((got.double() - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-30)
            same = torch.equal(got, again)
            worst[dtype] = max(worst[dtype], err)
            log(f"{fn.__name__} P={P} M={M} N={N} slices={slices}: max err {err:.3e} abs, "
                f"{rel:.3e} of the product's max-abs against float64 of the same "
                f"{str(dtype)[6:]} operands (tol {TOL[torch.float32]}); two launches "
                f"bit-identical: {same}")
            if rel > TOL[torch.float32] or not same:
                raise AssertionError(f"{fn.__name__} P={P} M={M} N={N}: error {rel} or not "
                                     "deterministic")
    out = {}
    P = 2 * 256 * 256
    for name, widths in WGRAD_WIDTHS.items():
        dtype = torch.float32 if name.endswith("_wg") else torch.bfloat16
        es = torch.tensor([], dtype=dtype).element_size()
        products = wgrad_products(name, dtype, gen)
        events = sorted(cuda_time_ms(products, 5) for _ in range(5))
        device = sorted(device_time(products)[0] for _ in range(5))
        library_ms = device[2]
        flops = sum(2 * P * widths[a] * widths[b] for a, b in WGRAD_PRODUCTS[name])
        nbytes = es * P * sum(widths.values())
        bound_ms, bound_by = bound(flops, nbytes, TENSOR_CORE_FLOPS[dtype])
        log(f"{name} kernel B {str(dtype)[6:]} at B=2 N=256: {flops / 1e9:.2f} GFLOP, bound "
            f"{bound_ms:.4f} ms ({bound_by}; operations "
            f"{1e3 * flops / TENSOR_CORE_FLOPS[dtype]:.4f} ms"
            f"{' as 3xTF32' if dtype == torch.float32 else ''}, bytes "
            f"{1e3 * nbytes / PEAK_BYTES:.4f} ms); the same products as torch.mm "
            f"{str(dtype)[6:]}{' (TF32 off)' if dtype == torch.float32 else ''}: "
            f"{library_ms:.4f} ms of device time (median of five rounds, {device[0]:.4f}-"
            f"{device[-1]:.4f}), {events[2]:.4f} ms by CUDA events ({events[0]:.4f}-"
            f"{events[-1]:.4f}); {card_line()}")
        out[name] = {"kernel_b_bound_ms": bound_ms, "kernel_b_bound_by": bound_by,
                     "kernel_b_library_ms": library_ms, "kernel_b_max_abs_err": worst[dtype]}
        del products
    return out


# The embedder backward's products a pair: kernel A's recompute (81,920) and
# input-gradient chain (dy1, dy0: 2 x 128 x 128 each; dm: 2 x 64 x 128), and
# kernel B's weight gradients (dW2, dW1: 2 x 128 x 128 each; dW_rel: 2 x 64 x
# 128); 245,760 in all.
EMB_BWD_A_FLOP_PER_PAIR = 2 * (64 * 128 + 128 * 128 + 128 * 128) + 2 * (2 * 128 * 128 + 64 * 128)
EMB_BWD_B_FLOP_PER_PAIR = 2 * (2 * 128 * 128 + 64 * 128)
EMB_BWD_PARTS = (("A", "emb_bwd_tile_kernel"), ("A", "emb_split_tile_kernel"),
                 ("weight splits", "prepare_"), ("B", "wgrad_wg_kernel"),
                 ("B", "wgrad_bf16_kernel"), ("row/col sums", "_sums"),
                 ("ordered reductions", "sum_partials"))
# Kernel A's bytes a pair: the cotangent read and the workspace written (m,
# y0, y1, dx, dy1, dy0 in the dtype; dm and dem in float32); the row and
# column sums read dy0 (the dtype), dm and dem (float32) twice.
EMB_BWD_A_VALUES, EMB_BWD_A_F32 = 5 * 128 + 64, 64 + 1
EMB_BWD_SUMS_VALUES, EMB_BWD_SUMS_F32 = 2 * 128, 2 * (64 + 1)


def edge_embedder_bwd_cost(B, N, dtype, n_bins=22):
    """(kernel A's operations, kernel B's operations, bytes) of one embedder
    backward call: the forward recompute and the backward products (the
    distogram row gather and the LayerNorm not counted); the cotangent, the
    O(N) inputs and weights once, the float32 gradients once."""
    es = torch.tensor([], dtype=dtype).element_size()
    weights = 64 * 128 + n_bins * 128 + 2 * 128 * 128 + 3 * 128
    pairs = B * N * N
    nbytes = (es * (pairs * 128 + B * N * (2 * 64 + 2 * 128 + 2) + weights)
              + 4 * (B * N * 3 * 2 + 2 * n_bins + 2 * 128)
              + 4 * (B * N * (2 * 64 + 2 * 128 + 2) + weights + 2 * 128))
    return pairs * EMB_BWD_A_FLOP_PER_PAIR, pairs * EMB_BWD_B_FLOP_PER_PAIR, nbytes


def xla_emb_backward(g, args):
    """The ``xla`` setting's embedder backward: the VJP of the plain forward
    recomputed under autograd (EdgeEmbedderFunction's "xla" branch)."""
    from framedipt_tpu_torch.model.kernels.edge_embedder import edge_embedder_plain

    *tensors, lower, upper = args
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(i not in (2, 3)) for i, t in enumerate(tensors)]
        out = edge_embedder_plain(*ins, lower, upper)
        return torch.autograd.grad(out, [t for t in ins if t.requires_grad], g)


def edge_embedder_bwd_parts_bound(B, N, dtype) -> dict[str, tuple[float, str]]:
    """(ms, "bytes" or "operations") of kernel A and of the row and column
    sums of one embedder backward call: kernel A's operations on the tensor
    cores (3xTF32 in float32) or its bytes (the cotangent read, the
    workspace written), the sums' bytes (the workspace rows they read)."""
    es = torch.tensor([], dtype=dtype).element_size()
    pairs = B * N * N
    a_bytes = pairs * (es * (128 + EMB_BWD_A_VALUES) + 4 * EMB_BWD_A_F32)
    sums_bytes = pairs * (es * EMB_BWD_SUMS_VALUES + 4 * EMB_BWD_SUMS_F32)
    return {"A": bound(pairs * EMB_BWD_A_FLOP_PER_PAIR, a_bytes, TENSOR_CORE_FLOPS[dtype]),
            "row/col sums": bound(0.0, sums_bytes, TENSOR_CORE_FLOPS[dtype])}


def check_edge_embedder_bwd() -> dict:
    """The embedder backward against its plain version on the card, in
    float32 and bf16: every gradient within tol of its own max-abs (float32
    1e-4, bf16 5e-2), with 22 and 0 distance bins, at one pair, one partial
    tile, a ragged grid with masked rows and the training shape, and a grid
    the wrapper runs in several chunks (a small workspace cap); two launches
    bit-identical; at B=2 N=256 the call, its plain version and the ``xla``
    backward timed, the call also by kernel.

    The kernels take their relu decisions from their recompute, which runs
    the forward kernel's code: the recompute's output must equal the forward
    kernel's bit for bit, every site where the plain forward's relu falls on
    the other side of 0 must hold an activation within the dtype's rounding
    of 0 (tol), and the gradients are held against the plain backward
    through the recompute's relu decisions. Returns the numbers at B=2 N=256
    by dtype (float32: kernel A on wgmma, csrc/edge_embedder_bwd_wg.cu; bf16:
    csrc/edge_embedder_bwd.cu), kernel A's and the sums' ms and bounds
    among them."""
    from framedipt_tpu_torch.model.kernels.edge_embedder import (
        BWD_WORKSPACE_CAP,
        _pre_norm,
        edge_embedder,
        edge_embedder_bwd,
        edge_embedder_bwd_plain,
        plan_bwd_chunks,
        split_parts,
        split_workspace_floats,
    )

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        # 40 grid rows a chunk: 10 chunks.
        small_cap = 4 * split_workspace_floats(40 * 200, 22, dtype, split_parts(40, 200, dtype))
        shapes = [(B, N, n_bins, None) for B, N in ((1, 1), (1, 17), (1, 256), (2, 200), (2, 256))
                  for n_bins in (22, 0)] + [(2, 200, 22, small_cap), (1, 70, 22, None)]
        for B, N, n_bins, cap in shapes:
            kw_cap = {} if cap is None else {"workspace_cap": cap}
            args = edge_embedder_inputs(B, N, dtype, gen, n_bins=n_bins)
            *tensors, lower, upper = args
            kw = {"bins_lower": lower, "bins_upper": upper}
            g = torch.randn(B, N, N, 128, generator=gen, device="cuda").to(dtype)
            rec = {}
            got = edge_embedder_bwd(g, *tensors, recompute=rec, **kw, **kw_cap)
            again = edge_embedder_bwd(g, *tensors, **kw, **kw_cap)
            ref = edge_embedder_bwd_plain(g, *tensors, **kw,
                                          relu_masks=(rec["y0"] > 0, rec["y1"] > 0))
            torch.cuda.synchronize()
            same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
            chunks = plan_bwd_chunks(B, N, N, n_bins, cap or BWD_WORKSPACE_CAP, dtype)
            most = max(b - a for a, b in chunks)
            ws_bytes = 4 * split_workspace_floats(most * N, n_bins, dtype,
                                                  split_parts(most, N, dtype))
            label = (f"edge_embedder_bwd {str(dtype)[6:]} B={B} N={N} n_bins={n_bins} "
                     f"chunks={len(chunks)} (workspace {ws_bytes} bytes)")
            worst_rel, worst_abs = grad_errors(got, ref, label)
            fwd_diff = float((rec["out"].float()
                              - edge_embedder(*args).float()).abs().max())
            n_flips, flip_max = relu_flips(
                *_pre_norm(*tensors[:6], *tensors[8:15], lower, upper)[2:4], rec)
            own_rel = grad_errors(got, edge_embedder_bwd_plain(g, *tensors, **kw), label)[0]
            line = (f"{label}: max err {worst_abs:.3e} abs, {worst_rel:.3e} of the gradient's "
                    f"max-abs (tol {TOL[dtype]}); two launches bit-identical: {same}; recompute vs "
                    f"forward kernel output: max diff {fwd_diff:.3e}; relu sites on the other side "
                    f"of 0 from the plain forward: {n_flips} (largest |activation| there "
                    f"{flip_max:.3e}); against the plain backward through its own relu decisions "
                    f"{own_rel:.3e}")
            if fwd_diff != 0 or flip_max > TOL[dtype]:
                log(line)
                raise AssertionError(f"{label}: the recompute is not the forward kernel's")
            if (B, N, n_bins, cap) == (2, 256, 22, None):
                ms = cuda_time_ms(lambda: edge_embedder_bwd(g, *tensors, **kw), 20)
                plain_ms = cuda_time_ms(lambda: edge_embedder_bwd_plain(g, *tensors, **kw), 5)
                xla_ms = cuda_time_ms(lambda: xla_emb_backward(g, args), 5)
                a_flops, b_flops, nbytes = edge_embedder_bwd_cost(B, N, dtype, n_bins)
                flops = a_flops + b_flops
                peak = TENSOR_CORE_FLOPS[dtype]
                bound_ms, bound_by = bound(flops, nbytes, peak)
                parts = bwd_parts_ms(lambda: edge_embedder_bwd(g, *tensors, **kw), EMB_BWD_PARTS)
                part_ms(parts, "A", label)  # each route's own kernel A
                own = edge_embedder_bwd_parts_bound(B, N, dtype)
                line += (f"; call {ms:.4f} ms, plain {plain_ms:.4f} ms, xla backward "
                         f"{xla_ms:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s; bound {bound_ms:.4f} "
                         f"ms ({bound_by}, tensor cores"
                         + (f", 3xTF32; CUDA cores {bound(flops, nbytes, PEAK_FLOPS[dtype])[0]:.4f} ms"
                            if dtype == torch.float32 else "")
                         + "); device ms by part (profiler, one call): " + parts_text(parts)
                         + f"; kernel A {parts['A']:.4f} ms beside its bound "
                         f"{own['A'][0]:.4f} ms ({own['A'][1]}; operations "
                         f"{1e3 * a_flops / peak:.4f} ms), the row/col sums "
                         f"{ms_text(parts['row/col sums'])} ms beside their bound "
                         f"{own['row/col sums'][0]:.4f} ms (bytes), kernel B bound by operations "
                         f"{1e3 * b_flops / peak:.4f} ms; {card_line()}")
                out[dtype] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                              "kernel_a_ms": parts.get("A"), "kernel_a_bound_ms": own["A"][0],
                              "kernel_a_bound_by": own["A"][1],
                              "sums_ms": parts.get("row/col sums"),
                              "sums_bound_ms": own["row/col sums"][0],
                              "kernel_b_ms": parts.get("B")}
            log(line)
            if worst_rel > TOL[dtype] or not same:
                raise AssertionError(f"{label}: error {worst_rel} over tolerance or "
                                     "not deterministic")
    return out


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn``: the summed time of the kernels it
    launches under torch.profiler, over ``iters`` calls (idle gaps left
    out, unlike cuda_time_ms); 0.0 if the profiler records no device time."""
    fn()
    return device_time(lambda: [fn() for _ in range(iters)])[0] / iters


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


KERNEL_NAMES = ("edge_embedder", "edge_embedder_wg", "pair_mlp_wg", "pair_mlp_wg_bf16",
                "ipa_attention", "pair_mlp_bwd_wg_bf16", "pair_mlp_bwd_wg", "edge_embedder_bwd",
                "edge_embedder_bwd_wg")


class RouteLaunches:
    """An edge-stack wrapper's launches of one of its kernels
    (``launches_mma``: csrc/edge_embedder.cu or csrc/edge_embedder_bwd.cu;
    ``launches_wgmma``: csrc/pair_mlp_wg.cu, csrc/pair_mlp_bwd_wg.cu,
    csrc/edge_embedder_wg.cu or csrc/edge_embedder_bwd_wg.cu;
    ``launches_wgmma_bf16``: csrc/pair_mlp_wg_bf16.cu or
    csrc/pair_mlp_bwd_wg_bf16.cu), read and set as a wrapper's ``launches``
    is."""

    def __init__(self, wrapper, attr: str) -> None:
        self.wrapper, self.attr = wrapper, attr

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.wrapper, self.attr, value)


def kernel_wrappers() -> dict:
    """Each kernel's launch count by name: the edge embedder's and the pair
    MLP's (forward and backward) by route."""
    from framedipt_tpu_torch.model.kernels.edge_embedder import edge_embedder, edge_embedder_bwd
    from framedipt_tpu_torch.model.kernels.ipa_attention import ipa_attention
    from framedipt_tpu_torch.model.kernels.pair_mlp import pair_mlp, pair_mlp_bwd

    return {"edge_embedder": RouteLaunches(edge_embedder, "launches_mma"),
            "edge_embedder_wg": RouteLaunches(edge_embedder, "launches_wgmma"),
            "pair_mlp_wg": RouteLaunches(pair_mlp, "launches_wgmma"),
            "pair_mlp_wg_bf16": RouteLaunches(pair_mlp, "launches_wgmma_bf16"),
            "ipa_attention": ipa_attention,
            "pair_mlp_bwd_wg_bf16": RouteLaunches(pair_mlp_bwd, "launches_wgmma_bf16"),
            "pair_mlp_bwd_wg": RouteLaunches(pair_mlp_bwd, "launches_wgmma"),
            "edge_embedder_bwd": RouteLaunches(edge_embedder_bwd, "launches_mma"),
            "edge_embedder_bwd_wg": RouteLaunches(edge_embedder_bwd, "launches_wgmma")}


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
    bf16 = service.cfg.model.compute_dtype == "bfloat16"
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
            edge = (NUM_BLOCKS - 1) * (num_t + 1)
            want = {
                # every forward without gradients: the wgmma kernels, but the
                # bf16 embedder's (mma.sync)
                "edge_embedder": num_t + 1 if bf16 else 0,
                "edge_embedder_wg": 0 if bf16 else num_t + 1,
                "pair_mlp_wg": 0 if bf16 else edge,
                "pair_mlp_wg_bf16": edge if bf16 else 0,
                "ipa_attention": NUM_BLOCKS * (num_t + 1) if ipa_on else 0,
                "pair_mlp_bwd_wg_bf16": 0,
                "pair_mlp_bwd_wg": 0,
                "edge_embedder_bwd": 0,
                "edge_embedder_bwd_wg": 0,
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
                f"request {k} (use_pallas_ipa={ipa_on}, {service.cfg.model.compute_dtype}): "
                f"N={n_res} "
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
    on, then one in bf16. Returns each kernel's launches on the path that
    runs it (the float32 edge kernels' from the default service, the IPA
    kernel's from the second, the bf16 pair MLP's and embedder's from the
    third)."""
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
    del service
    torch.cuda.empty_cache()

    # bf16 serving (model.compute_dtype=bfloat16): the pair MLP's forwards
    # on csrc/pair_mlp_wg_bf16.cu.
    cfg_bf16 = load_config(["model.compute_dtype=bfloat16"])
    cfg_bf16.inference.weights_path = ""
    t0 = time.perf_counter()
    service_bf16 = InpaintingService(cfg_bf16, device="cuda")
    log(f"service (model.compute_dtype=bfloat16) up in {time.perf_counter() - t0:.2f} s")
    bf16 = serve_requests(service_bf16, [(230, (100, 112), 100)])
    log(f"bf16 service launches: {bf16}")
    profile_sampler(service_bf16.model, service_bf16.diffuser)
    del service_bf16
    torch.cuda.empty_cache()
    return {"edge_embedder_wg": default["edge_embedder_wg"], "pair_mlp_wg": default["pair_mlp_wg"],
            "pair_mlp_wg_bf16": bf16["pair_mlp_wg_bf16"], "edge_embedder": bf16["edge_embedder"],
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
             (emb, "edge_embedder_bwd", emb.edge_embedder_bwd_plain),
             (pm, "pair_mlp", pm.pair_mlp_plain),
             (pm, "pair_mlp_bwd", pm.pair_mlp_bwd_plain),
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
    from framedipt_tpu_torch.model.ipa import EdgeTransition, InvariantPointAttention
    from framedipt_tpu_torch.sampling import sample

    ipa_on = any(m.use_kernel for m in model.modules() if isinstance(m, InvariantPointAttention))
    feats = serving_feats()

    def run() -> None:
        sample(model, diffuser, feats, torch.Generator(device="cuda").manual_seed(2),
               num_t=num_t, min_t=0.01, noise_scale=0.1, inpainting=True)
        torch.cuda.synchronize()

    run()
    wall = wall_ms(run)
    busy, by_name = device_time(run)
    if not by_name:
        log("sampler profile: torch.profiler recorded no device time (busy share not measured)")
        return
    dtype = next(m.dtype for m in model.modules() if isinstance(m, EdgeTransition))
    log(f"sampler B=2 N=256 num_t={num_t} ({num_t + 1} forwards, use_pallas_ipa={ipa_on}, "
        f"{str(dtype)[6:]}): "
        f"{wall:.1f} ms wall, "
        f"{busy:.1f} ms of device time, busy share {busy / wall:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:9.3f} ms  {name[:100]}")


# -- phase 6: the train step -------------------------------------------------


# Kernel step against plain-version step, per gradient on the scale of
# max(its own max-abs, 1e-3 x the largest): the kernels sum in other orders
# than cuBLAS (measured worst 3.7e-6 at full width).
TRAIN_TOL = 1e-4


# Phase 6's peak memory with the earlier persistent float32 pair-MLP
# backward kernel (PERF.md section 5; NVIDIA H100 80GB HBM3, 700 W), printed
# for reference.
STEP_PEAK_GB_PERSISTENT_BWD = {"pallas": 2.477, "xla": 3.063}
# The same with the persistent float32 embedder backward kernel (PERF.md
# section 5; NVIDIA H100 80GB HBM3, 700 W).
STEP_PEAK_GB_PERSISTENT_EMB_BWD = {"pallas": 2.179, "xla": 2.245}


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


def train_config(emb_bwd_impl: str = "pallas", dtype: str = "float32"):
    from framedipt_tpu_torch.tools.config import load_config

    # Full default width; "pallas" is the default embedder backward.
    cfg = load_config([f"model.ipa.pallas_emb_bwd_impl={emb_bwd_impl}",
                       f"model.compute_dtype={dtype}"])
    cfg.experiment.inpainting = True
    return cfg


def fixture_trainer(cfg):
    """make_trainer on the card with the test fixtures' weights
    (``synth_state_dict``: every layer non-zero, the final ones damped), so
    the first step's comparison reaches every gradient; make_trainer's own
    default, the JAX package's initialization, zeroes the final layers and
    with them most first-step gradients."""
    from framedipt_tpu_torch.model.weights import synth_state_dict
    from framedipt_tpu_torch.train.loop import make_trainer

    trainer = make_trainer(cfg, device="cuda")
    trainer.model.load_state_dict(synth_state_dict(trainer.model), strict=True)
    return trainer


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


def expected_launches(self_conditioned: bool, emb_bwd_impl: str = "pallas",
                      bf16: bool = False) -> dict[str, int]:
    """A train step's launches: every embedder and pair-MLP forward (the
    autograd forward's and the coin's, under no_grad) and backward on the
    dtype's kernels (float32: wgmma, each backward's kernel A recomputing
    the wgmma forward's bits; bf16: the pair-MLP forwards on
    csrc/pair_mlp_wg_bf16.cu and csrc/pair_mlp_bwd_wg_bf16.cu, the embedder's
    on mma.sync)."""
    edge = NUM_BLOCKS - 1
    sc = int(self_conditioned)  # the coin's forward runs without gradients
    pair_fwd, pair_bwd = (("pair_mlp_wg_bf16", "pair_mlp_bwd_wg_bf16") if bf16
                          else ("pair_mlp_wg", "pair_mlp_bwd_wg"))
    emb_fwd, emb_bwd = (("edge_embedder", "edge_embedder_bwd") if bf16
                        else ("edge_embedder_wg", "edge_embedder_bwd_wg"))
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    launches[emb_fwd], launches[emb_bwd] = 1 + sc, int(emb_bwd_impl == "pallas")
    launches[pair_fwd], launches[pair_bwd] = edge * (1 + sc), edge
    return launches


def check_training_refusals() -> None:
    """On the card: a pair-MLP backward other than its kernel cannot be
    asked for (the override is refused), an unknown embedder backward
    raises, and the IPA attention kernel refuses to run where autograd
    records."""
    from framedipt_tpu_torch.geometry.rigid import Rigid
    from framedipt_tpu_torch.model.ipa import InvariantPointAttention
    from framedipt_tpu_torch.tools.config import IPAConfig, load_config
    from framedipt_tpu_torch.train.loop import make_trainer

    with expect_raise(KeyError, "pallas_bwd_impl"):
        load_config(["model.ipa.pallas_bwd_impl=xla"])
    with expect_raise(ValueError, "must be 'xla' or 'pallas'"):
        make_trainer(train_config("typo"), device="cuda")
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
        "pallas_emb_bwd_impl=typo raises ValueError, the IPA kernel branch raises under autograd")


@contextlib.contextmanager
def expect_raise(kind: type, text: str):
    try:
        yield
    except kind as e:
        if text not in str(e):
            raise AssertionError(f"{kind.__name__} without {text!r}: {e}") from e
    else:
        raise AssertionError(f"expected {kind.__name__} ({text})")


def compare_steps(kern, other, m_k, m_o, label: str) -> None:
    """Loss and every gradient of two trainers' first steps, each gradient
    on the scale of max(its own max-abs, 1e-3 x the largest)."""
    if m_o["self_conditioned"] != m_k["self_conditioned"]:
        raise AssertionError(f"the {label} step drew another self-conditioning coin")
    grads_k = {n: p.grad for n, p in kern.model.named_parameters() if p.grad is not None}
    grads_o = {n: p.grad for n, p in other.model.named_parameters() if p.grad is not None}
    if grads_k.keys() != grads_o.keys():
        raise AssertionError(f"kernel and {label} steps give gradients to different parameters")
    largest = max(float(g.abs().max()) for g in grads_o.values())
    worst, worst_name = 0.0, ""
    for name, g in grads_k.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"first train step: gradient of {name} not finite")
        ref = grads_o[name]
        scale = max(float(ref.abs().max()), 1e-3 * largest)
        rel = float((g - ref).abs().max()) / scale
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(float(m_k["loss"]) - float(m_o["loss"])) / abs(float(m_o["loss"]))
    log(f"  against the {label} step: loss {float(m_k['loss']):.6f} / {float(m_o['loss']):.6f} "
        f"(rel {loss_rel:.2e}); grad norm {float(m_k['grad_norm']):.4f} / "
        f"{float(m_o['grad_norm']):.4f}; {len(grads_k)} gradients, worst {worst:.2e} of "
        f"max(own max-abs, 1e-3 x largest) ({worst_name}; tol {TRAIN_TOL})")
    if loss_rel > TRAIN_TOL or worst > TRAIN_TOL:
        raise AssertionError(f"first train step: kernels and the {label} step disagree")


def time_steps(trainer, batch, gen, steps: int = 5) -> tuple[float, float, list]:
    """(ms a step by CUDA events over ``steps`` steps after 3 warm ones, peak
    memory allocated in GB, the self-conditioning coins)."""
    for _ in range(3):
        trainer.step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    coins = []
    start_ev.record()
    for _ in range(steps):
        coins.append(trainer.step(batch, gen)["self_conditioned"])
    end_ev.record()
    torch.cuda.synchronize()
    return start_ev.elapsed_time(end_ev) / steps, torch.cuda.max_memory_allocated() / 1e9, coins


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


# Each profiler session opens with PROFILE_LEAD spin kernels of
# PROFILE_LEAD_CYCLES each (about 1.3 ms at the H100's 1.98 GHz, 80 ms in
# all), left out of the times. Once a process has run a few profiles, kineto
# drops the first kernel records of each session as out of its window
# ("Record counts: Out-of-range = N" in its log at KINETO_LOG_LEVEL=1; N grows
# over the run and with a session's size): without the lead, phase 3 lost
# bf16 kernel A, the first kernel of its backward after a fill (PERF.md
# section 7). A session that loses every lead kernel may have lost
# some of its own; such sessions are counted and printed.
PROFILE_LEAD = 64
PROFILE_LEAD_CYCLES = 2_500_000
# Over this run: profiler sessions, those that lost lead kernels, lead
# kernels lost, sessions that lost all of them (printed at the end).
PROFILE_LEAD_LOST = {"sessions": 0, "sessions losing lead kernels": 0, "lead kernels lost": 0,
                     "sessions losing every lead kernel": 0}


def device_time(fn) -> tuple[float, dict[str, float]]:
    """(device ms, device ms by kernel name) of one call of ``fn`` under
    torch.profiler, after the PROFILE_LEAD spin kernels; 0 and {} if the
    profiler records no device time. A session that lost every lead kernel
    (and so perhaps some of fn's) is logged and counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    lead = 0
    for e in prof.events():
        # Kernels and copies only: the optimizer's record_function range
        # also lands on the device timeline.
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        if "spin_kernel" in e.name:
            lead += 1
        else:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if by_name:
        PROFILE_LEAD_LOST["sessions"] += 1
        PROFILE_LEAD_LOST["sessions losing lead kernels"] += lead < PROFILE_LEAD
        PROFILE_LEAD_LOST["lead kernels lost"] += PROFILE_LEAD - lead
        if lead == 0:
            PROFILE_LEAD_LOST["sessions losing every lead kernel"] += 1
            log(f"torch.profiler lost all {PROFILE_LEAD} lead kernels of a session: its own "
                "first kernels may be missing from its times")
    return sum(by_name.values()), by_name


# bf16 step against the same step through every kernel's plain version:
# the loss, relative (the two sum in other orders and round to bf16 at the
# same points).
BF16_TRAIN_TOL = 5e-2


def check_bf16_step(batch) -> tuple[object, int]:
    """The bf16 train step (``model.compute_dtype=bfloat16``: both edge
    kernels and both backwards in bf16) at full width on ``batch``: the
    first step's loss within BF16_TRAIN_TOL of the plain-version step's,
    each gradient's error against its own max-abs printed; then 3 steps,
    finite, 3 pair-MLP and 1 embedder backward launches each. Returns the
    trainer and each kernel's launches over those 3 steps."""
    kern = fixture_trainer(train_config(dtype="bfloat16"))
    plain = fixture_trainer(train_config(dtype="bfloat16"))
    m_k, launches = step_launches(kern, batch, seed=0)
    if launches != expected_launches(m_k["self_conditioned"], bf16=True):
        raise AssertionError(f"first bf16 train step: launches {launches}")
    with plain_versions_in_model():
        m_p = plain.step(batch, torch.Generator(device="cuda").manual_seed(0))
    if m_p["self_conditioned"] != m_k["self_conditioned"]:
        raise AssertionError("the plain-version bf16 step drew another self-conditioning coin")
    grads_p = {n: p.grad for n, p in plain.model.named_parameters() if p.grad is not None}
    errs = {}
    for n, p in kern.model.named_parameters():
        if p.grad is None:
            continue
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"first bf16 train step: gradient of {n} not finite")
        errs[n] = float((p.grad - grads_p[n]).abs().max()) / max(
            float(grads_p[n].abs().max()), 1e-30)
    loss_rel = abs(float(m_k["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"]))
    log(f"train step B={batch['aatype'].shape[0]} N={batch['aatype'].shape[1]} bf16, first step "
        f"(self_conditioned={m_k['self_conditioned']}), launches {launches}; against the "
        f"plain-version step: loss {float(m_k['loss']):.6f} / {float(m_p['loss']):.6f} (rel "
        f"{loss_rel:.2e}, tol {BF16_TRAIN_TOL}); grad norm {float(m_k['grad_norm']):.4f} / "
        f"{float(m_p['grad_norm']):.4f}; {len(errs)} gradients, error over own max-abs, largest "
        "first: " + ", ".join(f"{n} {e:.2e}" for n, e in sorted(errs.items(), key=lambda kv: -kv[1])))
    if grads_p.keys() != errs.keys():
        raise AssertionError("kernel and plain-version bf16 steps train different parameters")
    if not loss_rel <= BF16_TRAIN_TOL:
        raise AssertionError(f"first bf16 train step: loss rel err {loss_rel} over {BF16_TRAIN_TOL}")
    del plain
    torch.cuda.empty_cache()
    total = dict.fromkeys(KERNEL_NAMES, 0)
    for i in range(3):
        m, launches = step_launches(kern, batch, seed=300 + i)
        if not (np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))):
            raise AssertionError(f"bf16 train step {i}: loss {m['loss']} grad norm {m['grad_norm']}")
        if launches != expected_launches(m["self_conditioned"], bf16=True):
            raise AssertionError(f"bf16 train step {i}: launches {launches}")
        total = {k: total[k] + launches[k] for k in total}
        log(f"  bf16 step {i}: loss {float(m['loss']):.4f}, grad norm "
            f"{float(m['grad_norm']):.4f}, launches {launches}")
    return kern, total


def check_train_step() -> dict[str, int]:
    """Phase 6. Returns each kernel's launches over the 10 float32 and 3
    bf16 steps checked for correctness."""
    B, N = 2, 256
    batch = train_batch(B, N)
    kern = fixture_trainer(train_config())
    plain = fixture_trainer(train_config())  # the same weights
    xla = fixture_trainer(train_config("xla"))
    m_k, launches = step_launches(kern, batch, seed=0)
    if launches != expected_launches(m_k["self_conditioned"]):
        raise AssertionError(f"first train step: launches {launches}")
    with plain_versions_in_model():
        m_p = plain.step(batch, torch.Generator(device="cuda").manual_seed(0))
    m_x, launches_x = step_launches(xla, batch, seed=0)
    if launches_x != expected_launches(m_x["self_conditioned"], "xla"):
        raise AssertionError(f"first train step with the xla embedder backward: launches {launches_x}")
    log(f"train step B={B} N={N} float32, first step (self_conditioned={m_k['self_conditioned']}), "
        f"launches {launches}")
    compare_steps(kern, plain, m_k, m_p, "plain-version")
    compare_steps(kern, xla, m_k, m_x, '"xla" embedder backward')
    del plain
    torch.cuda.empty_cache()

    # 10 steps at lr 1e-4: finite, parameters move, 3 + 1 backward launches each.
    start = {n: p.detach().clone() for n, p in kern.model.named_parameters()}
    total = dict.fromkeys(KERNEL_NAMES, 0)
    for i in range(10):
        m, launches = step_launches(kern, batch, seed=100 + i)
        if not (np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))):
            raise AssertionError(f"train step {i}: loss {m['loss']} grad norm {m['grad_norm']}")
        if launches != expected_launches(m["self_conditioned"]):
            raise AssertionError(f"train step {i}: launches {launches}")
        total = {k: total[k] + launches[k] for k in total}
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

    kern16, bf16_launches = check_bf16_step(batch)
    total = {k: total[k] + bf16_launches[k] for k in total}

    # Step time (CUDA events), peak memory, the settings in turn; busy share.
    gen = torch.Generator(device="cuda").manual_seed(200)
    trainers = {"float32 (pallas_emb_bwd_impl=pallas)": kern,
                "float32 (pallas_emb_bwd_impl=xla)": xla, "bf16 (pallas)": kern16}
    for label in list(trainers) + list(trainers)[::-1]:
        step_ms, peak_gb, coins = time_steps(trainers[label], batch, gen)
        line = (f"train step B={B} N={N} {label}: {step_ms:.3f} ms a step (CUDA events over 5 "
                f"steps after 3 warm; self-conditioned {sum(coins)} of 5), "
                f"{1e3 * B / step_ms:.2f} examples/s, peak memory {peak_gb:.3f} GB (three "
                "trainers resident")
        impl = label.split("=")[-1].rstrip(")")
        if label.startswith("float32"):
            line += (f"; with the persistent pair-MLP backward kernel "
                     f"{STEP_PEAK_GB_PERSISTENT_BWD[impl]} GB, with the persistent float32 "
                     f"embedder backward kernel {STEP_PEAK_GB_PERSISTENT_EMB_BWD[impl]} GB")
        log(line + ")")
    for label in ("float32 (pallas_emb_bwd_impl=pallas)", "bf16 (pallas)"):
        trainer = trainers[label]
        wall = wall_ms(lambda: [trainer.step(batch, gen) for _ in range(5)])
        busy, by_name = device_time(lambda: [trainer.step(batch, gen) for _ in range(5)])
        log(f"train step B={B} N={N} {label}: 5 steps {wall:.1f} ms wall, "
            + (f"{busy:.1f} ms of device time over 5 more under torch.profiler, busy share "
               f"{busy / wall:.3f}" if by_name else
               "torch.profiler recorded no device time (busy share not measured)"))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            log(f"  {ms:9.3f} ms  {name[:100]}")
        kernel_b = {re.search(r"wgrad_\w+(<[^>]*>)?", n).group(0): ms
                    for n, ms in by_name.items() if "wgrad_" in n}
        log(f"  kernel B of the split backwards: {sum(kernel_b.values()):.3f} ms ("
            + ", ".join(f"{n} {ms:.3f}" for n, ms in kernel_b.items()) + ")")
        embedder = {re.search(r"(emb|edge_embedder)\w*", n).group(0): ms
                    for n, ms in by_name.items() if re.search(r"emb_|edge_embedder", n)}
        log(f"  the edge embedder's kernels: {sum(embedder.values()):.3f} ms ("
            + ", ".join(f"{n} {ms:.3f}" for n, ms in embedder.items()) + ")")
    return total


# -- phase 7: the training CLI -----------------------------------------------


def cli_overrides(data_dir: pathlib.Path, root: pathlib.Path) -> list[str]:
    """The CLI's settings for phase 7: the default model and diffuser, the
    fixtures' single chains of 11-242 residues uncropped, 14-21 steps with
    checkpoints at 3 (early) and every 5, one eval at step 12."""
    return [
        f"data.csv_path={data_dir / 'metadata.csv'}", "data.single_chain=true",
        "data.filtering.min_len=10", "data.filtering.max_len=2000",
        "data.filtering.chain_max_len=256", "data.num_eval_lengths=1",
        "data.samples_per_eval_length=2", "data.num_t=10",
        "experiment.inpainting=true", "experiment.batch_size=2", "experiment.num_epoch=7",
        "experiment.log_freq=5", "experiment.ckpt_freq=5", "experiment.early_ckpt_step=3",
        "experiment.eval_freq=12", "experiment.name=chip_smoke",
        f"experiment.ckpt_dir={root / 'ckpt'}", f"experiment.eval_dir={root / 'eval'}",
    ]


def check_training_cli() -> int:
    """Phase 7: preprocess, train, checkpoint, eval, resume, serve. Returns
    the embedder backward kernel's launches over the first run."""
    import tempfile

    from framedipt_tpu_torch.data.pipeline import ProcessOptions, process_serially, write_metadata
    from framedipt_tpu_torch.experiments.serve import InpaintingService
    from framedipt_tpu_torch.experiments.train import TrainDataset, train
    from framedipt_tpu_torch.tools.config import Config, FilteringConfig, load_config
    from framedipt_tpu_torch.train.checkpoints import CKPT_FILE, latest_checkpoint
    from framedipt_tpu_torch.train.loop import make_trainer

    wrappers = kernel_wrappers()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        cifs = sorted((REPO / "tests" / "data" / "cifs").glob("*.cif"))
        rows = process_serially(cifs, ProcessOptions(
            output_dir=root / "data",
            filtering=FilteringConfig(min_len=10, max_len=2000, chain_max_len=256)))
        if len(rows) != len(cifs):
            raise AssertionError(f"preprocessing kept {len(rows)} of {len(cifs)} structures")
        write_metadata(rows, root / "data" / "metadata.csv")
        log(f"preprocessed {len(rows)} mmCIF files in {time.perf_counter() - t0:.2f} s "
            f"({[(r['pdb_name'], r['seq_len']) for r in rows]})")

        cfg = load_config(cli_overrides(root / "data", root))
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        first = train(cfg, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        rows = [json.loads(x) for x in (first.ckpt_dir / "metrics.jsonl").read_text().splitlines()]
        losses = {r["step"]: r["loss"] for r in rows if "loss" in r}
        evals = [r for r in rows if "eval_ca_ca_deviation" in r]
        log(f"train run: {first.steps_run} steps in {run_s:.2f} s (loop {first.loop_seconds:.2f} s, "
            f"{first.input_wait_seconds:.2f} s of it waiting for batches); losses "
            f"{ {k: round(v, 4) for k, v in losses.items()} }; launches {launches}")
        if not 14 <= first.steps_run <= 21 or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train run: {first.steps_run} steps, losses {losses}")
        if launches["edge_embedder_bwd_wg"] != first.steps_run or launches["pair_mlp_bwd_wg"] != (
                NUM_BLOCKS - 1) * first.steps_run:
            raise AssertionError(f"train run: launches {launches} for {first.steps_run} steps")
        pdbs = sorted((root / "eval" / "chip_smoke" / "step_12").rglob("*.pdb"))
        if len(evals) != 1 or evals[0]["step"] != 12 or len(pdbs) != 2:
            raise AssertionError(f"eval: rows {evals}, PDBs {pdbs}")
        log(f"eval at step 12: {len(pdbs)} PDBs ({pdbs[0].parent.name}), "
            f"{ {k: round(v, 4) for k, v in evals[0].items() if k.startswith('eval_')} }")
        ckpts = sorted(p.name for p in first.ckpt_dir.glob("step_*"))
        if ckpts != [f"step_{first.step}"] or not (first.ckpt_dir / ckpts[0] / CKPT_FILE).exists():
            raise AssertionError(f"checkpoints: {ckpts}")
        log(f"checkpoints: {ckpts} ({(first.ckpt_dir / ckpts[0] / CKPT_FILE).stat().st_size} bytes)")

        # Resume from the run's own directory for three more epochs.
        cfg = load_config(cli_overrides(root / "data", root) + [
            "experiment.num_epoch=3", "experiment.ckpt_freq=1000", "experiment.early_ckpt=false",
            "experiment.eval_freq=1000"])
        resumed = train(cfg, device="cuda")
        if resumed.step != first.step + resumed.steps_run or resumed.steps_run < 1 or (
                latest_checkpoint(resumed.ckpt_dir).name != f"step_{resumed.step}"):
            raise AssertionError(f"resume: step {resumed.step} after {first.step}, "
                                 f"{resumed.steps_run} run")
        with_pipeline = resumed.steps_run / resumed.loop_seconds
        # The same number of steps on batches already on the card (no input
        # pipeline), timed, then again under the profiler for device time.
        trainer = make_trainer(cfg, device="cuda", state_dict=resumed.model.state_dict())
        epoch = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
                 for b in TrainDataset(cfg, np.random.default_rng(cfg.experiment.seed)).batches(
                     cfg.experiment.batch_size)]
        batches = [epoch[i % len(epoch)] for i in range(resumed.steps_run)]
        gen = torch.Generator(device="cuda").manual_seed(1)
        trainer.step(batches[0], gen)
        in_memory_ms = wall_ms(lambda: [trainer.step(b, gen) for b in batches])
        busy, _ = device_time(lambda: [trainer.step(b, gen) for b in batches])
        log(f"resumed run: steps {first.step} -> {resumed.step}; {with_pipeline:.3f} steps/s with "
            f"the input pipeline (loop {resumed.loop_seconds:.3f} s, "
            f"{resumed.input_wait_seconds:.3f} s waiting for batches), "
            f"{1e3 * len(batches) / in_memory_ms:.3f} steps/s on the same number of batches "
            "already on the card; "
            + (f"{busy:.1f} ms of device time for them (torch.profiler): busy share "
               f"{busy / in_memory_ms:.3f} without the pipeline, "
               f"{busy / (1e3 * resumed.loop_seconds):.3f} of the resumed loop"
               if busy else "busy share not measured (no device time recorded)"))
        del trainer

        # Serve the checkpoint: one /inpaint request.
        scfg = Config()
        scfg.inference.weights_path = str(latest_checkpoint(resumed.ckpt_dir) / CKPT_FILE)
        service = InpaintingService(scfg, device="cuda")
        serve_requests(service, [(230, (100, 112), 25)])
        del service
    torch.cuda.empty_cache()
    return launches["edge_embedder_bwd_wg"]


# -- phase 8: the batch inpainting CLI ----------------------------------------

CLI_NUM_T = 100
# The EigenFold score with every kernel against the same score with every
# kernel's plain version, relative (1.85e-7 measured at num_t 25); and the
# noise_scale=0 structure's diffused CA against the plain-version run's, in
# A (under the PDB text's 1e-3 A measured). NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6.
CONFIDENCE_TOL = 1e-5
DIFFUSED_CA_TOL = 1e-3


def cli_config(root: pathlib.Path, name: str, *overrides: str):
    """Phase 8's CLI settings: the full default model and diffuser in
    float32, the JAX package's initialization, the TCR database's pMHC-II
    complexes (CDR3 of both TCR chains), two samples of CLI_NUM_T steps;
    then ``overrides`` (dotted, as on the command line)."""
    from framedipt_tpu_torch.tools.config import load_config

    return load_config([
        f"data.csv_path={REPO / 'database' / 'TCR_pMHC_II.csv'}", "inference.weights_path=",
        f"inference.output_dir={root}", f"inference.name={name}",
        f"inference.diffusion.num_t={CLI_NUM_T}", "inference.inpainting_samples.samples=2",
        *overrides,
    ])


def tree_files(run_dir: pathlib.Path) -> dict[str, int]:
    """Every file under ``run_dir`` with its mtime (ns)."""
    return {str(f.relative_to(run_dir)): f.stat().st_mtime_ns
            for f in sorted(run_dir.rglob("*")) if f.is_file()}


def check_tree(run_dir: pathlib.Path, cases: list[str], samples: int, num_t: int,
               confidence: bool = False) -> dict[str, dict]:
    """The CLI's tree for ``cases`` (pdb names): per case the ground truth
    with its diffused residues marked, diffusion_info.csv with its regions
    inside TCR chains A and B, and per sample the structure (the ground
    truth's residues, finite, the fixed CA equal to the ground truth's
    within 1e-3 A) and both trajectories of num_t models. Returns per case
    its directory, ground truth and samples."""
    import csv as csv_lib

    from framedipt_tpu_torch.data.protein import from_pdb_string

    if not (run_dir / "inference_conf.json").exists():
        raise AssertionError(f"{run_dir}: no inference_conf.json")
    found = {}
    for pdb in cases:
        dirs = sorted(run_dir.glob(f"{pdb}_length_*"))
        if len(dirs) != 1:
            raise AssertionError(f"{pdb}: case directories {dirs}")
        case = dirs[0]
        gt = from_pdb_string((case / f"{pdb}_1.pdb").read_text())
        diffused = gt.b_factors.max(axis=-1) == 100.0
        if int(diffused.sum()) != int(case.name.rsplit("_", 1)[1]):
            raise AssertionError(f"{case.name}: {int(diffused.sum())} residues marked diffused")
        with open(case / "diffusion_info.csv", newline="") as f:
            rows = list(csv_lib.reader(f, delimiter="\t"))
        if rows[0] != ["pdb_name", "seq", "chain", "start", "end"] or len(rows) != 2:
            raise AssertionError(f"{case.name}: diffusion_info.csv {rows[:1]}")
        info = dict(zip(rows[0], rows[1]))
        chains = info["chain"].split(",")
        starts = [int(x) for x in info["start"].split(",")]
        ends = [int(x) for x in info["end"].split(",")]
        chain_len = {c: int((gt.chain_index == i).sum())
                     for i, c in enumerate("ABCDEFGH") if (gt.chain_index == i).any()}
        if (sorted(chains) != ["A", "B"] or info["pdb_name"] != pdb
                or any(not 0 <= s_ <= e < chain_len[c] for c, s_, e in zip(chains, starts, ends))):
            raise AssertionError(f"{case.name}: diffusion_info {info['chain']} {starts} {ends}, "
                                 f"chains {chain_len}")
        worst = 0.0
        prots = []
        for s in range(samples):
            sd = case / f"sample_{s}"
            prot = from_pdb_string((sd / f"sample_{s}_1.pdb").read_text())
            if len(prot.aatype) != len(gt.aatype) or not np.isfinite(prot.atom_positions).all():
                raise AssertionError(f"{sd}: {len(prot.aatype)} residues or non-finite")
            ca_err = float(np.abs(prot.atom_positions[~diffused, 1]
                                  - gt.atom_positions[~diffused, 1]).max())
            if not ca_err <= 1e-3 + 1e-9:
                raise AssertionError(f"{sd}: fixed CA moved {ca_err} A")
            worst = max(worst, ca_err)
            for traj in ("bb_traj", "x0_traj"):
                with open(sd / f"{traj}_{s}_1.pdb") as f:
                    models = sum(line.startswith("MODEL") for line in f)
                if models != num_t:
                    raise AssertionError(f"{sd}: {traj} has {models} models")
            if confidence and not np.isfinite(float((sd / "confidence_score.txt").read_text())):
                raise AssertionError(f"{sd}: confidence score not finite")
            prots.append(prot)
        found[pdb] = {"dir": case, "gt": gt, "diffused": diffused, "samples": prots,
                      "fixed_ca_dev": worst, "regions": (info["chain"], starts, ends)}
    if sorted(p.name.split("_length_")[0] for p in run_dir.glob("*_length_*")) != sorted(cases):
        raise AssertionError(f"{run_dir}: cases {sorted(run_dir.glob('*_length_*'))}")
    return found


@contextlib.contextmanager
def counted_sampler():
    """For phase 8's reading only: each sampler call of the CLI is timed
    (host clock, synchronised) and its kernel launches counted; yields the
    list of (launches, seconds, outputs) it fills."""
    from framedipt_tpu_torch.experiments import inference as cli

    wrappers = kernel_wrappers()
    real = cli.sample
    calls = []

    def counted(*args, **kwargs):
        torch.cuda.synchronize()
        before = {name: fn.launches for name, fn in wrappers.items()}
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append(({name: fn.launches - before[name] for name, fn in wrappers.items()},
                      time.perf_counter() - t0, out))
        return out

    cli.sample = counted
    try:
        yield calls
    finally:
        cli.sample = real


def timed_writer(inf, first: list | None = None) -> list[float]:
    """Times each save_traj call of ``inf``; appends the first call's
    (args, kwargs) to ``first`` when given."""
    real = inf.save_traj
    times = []

    def save_traj(*args, **kwargs):
        if first is not None and not first:
            first.append((args, kwargs))
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out

    inf.save_traj = save_traj
    return times


# The batched CLI with the Python writer (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6): the writer's seconds and the seconds a structure.
PYTHON_WRITER_S, PYTHON_WRITER_S_PER_STRUCTURE = 29.82, 20.65


def check_native_writer() -> float:
    """The native PDB writer must build and load on the card's host: the
    writers then take it (no Python fallback). Returns the seconds of the
    call (the build on the first call, after that a cached load)."""
    from framedipt_tpu_torch import native

    t0 = time.perf_counter()
    if native.load_pdb_writer() is None:
        raise AssertionError("the native PDB writer did not build or load (see the warning)")
    return time.perf_counter() - t0


def check_trajectory_text(first_call) -> None:
    """One real trajectory (the first save_traj call: the first case's
    sample 0 bb_traj): the file the CLI wrote, the native text of its frames
    and the pure-Python text of the same frames byte-equal; both writers
    timed on it."""
    from framedipt_tpu_torch.analysis.utils import _as_protein, prot_pos_to_pdb
    from framedipt_tpu_torch.data.protein import prots_to_pdb

    (bb_traj, _, diffuse_mask), kw = first_call[0]
    b_factors = np.tile((diffuse_mask.astype(bool) * 100.0)[:, None], (1, 37))
    common = dict(aatype=kw["aatype"], residue_index=kw["residue_index"],
                  chain_index=kw["chain_index"], b_factors=b_factors)
    t0 = time.perf_counter()
    native_text = prot_pos_to_pdb(bb_traj, **common)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python_text = prots_to_pdb([
        _as_protein(frame, kw["aatype"], b_factors, kw["residue_index"], kw["chain_index"])
        for frame in bb_traj])
    python_s = time.perf_counter() - t0
    path = kw["output_dir"] / f"bb_traj_{kw['sample_idx']}_1.pdb"
    file_text = path.read_text()
    log(f"trajectory text {path.parent.parent.name}/{path.parent.name}/{path.name}: "
        f"{bb_traj.shape[0]} models x {bb_traj.shape[1]} residues, {len(native_text)} bytes; "
        f"native writer {native_s:.3f} s, Python writer {python_s:.3f} s "
        f"({python_s / native_s:.1f}x)")
    if not (file_text == native_text == python_text):
        raise AssertionError(f"{path}: the CLI's file, the native text and the Python text differ")


def forward_launches(forwards: int) -> dict[str, int]:
    """Each kernel's launches over ``forwards`` float32 model forwards
    without gradients (the edge embedder and the pair MLP on their wgmma
    kernels) and with the IPA attention as einsums."""
    return {"edge_embedder": 0, "edge_embedder_wg": forwards,
            "pair_mlp_wg": (NUM_BLOCKS - 1) * forwards, "pair_mlp_wg_bf16": 0, "ipa_attention": 0,
            "pair_mlp_bwd_wg_bf16": 0, "pair_mlp_bwd_wg": 0, "edge_embedder_bwd": 0,
            "edge_embedder_bwd_wg": 0}


def check_inference_cli(root: pathlib.Path) -> tuple[dict[str, int], pathlib.Path]:
    """Phase 8, in ``root``. Returns each kernel's launches over the batched
    run and the batched run's tree."""
    import shutil

    from framedipt_tpu_torch.experiments.inference import Inference
    from framedipt_tpu_torch.model.weights import synth_state_dict
    from framedipt_tpu_torch.sampling import sample
    from framedipt_tpu_torch.sampling.confidence import logp_confidence_score

    wrappers = kernel_wrappers()
    cifs = REPO / "tests" / "data" / "cifs"
    cases = sorted(p.name.split("-")[0] for p in cifs.glob("*.cif"))
    check_native_writer()
    log("native PDB writer loaded")
    one = root / "cifs_1fyt"
    one.mkdir()
    shutil.copy(cifs / "1fyt-assembly1.cif", one)

    # The batched loop over the three complexes.
    cfg = cli_config(root, "batched")
    t0 = time.perf_counter()
    inf = Inference(cfg, cif_dir=cifs, device="cuda")
    setup_s = time.perf_counter() - t0
    first_call = []
    writes = timed_writer(inf, first_call)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with counted_sampler() as calls:
        inf.run_sampling()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    want = forward_launches(CLI_NUM_T + 1)
    if len(calls) != len(cases) or any(c[0] != want for c in calls):
        raise AssertionError(f"batched run: launches per case {[c[0] for c in calls]}, "
                             f"expected {want} for each of {len(cases)}")
    found = check_tree(inf.output_dir, cases, 2, CLI_NUM_T)
    order = [path.stem[:4] for path in inf.sampler.cif_paths]  # the CSV's order
    n_res = {pdb: len(f["gt"].aatype) for pdb, f in found.items()}
    log(f"CLI batched: {len(cases)} complexes x 2 samples, num_t={CLI_NUM_T}, bucket "
        f"{sorted({((n + 127) // 128) * 128 for n in n_res.values()})}: {run_s:.2f} s "
        f"({run_s / len(cases):.2f} s a structure, {setup_s:.2f} s to set up); sampler "
        + ", ".join(f"{pdb} N={n_res[pdb]} {c[1]:.2f} s" for pdb, c in zip(order, calls))
        + f"; writer {len(writes)} save_traj calls, {sum(writes):.2f} s in all "
        f"(max {max(writes):.2f} s); launches {launches}")
    log(f"CLI writer {sum(writes):.2f} s in all (with the Python writer {PYTHON_WRITER_S} s), "
        f"{run_s / len(cases):.2f} s a structure (with the Python writer "
        f"{PYTHON_WRITER_S_PER_STRUCTURE} s)")
    for pdb, f in found.items():
        log(f"  {f['dir'].name}: regions {f['regions']}, fixed CA max dev "
            f"{f['fixed_ca_dev']:.1e} A")
    check_trajectory_text(first_call)
    del first_call

    # The device's busy share of one case (the first), run again.
    items = [inf.sampler[s] for s in range(2)]
    feats = inf._to_device({k: np.concatenate([it[2][k] for it in items]) for k in items[0][2]})

    def one_case():
        sample(inf.model, inf.diffuser, feats, inf._generator(0),
               num_t=CLI_NUM_T, min_t=0.01, noise_scale=0.1, inpainting=True, aux_traj=True)
        torch.cuda.synchronize()

    wall = wall_ms(one_case)
    busy, by_name = device_time(one_case)
    log(f"CLI case {items[0][0]} B=2 N={feats['res_mask'].shape[1]} num_t={CLI_NUM_T}: "
        f"{wall:.1f} ms wall, " + (
            f"{busy:.1f} ms of device time, busy share {busy / wall:.3f}" if by_name else
            "torch.profiler recorded no device time (busy share not measured)"))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:9.3f} ms  {name[:100]}")
    del feats

    # Resume: a second run over the same tree writes nothing.
    before = tree_files(inf.output_dir)
    again = Inference(cfg, cif_dir=cifs, device="cuda")
    for fn in wrappers.values():
        fn.launches = 0
    with counted_sampler() as calls:
        again.run_sampling()
    after = tree_files(inf.output_dir)
    before.pop("inference_conf.json"), after.pop("inference_conf.json")
    if calls or after != before or any(fn.launches for fn in wrappers.values()):
        raise AssertionError(f"resume: {len(calls)} sampler calls, "
                             f"{len(set(after) ^ set(before))} files differ")
    log(f"CLI resume: no sampler call, {len(after)} files unchanged")
    inf_tree = inf.output_dir
    del inf, again
    torch.cuda.empty_cache()

    # The serial loop on one complex.
    cfg = cli_config(root, "serial", "inference.inpainting_samples.batch_samples=false")
    serial = Inference(cfg, cif_dir=one, device="cuda")
    writes = timed_writer(serial)
    t0 = time.perf_counter()
    with counted_sampler() as calls:
        serial.run_sampling()
    run_s = time.perf_counter() - t0
    if len(calls) != 2 or any(c[0] != want for c in calls):
        raise AssertionError(f"serial run: launches {[c[0] for c in calls]}")
    check_tree(serial.output_dir, ["1fyt"], 2, CLI_NUM_T)
    log(f"CLI serial: 1fyt 2 samples one at a time, num_t={CLI_NUM_T}: {run_s:.2f} s; "
        f"sampler {[round(c[1], 2) for c in calls]} s; writer {sum(writes):.2f} s")
    del serial
    torch.cuda.empty_cache()

    # The rest on the test fixtures' weights (every layer non-zero): the
    # JAX package's initialization zeroes the final layers, so its
    # predictions equal its inputs and no kernel moves a coordinate.
    def fixture_cli(name, num_t, *overrides, plain=False):
        cfg = cli_config(root, name, f"inference.diffusion.num_t={num_t}", *overrides)
        run = Inference(cfg, cif_dir=one, device="cuda")
        run.model.load_state_dict(synth_state_dict(run.model), strict=True)
        with counted_sampler() as calls, (
                plain_versions_in_model() if plain else contextlib.nullcontext()):
            t0 = time.perf_counter()
            run.run_sampling()
            took = time.perf_counter() - t0
        return run, calls, took

    # EigenFold on one sample at num_t 25, against the plain versions.
    num_t = 25
    conf, calls, took = fixture_cli("eigenfold", num_t, "inference.inpainting_samples.samples=1",
                                    "inference.confidence_score=eigenfold")
    found = check_tree(conf.output_dir, ["1fyt"], 1, num_t, confidence=True)
    score_file = float((found["1fyt"]["dir"] / "sample_0" / "confidence_score.txt").read_text())
    feats = conf._to_device(conf.sampler[0][2])
    final = calls[0][2]["final_rigids"]
    dmask = (1.0 - feats["fixed_mask"]) * feats["res_mask"]
    scores, times = {}, {}
    for label in ("kernels", "plain", "plain", "kernels"):
        plain = plain_versions_in_model() if label == "plain" else contextlib.nullcontext()
        for fn in wrappers.values():
            fn.launches = 0
        with plain:
            t0 = time.perf_counter()
            scores[label] = float(logp_confidence_score(
                conf.model, conf.diffuser, feats, final, dmask, num_t=num_t, min_t=0.01,
                generator=conf._generator(0, 1000)))  # the CLI's stream for case 0, sample 0
            times.setdefault(label, []).append(time.perf_counter() - t0)
        # Two forwards a step of the ladder (self-conditioning, then scores).
        if label == "kernels" and {n: fn.launches for n, fn in wrappers.items()} != (
                forward_launches(2 * (num_t - 1))):
            raise AssertionError(f"confidence score: launches "
                                 f"{ {n: fn.launches for n, fn in wrappers.items()} }")
    rel = abs(scores["kernels"] - scores["plain"]) / abs(scores["plain"])
    log(f"CLI eigenfold 1fyt num_t={num_t} (fixture weights): run {took:.2f} s, score "
        f"{score_file!r} (file), recomputed with the kernels {scores['kernels']!r} "
        f"({min(times['kernels']):.2f} s), with the plain versions {scores['plain']!r} "
        f"({min(times['plain']):.2f} s): rel diff {rel:.2e} (tol {CONFIDENCE_TOL})")
    if scores["kernels"] != score_file and abs(scores["kernels"] - score_file) > 1e-6 * abs(
            score_file):
        raise AssertionError(f"confidence score {scores['kernels']} != file {score_file}")
    if not rel <= CONFIDENCE_TOL:
        raise AssertionError(f"confidence score: kernels vs plain rel diff {rel}")
    del conf, feats
    torch.cuda.empty_cache()

    # noise_scale 0, num_t 5: the kernels' structure against the plain versions'.
    kern, k_calls, _ = fixture_cli("det_kernels", 5, "inference.diffusion.noise_scale=0")
    plain, p_calls, _ = fixture_cli("det_plain", 5, "inference.diffusion.noise_scale=0",
                                    plain=True)
    got = check_tree(kern.output_dir, ["1fyt"], 2, 5)["1fyt"]
    ref = check_tree(plain.output_dir, ["1fyt"], 2, 5)["1fyt"]
    diffused = got["diffused"]
    fixed_dev = max(float(np.abs(a.atom_positions[~diffused, 1]
                                 - b.atom_positions[~diffused, 1]).max())
                    for a, b in zip(got["samples"], ref["samples"]))
    # The diffused CA in memory (float32), before the PDB text rounds it.
    feats = kern.sampler[0][2]
    rows = ((1.0 - feats["fixed_mask"][0]) * feats["res_mask"][0]) > 0
    ca = [c[0][2]["prot_traj"][0].cpu()[:, torch.as_tensor(rows), 1]
          for c in (k_calls, p_calls)]
    diff_dev = float((ca[0] - ca[1]).abs().max())
    log(f"CLI noise_scale=0 num_t=5 1fyt (fixture weights), kernels against plain versions: "
        f"fixed CA max diff {fixed_dev:.1e} A (PDB text), diffused CA max diff "
        f"{diff_dev:.3e} A (float32; tol {DIFFUSED_CA_TOL})")
    if not (fixed_dev <= 1e-3 + 1e-9 and diff_dev <= DIFFUSED_CA_TOL):
        raise AssertionError(f"noise_scale=0: fixed {fixed_dev}, diffused {diff_dev}")
    torch.cuda.empty_cache()
    return launches, inf_tree


# -- phase 9: the TCR evaluation CLI over phase 8's tree ----------------------


def read_csv_rows(path: pathlib.Path) -> list[dict[str, str]]:
    import csv as csv_lib

    with open(path, newline="") as f:
        return list(csv_lib.DictReader(f))


def check_tcr_eval(tree: pathlib.Path, out_root: pathlib.Path, cases: int, samples: int) -> None:
    """Phase 9: ``python -m framedipt_tpu_torch.eval.tcr_eval`` over phase
    8's batched tree, with ``--sasa`` and without: one row a sample with a
    finite backbone RMSD overall and per TCR chain, one row a case in each
    strategy's CSV, the RSA columns with ``--sasa``; the plots drawn where
    matplotlib and seaborn import, else skipped with the CLI's warning."""
    import importlib.util

    from framedipt_tpu_torch.eval.selection import SAMPLE_SELECTION_STRATEGIES

    have_plots = all(importlib.util.find_spec(m) is not None for m in ("matplotlib", "seaborn"))
    seconds = {}
    for label, extra in (("--sasa", ["--sasa"]), ("without --sasa", [])):
        out = out_root / ("eval_sasa" if extra else "eval")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "framedipt_tpu_torch.eval.tcr_eval",
             f"--prediction_dir={tree}", f"--output_dir={out}", *extra],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        seconds[label] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"tcr_eval {label} failed:\n{proc.stderr[-3000:]}")
        rows = read_csv_rows(out / "eval_metrics_all.csv")
        cols = ("backbone_rmsd", "bb_rmsd_alpha", "bb_rmsd_beta")
        if len(rows) != cases * samples or not all(
                np.isfinite(float(r[c])) for r in rows for c in cols):
            raise AssertionError(f"tcr_eval {label}: {len(rows)} rows, "
                                 f"{[[r.get(c) for c in cols] for r in rows]}")
        for strategy in SAMPLE_SELECTION_STRATEGIES:
            n = len(read_csv_rows(out / f"eval_metrics_{strategy}.csv"))
            if n != cases:
                raise AssertionError(f"tcr_eval {label}: {n} rows for {strategy}")
        if extra and not any(c.startswith("gt_rsa_alpha_") for c in rows[0]):
            raise AssertionError("tcr_eval --sasa: no RSA columns")
        pngs = sorted(p.name for p in out.glob("*.png"))
        warned = "matplotlib/seaborn unavailable; skipping plots" in proc.stderr
        if (have_plots and not pngs) or (not have_plots and (pngs or not warned)):
            raise AssertionError(f"tcr_eval {label}: plots {pngs}, warning {warned}, "
                                 f"matplotlib and seaborn {'present' if have_plots else 'missing'}")
        mean = np.mean([float(r["backbone_rmsd"]) for r in rows])
        log(f"tcr_eval {label}: {seconds[label]:.2f} s for {len(rows)} samples of {cases} "
            f"complexes, mean backbone RMSD {mean:.3f} A, "
            + (f"{len(pngs)} plots" if have_plots else "plots skipped with the warning"))
    log(f"tcr_eval: --sasa {seconds['--sasa']:.2f} s, without {seconds['without --sasa']:.2f} s "
        f"(the SASA {seconds['--sasa'] - seconds['without --sasa']:.2f} s)")


# -- phase 10: de novo design at full width ----------------------------------

DENOVO_LENGTHS = (100, 500)
DENOVO_SEQS = 8
# Recorded ProteinMPNN: log-probabilities and scores (and the tied and PSSM
# probs) within 2e-4; the CA-only model's log-probabilities within 3e-2 of
# the recording (tests/parity/test_mpnn_parity.py; its docstring says why).
MPNN_TOL, MPNN_CA_TOL = 2e-4, 3e-2


def check_recorded_denovo() -> None:
    """(a) The reference model at the de novo config (inpainting=False: the
    embedder without aatype), N=128, weights synthesised from the manifest
    of ``recorded_denovo_parity.npz``: the forward through the kernels
    within 5e-3 relative, then the 100-step reverse trajectory at
    noise_scale 0 against ``traj100::ca_traj`` (final CA-RMSD < 0.1 A,
    worst step < 0.5 A), with one edge-embedder and three pair-MLP launches
    a forward."""
    from framedipt_tpu_torch.diffusion import SE3Diffuser
    from framedipt_tpu_torch.model import ScoreNetwork
    from framedipt_tpu_torch.model.weights import synth_value
    from framedipt_tpu_torch.sampling import sample
    from framedipt_tpu_torch.tools.config import Config, resolve_kernel_flags

    z = np.load(REPO / "tests" / "parity" / "fixtures" / "recorded_denovo_parity.npz")
    cfg = Config()
    resolve_kernel_flags(cfg, torch.device("cuda"))
    diffuser = SE3Diffuser(cfg.diffuser, device="cuda")
    net = ScoreNetwork(cfg.model, diffuser, inpainting=False)
    net.load_state_dict({n: torch.as_tensor(synth_value(n, tuple(s)))
                         for n, s in json.loads(str(z["param_manifest"]))}, strict=True)
    net.to("cuda").eval()
    feats = {k[6:]: torch.as_tensor(z[k], device="cuda") for k in z.files if k.startswith("feat::")}
    with torch.inference_mode():
        out = net(feats)
    torch.cuda.synchronize()
    for key in ("psi", "atom37", "rot_score", "trans_score"):
        ref = z[f"out::{key}"]
        rel = float(np.abs(out[key].float().cpu().numpy() - ref).max()
                    / max(1.0, float(np.abs(ref).max())))
        log(f"recorded de novo forward N=128 {key}: rel err {rel:.3e} (tol 5e-3)")
        if not rel < 5e-3:
            raise AssertionError(f"recorded de novo forward {key}: rel err {rel}")
    ref_traj = z["traj100::ca_traj"]  # [T, N, 3], index 0 the final structure
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    traj = sample(net, diffuser, feats, torch.Generator(device="cuda").manual_seed(0),
                  num_t=ref_traj.shape[0], min_t=0.01, noise_scale=0.0,
                  inpainting=False)["prot_traj"][:, 0, :, 1].cpu().numpy()
    took = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items()}
    per_step = np.sqrt(np.mean(np.sum((ref_traj - traj) ** 2, axis=-1), axis=-1))
    log(f"recorded de novo trajectory N=128 num_t={ref_traj.shape[0]} noise_scale=0: final "
        f"CA-RMSD {per_step[0]:.4f} A (tol 0.1), worst step {per_step.max():.4f} A at step "
        f"{int(per_step.argmax())} (tol 0.5), {took:.2f} s, launches {launches}")
    if not (per_step[0] < 0.1 and per_step.max() < 0.5):
        raise AssertionError(f"recorded de novo trajectory: final {per_step[0]}, "
                             f"worst {per_step.max()}")
    if launches != forward_launches(ref_traj.shape[0] + 1):
        raise AssertionError(f"recorded de novo trajectory: launches {launches}")
    del net
    torch.cuda.empty_cache()


def mpnn_fixture(name: str, ca_only: bool):
    """(recording, the port's ProteinMPNN with the manifest's synthesised
    weights on the card, the inputs on the card)."""
    from framedipt_tpu_torch.model import mpnn
    from framedipt_tpu_torch.model.weights import synth_value

    z = np.load(REPO / "tests" / "parity" / "fixtures" / name, allow_pickle=False)
    sd = {str(n): torch.as_tensor(synth_value(str(n), tuple(int(x) for x in s.split(",")),
                                              seed=int(z["seed"])))
          for n, s in zip(z["manifest_names"], z["manifest_shapes"])}
    model = mpnn.ProteinMPNN(mpnn.MPNNConfig(k_neighbors=48, ca_only=ca_only))
    model.load_state_dict(sd, strict=True)
    f = {k[3:]: torch.as_tensor(z[k], device="cuda") for k in z.files if k.startswith("in_")}
    return z, model.to("cuda").eval(), f, sd


def check_recorded_mpnn() -> dict[str, torch.Tensor]:
    """(b) The port's ProteinMPNN on the card against the recorded reference
    ProteinMPNN, vanilla and CA-only: the log-probabilities (random and
    fixed order, unconditional, conditional and its backbone-only form) and
    the scores, the near-greedy sample's S and order, the tied sample's S,
    order and probs, the PSSM probs. Returns the vanilla manifest's weights
    (phase 10's design weights)."""
    from framedipt_tpu_torch.model import mpnn

    def cuda(a):
        return torch.as_tensor(a, device="cuda")

    def check(label, got, want, tol):
        err = float(np.abs(np.asarray(got, np.float64) - want).max())
        log(f"recorded ProteinMPNN {label}: max abs err {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"recorded ProteinMPNN {label}: error {err}")

    def equal(label, got, want):
        if not np.array_equal(got, want):
            raise AssertionError(f"recorded ProteinMPNN {label}: differs from the recording")
        log(f"recorded ProteinMPNN {label}: equal to the recording")

    z, model, f, sd = mpnn_fixture("recorded_mpnn_parity.npz", ca_only=False)
    x = (f["X"], f["S"], f["mask"], f["chain_M"], f["residue_idx"], f["chain_encoding_all"])
    with torch.inference_mode():
        lp = mpnn.mpnn_log_probs(model, *x, randn=cuda(z["randn_fwd"]))
        check("log_probs_rand", lp.cpu(), z["log_probs_rand"], MPNN_TOL)
        check("scores", mpnn.mpnn_scores(f["S"], lp, f["mask"] * f["chain_M"]).cpu(), z["scores"],
              MPNN_TOL)
        check("log_probs_fixed", mpnn.mpnn_log_probs(
            model, *x, decoding_order=cuda(z["order_fixed"])).cpu(), z["log_probs_fixed"],
            MPNN_TOL)
        check("log_probs_uncond", mpnn.mpnn_unconditional_log_probs(
            model, f["X"], f["mask"], f["residue_idx"], f["chain_encoding_all"]).cpu(),
            z["log_probs_uncond"], MPNN_TOL)
        for bb, key in ((False, "log_probs_cond"), (True, "log_probs_cond_bb")):
            check(key, mpnn.mpnn_conditional_log_probs(
                model, *x, cuda(z["randn_cond"]), backbone_only=bb).cpu(), z[key], MPNN_TOL)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rest = (f["S"], f["chain_M"], f["chain_encoding_all"], f["residue_idx"], f["mask"])
    out = mpnn.mpnn_sample(model, gen, f["X"], cuda(z["randn_smp"]), *rest, temperature=1e-4)
    equal("near-greedy S", out["S"].cpu().numpy(), z["sample_S"])
    equal("near-greedy decoding order", out["decoding_order"].cpu().numpy(), z["sample_order"])
    tied_pos = tuple(tuple(int(v) for v in row) for row in z["tied_pos"])
    out = mpnn.mpnn_tied_sample(model, gen, f["X"], cuda(z["randn_tied"]), *rest, tied_pos,
                                temperature=1e-4)
    equal("tied S", out["S"].cpu().numpy(), z["sample_tied_S"])
    equal("tied decoding order", out["decoding_order"].cpu().numpy(), z["sample_tied_order"])
    check("tied probs", out["probs"].cpu(), z["sample_tied_probs"], MPNN_TOL)
    pos = int(z["pssm_pos"])
    chain_m_pos = torch.zeros_like(f["chain_M"])
    chain_m_pos[:, pos] = 1.0
    out = mpnn.mpnn_sample(model, gen, f["X"], cuda(z["randn_pssm"]), *rest, temperature=0.2,
                           chain_m_pos=chain_m_pos, pssm_coef=cuda(z["pssm_coef"]),
                           pssm_bias=cuda(z["pssm_bias"]), pssm_multi=0.7,
                           pssm_log_odds_mask=cuda(z["pssm_log_odds_mask"]))
    check("PSSM probs", out["probs"][:, pos].cpu(), z["sample_pssm_probs"][:, pos], MPNN_TOL)
    weights = sd

    z, model, f, _ = mpnn_fixture("recorded_mpnn_ca_parity.npz", ca_only=True)
    x = (f["X"], f["S"], f["mask"], f["chain_M"], f["residue_idx"], f["chain_encoding_all"])
    with torch.inference_mode():
        lp = mpnn.mpnn_log_probs(model, *x, randn=cuda(z["randn_fwd"])).cpu().numpy()
    check("CA-only log_probs_rand", lp, z["log_probs_rand"], MPNN_CA_TOL)
    valid = z["in_mask"][0] > 0
    equal("CA-only log_probs argmax", lp[0, valid].argmax(-1),
          z["log_probs_rand"][0, valid].argmax(-1))
    out = mpnn.mpnn_sample(model, gen, f["X"], cuda(z["randn_smp"]), f["S"], f["chain_M"],
                           f["chain_encoding_all"], f["residue_idx"], f["mask"], temperature=1e-4)
    equal("CA-only near-greedy S", out["S"].cpu().numpy(), z["sample_S"])
    equal("CA-only near-greedy decoding order", out["decoding_order"].cpu().numpy(),
          z["sample_order"])
    del model
    return weights


class _Warnings:
    """The package logger's warnings while in use."""

    def __enter__(self):
        import logging

        from framedipt_tpu_torch.tools.log import get_logger

        self.messages = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                outer.messages.append(record.getMessage())

        self.handler = Handler(logging.WARNING)
        get_logger().addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        from framedipt_tpu_torch.tools.log import get_logger

        get_logger().removeHandler(self.handler)


def check_denovo_cli(root: pathlib.Path, mpnn_weights: dict[str, torch.Tensor]) -> dict[str, int]:
    """(c) The de novo CLI in-process at the full default width (float32,
    the JAX package's initialization), lengths 100 and 500, one sample of
    num_t 100 at noise_scale 0.1 each, and the self-consistency check with
    the in-process ProteinMPNN (``mpnn_weights``, written to an .npz) and
    no ESMFold. Then (d) the TM-score and RMSD of the N=500 sample. Returns
    each kernel's launches over the run."""
    from framedipt_tpu_torch.analysis import metrics
    from framedipt_tpu_torch.data.protein import from_pdb_string
    from framedipt_tpu_torch.experiments import inference as cli
    from framedipt_tpu_torch.model.mpnn import MPNN_ALPHABET
    from framedipt_tpu_torch.sampling import sample
    from framedipt_tpu_torch.tools import mpnn_design
    from framedipt_tpu_torch.tools.config import load_config

    weights = root / "v_48_020_synth.npz"
    np.savez(weights, num_edges=np.asarray(48), **{k: v.numpy() for k, v in mpnn_weights.items()})
    lo, hi = DENOVO_LENGTHS
    cfg = load_config([
        "inference.inpainting=false", f"inference.samples.min_length={lo}",
        f"inference.samples.max_length={hi}", f"inference.samples.length_step={hi - lo}",
        "inference.samples.samples_per_length=1", f"inference.samples.seq_per_sample={DENOVO_SEQS}",
        "inference.weights_path=", f"inference.mpnn_weights_path={weights}",
        f"inference.output_dir={root}", "inference.name=denovo",
    ])
    num_t = cfg.inference.diffusion.num_t
    wrappers = kernel_wrappers()
    inf = cli.Inference(cfg, device="cuda")
    writes = timed_writer(inf)
    real_design = mpnn_design.design_sequences
    designs = []

    def timed_design(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_design(*args, **kwargs)
        torch.cuda.synchronize()
        designs.append(time.perf_counter() - t0)
        return out

    mpnn_design.design_sequences = timed_design
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    try:
        with counted_sampler() as calls, _Warnings() as warned:
            t0 = time.perf_counter()
            inf.run_sampling()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    finally:
        mpnn_design.design_sequences = real_design
    launches = {name: fn.launches for name, fn in wrappers.items()}
    want = forward_launches(num_t + 1)
    if len(calls) != 2 or any(c[0] != want for c in calls) or launches != forward_launches(
            2 * (num_t + 1)):
        raise AssertionError(f"de novo run: launches per sample {[c[0] for c in calls]}, "
                             f"expected {want}; over the run {launches}")
    if len(designs) != 2 or len(writes) != 2:
        raise AssertionError(f"de novo run: {len(designs)} designs, {len(writes)} writes")
    esm = [m for m in warned.messages if m.startswith("ESMFold unavailable")]
    if len(esm) != 2:
        raise AssertionError(f"de novo run: ESMFold warnings {warned.messages}")
    samples = {}
    for n, call, design_s, write_s in zip(DENOVO_LENGTHS, calls, designs, writes):
        sd = inf.output_dir / f"length_{n}" / "sample_0"
        prot = from_pdb_string((sd / "sample_0_1.pdb").read_text())
        if len(prot.aatype) != n or not np.isfinite(prot.atom_positions).all():
            raise AssertionError(f"{sd}: {len(prot.aatype)} residues or non-finite")
        for traj in ("bb_traj", "x0_traj"):
            with open(sd / f"{traj}_0_1.pdb") as f:
                models = sum(line.startswith("MODEL") for line in f)
            if models != num_t:
                raise AssertionError(f"{sd}: {traj} has {models} models")
        fas = sorted((sd / "self_consistency" / "seqs").glob("*.fa"))
        if [p.name for p in fas] != ["sample_0_1.fa"]:
            raise AssertionError(f"{sd}: fasta files {fas}")
        lines = fas[0].read_text().splitlines()
        seqs = lines[3::2]
        if (len(lines) != 2 * (1 + DENOVO_SEQS) or len(seqs) != DENOVO_SEQS
                or any(len(s) != n or not set(s) <= set(MPNN_ALPHABET[:20]) for s in seqs)):
            raise AssertionError(f"{fas[0]}: {len(lines)} lines, lengths "
                                 f"{[len(s) for s in seqs]}")
        if (sd / "self_consistency" / "sc_results.csv").exists():
            raise AssertionError(f"{sd}: sc_results.csv without ESMFold")
        samples[n] = prot
        log(f"de novo N={n} num_t={num_t}: sampler {call[1]:.3f} s, writer {write_s:.3f} s, "
            f"ProteinMPNN design of {DENOVO_SEQS} sequences {design_s:.3f} s, "
            f"launches {call[0]}; "
            f"recovery line {lines[2][:70]}")
    log(f"de novo CLI: 2 samples in {run_s:.2f} s (ESMFold absent: {len(esm)} warnings)")

    # The design again, with the weights loaded: seconds a backbone.
    for n in DENOVO_LENGTHS:
        sd = inf.output_dir / f"length_{n}" / "sample_0"
        stage = root / f"design_{n}"
        stage.mkdir()
        (stage / "sample_0_1.pdb").write_text((sd / "sample_0_1.pdb").read_text())
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mpnn_design.design_sequences(stage, stage / "out", num_seq_per_target=DENOVO_SEQS,
                                         model=inf._mpnn)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        log(f"ProteinMPNN design N={n}, {DENOVO_SEQS} sequences (weights loaded): "
            f"{secs[0]:.3f} s, {secs[1]:.3f} s")
        if n == DENOVO_LENGTHS[-1]:
            def design_once(stage=stage):
                mpnn_design.design_sequences(stage, stage / "profiled",
                                             num_seq_per_target=DENOVO_SEQS, model=inf._mpnn)
                torch.cuda.synchronize()

            wall = wall_ms(design_once)
            t0 = time.perf_counter()
            busy, by_name = device_time(design_once)
            log(f"ProteinMPNN design N={n} (profiled in {time.perf_counter() - t0:.1f} s): "
                f"{wall:.1f} ms wall, " + (
                f"{busy:.1f} ms of device time, busy share {busy / wall:.3f}" if by_name else
                "torch.profiler recorded no device time (busy share not measured)"))
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
                log(f"  {ms:9.3f} ms  {name[:100]}")

    # The N=500 sample's device busy share, its sampler call run again.
    feats = inf._to_device(next(it for it in inf.sampler if it[0] == f"length_{hi}")[2])

    def one_sample():
        sample(inf.model, inf.diffuser, feats, inf._generator(1), num_t=num_t, min_t=0.01,
               noise_scale=0.1, inpainting=False, aux_traj=True)
        torch.cuda.synchronize()

    wall = wall_ms(one_sample)
    t0 = time.perf_counter()
    busy, by_name = device_time(one_sample)
    log(f"de novo sample N={hi} num_t={num_t} (profiled in {time.perf_counter() - t0:.1f} s): "
        f"{wall:.1f} ms wall, " + (
        f"{busy:.1f} ms of device time, busy share {busy / wall:.3f}" if by_name else
        "torch.profiler recorded no device time (busy share not measured)"))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:9.3f} ms  {name[:100]}")
    del feats

    # Resume: a second run over the same tree writes nothing.
    before = tree_files(inf.output_dir)
    again = cli.Inference(cfg, device="cuda")
    for fn in wrappers.values():
        fn.launches = 0
    with counted_sampler() as calls:
        again.run_sampling()
    after = tree_files(inf.output_dir)
    before.pop("inference_conf.json"), after.pop("inference_conf.json")
    if calls or after != before or any(fn.launches for fn in wrappers.values()):
        raise AssertionError(f"de novo resume: {len(calls)} sampler calls, "
                             f"{len(set(after) ^ set(before))} files differ")
    log(f"de novo CLI resume: no sampler call, {len(after)} files unchanged")

    # (d) TM-score and aligned RMSD of the N=500 sample against itself and a
    # rotated, translated copy.
    ca = samples[hi].atom_positions[:, 1]
    angle = 0.7
    rot = np.array([[np.cos(angle), -np.sin(angle), 0.0], [np.sin(angle), np.cos(angle), 0.0],
                    [0.0, 0.0, 1.0]]) @ np.array([[1.0, 0.0, 0.0], [0.0, 0.6, -0.8],
                                                  [0.0, 0.8, 0.6]])
    moved = ca @ rot.T + np.array([12.0, -7.5, 30.0])
    for label, other in (("itself", ca), ("a rotated, translated copy", moved)):
        t0 = time.perf_counter()
        tm = metrics.calc_tm_score(other, ca)
        rmsd = metrics.calc_aligned_rmsd(other, ca)
        took = time.perf_counter() - t0
        log(f"TM-score / aligned RMSD N={hi} against {label}: TM {tm[0]:.6f} / {tm[1]:.6f}, "
            f"RMSD {rmsd:.2e} A ({took:.3f} s on the host)")
        if not (abs(tm[0] - 1.0) < 1e-6 and abs(tm[1] - 1.0) < 1e-6 and rmsd < 1e-3):
            raise AssertionError(f"TM-score / RMSD against {label}: {tm}, {rmsd}")
    del inf, again
    torch.cuda.empty_cache()
    return launches


# -- phase 11: ProteinMPNN training at the published width --------------------

# (a) The train step's loss against the recorded reference's smoothed loss,
# relative, and each gradient on the card against the same step on the CPU,
# on the scale of its max-abs (the card's gather backward sums with atomics).
MPNN_LOSS_TOL, MPNN_GRAD_TOL = 2e-4, 1e-4
MPNN_TRAIN_STEPS = 20
# (c) The timed shape: the train CLI's default batch and crop.
MPNN_B, MPNN_L = 8, 512


def mpnn_clean_loss(model, f: dict, randn: torch.Tensor) -> float:
    """The smoothed loss in eval mode: no noise, no dropout, ``randn``'s order."""
    from framedipt_tpu_torch.model import mpnn
    from framedipt_tpu_torch.train.mpnn_train import smoothed_loss

    model.eval()
    with torch.no_grad():
        lp = mpnn.mpnn_log_probs(model, f["X"], f["S"], f["mask"], f["chain_M"],
                                 f["residue_idx"], f["chain_encoding_all"], randn=randn)
        return float(smoothed_loss(f["S"], lp, f["mask"] * f["chain_M"]))


def check_mpnn_train_step(weights: dict[str, torch.Tensor], device: str = "cuda") -> None:
    """(a) The train step at the published width on the recorded ProteinMPNN's
    structure and weights (``recorded_mpnn_parity.npz``; dropout 0, no noise,
    the recording's ``randn_fwd``): the loss against the smoothed loss of the
    recorded log-probabilities, every gradient against the same step on the
    CPU; then 20 steps on that batch with the training settings (noise 0.2,
    dropout 0.1): finite losses, the parameters moved, and the loss without
    noise and dropout lower after than before. (``device`` "cpu" rehearses
    it.)"""
    from framedipt_tpu_torch.model import mpnn
    from framedipt_tpu_torch.train.mpnn_train import MPNNTrainer, smoothed_loss

    z = np.load(REPO / "tests" / "parity" / "fixtures" / "recorded_mpnn_parity.npz")
    f_cpu = {k[3:]: torch.as_tensor(z[k]) for k in z.files if k.startswith("in_")}
    f = {k: v.to(device) for k, v in f_cpu.items()}
    randn = torch.as_tensor(z["randn_fwd"])
    want = float(smoothed_loss(f_cpu["S"], torch.as_tensor(z["log_probs_rand"]),
                               f_cpu["mask"] * f_cpu["chain_M"]))

    def first_step(dev: str):
        model = mpnn.ProteinMPNN(mpnn.MPNNConfig(k_neighbors=48, dropout=0.0))
        model.load_state_dict(weights, strict=True)
        trainer = MPNNTrainer(model.to(dev))
        batch = {k: v.to(dev) for k, v in f_cpu.items()}
        return model, trainer.step(batch, torch.Generator(device=dev).manual_seed(0),
                                   randn=randn.to(dev))

    (model, m), (cpu_model, _) = first_step(device), first_step("cpu")
    rel = abs(float(m["loss"]) - want) / want
    log(f"ProteinMPNN train step (recorded structure, L=53): loss {float(m['loss']):.7f} against "
        f"the recording's smoothed loss {want:.7f}, rel err {rel:.3e} (tol {MPNN_LOSS_TOL}); "
        f"grad_norm {float(m['grad_norm']):.5f}, lr {m['lr']:.3e}")
    if not rel <= MPNN_LOSS_TOL:
        raise AssertionError(f"ProteinMPNN train step loss: rel err {rel}")
    cpu_grads = dict(cpu_model.named_parameters())
    errs = {}
    for name, p in model.named_parameters():
        ref = cpu_grads[name].grad
        errs[name] = float((p.grad.cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    log(f"ProteinMPNN train step gradients, card against CPU: worst {errs[worst]:.3e} "
        f"({worst}) of the gradient's max-abs (tol {MPNN_GRAD_TOL}), {len(errs)} tensors")
    if not errs[worst] <= MPNN_GRAD_TOL:
        raise AssertionError(f"ProteinMPNN gradient {worst}: error {errs[worst]}")

    model = mpnn.ProteinMPNN(mpnn.MPNNConfig(k_neighbors=48, augment_eps=0.2, dropout=0.1))
    model.load_state_dict(weights, strict=True)
    model.to(device)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    clean0 = mpnn_clean_loss(model, f, randn.to(device))
    trainer = MPNNTrainer(model)
    gen = torch.Generator(device=device).manual_seed(1)
    losses = [float(trainer.step(f, gen)["loss"]) for _ in range(MPNN_TRAIN_STEPS)]
    clean1 = mpnn_clean_loss(model, f, randn.to(device))
    moved = max(float((v - before[k]).abs().max()) for k, v in model.state_dict().items())
    log(f"ProteinMPNN {MPNN_TRAIN_STEPS} steps (noise 0.2, dropout 0.1): losses "
        f"{[round(x, 5) for x in losses]}; loss without noise and dropout {clean0:.6f} -> "
        f"{clean1:.6f}; largest parameter change {moved:.3e}")
    if not (all(np.isfinite(losses)) and moved > 0 and clean1 < clean0):
        raise AssertionError(f"ProteinMPNN training: losses {losses}, clean {clean0} -> "
                             f"{clean1}, moved {moved}")


def check_mpnn_train_cli(root: pathlib.Path, weights: dict[str, torch.Tensor],
                         device: str = "cuda") -> None:
    """(b) ``python -m framedipt_tpu_torch.experiments.train_mpnn`` in-process
    on the card: the fixture mmCIF complexes preprocessed by the port's
    pipeline (max_len 2000, min_len 10, chain_max_len 2000), 20 steps at the
    defaults (batch 8, crops of 512) from the recorded weights, an eval and a
    checkpoint every 10 steps; the metrics rows, finite losses, the three
    checkpoints; ``last.npz`` loaded by the designer, 8 sequences designed
    for one complex; a warm start whose neighbour count differs refused.
    (``device`` "cpu" rehearses it.)"""
    import pickle

    from framedipt_tpu_torch.data.pipeline import ProcessOptions, process_serially, write_metadata
    from framedipt_tpu_torch.data.protein import Protein, to_pdb
    from framedipt_tpu_torch.experiments import train_mpnn
    from framedipt_tpu_torch.tools import mpnn_design
    from framedipt_tpu_torch.tools.config import FilteringConfig

    data = root / "mpnn_data"
    t0 = time.perf_counter()
    rows = process_serially(sorted((REPO / "tests" / "data" / "cifs").glob("*.cif")),
                            ProcessOptions(output_dir=data, filtering=FilteringConfig(
                                max_len=2000, min_len=10, chain_max_len=2000)))
    write_metadata(rows, data / "metadata.csv")
    log(f"preprocessed {len(rows)} complexes in {time.perf_counter() - t0:.2f} s: "
        f"{[(r['pdb_name'], r['seq_len'], r['num_chains']) for r in rows]}")
    if len(rows) != 3:
        raise AssertionError(f"preprocessing kept {len(rows)} of 3 complexes")
    start = root / "recorded_mpnn.npz"
    np.savez(start, num_edges=np.int64(48), **{k: v.numpy() for k, v in weights.items()})
    out = root / "mpnn_run"
    flags = ["--csv_path", str(data / "metadata.csv"), "--previous_checkpoint", str(start),
             "--device", device]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = train_mpnn.main([*flags, "--output_dir", str(out), "--num_steps", "20",
                            "--eval_freq", "10", "--ckpt_freq", "10"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    metrics = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    log(f"ProteinMPNN train CLI: 20 steps (batch 8, crops of 512, 2 complexes a batch) in "
        f"{run_s:.2f} s with 2 evals; rows {metrics}")
    steps = [(r["step"], "loss" in r) for r in metrics]
    if steps != [(10, True), (10, False), (20, True), (20, False)] or not all(
            np.isfinite(r[k]) for r in metrics for k in r if k != "step"):
        raise AssertionError(f"ProteinMPNN train CLI: metrics rows {metrics}")
    ckpts = sorted(p.name for p in out.glob("*.npz"))
    if ckpts != ["last.npz", "step_10.npz", "step_20.npz"] or set(last) != {
            "loss", "nll", "accuracy", "grad_norm", "lr"}:
        raise AssertionError(f"ProteinMPNN train CLI: checkpoints {ckpts}, last {last}")

    model = mpnn_design.load_mpnn_params(out / "last.npz", device=device)
    with open(rows[0]["processed_path"], "rb") as fh:
        raw = pickle.load(fh)
    stage = root / "mpnn_design"
    stage.mkdir()
    (stage / f"{rows[0]['pdb_name']}.pdb").write_text(to_pdb(Protein(
        atom_positions=raw["atom_positions"], atom_mask=raw["atom_mask"], aatype=raw["aatype"],
        residue_index=raw["residue_index"], chain_index=raw["chain_index"],
        b_factors=raw["b_factors"])))
    t0 = time.perf_counter()
    mpnn_design.design_sequences(stage, stage / "out", num_seq_per_target=DENOVO_SEQS,
                                 model=model)
    torch.cuda.synchronize()
    design_s = time.perf_counter() - t0
    lines = (stage / "out" / "seqs" / f"{rows[0]['pdb_name']}.fa").read_text().splitlines()
    seqs = [s.replace("/", "") for s in lines[3::2]]
    log(f"ProteinMPNN design with last.npz: {len(seqs)} sequences of {rows[0]['seq_len']} "
        f"residues ({rows[0]['num_chains']} chains) in {design_s:.2f} s; {lines[2][:70]}")
    if len(seqs) != DENOVO_SEQS or any(len(s) != rows[0]["seq_len"] for s in seqs):
        raise AssertionError(f"ProteinMPNN design with last.npz: {lines[:3]}")
    with expect_raise(ValueError, "k_neighbors"):
        train_mpnn.main([*flags[:2], "--previous_checkpoint", str(out / "last.npz"),
                         "--device", device, "--k_neighbors", "32", "--num_steps", "1",
                         "--output_dir", str(root / "mpnn_refused")])
    log("ProteinMPNN train CLI: a warm start from a checkpoint of 48 neighbours with "
        "--k_neighbors 32 refused")
    del model
    torch.cuda.empty_cache()


def mpnn_step_flops(B: int, L: int, cfg) -> float:
    """The products of one train step (forward, and twice the forward for the
    backward): per edge the edge embedding and W_e, each encoder layer's node
    messages and edge update (5 h^2 multiply-adds each) and its feed-forward
    per node (8 h^2), each decoder layer's messages (6 h^2) and feed-forward."""
    from framedipt_tpu_torch.model.mpnn import edge_input_width

    h, k = cfg.hidden_dim, min(cfg.k_neighbors, L)
    edges, nodes = B * L * k, B * L
    fwd = 2 * edges * (edge_input_width(cfg) * h + h * h)
    fwd += cfg.num_encoder_layers * 2 * (edges * 10 * h * h + nodes * 8 * h * h)
    fwd += cfg.num_decoder_layers * 2 * (edges * 6 * h * h + nodes * 8 * h * h)
    return 3.0 * fwd


def time_mpnn_train_step() -> None:
    """(c) The train step's cost at B=8, L=512, every row valid: crops of 512
    residues of the fixture complexes (all five chains, parsed from the
    mmCIF files without filtering), the published width and training
    settings, fresh weights. ms a step (CUDA events, 5 steps after 3 warm),
    valid residues a second, peak memory, the bound of its products at
    float32's CUDA-core peak, and the device's busy share and time by kernel
    over 2 steps (torch.profiler)."""
    from framedipt_tpu_torch.data import features as feature_lib
    from framedipt_tpu_torch.data.mmcif import parse_mmcif
    from framedipt_tpu_torch.experiments.train_mpnn import structure_to_mpnn_features
    from framedipt_tpu_torch.model import mpnn
    from framedipt_tpu_torch.train.mpnn_train import MPNNTrainer

    complexes = []
    for path in sorted((REPO / "tests" / "data" / "cifs").glob("*.cif")):
        raw = feature_lib.structure_to_features(parse_mmcif(path, file_id=path.stem[:4]))
        complexes.append(structure_to_mpnn_features(raw))
    rows = []
    for i in range(MPNN_B):
        feats = complexes[i % len(complexes)]
        start = 144 * (i // len(complexes))
        rows.append({k: v[:, start:start + MPNN_L] for k, v in feats.items()})
    batch = {k: torch.as_tensor(np.concatenate([r[k] for r in rows])).cuda() for k in rows[0]}
    valid = float((batch["mask"] * batch["chain_M"]).sum())
    if batch["X"].shape[1] != MPNN_L or valid != MPNN_B * MPNN_L:
        raise AssertionError(f"ProteinMPNN timing batch: {tuple(batch['X'].shape)}, "
                             f"{valid} valid residues")
    cfg = mpnn.MPNNConfig(augment_eps=0.2)
    model = mpnn.ProteinMPNN(cfg)
    model.load_state_dict(mpnn.init_mpnn_state_dict(cfg, seed=0), strict=True)
    trainer = MPNNTrainer(model.cuda())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(3):
        trainer.step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    losses = [trainer.step(batch, gen)["loss"] for _ in range(5)]
    end_ev.record()
    torch.cuda.synchronize()
    ms = start_ev.elapsed_time(end_ev) / 5
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = mpnn_step_flops(MPNN_B, MPNN_L, cfg)
    bound_ms = 1e3 * flops / PEAK_FLOPS[torch.float32]
    log(f"ProteinMPNN train step B={MPNN_B} L={MPNN_L} (published width, float32): {ms:.2f} ms a "
        f"step, {valid / ms * 1e3:.0f} valid residues/s, peak memory {peak:.3f} GB; "
        f"{flops / 1e12:.3f} TFLOP a step, bound {bound_ms:.2f} ms at float32's CUDA-core peak "
        f"({ms / bound_ms:.1f}x); losses {[round(float(x), 5) for x in losses]}")
    if not all(np.isfinite(float(x)) for x in losses):
        raise AssertionError(f"ProteinMPNN timed steps: losses {losses}")

    def two_steps():
        for _ in range(2):
            trainer.step(batch, gen)
        torch.cuda.synchronize()

    wall = wall_ms(two_steps)
    t0 = time.perf_counter()
    busy, by_name = device_time(two_steps)
    log(f"ProteinMPNN 2 train steps (profiled in {time.perf_counter() - t0:.1f} s): {wall:.1f} ms "
        f"wall, " + (f"{busy:.1f} ms of device time, busy share {busy / wall:.3f}" if by_name else
                     "torch.profiler recorded no device time (busy share not measured)"))
    for name, dev_ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {dev_ms:9.3f} ms  {name[:100]}")
    del trainer, model, batch
    torch.cuda.empty_cache()


# -- phase 12: evaluation, host tools, the database flow, the CIF parser -------

DATABASE_NUM_T = 5


def check_cif_tokenizer() -> float:
    """The native CIF parser must build and load on the card's host (phase
    2). Returns the seconds of the call."""
    from framedipt_tpu_torch import native

    t0 = time.perf_counter()
    if native.load_cif_tokenizer() is None:
        raise AssertionError("the native CIF tokenizer did not build or load (see the warning)")
    return time.perf_counter() - t0


def check_denovo_eval(tree: pathlib.Path, root: pathlib.Path) -> None:
    """(a) The de novo evaluation over phase 10's tree (lengths 100 and 500):
    scipy diversity (MaxCluster absent or not, the run logs which), foldseek
    asked for and absent (a warning), two samples, two composition rows."""
    from framedipt_tpu_torch.eval import denovo_eval

    out = root / "eval_denovo"
    with _Warnings() as warned:
        t0 = time.perf_counter()
        results = denovo_eval.run(tree, out, foldseek_db=root / "no_foldseek_db")
        took = time.perf_counter() - t0
    comp = read_csv_rows(out / "ss_composition.csv")
    if results["num_samples"] != 2 or len(comp) != 2 or "pdbTM_mean" in results:
        raise AssertionError(f"denovo_eval: {results}, {len(comp)} composition rows")
    if sorted(int(r["length"]) for r in comp) != list(DENOVO_LENGTHS):
        raise AssertionError(f"denovo_eval: lengths {[r['length'] for r in comp]}")
    summary = (out / "denovo_summary.csv").read_text().splitlines()
    log(f"denovo_eval over phase 10's tree: {took:.3f} s; {summary[0]} = {summary[1]}; "
        f"warnings {warned.messages}")


def check_cg2all_eval(tree: pathlib.Path, root: pathlib.Path, rows: int) -> None:
    """(b) ``cg2all_eval --skip_convert`` over phase 8's tree, each sample's
    ``_all_atom.pdb`` a copy of its backbone PDB (no cg2all on the card's
    machine): ``rows`` rows with finite RMSDs, the full-atom RMSD equal to
    the RMSD over the five atoms a sample holds (N, CA, C, CB, O) recomputed
    here."""
    import shutil

    from framedipt_tpu_torch.data import constants as rc
    from framedipt_tpu_torch.data.protein import chain_id_to_int, from_pdb_string
    from framedipt_tpu_torch.eval.tcr_eval import parse_diffusion_info

    samples = sorted(tree.glob("*_length_*/sample_*/sample_*_1.pdb"))
    for p in samples:
        shutil.copy(p, p.with_name(p.stem + "_all_atom.pdb"))
    out = root / "eval_cg2all"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "framedipt_tpu_torch.eval.cg2all_eval",
         f"--prediction_dir={tree}", f"--output_dir={out}", "--skip_convert"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cg2all_eval failed:\n{proc.stderr[-3000:]}")
    got = read_csv_rows(out / "cg2all_eval.csv")
    if len(got) != rows or not all(np.isfinite(float(r[c])) for r in got
                                   for c in ("bb_rmsd", "full_atom_rmsd")):
        raise AssertionError(f"cg2all_eval: {len(got)} rows, {got[:2]}")
    # The copies hold N, CA, C, CB and O: the full-atom RMSD is the RMSD over
    # those five slots where the ground truth has them (no CB on a glycine).
    slots = [rc.atom_order[a] for a in ("N", "CA", "C", "CB", "O")]
    worst = 0.0
    for r in got:
        case = next(tree.glob(f"{r['pdb_name']}_length_*"))
        info = parse_diffusion_info(case / "diffusion_info.csv")
        gt = from_pdb_string((case / f"{r['pdb_name']}_1.pdb").read_text())
        pred = from_pdb_string((case / f"sample_{r['sample_idx']}" /
                                f"sample_{r['sample_idx']}_1.pdb").read_text())
        if sorted(np.flatnonzero(pred.atom_mask.any(0))) != sorted(slots):
            raise AssertionError(f"{r['pdb_name']} sample {r['sample_idx']}: atoms "
                                 f"{np.flatnonzero(pred.atom_mask.any(0))}")
        deltas = []
        for ch, (s0, e0) in zip(info["chains"], info["regions"]):
            sel = [np.flatnonzero(p.chain_index == chain_id_to_int(ch))[s0:e0 + 1]
                   for p in (pred, gt)]
            both = gt.atom_mask[sel[1]][:, slots] > 0
            deltas.append((pred.atom_positions[sel[0]][:, slots]
                           - gt.atom_positions[sel[1]][:, slots])[both])
        d = np.concatenate(deltas)
        worst = max(worst, abs(float(np.sqrt((d ** 2).sum() / len(d))) - float(r["full_atom_rmsd"])))
    if not worst < 1e-9:
        raise AssertionError(f"cg2all_eval: full-atom RMSD off the five-slot RMSD by {worst}")
    bb, fa = [float(r["bb_rmsd"]) for r in got], [float(r["full_atom_rmsd"]) for r in got]
    log(f"cg2all_eval --skip_convert over phase 8's tree: {took:.3f} s (subprocess), {len(got)} "
        f"rows; bb_rmsd {[round(x, 3) for x in bb]}, full_atom_rmsd {[round(x, 3) for x in fa]} "
        f"(the N, CA, C, CB, O RMSD within {worst:.1e}; it differs from bb_rmsd by the CB)")


def check_process_pdb_files(tree: pathlib.Path, root: pathlib.Path) -> None:
    """(c) The monomer PDB preprocessing over phase 10's two samples."""
    import pickle
    import shutil

    from framedipt_tpu_torch.data import process_pdb_files

    pdbs = root / "denovo_pdbs"
    pdbs.mkdir()
    for n in DENOVO_LENGTHS:
        shutil.copy(tree / f"length_{n}" / "sample_0" / "sample_0_1.pdb", pdbs / f"dn{n}.pdb")
    out = root / "denovo_processed"
    t0 = time.perf_counter()
    process_pdb_files.main([f"--pdb_dir={pdbs}", f"--output_dir={out}", "--device=cuda"])
    took = time.perf_counter() - t0
    rows = read_csv_rows(out / "metadata.csv")
    if sorted(int(r["seq_len"]) for r in rows) != list(DENOVO_LENGTHS):
        raise AssertionError(f"process_pdb_files: rows {rows}")
    for r in rows:
        with open(r["processed_path"], "rb") as f:
            raw = pickle.load(f)
        if raw["atom_positions"].shape != (int(r["seq_len"]), 37, 3):
            raise AssertionError(f"process_pdb_files: {r['pdb_name']} {raw['atom_positions'].shape}")
    log(f"process_pdb_files over phase 10's samples: {took:.3f} s, {len(rows)} rows, "
        + ", ".join(f"{r['pdb_name']} helix {float(r['helix_percent']):.3f} strand "
                    f"{float(r['strand_percent']):.3f} Rg {float(r['radius_gyration']):.3f} nm"
                    for r in rows))


def check_database_cli(root: pathlib.Path) -> dict[str, int]:
    """(d) The inpainting CLI's database flow, in-process: the three fixture
    CIFs in ``download_dir/cifs``, the pMHC-II database CSV, one sample of
    DATABASE_NUM_T steps. RCSB is a local directory that holds nothing, so
    each listed structure not present fails to download (no network: a
    guard refuses any URL that is not a local file). The three cases' trees
    and launches as phase 8's; then a second run reuses the cached
    ``metadata.csv``. Returns each kernel's launches over the first run."""
    import shutil
    import urllib.request

    from framedipt_tpu_torch.data import download
    from framedipt_tpu_torch.experiments.inference import Inference

    cifs = REPO / "tests" / "data" / "cifs"
    cases = sorted(p.name.split("-")[0] for p in cifs.glob("*.cif"))
    dl = root / "database"
    (dl / "cifs").mkdir(parents=True)
    for p in cifs.glob("*.cif"):
        shutil.copy(p, dl / "cifs")
    real_url, real_urlopen = download.RCSB_URL, download.urllib.request.urlopen

    def local_only(url, *args, **kwargs):
        if not str(url).startswith("file:"):
            raise AssertionError(f"phase 12 asked for a non-local URL: {url}")
        return real_urlopen(url, *args, **kwargs)

    download.RCSB_URL = (root / "rcsb_offline").as_uri()
    download.urllib.request.urlopen = local_only
    wrappers = kernel_wrappers()
    try:
        cfg = cli_config(root, "database", f"inference.diffusion.num_t={DATABASE_NUM_T}",
                         "inference.inpainting_samples.samples=1",
                         f"inference.inpainting_samples.data_path="
                         f"{REPO / 'database' / 'TCR_pMHC_II.csv'}",
                         f"inference.inpainting_samples.download_dir={dl}")
        with _Warnings() as warned:
            t0 = time.perf_counter()
            inf = Inference(cfg, device="cuda")
            setup_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            t1 = time.perf_counter()
            with counted_sampler() as calls:
                inf.run_sampling()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
        launches = {name: fn.launches for name, fn in wrappers.items()}
        want = forward_launches(DATABASE_NUM_T + 1)
        if len(calls) != len(cases) or any(c[0] != want for c in calls):
            raise AssertionError(f"database run: launches per case {[c[0] for c in calls]}, "
                                 f"expected {want} for each of {len(cases)}")
        check_tree(inf.output_dir, cases, 1, DATABASE_NUM_T)
        offline = [m for m in warned.messages if "failed to download" in m]
        if len(offline) != 15 or not all("offline environment?" in m for m in offline):
            raise AssertionError(f"database run: download warnings {warned.messages[:3]}")
        meta = read_csv_rows(dl / "processed" / "metadata.csv")
        if sorted(r["pdb_name"] for r in meta) != cases:
            raise AssertionError(f"database run: metadata rows {[r['pdb_name'] for r in meta]}")
        log(f"database CLI: {len(cases)} complexes x 1 sample, num_t={DATABASE_NUM_T}: set-up "
            f"(download attempts, filters, metadata.csv, model) {setup_s:.2f} s, sampling "
            f"{run_s:.2f} s, {setup_s + run_s:.2f} s in all; sampler "
            f"{[round(c[1], 2) for c in calls]} s; launches {launches}; {len(offline)} offline "
            f"download warnings, the first: {offline[0][:160]}")
        # A second run reuses the cached metadata.csv and the tree: no sampler call.
        with _Warnings() as warned:
            again = Inference(cfg, device="cuda")
            with counted_sampler() as calls:
                again.run_sampling()
        if calls or [p.name for p in again.sampler.cif_paths] != [p.name for p in inf.sampler.cif_paths]:
            raise AssertionError(f"database resume: {len(calls)} sampler calls")
        log("database CLI resume: cached metadata.csv reused, no sampler call")
    finally:
        download.RCSB_URL, download.urllib.request.urlopen = real_url, real_urlopen
    del inf, again
    torch.cuda.empty_cache()
    return launches


def check_sweep(root: pathlib.Path) -> None:
    """(e) ``tools.sweep`` over two jobs of the de novo CLI on device 0
    (length 100, one sample, num_t 2 and 5): rc 0, two run directories with
    their ``_job<N>`` suffix, each with its sample. Each job's seconds from
    its log's last write (the jobs run one after the other)."""
    out = root / "sweep"
    logs = root / "sweep_logs"
    cmd = [sys.executable, "-m", "framedipt_tpu_torch.tools.sweep", "--devices", "0",
           f"--log_dir={logs}", "--", sys.executable, "-m",
           "framedipt_tpu_torch.experiments.inference", "inference.inpainting=false",
           "inference.samples.min_length=100", "inference.samples.max_length=100",
           "inference.samples.samples_per_length=1", "inference.diffusion.num_t=2,5",
           "inference.weights_path=", f"inference.mpnn_weights_path={root / 'no_mpnn.pt'}",
           f"inference.output_dir={out}", "inference.name=sweep"]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    took = time.time() - t0
    if proc.returncode != 0:
        tails = "".join((logs / f"job_{i}.log").read_text()[-1500:] for i in range(2)
                        if (logs / f"job_{i}.log").exists())
        raise AssertionError(f"sweep rc {proc.returncode}:\n{proc.stderr[-1500:]}\n{tails}")
    dirs = sorted(p.name for p in out.iterdir())
    if dirs != ["sweep_job0", "sweep_job1"]:
        raise AssertionError(f"sweep: run directories {dirs}")
    for i, num_t in enumerate((2, 5)):
        sd = out / f"sweep_job{i}" / "length_100" / "sample_0"
        with open(sd / "bb_traj_0_1.pdb") as f:
            models = sum(line.startswith("MODEL") for line in f)
        if not (sd / "sample_0_1.pdb").exists() or models != num_t:
            raise AssertionError(f"sweep job {i}: {models} models in {sd}")
    ends = [(logs / f"job_{i}.log").stat().st_mtime for i in range(2)]
    log(f"sweep of 2 de novo CLI jobs on CUDA device 0: {took:.2f} s in all, job 0 "
        f"{ends[0] - t0:.2f} s, job 1 {ends[1] - ends[0]:.2f} s (from the logs' last writes)")


def check_profiling_trace(root: pathlib.Path) -> None:
    """(f) ``profiling.trace`` around a sampler run of three steps at B=1
    N=256 (the full default model): the Chrome trace names the pair-MLP and
    edge-embedder CUDA kernels."""
    from framedipt_tpu_torch.diffusion import SE3Diffuser
    from framedipt_tpu_torch.model import ScoreNetwork
    from framedipt_tpu_torch.model.weights import init_state_dict
    from framedipt_tpu_torch.sampling import sample
    from framedipt_tpu_torch.tools import profiling
    from framedipt_tpu_torch.tools.config import Config, resolve_kernel_flags

    cfg = Config()
    resolve_kernel_flags(cfg, torch.device("cuda"))
    diffuser = SE3Diffuser(cfg.diffuser, device="cuda")
    model = ScoreNetwork(cfg.model, diffuser, inpainting=True)
    model.load_state_dict(init_state_dict(model, torch.Generator().manual_seed(0)), strict=True)
    model.to("cuda").eval()
    feats = {k: v[:1] for k, v in serving_feats().items()}
    t0 = time.perf_counter()
    with profiling.trace(root / "trace"):
        sample(model, diffuser, feats, torch.Generator(device="cuda").manual_seed(3), num_t=3,
               min_t=0.01, noise_scale=0.1, inpainting=True)
        torch.cuda.synchronize()
    took = time.perf_counter() - t0
    files = list((root / "trace").glob("trace_*.json"))
    if len(files) != 1:
        raise AssertionError(f"trace files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    found = {k: sum(n for name, n in kernels.items() if f"{k}_kernel" in name)
             for k in ("pair_mlp_wg", "pair_mlp_wg_bf16", "edge_embedder",
                       "edge_embedder_wg")}
    want = forward_launches(3 + 1)  # the sampler's forwards: num_t + 1
    if found != {k: want[k] for k in found}:
        raise AssertionError(f"trace: kernel events {found}; names {sorted(kernels)[:10]}")
    log(f"profiling.trace of 3 sampler steps at B=1 N=256: {took:.2f} s with the export, "
        f"{files[0].stat().st_size / 1e6:.1f} MB, {len(events)} events, {len(kernels)} CUDA "
        f"kernel names; " + ", ".join(f"{k}_kernel x{n}" for k, n in found.items()))
    del model
    torch.cuda.empty_cache()


def check_cif_parse_speed(repeats: int = 5) -> None:
    """(g) The fixture CIFs through the native parser and the Python one,
    ``repeats`` times each: equal dicts; the seconds of each and the ratio."""
    from framedipt_tpu_torch import native
    from framedipt_tpu_torch.data.mmcif import parse_cif_categories_py

    total = {"native": 0.0, "python": 0.0}
    for path in sorted((REPO / "tests" / "data" / "cifs").glob("*.cif")):
        text = path.read_text()
        secs = {}
        for label, fn in (("native", native.parse_cif_categories),
                          ("python", parse_cif_categories_py)):
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                cats = fn(text)
                times.append(time.perf_counter() - t0)
            secs[label] = min(times)
            total[label] += sum(times)
            if label == "native":
                got = cats
        if got != cats:
            raise AssertionError(f"{path.name}: native and Python parses differ")
        log(f"CIF parse {path.name} ({len(text) / 1e6:.2f} MB, {len(cats)} categories): native "
            f"{secs['native'] * 1e3:.1f} ms, Python {secs['python'] * 1e3:.1f} ms (best of "
            f"{repeats}), {secs['python'] / secs['native']:.1f}x")
    log(f"CIF parse, 3 files x {repeats}: native {total['native']:.3f} s, Python "
        f"{total['python']:.3f} s, ratio {total['python'] / total['native']:.1f}x")


# -- phase 13: row blocks, the SP sampler, the DP step, torchrun --------------

# (a) Row blocks: B=2 at the CLI's bucket 896 and at 230 (ragged at sp=4:
# rows 58, 58, 58, 56).
ROW_BLOCK_NS = (896, 230)
# The wrappers' row-side arguments: pair, i_term, row_mask, fi of the pair
# MLP; g, pos_rows, i_term, row_mask of the edge embedder.
ROW_ARGS = {"pair_mlp_wg_bf16": (0, 1, 3, 13), "pair_mlp_wg": (0, 1, 3, 13),
            "edge_embedder": (0, 2, 4, 6),
            "edge_embedder_wg": (0, 2, 4, 6)}
# (b) The SP sampler against the one-process sampler on the card: the JAX
# package's SP test's tolerances (tests/unit/test_sequence_parallel.py).
SP_N, SP_NUM_T = 896, 10
SP_TOL = {"final_rigids": 2e-5, "prot_traj": 2e-4}
# (c) The DP step against the one-process step on the whole batch: loss and
# grad norm relative, the parameters on the scale of each one's max-abs but
# where the gradient cancels (below, compare_dp_part).
DP_B, DP_N, DP_STEPS, DP_TOL = 4, 256, 3, 1e-5
# Adam's eps in both runs of (c). At the training default (1e-8) Adam moves
# an entry by about lr whatever its gradient's size, so where the gradient is
# at rounding level two sums of it in another order (one batch against two
# halves all-reduced) end up to 2 lr apart, and the steps after carry that
# into every gradient: on an H100 the parameters after steps 1 and 3 differ
# by 5.85e-4 and 2.20e-3 of their max-abs at 1e-8 and 3.39e-5 and 3.28e-5 at
# 1e-4; at 1e-3 the update is continuous in the gradient there and they
# agree within 5.30e-6 and 6.88e-6.
DP_ADAM_EPS = 1e-3
PART_TIMEOUT_S = 300


def parallel_backend(world: int) -> str:
    """Chosen before any rank starts: NCCL where every rank has a card of
    its own, gloo where ranks share one (NCCL refuses two ranks on a
    device)."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def check_row_blocks() -> None:
    """(a) One process, no collective: each rank's row block at sp 2 and 4
    through the pair-MLP kernels (the wgmma ones in float32 and bf16, as the
    samplers run them: without gradients) and the edge-embedder kernels
    (both routes) against
    the same rows of the full launch (bits, largest difference), each block
    timed beside the full launch."""
    from framedipt_tpu_torch.model.kernels.edge_embedder import edge_embedder
    from framedipt_tpu_torch.model.kernels.pair_mlp import pair_mlp
    from framedipt_tpu_torch.parallel.sp import row_block

    gen = torch.Generator(device="cuda").manual_seed(13)
    f32, bf16 = (torch.float32,), (torch.bfloat16,)
    kernels = {"pair_mlp_wg_bf16": (pair_mlp, pair_mlp_inputs, bf16),
               "pair_mlp_wg": (pair_mlp, pair_mlp_inputs, f32),
               "edge_embedder": (edge_embedder, edge_embedder_inputs, bf16),
               "edge_embedder_wg": (edge_embedder, edge_embedder_inputs, f32)}
    for n in ROW_BLOCK_NS:
        for dtype in (torch.float32, torch.bfloat16):
            for name, (fn, inputs, dtypes) in kernels.items():
                if dtype not in dtypes:
                    continue
                args = inputs(2, n, dtype, gen)
                full = fn(*args)
                full_ms = cuda_time_ms(lambda: fn(*args), 5)
                for size in (2, 4):
                    rows = -(-n // size)
                    worst, equal, times = 0.0, True, []
                    for index in range(size):
                        block = [row_block(a, index, size) if i in ROW_ARGS[name] else a
                                 for i, a in enumerate(args)]
                        got = fn(*block)
                        valid = min(n, (index + 1) * rows) - index * rows
                        want = full[:, index * rows:index * rows + valid]
                        diff, violation = max_violation(got[:, :valid], want, TOL[dtype])
                        if violation > 0 or got[:, valid:].any():
                            raise AssertionError(f"{name} N={n} {dtype} sp={size} block {index}: "
                                                 f"max diff {diff}, padded rows not 0")
                        worst = max(worst, diff)
                        equal = equal and torch.equal(got[:, :valid], want)
                        times.append(cuda_time_ms(lambda: fn(*block), 5))
                    log(f"row blocks {name} B=2 N={n} {str(dtype)[6:]} sp={size} ({rows} rows): "
                        f"max diff {worst:.3e}, bits equal {equal}; ms a block "
                        f"{[round(t, 4) for t in times]} (sum {sum(times):.4f}) beside "
                        f"{full_ms:.4f} the full launch")


def sp_model():
    """The default full-width model on the card with the test fixtures'
    weights (every layer non-zero: the JAX package's initialization zeroes
    the frame and psi heads, and the trajectory would not see the edge
    stack)."""
    from framedipt_tpu_torch.diffusion import SE3Diffuser
    from framedipt_tpu_torch.model import ScoreNetwork
    from framedipt_tpu_torch.model.weights import synth_state_dict
    from framedipt_tpu_torch.tools.config import Config, resolve_kernel_flags

    cfg = Config()
    resolve_kernel_flags(cfg, torch.device("cuda"))
    model = ScoreNetwork(cfg.model, SE3Diffuser(cfg.diffuser, device="cuda"), inpainting=True)
    model.load_state_dict(synth_state_dict(model), strict=True)
    return model.to("cuda").eval()


def sp_feats() -> dict[str, torch.Tensor]:
    """Two samples at bucket 896: an 819-residue complex (the largest
    fixture's length) with a 14-residue loop diffused, random frames, from a
    numpy seed (the same on every process)."""
    rng = np.random.default_rng(20)
    B, N = 2, SP_N
    qs = rng.normal(size=(B, N, 4))
    res = np.ones((B, N), np.float32)
    res[:, 819:] = 0.0
    fixed = np.ones((B, N), np.float32)
    fixed[:, 400:414] = 0.0
    feats = {
        "res_mask": res, "fixed_mask": fixed, "seq_idx": np.tile(np.arange(N), (B, 1)),
        "t": np.ones(B, np.float32), "sc_ca_t": np.zeros((B, N, 3), np.float32),
        "rigids_t": np.concatenate([qs / np.linalg.norm(qs, axis=-1, keepdims=True),
                                    rng.normal(size=(B, N, 3)) * 10], -1).astype(np.float32),
        "torsion_angles_sin_cos": rng.normal(size=(B, N, 7, 2)).astype(np.float32),
        "aatype": rng.integers(0, 20, size=(B, N)),
    }
    return {k: torch.as_tensor(v, device="cuda") for k, v in feats.items()}


def run_sp_sampler(mesh=None) -> dict:
    """The sampler at noise_scale 1 from seed 3, timed, with its launches and
    peak memory."""
    from framedipt_tpu_torch.sampling import sample

    model, feats = sp_model(), sp_feats()
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = sample(model, model.diffuser, feats, torch.Generator(device="cuda").manual_seed(3),
                 num_t=SP_NUM_T, min_t=0.01, inpainting=True, sp_mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"final_rigids": out["final_rigids"].cpu().numpy(),
            "prot_traj": out["prot_traj"].cpu().numpy(),
            "launches": {name: fn.launches for name, fn in wrappers.items()},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "s_per_forward": seconds / (SP_NUM_T + 1)}


def dp_model(cfg):
    """The full-width model of phase 13(c) on the CPU."""
    from framedipt_tpu_torch.diffusion import SE3Diffuser
    from framedipt_tpu_torch.model import ScoreNetwork

    return ScoreNetwork(cfg.model, SE3Diffuser(cfg.diffuser, device="cpu"), inpainting=True)


def fixture_state_dict(cfg) -> dict[str, torch.Tensor]:
    from framedipt_tpu_torch.model.weights import synth_state_dict

    return synth_state_dict(dp_model(cfg))


def run_dp_steps(mesh=None) -> dict:
    """DP_STEPS float32 train steps on the whole batch of DP_B at N=DP_N from
    the fixtures' weights, Adam's eps DP_ADAM_EPS (each rank keeps its rows
    under ``mesh``): loss and
    grad norm a step, ms a step, peak memory, launches, and (rank 0, or one
    process) each step's gradients (clipped, whole) and the parameters after
    the first step and after the last."""
    from torch.distributed.tensor import DTensor

    from framedipt_tpu_torch.parallel.mesh import rank
    from framedipt_tpu_torch.train.checkpoints import full_state
    from framedipt_tpu_torch.train.loop import make_trainer

    cfg = train_config()
    trainer = make_trainer(cfg, device="cuda", state_dict=fixture_state_dict(cfg), mesh=mesh)
    for group in trainer.optimizer.param_groups:
        group["eps"] = DP_ADAM_EPS
    batch = train_batch(DP_B, DP_N)
    gen = torch.Generator(device="cuda").manual_seed(4)
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    losses, norms, ms, grads, params = [], [], [], [], []
    for i in range(DP_STEPS):
        t0 = time.perf_counter()
        m = trainer.step(batch, gen)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        # FSDP's shards gathered on every rank (a collective); rank 0 keeps them.
        step_grads = {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad).cpu()
                      for n, p in trainer.model.named_parameters() if p.grad is not None}
        if rank() == 0:
            grads.append(step_grads)
        if i in (0, DP_STEPS - 1):
            params.append({k: v.numpy().copy() for k, v in
                           full_state(trainer.model, trainer.optimizer)[0].items()})
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    return {"loss": losses, "grad_norm": norms, "ms": ms, "peak_gb": peak, "launches": launches,
            "params": params, "grads": grads}


def parallel_rank(part: str, rank: int, world: int, backend: str, work: str) -> None:
    """One rank of phase 13's part ``part`` ("sp": the sampler at sp=world;
    "dp": the train step at dp=world; "fsdp": at fsdp=world), started by
    :func:`spawn_part`; writes ``<part>_rank<r>.pt`` in ``work``."""
    sys.path.insert(0, str(REPO))
    from framedipt_tpu_torch.model.kernels.build import build_all
    from framedipt_tpu_torch.parallel import init_distributed, make_mesh, make_sp_mesh
    from framedipt_tpu_torch.tools.device import set_full_precision_matmul

    set_full_precision_matmul()
    build_all()  # the libraries the parent built
    init_distributed(f"file://{work}/rendezvous_{part}", world, rank, device="cuda",
                     backend=backend, initialization_timeout=120)
    if part == "sp":
        result = run_sp_sampler(make_sp_mesh(world, 1, "cuda"))
    elif part == "dp":
        result = run_dp_steps(make_mesh(world, 1, "cuda"))
    else:
        result = run_dp_steps(make_mesh(1, world, "cuda"))
    torch.save(result, pathlib.Path(work) / f"{part}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def spawn_part(part: str, world: int, work: pathlib.Path) -> list[dict]:
    """Start ``world`` ranks of ``part`` on the card(s), each with its own
    log, under PART_TIMEOUT_S (every rank killed at the limit); returns the
    ranks' results. Any rank that fails fails the run."""
    backend = parallel_backend(world)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.parallel_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), "
            "sys.argv[5], sys.argv[6])")
    logs = [open(work / f"{part}_rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(REPO), part, str(r), str(world),
                               backend, str(work)], cwd=REPO, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + PART_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (work / f"{part}_rank{r}.log").read_text()[-3000:]
            raise AssertionError(f"phase 13 {part} rank {r}/{world} ({backend}): "
                                 f"rc {p.returncode}\n{tail}")
    return [torch.load(work / f"{part}_rank{r}.pt", weights_only=False) for r in range(world)]


def check_sp_sampler(work: pathlib.Path) -> dict[str, int]:
    """(b) Two ranks at sp=2 against the one-process sampler on the card;
    returns the launches of both ranks together."""
    single = run_sp_sampler()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_part("sp", 2, work)
    spawn_s = time.perf_counter() - t0
    for key, tol in SP_TOL.items():
        errs = [float(np.abs(r[key] - single[key]).max()) for r in ranks]
        log(f"SP sampler sp=2 B=2 N={SP_N} num_t {SP_NUM_T}: {key} max diff a rank {errs} "
            f"(tol {tol})")
        if not max(errs) <= tol:
            raise AssertionError(f"SP sampler {key}: {errs} > {tol}")
    if not np.array_equal(ranks[0]["final_rigids"], ranks[1]["final_rigids"]):
        raise AssertionError("SP sampler: the ranks' final_rigids differ")
    expect = {"edge_embedder_wg": SP_NUM_T + 1, "edge_embedder": 0,
              "pair_mlp_wg": (NUM_BLOCKS - 1) * (SP_NUM_T + 1), "pair_mlp_wg_bf16": 0,
              "ipa_attention": 0}
    for r, res in enumerate(ranks):
        if any(res["launches"][k] != v for k, v in expect.items()):
            raise AssertionError(f"SP sampler rank {r}: launches {res['launches']}")
    log(f"SP sampler ({parallel_backend(2)}, {torch.cuda.device_count()} card(s)): ranks' "
        f"final_rigids bit-equal; launches a rank "
        f"{[{k: r['launches'][k] for k in expect} for r in ranks]}; peak GB a rank "
        f"{[round(r['peak_gb'], 3) for r in ranks]} beside {single['peak_gb']:.3f} in one "
        f"process; s a forward {[round(r['s_per_forward'], 4) for r in ranks]} beside "
        f"{single['s_per_forward']:.4f} in one process; the part {spawn_s:.1f} s")
    return {k: sum(r["launches"][k] for r in ranks) for k in KERNEL_NAMES}


def check_dp_step(work: pathlib.Path) -> dict[str, int]:
    """(c) Two ranks at dp=2 (and at fsdp=2 where there are two cards)
    against the one-process step on the whole batch; returns the dp=2 run's
    launches, both ranks together."""
    single = run_dp_steps()
    torch.cuda.empty_cache()
    launches = compare_dp_part("dp", single, work)
    if torch.cuda.device_count() < 2:
        log("FSDP step (dp=1, fsdp=2): not run: the machine has one card, and this phase runs "
            "FSDP only with a card a rank (NCCL); the CPU tests hold FSDP over gloo "
            "(tests/test_torch_parallel_dist.py)")
    else:
        compare_dp_part("fsdp", single, work)
    return launches


def param_errors(got: dict, want: dict, left_out: dict | None) -> tuple[float, str]:
    """The largest difference of ``got``'s parameters from ``want``'s on the
    scale of each one's max-abs, over every entry but those ``left_out``
    marks (None: every entry), and its parameter."""
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        keep = ~left_out[name] if left_out and name in left_out else np.ones(w.shape, bool)
        err = float(np.abs(got[name] - w)[keep].max(initial=0.0))
        err /= max(float(np.abs(w).max(initial=0.0)), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def compare_dp_part(part: str, single: dict, work: pathlib.Path) -> dict[str, int]:
    """Two ranks of ``part`` against the one-process steps ``single``: every
    number printed first, then each gate; returns the launches of both
    ranks together. Gated: each step's loss and grad norm (DP_TOL relative)
    and gradients (TRAIN_TOL of max(own max-abs, 1e-3 x the largest), as
    phase 6 holds the kernels' step); the parameters after the first and the
    last step (DP_TOL of their max-abs) but the entries whose gradient is 0
    in exact arithmetic (``cancelled_entries``, as
    tests/test_torch_parallel_dist.py leaves them out): their gradient is
    rounding noise and the softmax cancels whatever value they take."""
    from framedipt_tpu_torch.model.weights import cancelled_entries

    ranks = spawn_part(part, 2, work)
    rel = {key: max(abs(a / b - 1) for r in ranks for a, b in zip(r[key], single[key]))
           for key in ("loss", "grad_norm")}
    grad_err = []
    for got, want in zip(ranks[0]["grads"], single["grads"]):
        if got.keys() != want.keys():
            raise AssertionError(f"{part} step: gradients of {sorted(set(got) ^ set(want))}")
        largest = max(float(g.abs().max()) for g in want.values())
        grad_err.append(max((float((got[n] - g).abs().max())
                             / max(float(g.abs().max()), 1e-3 * largest), n)
                            for n, g in want.items()))
    cancelled = cancelled_entries(dp_model(train_config()))
    errs = [param_errors(got, want, cancelled)
            for got, want in zip(ranks[0]["params"], single["params"])]
    every = [param_errors(got, want, None)[0]
             for got, want in zip(ranks[0]["params"], single["params"])]
    left_out = sum(int(m.sum()) for m in cancelled.values())
    log(f"{part} step at {part}=2 B={DP_B} N={DP_N} float32, {DP_STEPS} steps, Adam eps "
        f"{DP_ADAM_EPS} "
        f"({parallel_backend(2)}, {torch.cuda.device_count()} card(s)): loss {ranks[0]['loss']} "
        f"beside {single['loss']}, grad norm {ranks[0]['grad_norm']} beside "
        f"{single['grad_norm']} (relative {rel['loss']:.2e}, {rel['grad_norm']:.2e}); "
        f"gradients within {[f'{e:.2e} ({n})' for e, n in grad_err]} of their scale a step; "
        f"the parameters after steps 1 and {DP_STEPS} within "
        f"{[f'{e:.2e} ({n})' for e, n in errs]} of their max-abs but where the gradient "
        f"cancels ({left_out} of {sum(v.size for v in single['params'][0].values())} entries "
        f"left out), {[f'{e:.2e}' for e in every]} over every entry; ms a step a "
        f"rank {[[round(t, 1) for t in r['ms']] for r in ranks]} beside "
        f"{[round(t, 1) for t in single['ms']]} in one process; peak GB a rank "
        f"{[round(r['peak_gb'], 3) for r in ranks]} beside {single['peak_gb']:.3f}")
    for key, err in rel.items():
        if not err <= DP_TOL:
            raise AssertionError(f"{part} step {key}: relative {err} > {DP_TOL}")
    for step, (err, name) in enumerate(grad_err, 1):
        if not err <= TRAIN_TOL:
            raise AssertionError(f"{part} step {step}: gradient {name} off by {err} of its "
                                 f"scale (> {TRAIN_TOL})")
    for step, (err, name) in zip((1, DP_STEPS), errs):
        if not err <= DP_TOL:
            raise AssertionError(f"{part} step {step}: parameter {name} off by {err} of its "
                                 f"max-abs (> {DP_TOL})")
    return {k: sum(r["launches"][k] for r in ranks) for k in KERNEL_NAMES}


def check_torchrun_cli(work: pathlib.Path) -> None:
    """(d) The training CLI under ``torchrun --standalone --nproc_per_node=1``
    with experiment.dp_size=1: a few steps through init_distributed and the
    rank-0 writers, an eval, and its checkpoint served."""
    from framedipt_tpu_torch.data.pipeline import ProcessOptions, process_serially, write_metadata
    from framedipt_tpu_torch.experiments.serve import InpaintingService
    from framedipt_tpu_torch.tools.config import Config, FilteringConfig
    from framedipt_tpu_torch.train.checkpoints import CKPT_FILE, latest_checkpoint

    rows = process_serially(sorted((REPO / "tests" / "data" / "cifs").glob("*.cif")), ProcessOptions(
        output_dir=work / "data", filtering=FilteringConfig(min_len=10, max_len=2000,
                                                            chain_max_len=256)))
    write_metadata(rows, work / "data" / "metadata.csv")
    procs = 1 if torch.cuda.device_count() < 2 else 2
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={procs}", "-m", "framedipt_tpu_torch.experiments.train",
            f"experiment.dp_size={procs}", *cli_overrides(work / "data", work),
            "experiment.num_epoch=1", "experiment.eval_freq=2", "experiment.ckpt_freq=1000",
            "experiment.early_ckpt=false", "experiment.log_freq=1"]
    t0 = time.perf_counter()
    proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=PART_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun CLI: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    run_dir = work / "ckpt" / "chip_smoke"
    metrics = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in metrics if "loss" in r]
    evals = [r for r in metrics if "eval_ca_ca_deviation" in r]
    ckpt = latest_checkpoint(run_dir)
    if (not steps or steps != sorted(set(steps)) or len(evals) != 1 or ckpt is None
            or not (run_dir / "train_conf.json").exists()
            or not all(np.isfinite(r["loss"]) for r in metrics if "loss" in r)):
        raise AssertionError(f"torchrun CLI: steps {steps}, evals {evals}, checkpoint {ckpt}")
    if procs == 1:
        log("torchrun CLI at --nproc_per_node=2: not run (one card)")
    log(f"torchrun --standalone --nproc_per_node={procs} training CLI: {len(steps)} steps in "
        f"{seconds:.1f} s (process start included), one line a step in metrics.jsonl, one eval, "
        f"{ckpt.name}")
    scfg = Config()
    scfg.inference.weights_path = str(ckpt / CKPT_FILE)
    service = InpaintingService(scfg, device="cuda")
    serve_requests(service, [(230, (100, 112), 25)])
    del service
    torch.cuda.empty_cache()


def check_parallel() -> dict[str, dict[str, int]]:
    """Phase 13. Returns the SP sampler's and the DP step's launches (both
    ranks together)."""
    t0 = time.perf_counter()
    log(f"phase 13 ({torch.cuda.device_count()} card(s): {parallel_backend(2)} for two ranks)")
    check_row_blocks()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        work = pathlib.Path(tmp)
        sp_launches = check_sp_sampler(work)
        dp_launches = check_dp_step(work)
        check_torchrun_cli(work)
    log(f"phase 13: {time.perf_counter() - t0:.2f} s")
    return {"sp": sp_launches, "dp": dp_launches}


def kernel_label(mangled: str) -> str:
    """A CUDA kernel's name and the start of its template arguments from its
    mangled name (``..._cu_<hash><len><name>I13__nv_bfloat16Lb1E...``)."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m is None:
        return mangled[:60]
    end = m.end() + int(m.group(1))
    return f"{mangled[m.end():end]}<{mangled[end:end + 24]}>"


def kernel_sources(name: str) -> list[str]:
    """The files under csrc/ that kernel ``name``'s source includes, itself first."""
    csrc = REPO / "framedipt_tpu_torch" / "csrc"
    found, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f not in found:
            found.append(f)
            todo += [line.split('"')[1] for line in (csrc / f).read_text().splitlines()
                     if line.startswith('#include "')]
    return found


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 2
    sys.path.insert(0, str(REPO))
    from framedipt_tpu_torch.model.kernels.build import build_all
    from framedipt_tpu_torch.tools.device import set_full_precision_matmul

    set_full_precision_matmul()
    started = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    info = build_all()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.2f} s; native PDB writer built "
        f"and loaded in {check_native_writer():.2f} s; native CIF tokenizer built and loaded in "
        f"{check_cif_tokenizer():.2f} s")
    for name, entry in info.items():
        fn = ""
        for line in entry["log"].splitlines():
            if "Function properties for" in line:
                fn = kernel_label(line.split()[-1])
            elif ("registers" in line or "spill" in line or "C7512" in line
                  or "error" in line.lower()):
                log(f"  {name} {fn}: {line.strip()}")
    torch.cuda.synchronize()

    log(f"phase 3: kernels against their plain versions (at {time.perf_counter() - started:.0f} s)")
    serving = check_kernels()
    bwd = check_pair_mlp_bwd()
    serving["pair_mlp_bwd_wg"] = bwd[torch.float32]
    serving["pair_mlp_bwd_wg_bf16"] = bwd[torch.bfloat16]
    emb_bwd = check_edge_embedder_bwd()
    serving["edge_embedder_bwd_wg"] = emb_bwd[torch.float32]
    serving["edge_embedder_bwd"] = emb_bwd[torch.bfloat16]
    for name, numbers in check_wgrad().items():
        serving[name].update(numbers)
    compare_ipa_branches()
    log(f"phase 4: full-width forward against the recorded reference (at {time.perf_counter() - started:.0f} s)")
    check_recorded_forward(use_pallas_ipa=False)
    check_recorded_forward(use_pallas_ipa=True)
    log(f"phase 5: inpainting service (at {time.perf_counter() - started:.0f} s)")
    launches = drive_service()
    log(f"phase 6: train step (at {time.perf_counter() - started:.0f} s)")
    check_training_refusals()
    train_launches = check_train_step()
    for name in ("pair_mlp_bwd_wg_bf16", "pair_mlp_bwd_wg", "edge_embedder_bwd"):
        launches[name] = train_launches[name]
    log(f"phase 7: the training CLI (at {time.perf_counter() - started:.0f} s)")
    launches["edge_embedder_bwd_wg"] = check_training_cli()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_infer_") as tmp:
        root = pathlib.Path(tmp)
        log(f"phase 8: the batch inpainting CLI (at {time.perf_counter() - started:.0f} s)")
        cli_launches, tree = check_inference_cli(root)
        log(f"phase 9: the TCR evaluation CLI over phase 8's tree (at {time.perf_counter() - started:.0f} s)")
        check_tcr_eval(tree, root, cases=3, samples=2)
        log(f"phase 10: de novo design at full width (at {time.perf_counter() - started:.0f} s)")
        check_recorded_denovo()
        mpnn_weights = check_recorded_mpnn()
        denovo_launches = check_denovo_cli(root, mpnn_weights)
        log(f"phase 11: ProteinMPNN training at the published width (at {time.perf_counter() - started:.0f} s)")
        check_mpnn_train_step(mpnn_weights)
        check_mpnn_train_cli(root, mpnn_weights)
        time_mpnn_train_step()
        log(f"phase 12: evaluation, host tools, the database flow, the CIF parser (at {time.perf_counter() - started:.0f} s)")
        t12 = time.perf_counter()
        check_denovo_eval(root / "denovo", root)
        check_cg2all_eval(tree, root, rows=3 * 2)
        check_process_pdb_files(root / "denovo", root)
        database_launches = check_database_cli(root)
        check_sweep(root)
        check_profiling_trace(root)
        check_cif_parse_speed()
        log(f"phase 12: {time.perf_counter() - t12:.2f} s")
    log(f"phase 13: row blocks, the SP sampler, the DP step, the training CLI under torchrun (at {time.perf_counter() - started:.0f} s)")
    parallel_launches = check_parallel()

    replaces = {
        "edge_embedder": "framedipt_tpu/model/pallas/edge_embedder.py:76",
        "edge_embedder_wg": "framedipt_tpu/model/pallas/edge_embedder.py:76",
        "pair_mlp_wg": "framedipt_tpu/model/pallas/pair_mlp.py:78",
        "pair_mlp_wg_bf16": "framedipt_tpu/model/pallas/pair_mlp.py:78",
        "ipa_attention": "framedipt_tpu/model/pallas/ipa_attention.py:65",
        "pair_mlp_bwd_wg_bf16": "framedipt_tpu/model/pallas/pair_mlp.py:349",
        "pair_mlp_bwd_wg": "framedipt_tpu/model/pallas/pair_mlp.py:349",
        "edge_embedder_bwd": "framedipt_tpu/model/pallas/edge_embedder.py:366",
        "edge_embedder_bwd_wg": "framedipt_tpu/model/pallas/edge_embedder.py:366",
    }
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": f"framedipt_tpu_torch/csrc/{name}.cu",
            "sources": [f"framedipt_tpu_torch/csrc/{f}" for f in kernel_sources(name)],
            "replaces": replaces[name], "launches": launches[name],
            "train_launches": train_launches[name],
            "inference_cli_launches": cli_launches[name],
            "denovo_cli_launches": denovo_launches[name],
            "database_cli_launches": database_launches[name],
            "sp_launches": parallel_launches["sp"][name],
            "dp_launches": parallel_launches["dp"][name],
            **serving[name],
        }
        for name in KERNEL_NAMES
    ]
    log(f"torch.profiler over this run: {PROFILE_LEAD_LOST} ({PROFILE_LEAD} lead kernels a session)")
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
