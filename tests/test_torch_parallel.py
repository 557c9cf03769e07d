"""The port's ``parallel/`` package in one process: the mesh size rules and
refusals (as tests/unit/test_fsdp.py holds JAX's), the batch split and its
padding, the sequence-parallel helpers (the identity outside a context, as
tests/unit/test_sequence_parallel.py holds JAX's; row blocks padded to
ceil(N/sp) inside one), the refusal of the IPA attention kernel under SP,
and the edge-stack kernels' plain versions on a row block (Nr = N/4, and a
ragged block padded with masked rows) against the same rows of the full call
and against JAX's Pallas kernels in interpret mode on that row block.

A mesh that no process group backs is stood in for by :class:`FakeMesh`;
tests/test_torch_parallel_dist.py runs the real collectives over gloo.
Tolerance: 1e-5 against JAX (float32)."""
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from framedipt_tpu.model.pallas import edge_embedder as j_emb
from framedipt_tpu.model.pallas import pair_mlp as j_pair

from framedipt_tpu_torch.diffusion import SE3Diffuser
from framedipt_tpu_torch.model import ScoreNetwork
from framedipt_tpu_torch.model.kernels import edge_embedder as t_emb
from framedipt_tpu_torch.model.kernels import pair_mlp as t_pair
from framedipt_tpu_torch.parallel import make_mesh, make_sp_mesh, sp
from framedipt_tpu_torch.parallel.mesh import data_ranks, pad_batch, shard_batch
from framedipt_tpu_torch.sampling import sample

from tests.test_torch_cuda import emb_args, emb_to_torch, pair_args, pair_to_torch
from tests.test_torch_kernels import _emb_jax, _to_jax
from tests.test_torch_model import make_feats, tiny_configs


class FakeMesh:
    """The DeviceMesh calls of ``parallel/`` for one rank of a mesh that no
    process group backs; any collective fails the test."""

    def __init__(self, names: tuple[str, str], shape: tuple[int, int], coord: tuple[int, int]):
        self.mesh_dim_names, self.shape, self.coord = names, shape, coord

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]

    def get_coordinate(self):
        return list(self.coord)

    def size(self, dim=None):
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def get_group(self, name):
        raise AssertionError("no collective in a one-process test")


def sp_mesh(size, index):
    return FakeMesh(("dp", "sp"), (1, size), (0, index))


@pytest.mark.parametrize("dp,fsdp", [(-1, 1), (1, 1)])
def test_make_mesh_runs_alone_at_size_one(dp, fsdp):
    """Outside a process group dp x fsdp 1 is one process: no mesh."""
    assert make_mesh(dp, fsdp, "cpu") is None
    assert data_ranks(None) == (0, 1)


@pytest.mark.parametrize("dp,fsdp,match", [
    (2, 1, "torchrun"), (1, 2, "torchrun"), (4, 2, "torchrun"), (-1, 2, "not divisible.*torchrun"),
])
def test_make_mesh_refuses_sizes_the_world_lacks(dp, fsdp, match):
    """One process per GPU: dp x fsdp above the world size raises (a JAX
    process would take a slice of its devices; the port names torchrun)."""
    with pytest.raises(ValueError, match=match):
        make_mesh(dp, fsdp, "cpu")


def test_make_sp_mesh_size_rules():
    assert make_sp_mesh(1, 1, "cpu") is None
    for sp_size, dp in ((2, 1), (1, 2), (4, 2)):
        with pytest.raises(ValueError, match="world size"):
            make_sp_mesh(sp_size, dp, "cpu")


def test_shard_batch_gives_each_rank_its_block():
    """Every rank of a (dp=2, fsdp=2) mesh takes its own rows, dp-major."""
    batch = {"x": torch.arange(8 * 3).reshape(8, 3), "y": np.arange(8)}
    blocks = []
    for d in range(2):
        for f in range(2):
            mesh = FakeMesh(("dp", "fsdp"), (2, 2), (d, f))
            assert data_ranks(mesh) == (2 * d + f, 4)
            part = shard_batch(mesh, batch)
            np.testing.assert_array_equal(part["y"], np.arange(2 * (2 * d + f), 2 * (2 * d + f) + 2))
            blocks.append(part["x"])
    torch.testing.assert_close(torch.cat(blocks), batch["x"])
    assert shard_batch(None, batch) is batch
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(FakeMesh(("dp", "fsdp"), (2, 2), (0, 0)), torch.zeros(6))


@pytest.mark.parametrize("size,multiple", [(3, 4), (1, 4), (5, 2), (4, 4), (2, 1)])
def test_pad_batch_repeats_examples_as_the_jax_cli(size, multiple):
    """The JAX training CLI's padding (experiments/train.py: cycle the
    example indices to the next multiple), to dp x fsdp here."""
    batch = {"a": np.arange(size) * 10, "b": np.arange(size * 2).reshape(size, 2)}
    got = pad_batch(batch, multiple)
    want = batch
    if size % multiple:
        pad_idx = np.resize(np.arange(size), multiple - size % multiple)
        want = {k: np.concatenate([v, v[pad_idx]]) for k, v in batch.items()}
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].shape[0] % multiple == 0


def test_sp_helpers_are_identity_when_inactive():
    x = torch.ones(2, 8, 8, 4)
    assert sp.active() is None
    assert sp.local_rows(x) is x
    assert sp.gather_rows(x, 8) is x
    assert sp.row_range(8) == (0, 8)


@pytest.mark.parametrize("n,size", [(24, 4), (22, 4), (5, 4), (22, 2)])
def test_local_rows_split_and_pad(n, size):
    """ceil(n/sp) rows a rank, the last ranks' rows past n zero; the blocks
    in rank order, cut to n, are the tensor."""
    x = torch.randn(2, n, n, 3)
    rows = math.ceil(n / size)
    blocks = []
    with torch.no_grad():
        for index in range(size):
            with sp.sp_context(sp_mesh(size, index)):
                assert sp.active() is not None
                start, stop = sp.row_range(n)
                assert (start, stop) == (index * rows, (index + 1) * rows)
                block = sp.local_rows(x)
            assert block.shape == (2, rows, n, 3)
            valid = max(0, min(stop, n) - start)
            assert not block[:, valid:].any()
            blocks.append(block)
        assert sp.active() is None
    torch.testing.assert_close(torch.cat(blocks, dim=1)[:, :n], x, rtol=0, atol=0)


def test_sp_is_inference_only():
    with sp.sp_context(sp_mesh(2, 0)):
        with pytest.raises(RuntimeError, match="inference only"):
            sp.local_rows(torch.ones(1, 4, 3))


def _tiny_model(use_pallas_ipa):
    _, tc = tiny_configs()
    tc.model.ipa.use_pallas_ipa = use_pallas_ipa
    return tc, ScoreNetwork(tc.model, SE3Diffuser(tc.diffuser, device="cpu"), inpainting=True)


def test_sp_rejects_the_ipa_attention_kernel():
    """As test_sp_rejects_unsupported_pallas_kernels holds build_inference_fn:
    the sampler refuses use_pallas_ipa with an sp mesh before anything runs,
    and the trunk refuses the kernel under an active context."""
    _, model = _tiny_model(True)
    feats = {k: torch.as_tensor(v) for k, v in make_feats(1, B=1, N=8).items()}
    with pytest.raises(ValueError, match="use_pallas_ipa"):
        sample(model, model.diffuser, feats, torch.Generator().manual_seed(0), num_t=2,
               min_t=0.01, inpainting=True, sp_mesh=sp_mesh(2, 0))
    with torch.no_grad(), sp.sp_context(sp_mesh(2, 0)):
        with pytest.raises(ValueError, match="use_pallas_ipa"):
            model(feats)


# Row blocks: N=24 at sp=4 (six rows, rank 1) and N=22 at sp=4 (rank 3: four
# rows and two padded).
ROW_CASES = [(24, 1), (22, 3)]


def _row_block(args, row_positions, index):
    """The arguments with the row-side ones cut to rank ``index``'s block."""
    with torch.no_grad(), sp.sp_context(sp_mesh(4, index)):
        return [sp.local_rows(a) if i in row_positions else a for i, a in enumerate(args)]


@pytest.mark.parametrize("n,index", ROW_CASES, ids=["quarter", "ragged"])
def test_pair_mlp_on_a_row_block(n, index):
    args = pair_args(np.random.default_rng(n), 2, n, 16, 32, 16, True)
    full = t_pair.pair_mlp(*pair_to_torch(args, torch.float32))
    # pair, i_term, row_mask, fi are the rows; the rest whole.
    block = _row_block(pair_to_torch(args, torch.float32), (0, 1, 3, 13), index)
    assert block[0].shape[1] == 6 and block[2].shape[1] == n
    got = t_pair.pair_mlp(*block)
    start = 6 * index
    valid = min(n, start + 6) - start
    torch.testing.assert_close(got[:, :valid], full[:, start:start + valid], rtol=0, atol=1e-6)
    assert not got[:, valid:].any()
    ja = _to_jax([a.numpy() for a in block], jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = j_pair.fused_pair_mlp(*ja[:13], fi=ja[13], fj=ja[14], wfe=ja[15],
                                     tile_i=8, tile_j=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,index", ROW_CASES, ids=["quarter", "ragged"])
def test_edge_embedder_on_a_row_block(n, index):
    args, bins = emb_args(np.random.default_rng(n + 1), 2, n, 16, 22)
    full = t_emb.edge_embedder(*emb_to_torch(args, torch.float32), *bins)
    # g, pos_rows, i_term, row_mask are the rows; the rest whole.
    block = _row_block(emb_to_torch(args, torch.float32), (0, 2, 4, 6), index)
    assert block[0].shape[1] == 6 and block[1].shape[1] == n
    got = t_emb.edge_embedder(*block, *bins)
    start = 6 * index
    valid = min(n, start + 6) - start
    torch.testing.assert_close(got[:, :valid], full[:, start:start + valid], rtol=0, atol=1e-6)
    assert not got[:, valid:].any()
    with pltpu.force_tpu_interpret_mode():
        want = j_emb.fused_edge_embedder(
            *_emb_jax([a.numpy() for a in block], jnp.float32), bins_lower=bins[0],
            bins_upper=bins[1], tile_i=8, tile_j=16,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_one_process_clis_do_not_load_the_distributed_modules():
    """A CLI started without torchrun loads neither torch.distributed.tensor
    nor torch.distributed.checkpoint (seconds of every process start); they
    load where a process group needs them."""
    import subprocess
    import sys

    code = ("import sys; import framedipt_tpu_torch.experiments.inference, "
            "framedipt_tpu_torch.experiments.train, framedipt_tpu_torch.experiments.serve; "
            "print(sorted(m for m in sys.modules if m.startswith(('torch.distributed.tensor', "
            "'torch.distributed.checkpoint', 'torch.distributed.fsdp'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
