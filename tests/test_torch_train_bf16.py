"""The port's train step with ``model.compute_dtype=bfloat16`` on the CPU, at
a small width, through the kernels' plain versions (on the card the same
step runs every edge kernel and both backwards in bf16: ``chip_smoke.py``
phase 6).

The bf16 step trains the same parameters as the float32 step (float32
parameters and gradients, every gradient finite), and its first step's loss
is within 5e-2 (relative) of the float32 step's on the same batch, noise and
weights, with the self-conditioning coin both ways. No JAX reference: the
float32 step is held against the JAX package's in tests/test_torch_train.py.
"""
import numpy as np
import pytest
import torch

from framedipt_tpu_torch.model.weights import synth_state_dict
from framedipt_tpu_torch.tools.config import Config, SO3Config
from framedipt_tpu_torch.train.loop import make_trainer

TINY = {
    "node_embed_size": 32, "edge_embed_size": 16,
    "ipa.c_s": 32, "ipa.c_z": 16, "ipa.c_hidden": 16, "ipa.c_skip": 8, "ipa.no_heads": 2,
    "ipa.no_qk_points": 4, "ipa.no_v_points": 4, "ipa.num_blocks": 2,
    "ipa.seq_tfmr_num_layers": 1, "ipa.seq_tfmr_num_heads": 2,
}


def tiny_config(dtype: str) -> Config:
    cfg = Config()
    cfg.diffuser.so3 = SO3Config(num_omega=50, num_sigma=20, cache_dir=None)
    cfg.model.compute_dtype = dtype
    for key, value in TINY.items():
        node = cfg.model
        *parents, leaf = key.split(".")
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    cfg.experiment.inpainting = True
    return cfg


def batch(B=2, N=10, seed=0) -> dict[str, torch.Tensor]:
    """Frames on a smooth random walk, three fixed residues a chain."""
    rng = np.random.default_rng(seed)
    trans = np.cumsum(rng.normal(size=(B, N, 3)), axis=1).astype(np.float32) * 2
    trans -= trans.mean(axis=1, keepdims=True)
    qs = rng.normal(size=(B, N, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    fixed = np.zeros((B, N), np.float32)
    fixed[:, :3] = 1.0
    return {
        "rigids_0": torch.as_tensor(np.concatenate([qs, trans], -1)),
        "res_mask": torch.ones(B, N), "fixed_mask": torch.as_tensor(fixed),
        "seq_idx": torch.arange(N)[None].repeat(B, 1),
        "torsion_angles_sin_cos": torch.as_tensor(rng.normal(size=(B, N, 7, 2)).astype(np.float32)),
        "aatype": torch.as_tensor(rng.integers(0, 20, size=(B, N))),
    }


@pytest.mark.parametrize("seed", [0, 4])
def test_bf16_step_trains_the_float32_parameters(seed):
    """Seeds 0 and 4 draw the self-conditioning coin both ways."""
    f32 = make_trainer(tiny_config("float32"), device="cpu")
    weights = synth_state_dict(f32.model)
    f32.model.load_state_dict(weights)
    bf16 = make_trainer(tiny_config("bfloat16"), device="cpu", state_dict=weights)
    b = batch()
    m32 = f32.step(b, torch.Generator().manual_seed(seed))
    m16 = bf16.step(b, torch.Generator().manual_seed(seed))
    assert m16["self_conditioned"] == m32["self_conditioned"] == (seed == 4)
    grads32 = {n: p.grad for n, p in f32.model.named_parameters() if p.grad is not None}
    grads16 = {n: p.grad for n, p in bf16.model.named_parameters() if p.grad is not None}
    assert grads16.keys() == grads32.keys()
    for name, g in grads16.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
    assert any(g.abs().max() > 0 for g in grads16.values())
    assert np.isfinite(float(m16["grad_norm"]))
    loss32, loss16 = float(m32["loss"]), float(m16["loss"])
    assert abs(loss16 - loss32) <= 5e-2 * abs(loss32), (loss16, loss32)
