"""One training step of the score network: timestep sampling, SE(3)
forward-marginal noising, optional recycling, the optional stop-gradient
self-conditioning forward, the forward with gradients, the denoising
score-matching losses, backward, global-norm gradient clipping and Adam.

The port of the JAX package's ``train/loop.py``. Randomness comes from one
``torch.Generator`` on the model's device, drawn in this order: t, the
forward marginal (rotations, then translation noise), the recycle path's
marginal and reverse-step noises, the self-conditioning coin. The model runs
on CUDA unless it was built on the CPU (:func:`make_trainer`).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import torch

from framedipt_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from framedipt_tpu_torch.geometry import frames
from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.model.score_network import ScoreNetwork
from framedipt_tpu_torch.model.weights import synth_state_dict
from framedipt_tpu_torch.tools.config import Config, check_emb_bwd_impl, resolve_kernel_flags
from framedipt_tpu_torch.tools.device import resolve_device
from framedipt_tpu_torch.train.losses import score_matching_losses

F32 = torch.float32


class ClippedAdam(torch.optim.Adam):
    """Adam (beta 0.9/0.999, eps 1e-8: ``optax.adam``'s update) after
    clipping the gradients by their global norm as
    ``optax.clip_by_global_norm`` does: g * max_norm / norm where norm >=
    max_norm, no epsilon. :meth:`step` returns the norm before clipping."""

    def __init__(self, params, lr: float, max_grad_norm: float = 10.0) -> None:
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.max_grad_norm = max_grad_norm

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        # Multi-tensor ops: a few launches for all gradients, none per tensor.
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = norm >= self.max_grad_norm
        one = torch.ones_like(norm)
        torch._foreach_mul_(grads, torch.where(clip, self.max_grad_norm * one, one))
        torch._foreach_div_(grads, torch.where(clip, norm, one))
        super().step()
        return norm


def make_optimizer(params, lr: float = 1e-4, max_grad_norm: float = 10.0) -> ClippedAdam:
    """Adam with global-norm clipping (the reference's optimizer)."""
    return ClippedAdam(params, lr, max_grad_norm)


def build_model_feats(batch: dict, rigids_t7, t, sc_ca_t) -> dict:
    """The score network's input dict from a training batch."""
    feats = {
        "res_mask": batch["res_mask"],
        "fixed_mask": batch["fixed_mask"],
        "seq_idx": batch["seq_idx"],
        "torsion_angles_sin_cos": batch["torsion_angles_sin_cos"],
        "rigids_t": rigids_t7,
        "t": t,
        "sc_ca_t": sc_ca_t,
    }
    if "aatype" in batch:
        feats["aatype"] = batch["aatype"]
    return feats


def build_train_step(
    model: torch.nn.Module,
    diffuser: SE3Diffuser,
    cfg: Config,
    optimizer: ClippedAdam,
) -> Callable[[dict, torch.Generator], dict]:
    """Returns ``train_step(batch, generator) -> metrics``, which updates the
    model's parameters in place.

    ``batch`` (tensors on the model's device): rigids_0 [B,N,7], res_mask,
    fixed_mask, seq_idx [B,N], torsion_angles_sin_cos [B,N,7,2], optional
    aatype [B,N], optional t [B] and loss_weight [B] (importance-sampled
    timesteps). ``metrics``: loss, grad_norm (before clipping), the loss
    terms, t, and self_conditioned (the coin, a bool)."""
    exp_conf = cfg.experiment
    min_t = cfg.data.min_t
    device = next(model.parameters()).device
    check_emb_bwd_impl(cfg)

    def diffuse_mask_of(batch):
        return (1.0 - batch["fixed_mask"].to(F32)) * batch["res_mask"].to(F32)

    def noise_batch(batch, generator):
        b = batch["res_mask"].shape[0]
        if "t" in batch:
            t = batch["t"].to(F32)
        else:
            u = torch.rand((b,), generator=generator, device=device)
            t = min_t + (1.0 - min_t) * u
        rigids_0 = Rigid.from_tensor7(batch["rigids_0"].to(F32))
        return t, diffuser.forward_marginal(generator, rigids_0, t, diffuse_mask_of(batch))

    def recycle_rigids(batch, t, generator):
        """Noise to a later time ('max' -> t=1, 'next' -> t+dt), run the
        model without gradient, take one reverse step back to t."""
        dt = 1.0 / cfg.data.num_t
        if exp_conf.recycle.mode == "max":
            t_recycle = torch.ones_like(t)
        else:  # "next"
            t_recycle = torch.clamp(t + dt, max=1.0)
        diffuse_mask = diffuse_mask_of(batch)
        marg_r = diffuser.forward_marginal(
            generator, Rigid.from_tensor7(batch["rigids_0"].to(F32)), t_recycle, diffuse_mask
        )
        rigids_r7 = marg_r.rigids_t.to_tensor7()
        with torch.no_grad():
            out_r = model(build_model_feats(batch, rigids_r7, t_recycle,
                                            torch.zeros_like(rigids_r7[..., 4:])))
        z_rot = torch.randn(out_r["rot_score"].shape, generator=generator, device=device)
        z_trans = torch.randn(out_r["trans_score"].shape, generator=generator, device=device)
        return diffuser.reverse(
            marg_r.rigids_t, out_r["rot_score"], out_r["trans_score"],
            t_recycle[:, None, None], dt, z_rot, z_trans, diffuse_mask=diffuse_mask,
        ).to_tensor7()

    def loss_fn(batch, generator):
        t, marg = noise_batch(batch, generator)
        rigids_t7 = marg.rigids_t.to_tensor7()
        trans_score_target, rot_score_target = marg.trans_score, marg.rot_score
        if exp_conf.recycle.enabled:
            rigids_t7 = recycle_rigids(batch, t, generator)
            # The recycled frames are another x_t than the marginal's draw:
            # recompute the score targets against them.
            r0 = batch["rigids_0"].to(F32)
            if diffuser.diffuse_trans:
                trans_score_target = diffuser.calc_trans_score(rigids_t7[..., 4:], r0[..., 4:], t)
            if diffuser.diffuse_rot:
                rot_score_target = diffuser.calc_rot_score(rigids_t7[..., :4], r0[..., :4], t)

        # Ground-truth idealized backbone atoms from the clean frames.
        gt_psi = batch["torsion_angles_sin_cos"][..., 2, :].to(F32)
        _, _, _, atom14_gt = frames.compute_backbone(
            Rigid.from_tensor7(batch["rigids_0"].to(F32)), gt_psi, aatype=batch.get("aatype")
        )

        # Self-conditioning on a coin flip, detached.
        sc_ca = torch.zeros_like(rigids_t7[..., 4:])
        self_conditioned = False
        if cfg.model.embed.embed_self_conditioning:
            self_conditioned = bool(torch.rand((), generator=generator, device=device) < 0.5)
            if self_conditioned:
                with torch.no_grad():
                    sc_ca = model(build_model_feats(batch, rigids_t7, t, sc_ca))["rigids"][..., 4:]

        pred = model(build_model_feats(batch, rigids_t7, t, sc_ca))
        loss_batch = {
            **batch,
            "t": t,
            "trans_score": trans_score_target,
            "rot_score": rot_score_target,
            "trans_score_scaling": marg.trans_score_scaling,
            "rot_score_scaling": marg.rot_score_scaling,
            "atom14_gt": atom14_gt,
        }
        total, terms = score_matching_losses(
            pred, loss_batch, exp_conf,
            diffuse_rot=diffuser.diffuse_rot, diffuse_trans=diffuser.diffuse_trans,
        )
        if "loss_weight" in batch:
            # Importance-sampled timesteps: optimize the 1/p-weighted loss,
            # report the raw per-example loss for the sampler's history.
            terms["raw_per_example_loss"] = terms["per_example_loss"]
            per_ex = terms["per_example_loss"] * batch["loss_weight"]
            total = torch.mean(per_ex)
            terms["per_example_loss"] = per_ex
            terms["total_loss"] = total
        terms["t"] = t
        return total, terms, self_conditioned

    def train_step(batch: dict, generator: torch.Generator) -> dict:
        optimizer.zero_grad(set_to_none=True)
        loss, terms, self_conditioned = loss_fn(batch, generator)
        loss.backward()
        grad_norm = optimizer.step()
        return {
            "loss": loss.detach(),
            "grad_norm": grad_norm,
            **{k: v.detach() for k, v in terms.items()},
            "self_conditioned": self_conditioned,
        }

    return train_step


def make_trainer(cfg: Config, device: str | torch.device | None = None,
                 state_dict: dict | None = None, seed: int = 0) -> SimpleNamespace:
    """A model, diffuser, optimizer and train step for ``cfg`` on ``device``
    (CUDA unless asked otherwise), with ``state_dict`` or seeded random
    weights (``synth_state_dict``). Resolves the kernel flags as training
    does (``use_pallas_ipa=None`` -> False)."""
    dev = resolve_device(device)
    resolve_kernel_flags(cfg, dev)
    diffuser = SE3Diffuser(cfg.diffuser, device=dev)
    model = ScoreNetwork(cfg.model, diffuser, inpainting=cfg.experiment.inpainting)
    model.load_state_dict(state_dict if state_dict is not None
                          else synth_state_dict(model, seed), strict=True)
    model.to(dev)
    optimizer = make_optimizer(model.parameters(), cfg.experiment.learning_rate)
    step = build_train_step(model, diffuser, cfg, optimizer)
    return SimpleNamespace(model=model, diffuser=diffuser, optimizer=optimizer, step=step,
                           device=dev)
