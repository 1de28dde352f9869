"""One training step and a K-step loop of them (twin of the adam path of
mtamrecommender_tpu/train/trainer.py).

  * `make_lr_schedule`: the two staircase exponential decays and the
    reference's ``learning_rate > 0.001 -> lr1 else lr2`` switch, read
    with the previous step's value;
  * `make_optimizer`: optax's ``chain(clip_by_global_norm(max_norm),
    scale_by_adam(0.9, 0.999, 1e-8), scale_by_schedule(-lr))`` written
    out on the parameter tensors, updated in place;
  * `make_train_step`: loss -> backward -> clipped Adam update;
  * `make_superstep`: K such steps over batches gathered from a
    device-resident dataset, the per-step metrics stacked;
  * `TrainState`: the model, its Adam state and the step, what
    `train.checkpoint` saves and restores.

A step's random draws (the attention-weight dropout masks of SASrec,
TiSAS, NARM and MTAM_no_time_aware_att, and bpr's negative item; the
other models draw nothing) come from one `torch.Generator` on the
step's device, seeded from ``cfg.train.seed``; every step draws from
where the last one stopped, so a run is reproducible on one device.
Its stream is not JAX's: the draws cannot match JAX's threefry draws,
and a checkpoint does not carry the generator's state, so a run resumed
from one redraws them.  The other optimizers,
``flatten_optimizer``, ``pack_small_leaves`` and the ``Trainer`` loop
are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from mtamrecommender_tpu_torch.config import ExperimentConfig, TrainConfig
from mtamrecommender_tpu_torch.data.device_data import (DeviceDataset,
                                                         gather_batch)
from mtamrecommender_tpu_torch.models.base import ModelDef, compute_loss
from mtamrecommender_tpu_torch.types import Batch, resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr1 = base * 0.99^(step//100); lr2 = 1e-3 * decay_rate^(step//100).
    lr1 applies while base > 1e-3 and lr1(step-1) > 1e-3, lr2 otherwise.
    Computed in float32, as the JAX schedule is."""
    base = np.float32(cfg.learning_rate)
    decay = np.float32(cfg.decay_rate)
    f32 = np.float32

    def schedule(step: int) -> float:
        k = f32(np.floor(f32(step) / f32(100.0)))
        k_prev = f32(np.floor(f32(max(step - 1, 0)) / f32(100.0)))
        lr1 = base * np.power(f32(0.99), k)
        lr2 = f32(1e-3) * np.power(decay, k)
        prev = base * np.power(f32(0.99), k_prev)
        return float(lr1 if (base > f32(1e-3)) and (prev > f32(1e-3))
                     else lr2)

    return schedule


class AdamState(NamedTuple):
    count: int                       # updates applied so far
    mu: Dict[str, torch.Tensor]      # first moments, by parameter name
    nu: Dict[str, torch.Tensor]      # second moments

    def to_dict(self) -> Dict[str, Any]:
        """Plain ints and dicts of tensors, which ``torch.load`` reads
        back with ``weights_only=True`` (a pickled NamedTuple it
        refuses)."""
        return {"count": int(self.count), "mu": dict(self.mu),
                "nu": dict(self.nu)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AdamState":
        return cls(count=int(d["count"]), mu=dict(d["mu"]), nu=dict(d["nu"]))


class Optimizer(NamedTuple):
    init: Callable[[nn.Module], AdamState]
    # (model, grads by name, state) -> new state; updates the model in place
    update: Callable[[nn.Module, Dict[str, torch.Tensor], AdamState],
                     AdamState]


def clip_by_global_norm(grads: Dict[str, torch.Tensor],
                        max_norm: float) -> Dict[str, torch.Tensor]:
    """optax's clip: g * max_norm / ||g|| only where ||g|| >= max_norm
    (torch's clip_grad_norm_ divides by ||g|| + 1e-6 instead).  Decided
    on the device, so the step does not wait for the norm."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    keep = norm < max_norm
    return {n: torch.where(keep, g, g / norm * max_norm)
            for n, g in grads.items()}


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """Clip to the global norm ``max_gradient_norm``, Adam(0.9, 0.999,
    1e-8) with eps added after sqrt(nu_hat), then ``-lr(count)``, where
    count is the number of updates before this one."""
    if cfg.optimizer != "adam":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet; the port has "
            "'adam' (ROADMAP.md, Queue 1)")
    if cfg.flatten_optimizer or cfg.pack_small_leaves:
        raise NotImplementedError(
            "flatten_optimizer and pack_small_leaves are not ported yet "
            "(ROADMAP.md, Queue 1)")
    schedule = make_lr_schedule(cfg)

    def init(model: nn.Module) -> AdamState:
        params = dict(model.named_parameters())
        return AdamState(
            count=0,
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(model: nn.Module, grads: Dict[str, torch.Tensor],
               state: AdamState) -> AdamState:
        grads = clip_by_global_norm(grads, cfg.max_gradient_norm)
        count = state.count + 1
        bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count))
        lr = schedule(state.count)
        mu, nu = {}, {}
        for name, p in model.named_parameters():
            g = grads[name]
            mu[name] = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[name]
            nu[name] = (1 - ADAM_B2) * g.square() + ADAM_B2 * state.nu[name]
            step = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + ADAM_EPS)
            p.add_(-lr * step)
        return AdamState(count=count, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


@dataclass
class TrainState:
    """What a checkpoint holds: the model (its parameters), the Adam
    state (None where only the parameters are wanted) and the number of
    steps taken."""

    model: nn.Module
    opt_state: Optional[AdamState]
    step: int = 0


def _check_device(device: torch.device, model: nn.Module,
                  batch: Batch) -> None:
    for what, t in (("the model", next(model.parameters())),
                    ("the batch", batch.items)):
        if t.device.type != device.type:
            raise ValueError(f"train step on {device}: {what} is on "
                             f"{t.device}")


def make_train_step(model_def: ModelDef, cfg: ExperimentConfig,
                    optimizer: Optimizer, valid_vocab: Optional[int] = None,
                    device=None):
    """``step(model, opt_state, batch) -> (opt_state, metrics)``: loss,
    gradients, the clipped update applied to the model's parameters in
    place.  Runs on CUDA unless ``device="cpu"``; the model and the batch
    must be on that device.  Dropout masks are drawn from a generator on
    the device seeded from ``cfg.train.seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed)

    def train_step(model: nn.Module, opt_state: AdamState, batch: Batch):
        _check_device(device, model, batch)
        model.zero_grad(set_to_none=True)
        metrics = compute_loss(model_def, model, cfg.model, batch,
                               valid_vocab, gen=gen)
        metrics["loss"].backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters()}
        opt_state = optimizer.update(model, grads, opt_state)
        return opt_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_superstep(model_def: ModelDef, cfg: ExperimentConfig,
                   optimizer: Optimizer, valid_vocab: int, batch_size: int,
                   device=None):
    """``run(model, opt_state, data, order, start_step, n_steps) ->
    (opt_state, stacked)``: ``n_steps`` train steps over the batches
    ``gather_batch(data, order, start_step + k, batch_size)``, with the
    metrics {loss, ce, l2} stacked to [n_steps].  The twin of the JAX
    `make_superstep`, as a Python loop."""
    step = make_train_step(model_def, cfg, optimizer, valid_vocab, device)

    def run(model: nn.Module, opt_state: AdamState, data: DeviceDataset,
            order: torch.Tensor, start_step: int, n_steps: int):
        rows = []
        for k in range(n_steps):
            batch = gather_batch(data, order, start_step + k, batch_size)
            opt_state, metrics = step(model, opt_state, batch)
            rows.append(metrics)
        stacked = {key: torch.stack([m[key] for m in rows])
                   for key in ("loss", "ce", "l2")}
        return opt_state, stacked

    return run
