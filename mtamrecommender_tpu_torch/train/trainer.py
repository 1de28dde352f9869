"""Training: the optimizers, the train steps and the epoch / eval loop
(the counterpart of mtamrecommender_tpu/train/trainer.py).

  * `make_lr_schedule`: the two staircase exponential decays and the
    reference's ``learning_rate > 0.001 -> lr1 else lr2`` switch, read
    with the previous step's value;
  * `make_optimizer`: optax's ``chain(clip_by_global_norm(max_norm),
    core, scale_by_schedule(-lr))`` written out on the parameter tensors
    and applied in place, with ``core`` one of ``scale_by_adam(0.9,
    0.999, 1e-8)``, ``scale_by_adadelta(0.95, 1e-8)``,
    ``scale_by_rms(0.9, 1e-10)`` and ``identity`` (sgd), as optax 0.2.6
    defines them.  ``flatten_optimizer`` runs the update on one raveled
    vector (optax.flatten), ``pack_small_leaves`` on one vector of the
    small float leaves a dtype with the tables standalone; both change
    only the state's layout (`Layout`);
  * `make_train_step`, `make_device_train_step` (the batch gathered from
    a device-resident dataset), `make_superstep` and
    `make_dynamic_superstep` (K steps, a Python loop);
  * `Trainer`: the epoch loop with the initial eval, the display / eval /
    save cadence, exact resume through a data cursor, and a
    FloatingPointError on a non-finite loss;
  * `TrainState`: the model, its optimizer state and the step, what
    `train.checkpoint` saves and restores.

A step's random draws (the attention-weight dropout masks of SASrec,
TiSAS, NARM and MTAM_no_time_aware_att, and bpr's negative item; the
other models draw nothing) come from one `torch.Generator` on the
step's device, which the caller gives or which is seeded from
``cfg.train.seed``; every step draws from where the last one stopped.
Its stream is not JAX's threefry stream, so these draws cannot match
JAX's.  The `Trainer`'s checkpoints carry the generator's state
(`Trainer._cursor_for_save`), so a resumed run draws what the unbroken
run draws.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mtamrecommender_tpu_torch.config import ExperimentConfig, TrainConfig
from mtamrecommender_tpu_torch.data import device_data as dd
from mtamrecommender_tpu_torch.data.device_data import (DeviceDataset,
                                                         gather_batch)
from mtamrecommender_tpu_torch.data.pipeline import (PackedDataset,
                                                     batch_iterator,
                                                     prefetch_to_device)
from mtamrecommender_tpu_torch.models.base import ModelDef, compute_loss
from mtamrecommender_tpu_torch.train import evaluate as eval_lib
from mtamrecommender_tpu_torch.types import Batch, resolve_device
from mtamrecommender_tpu_torch.utils.logging import (MetricsWriter, NullWriter,
                                                     create_log, quiet_log)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADADELTA_RHO, ADADELTA_EPS = 0.95, 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1e-10
PACK_MAX_ELEMS = 1 << 20      # pack_small_leaves: leaves up to this size


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


# ------------------------------------------------------------ optimizer state
#
# Each state is the update count and its moments, each a dict of tensors
# keyed by the layout's keys (`Layout.keys`).  `to_dict` gives plain ints
# and dicts of tensors, which ``torch.load`` reads back with
# ``weights_only=True`` (a pickled NamedTuple it refuses).

def _to_dict(state) -> Dict[str, Any]:
    return {"count": int(state.count),
            **{k: dict(getattr(state, k)) for k in state._fields[1:]}}


def _from_dict(cls, d: Dict[str, Any]):
    return cls(int(d["count"]), *(dict(d[k]) for k in cls._fields[1:]))


class AdamState(NamedTuple):
    count: int                       # updates applied so far
    mu: Dict[str, torch.Tensor]      # first moments
    nu: Dict[str, torch.Tensor]      # second moments

    kind = "adam"
    to_dict = _to_dict
    from_dict = classmethod(_from_dict)


class AdadeltaState(NamedTuple):
    count: int
    e_g: Dict[str, torch.Tensor]     # E[squared gradient]
    e_x: Dict[str, torch.Tensor]     # E[squared update]

    kind = "adadelta"
    to_dict = _to_dict
    from_dict = classmethod(_from_dict)


class RmsState(NamedTuple):
    count: int
    nu: Dict[str, torch.Tensor]      # E[squared gradient]

    kind = "rmsprop"
    to_dict = _to_dict
    from_dict = classmethod(_from_dict)


class SgdState(NamedTuple):
    count: int

    kind = "sgd"
    to_dict = _to_dict
    from_dict = classmethod(_from_dict)


OPT_STATES = {cls.kind: cls for cls in (AdamState, AdadeltaState, RmsState,
                                        SgdState)}


def moments(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """A state's moment dicts by field name (none for sgd)."""
    return {k: getattr(state, k) for k in state._fields[1:]}


def opt_state_to(state, device=None, dtype=None):
    """The state with every moment tensor moved to ``device``."""
    return type(state)(state.count, *(
        {n: t.to(device=device, dtype=dtype) for n, t in m.items()}
        for m in moments(state).values()))


# ------------------------------------------------------------ layouts

def jax_order(names: List[str]) -> List[str]:
    """Dotted parameter names in the order ``jax.tree.flatten`` visits the
    JAX package's parameter tree: dict keys sorted at each level, list
    entries (the digit parts) by index."""
    def key(name):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                     for p in name.split("."))
    return sorted(names, key=key)


class Layout:
    """Where each parameter's slice of the optimizer state lives.

    ``"leaf"``: a tensor a parameter, keyed by its name.  ``"flat"``
    (flatten_optimizer): one vector, key ``"flat"``, the parameters
    raveled in JAX's tree order.  ``"packed"`` (pack_small_leaves): one
    vector a dtype of the float leaves of at most PACK_MAX_ELEMS elements,
    keyed ``"small.<dtype>"`` in dtype-name order (``"small.float32"``
    empty where there is none), then the other leaves standalone, keyed
    by name, in tree order.  With both knobs set the flat vector holds
    the packed order, as optax.flatten inside pack_small_leaves does."""

    def __init__(self, kind: str, shapes: Dict[str, Tuple[torch.Size,
                                                          torch.dtype]]):
        self.kind = kind
        self.shapes = shapes
        order = jax_order(list(shapes))
        if kind == "leaf":
            self.groups = {n: [n] for n in order}
            return
        groups: Dict[str, List[str]] = {}
        if kind in ("packed", "flat_packed"):
            small: Dict[str, List[str]] = {}
            for n in order:
                shape, dtype = shapes[n]
                if shape.numel() <= PACK_MAX_ELEMS and dtype.is_floating_point:
                    small.setdefault(str(dtype).replace("torch.", ""),
                                     []).append(n)
            for dname in sorted(small) or ["float32"]:
                groups[f"small.{dname}"] = small.get(dname, [])
            in_small = {n for ns in small.values() for n in ns}
            groups.update({n: [n] for n in order if n not in in_small})
        if kind == "flat":
            groups = {"flat": order}
        elif kind == "flat_packed":
            groups = {"flat": [n for ns in groups.values() for n in ns]}
        self.groups = groups

    @property
    def keys(self) -> List[str]:
        return list(self.groups)

    def pack(self, tensors: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Per-parameter tensors -> the layout's tensors."""
        if self.kind == "leaf":
            return {n: tensors[n] for n in self.groups}
        out = {}
        for key, names in self.groups.items():
            if key.startswith("small.") or key == "flat":
                parts = [tensors[n].reshape(-1) for n in names]
                out[key] = (torch.cat(parts) if parts else torch.zeros(
                    0, dtype=torch.float32,
                    device=next(iter(tensors.values())).device))
            else:
                out[key] = tensors[names[0]]
        return out

    def unpack(self, packed: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The layout's tensors -> per-parameter views."""
        if self.kind == "leaf":
            return dict(packed)
        out = {}
        for key, names in self.groups.items():
            if key.startswith("small.") or key == "flat":
                off = 0
                for n in names:
                    shape, dtype = self.shapes[n]
                    size = shape.numel()
                    out[n] = packed[key][off:off + size].view(shape).to(dtype)
                    off += size
            else:
                out[names[0]] = packed[key]
        return out

    def zeros(self, params: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros_like(v) for k, v in self.pack(params).items()}


def layout_kind(cfg: TrainConfig) -> str:
    if cfg.flatten_optimizer:
        return "flat_packed" if cfg.pack_small_leaves else "flat"
    return "packed" if cfg.pack_small_leaves else "leaf"


def make_layout(cfg: TrainConfig, model: nn.Module) -> Layout:
    return Layout(layout_kind(cfg), {n: (p.shape, p.dtype)
                                     for n, p in model.named_parameters()})


# ------------------------------------------------------------ optimizer

class Optimizer(NamedTuple):
    init: Callable[[nn.Module], Any]
    # (model, grads by name, state) -> new state; updates the model in place
    update: Callable[[nn.Module, Dict[str, torch.Tensor], Any], Any]


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, leaf by leaf."""
    return torch.sqrt(sum(g.square().sum() for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor],
                        max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """optax's clip: g * max_norm / ||g|| only where ||g|| >= max_norm
    (torch's clip_grad_norm_ divides by ||g|| + 1e-6 instead).  Decided
    on the device, so the step does not wait for the norm.  ``norm``
    (the per-leaf gradients' `global_norm`) where ``grads`` are packed."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return {n: torch.where(keep, g, g / norm * max_norm)
            for n, g in grads.items()}


def _adam(g, state):
    count = state.count + 1
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count))
    mu, nu, step = {}, {}, {}
    for k, gk in g.items():
        mu[k] = (1 - ADAM_B1) * gk + ADAM_B1 * state.mu[k]
        nu[k] = (1 - ADAM_B2) * gk.square() + ADAM_B2 * state.nu[k]
        step[k] = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
    return step, AdamState(count, mu, nu)


def _adadelta(g, state):
    e_g, e_x, step = {}, {}, {}
    for k, gk in g.items():
        e_g[k] = (1 - ADADELTA_RHO) * gk.square() + ADADELTA_RHO * state.e_g[k]
        step[k] = (torch.sqrt(state.e_x[k] + ADADELTA_EPS)
                   / torch.sqrt(e_g[k] + ADADELTA_EPS)) * gk
        e_x[k] = ((1 - ADADELTA_RHO) * step[k].square()
                  + ADADELTA_RHO * state.e_x[k])
    return step, AdadeltaState(state.count + 1, e_g, e_x)


def _rms(g, state):
    nu, step = {}, {}
    for k, gk in g.items():
        nu[k] = (1 - RMS_DECAY) * gk.square() + RMS_DECAY * state.nu[k]
        step[k] = torch.rsqrt(nu[k] + RMS_EPS) * gk
    return step, RmsState(state.count + 1, nu)


def _sgd(g, state):
    return dict(g), SgdState(state.count + 1)


_CORES = {"adam": _adam, "adadelta": _adadelta, "rmsprop": _rms, "sgd": _sgd}


def make_optimizer(cfg: TrainConfig,
                   norm_fn: Optional[Callable[[Dict[str, torch.Tensor]],
                                              torch.Tensor]] = None
                   ) -> Optimizer:
    """Clip to the global norm ``max_gradient_norm``, the optimizer's
    scaling (``cfg.optimizer``: adam, adadelta, rmsprop or sgd), then
    ``-lr(count)``, where count is the number of updates before this one.
    The global norm is summed leaf by leaf in every layout, so the packed
    and flat layouts apply the per-leaf layout's update bit for bit.
    ``norm_fn`` (gradients by name -> the norm) replaces `global_norm`:
    the sharded step's sums the table shards' squares over the model
    group (`parallel.dist_trainer.sharded_global_norm`)."""
    if cfg.optimizer not in _CORES:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    schedule = make_lr_schedule(cfg)
    core, state_cls = _CORES[cfg.optimizer], OPT_STATES[cfg.optimizer]
    layouts: Dict[tuple, Layout] = {}

    def layout_of(params: Dict[str, torch.Tensor]) -> Layout:
        sig = tuple((n, tuple(p.shape), p.dtype) for n, p in params.items())
        if sig not in layouts:
            layouts[sig] = Layout(layout_kind(cfg), {
                n: (p.shape, p.dtype) for n, p in params.items()})
        return layouts[sig]

    def init(model: nn.Module):
        params = dict(model.named_parameters())
        layout = layout_of(params)
        return state_cls(0, *(layout.zeros(params)
                              for _ in state_cls._fields[1:]))

    @torch.no_grad()
    def update(model: nn.Module, grads: Dict[str, torch.Tensor], state):
        if not isinstance(state, state_cls):
            raise TypeError(f"{cfg.optimizer} update: the state is a "
                            f"{type(state).__name__}, not a "
                            f"{state_cls.__name__}")
        params = dict(model.named_parameters())
        layout = layout_of(params)
        norm = (norm_fn or global_norm)({n: grads[n] for n in params})
        g = clip_by_global_norm(layout.pack(grads), cfg.max_gradient_norm,
                                norm)
        lr = schedule(state.count)
        step, new_state = core(g, state)
        for name, u in layout.unpack({k: -lr * s
                                      for k, s in step.items()}).items():
            params[name].add_(u)
        return new_state

    return Optimizer(init=init, update=update)


@dataclass
class TrainState:
    """What a checkpoint holds: the model (its parameters), the optimizer
    state (None where only the parameters are wanted) and the number of
    steps taken."""

    model: nn.Module
    opt_state: Optional[Any]
    step: int = 0


# ------------------------------------------------------------ steps

def _check_device(device: torch.device, model: nn.Module,
                  batch: Batch) -> None:
    for what, t in (("the model", next(model.parameters())),
                    ("the batch", batch.items)):
        if t.device.type != device.type:
            raise ValueError(f"train step on {device}: {what} is on "
                             f"{t.device}")


def _step_generator(cfg: ExperimentConfig, device: torch.device,
                    gen: Optional[torch.Generator]) -> torch.Generator:
    if gen is None:
        return torch.Generator(device=device).manual_seed(cfg.train.seed)
    if gen.device.type != device.type:
        raise ValueError(f"train step on {device}: the generator is on "
                         f"{gen.device}")
    return gen


def make_train_step(model_def: ModelDef, cfg: ExperimentConfig,
                    optimizer: Optimizer, valid_vocab: Optional[int] = None,
                    device=None, gen: Optional[torch.Generator] = None):
    """``step(model, opt_state, batch) -> (opt_state, metrics)``: loss,
    gradients, the clipped update applied to the model's parameters in
    place.  Runs on CUDA unless ``device="cpu"``; the model and the batch
    must be on that device.  Random draws come from ``gen`` (a generator
    on the device), by default one seeded from ``cfg.train.seed``."""
    device = resolve_device(device)
    gen = _step_generator(cfg, device, gen)

    def train_step(model: nn.Module, opt_state, batch: Batch):
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


def make_device_train_step(model_def: ModelDef, cfg: ExperimentConfig,
                           optimizer: Optimizer, valid_vocab: int,
                           batch_size: int, device=None,
                           gen: Optional[torch.Generator] = None,
                           mesh=None):
    """``step(model, opt_state, data, order, step_index) -> (opt_state,
    metrics)``: the train step on the batch `gather_batch` assembles on
    the device from a device-resident dataset, no host work a step.
    With ``mesh`` (a `parallel.mesh.Mesh`) the step is
    `parallel.dist_trainer.make_sharded_train_step`'s on the gathered
    global batch."""
    if mesh is None:
        step = make_train_step(model_def, cfg, optimizer, valid_vocab,
                               device, gen)
    else:
        from mtamrecommender_tpu_torch.parallel import dist_trainer
        step = dist_trainer.make_sharded_train_step(
            model_def, cfg, optimizer, mesh, valid_vocab, device, gen)

    def train_step(model: nn.Module, opt_state, data: DeviceDataset,
                   order: torch.Tensor, step_index: int):
        return step(model, opt_state,
                    gather_batch(data, order, step_index, batch_size))

    return train_step


METRICS = ("loss", "ce", "l2")


def make_superstep(model_def: ModelDef, cfg: ExperimentConfig,
                   optimizer: Optimizer, valid_vocab: int, batch_size: int,
                   device=None, gen: Optional[torch.Generator] = None,
                   mesh=None):
    """``run(model, opt_state, data, order, start_step, n_steps) ->
    (opt_state, stacked)``: ``n_steps`` train steps over the batches
    ``gather_batch(data, order, start_step + k, batch_size)``, with the
    metrics {loss, ce, l2} stacked to [n_steps].  The counterpart of the
    JAX `make_superstep`, as a Python loop; with ``mesh``, of its
    `make_sharded_superstep`."""
    step = make_device_train_step(model_def, cfg, optimizer, valid_vocab,
                                  batch_size, device, gen, mesh)

    def run(model: nn.Module, opt_state, data: DeviceDataset,
            order: torch.Tensor, start_step: int, n_steps: int):
        rows = []
        for k in range(n_steps):
            opt_state, metrics = step(model, opt_state, data, order,
                                      start_step + k)
            rows.append(metrics)
        stacked = {key: torch.stack([m[key] for m in rows])
                   for key in METRICS}
        return opt_state, stacked

    return run


def make_dynamic_superstep(model_def: ModelDef, cfg: ExperimentConfig,
                           optimizer: Optimizer, valid_vocab: int,
                           batch_size: int, max_sub: int, device=None,
                           gen: Optional[torch.Generator] = None,
                           mesh=None):
    """``run(model, opt_state, data, order, start_step, n_sub) ->
    (opt_state, bufs)``: `make_superstep`'s ``n_sub`` steps, 1 <= n_sub <=
    max_sub, with each metric in a [max_sub] buffer of which [:n_sub] is
    written and the tail is zero.  The counterpart of the JAX
    `make_dynamic_superstep`, whose traced trip count spares a compile a
    chunk size; a Python loop has no compile to save, and this is kept so
    the `Trainer` reads as JAX's does."""
    run_fixed = make_superstep(model_def, cfg, optimizer, valid_vocab,
                               batch_size, device, gen, mesh)

    def run(model: nn.Module, opt_state, data: DeviceDataset,
            order: torch.Tensor, start_step: int, n_sub: int):
        if not 1 <= n_sub <= max_sub:
            raise ValueError(f"n_sub {n_sub} outside 1..{max_sub}")
        opt_state, stacked = run_fixed(model, opt_state, data, order,
                                       start_step, n_sub)
        bufs = {}
        for key, v in stacked.items():
            bufs[key] = torch.zeros((max_sub,) + tuple(v.shape[1:]),
                                    dtype=v.dtype, device=v.device)
            bufs[key][:n_sub] = v
        return opt_state, bufs

    return run


# ------------------------------------------------------------ orchestration

@dataclass
class Trainer:
    """Epoch/eval loop (Train_main_process.train, train_process.py:132-407).

    Runs on CUDA unless ``device="cpu"``.  ``device_resident`` keeps the
    training set on the device and gathers each batch there; otherwise
    batches come from `batch_iterator` through `prefetch_to_device`.
    Both draw each epoch's order from ``np_rng`` the same way, so both
    visit the same rows in the same order as the JAX package's `Trainer`
    given the same seed.

    ``mesh`` (a `parallel.mesh.Mesh` with its groups attached) runs the
    sharded steps of `parallel.dist_trainer`: every rank holds the whole
    dataset on its device, draws the same epoch order from the same seed,
    gathers the global batch and takes its data rows; the tables are
    row-sharded where ``cfg.mesh.shard_embeddings``.  Only rank 0 logs
    and writes events; a checkpointer must carry the trainer's
    `placement` (rank 0 writes the single-device format)."""

    cfg: ExperimentConfig
    model: ModelDef
    train_data: PackedDataset
    test_data: PackedDataset
    run_dir: str = "data/runs/dev"
    use_tensorboard: bool = False
    device_resident: bool = True      # dataset on the device, gathered there
    best: Dict[str, float] = field(default_factory=dict)
    device: Any = None
    mesh: Any = None                  # parallel.mesh.Mesh -> sharded steps

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.chief = self.mesh is None or self.mesh.rank == 0
        if self.chief:
            self.logger = create_log(self.cfg.data.dataset,
                                     self.cfg.model.experiment_type,
                                     self.cfg.version)
            self.writer = MetricsWriter(self.run_dir, self.use_tensorboard)
        else:
            self.logger, self.writer = quiet_log(), NullWriter()
        self.valid_vocab = self.train_data.meta.item_vocab
        cfg_t = self.cfg.train
        # the step generator, shared by every step function below
        self.gen = torch.Generator(device=self.device).manual_seed(cfg_t.seed)
        self.placement = None
        if self.mesh is None:
            self.optimizer = make_optimizer(cfg_t)
            self.train_step = make_train_step(self.model, self.cfg,
                                              self.optimizer,
                                              self.valid_vocab, self.device,
                                              self.gen)
            self.eval_step = eval_lib.make_eval_step(
                self.model, self.cfg.model, cfg_t.topk, self.valid_vocab)
        else:
            from mtamrecommender_tpu_torch.parallel import dist_trainer
            from mtamrecommender_tpu_torch.parallel.sharding import Placement
            self.placement = Placement(self.mesh, self.cfg.mesh,
                                       layout_kind(cfg_t))
            self.optimizer = dist_trainer.make_sharded_optimizer(self.cfg,
                                                                 self.mesh)
            self.train_step = dist_trainer.make_sharded_train_step(
                self.model, self.cfg, self.optimizer, self.mesh,
                self.valid_vocab, self.device, self.gen)
            self.eval_step = dist_trainer.make_sharded_eval_step(
                self.model, self.cfg, self.mesh, cfg_t.topk,
                self.valid_vocab)
        self.device_train_step = None
        self._dynamic_superstep = None
        if self.device_resident:
            self.device_train_step = make_device_train_step(
                self.model, self.cfg, self.optimizer, self.valid_vocab,
                cfg_t.train_batch_size, self.device, self.gen, self.mesh)
            if cfg_t.steps_per_call > 1:
                self._dynamic_superstep = make_dynamic_superstep(
                    self.model, self.cfg, self.optimizer, self.valid_vocab,
                    cfg_t.train_batch_size, cfg_t.steps_per_call,
                    self.device, self.gen, self.mesh)
        self._cursor = None
        self._device_data = None
        self._test_data = None
        self.np_rng = np.random.RandomState(cfg_t.seed)

    def _capture_cursor(self, epoch: int, epoch_start_step: int) -> Dict:
        """JSON-able data cursor as of an epoch's start: epoch index,
        global step and the epoch-shuffle numpy rng.  Saved with each
        checkpoint so resume replays the interrupted epoch's shuffle
        exactly (train/checkpoint.py)."""
        st = self.np_rng.get_state()
        return {"epoch": int(epoch),
                "step_at_epoch_start": int(epoch_start_step),
                "np_keys": np.asarray(st[1]).astype(np.uint32).tolist(),
                "np_pos": int(st[2]), "np_has_gauss": int(st[3]),
                "np_cached": float(st[4]),
                # best-so-far maxima travel with the cursor, so a retry
                # does not restart `best` from zero
                "best": {k: float(v) for k, v in self.best.items()}}

    def resume_from_cursor(self, cursor: Dict, state: TrainState
                           ) -> Tuple[int, int]:
        """Restore the epoch-shuffle rng to the cursor's epoch start and
        the step generator to the saved step; returns (start_epoch,
        skip_steps) to pass to fit() for an exact resume.

        The counterpart of JAX's `fast_forward_rng`: JAX freezes its step
        key at the epoch start and replays the skipped steps' splits; a
        torch generator cannot be advanced by steps, so the cursor saved
        with a checkpoint carries the generator's state at the save
        (``gen_state``, `_cursor_for_save`), which is set here once the
        numpy state the shuffle replays from is.  The skipped steps draw
        nothing, so the first step after them draws what the unbroken
        run's did.  A cursor without ``gen_state`` leaves the generator
        as it is."""
        self.np_rng.set_state(
            ("MT19937", np.asarray(cursor["np_keys"], np.uint32),
             int(cursor["np_pos"]), int(cursor["np_has_gauss"]),
             float(cursor["np_cached"])))
        if cursor.get("gen_state") is not None:
            self.gen.set_state(torch.tensor(cursor["gen_state"],
                                            dtype=torch.uint8))
        cbest = cursor.get("best", {})
        if not self.best:
            # the shipped flow: a fresh trainer restores the dict verbatim
            self.best = {k: float(v) for k, v in cbest.items()}
        else:
            # merging into a non-empty tracker uses the reference's PAIRED
            # rule (train_process.py:279-288): hr and ndcg at the same k
            # must both improve
            ks = {key.split("@", 1)[1] for key in cbest if key.startswith("hr@")}
            for k in ks:
                hr = float(cbest.get(f"hr@{k}", 0.0))
                ndcg = float(cbest.get(f"ndcg@{k}", 0.0))
                if (hr > self.best.get(f"hr@{k}", 0.0)
                        and ndcg > self.best.get(f"ndcg@{k}", 0.0)):
                    self.best[f"hr@{k}"] = hr
                    self.best[f"ndcg@{k}"] = ndcg
        return int(cursor["epoch"]), \
            int(state.step) - int(cursor["step_at_epoch_start"])

    def _cursor_for_save(self) -> Optional[Dict]:
        """The epoch-start cursor with its best-so-far refreshed to now
        and the step generator's state at this step added (as a list of
        ints); the epoch and numpy fields stay frozen at the epoch start
        so resume replays the epoch's shuffle exactly."""
        if self._cursor is None:
            return None
        return {**self._cursor,
                "best": {k: float(v) for k, v in self.best.items()},
                "gen_state": self.gen.get_state().tolist()}

    def _chunk_size(self, step: int, steps_left: int,
                    max_steps: Optional[int]) -> int:
        """Largest superstep chunk that does not cross an eval boundary,
        the epoch end, or max_steps — so evals/saves/stops land on exactly
        the same global steps as the per-step paths."""
        if self._dynamic_superstep is None:
            return 1
        cfg_t = self.cfg.train
        chunk = min(cfg_t.steps_per_call, steps_left,
                    cfg_t.eval_freq - (step % cfg_t.eval_freq))
        if max_steps is not None:
            chunk = min(chunk, max_steps - step)
        return max(chunk, 1)

    def init_state(self, state: Optional[TrainState] = None) -> TrainState:
        """A fresh model from a CPU generator seeded from
        ``cfg.train.seed`` (the same parameters on every device) and its
        optimizer state, on the trainer's device.  ``state``, e.g. a model
        with parameters from `bridge.load_jax_params` and an optimizer
        state from `bridge.opt_state_from_jax`, is placed on the device
        instead (its optimizer state initialized where it is None).  On a
        mesh the state is the whole model's, and this rank keeps its
        part (`parallel.sharding.place_params` / `place_opt_state`)."""
        if state is None:
            gen = torch.Generator().manual_seed(self.cfg.train.seed)
            state = TrainState(self.model.init(gen, self.cfg.model,
                                               self.train_data.meta), None, 0)
        model = state.model
        given = state.opt_state
        if self.placement is not None:
            from mtamrecommender_tpu_torch.parallel import sharding
            model = sharding.place_params(self.mesh, self.cfg.mesh, model)
            if given is not None:
                given = sharding.place_opt_state(self.placement, given, model)
        model = model.to(self.device)
        opt_state = (self.optimizer.init(model) if given is None
                     else opt_state_to(given, self.device))
        return TrainState(model=model, opt_state=opt_state,
                          step=int(state.step))

    def evaluate(self, state: TrainState) -> Dict[str, float]:
        if self._test_data is None:
            self._test_data = dd.to_device(self.test_data, self.device)
        batches = eval_lib.eval_batches(self._test_data,
                                        self.cfg.train.test_batch_size)
        metrics = eval_lib.evaluate_dataset(self.eval_step, state.model,
                                            batches)
        # best-so-far maxima (train_process.py:279-288): hr and ndcg must
        # BOTH improve to update, per the reference's paired condition
        for k in self.cfg.train.topk:
            hr, ndcg = metrics.get(f"hr@{k}", 0.0), metrics.get(f"ndcg@{k}", 0.0)
            if (hr > self.best.get(f"hr@{k}", 0.0)
                    and ndcg > self.best.get(f"ndcg@{k}", 0.0)):
                self.best[f"hr@{k}"] = hr
                self.best[f"ndcg@{k}"] = ndcg
            self.logger.info("Test recall rate @ %d : %.4f   ndcg @ %d: %.4f",
                             k, hr, k, ndcg)
        if metrics:
            self.writer.scalars(state.step, metrics)
        return metrics

    def _log_best(self) -> None:
        for k in self.cfg.train.topk:
            self.logger.info("Max recall rate @ %d: %.4f   ndcg @ %d: %.4f",
                             k, self.best.get(f"hr@{k}", 0.0), k,
                             self.best.get(f"ndcg@{k}", 0.0))

    def fit(self, state: Optional[TrainState] = None,
            max_epochs: Optional[int] = None,
            max_steps: Optional[int] = None,
            checkpointer=None, start_epoch: int = 0,
            skip_steps: int = 0) -> TrainState:
        """Epoch loop.  ``start_epoch``/``skip_steps`` (usually from
        ``resume_from_cursor``) resume an interrupted run exactly: the
        first epoch's shuffle is re-drawn from the restored numpy rng and
        its first ``skip_steps`` already-trained steps are skipped."""
        cfg_t = self.cfg.train
        if self.placement is not None and checkpointer is not None and \
                getattr(checkpointer, "placement", None) is None:
            raise ValueError("a sharded Trainer saves through a "
                             "Checkpointer(..., placement=trainer.placement)")
        state = state or self.init_state()
        if max_steps is not None and state.step >= max_steps:
            # resumed at/past the step budget (e.g. a fleet retry of a job
            # killed after reaching max_steps but before its clean exit):
            # run ZERO optimizer steps — eval/save/report only
            self.evaluate(state)
            self._log_best()
            if checkpointer is not None:
                checkpointer.save(state, cursor=self._cursor_for_save())
            return state
        self.evaluate(state)  # initial eval (train_process.py:308)
        epochs = max_epochs if max_epochs is not None else cfg_t.max_epochs
        self._avg_loss, self._seen = 0.0, 0
        if self.device_resident and self._device_data is None:
            self._device_data = dd.to_device(self.train_data, self.device)

        def on_step(metrics, fetch_every_step: bool) -> bool:
            """Shared display/eval/save cadence; returns True to stop.
            On the device-resident path metrics are fetched only on
            cadence boundaries so the loop never syncs per step."""
            state.step += 1
            if fetch_every_step:
                self._avg_loss += float(metrics["loss"])
                self._seen += 1
            if state.step % cfg_t.display_freq == 0:
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    # surface divergence instead of training on garbage
                    # (the reference swallows step errors,
                    # train_process.py:369-371 — deliberately not replicated)
                    raise FloatingPointError(
                        f"non-finite train loss {loss} at step {state.step}; "
                        f"restore the last checkpoint and lower the lr")
                if not fetch_every_step:
                    self._avg_loss += loss
                    self._seen += 1
                self.writer.scalars(state.step, {
                    "train_loss": loss, "ce": float(metrics["ce"]),
                    "l2": float(metrics["l2"])})
            if state.step % cfg_t.eval_freq == 0:
                self.logger.info("Global step %d  train_loss %.5f",
                                 state.step,
                                 self._avg_loss / max(self._seen, 1))
                self._avg_loss, self._seen = 0.0, 0
                self.evaluate(state)
                if checkpointer is not None and \
                        state.step % cfg_t.save_freq == 0:
                    checkpointer.save(state, cursor=self._cursor_for_save())
            return max_steps is not None and state.step >= max_steps

        for epoch in range(start_epoch, epochs):
            epoch_start = time.time()
            stop = False
            skip = skip_steps if epoch == start_epoch else 0
            # cursor BEFORE the epoch's shuffle draw, so a restore can
            # replay this epoch's order from the same numpy rng state
            self._cursor = self._capture_cursor(epoch, state.step - skip)
            if self.device_resident:
                order_np, n_steps = dd.epoch_order(
                    len(self.train_data), cfg_t.train_batch_size, self.np_rng)
                order = torch.as_tensor(order_np, device=self.device)
                i = skip
                while i < n_steps and not stop:
                    chunk = self._chunk_size(state.step, n_steps - i,
                                             max_steps)
                    if chunk > 1:
                        state.opt_state, bufs = self._dynamic_superstep(
                            state.model, state.opt_state, self._device_data,
                            order, i, chunk)
                        for k in range(chunk):
                            if on_step({m: bufs[m][k] for m in bufs},
                                       fetch_every_step=False):
                                stop = True
                                break
                        i += chunk
                    else:
                        state.opt_state, metrics = self.device_train_step(
                            state.model, state.opt_state, self._device_data,
                            order, i)
                        if on_step(metrics, fetch_every_step=False):
                            stop = True
                        i += 1
            else:
                it = batch_iterator(self.train_data, cfg_t.train_batch_size,
                                    shuffle=True, rng=self.np_rng)
                if skip:
                    it = itertools.islice(it, skip, None)
                for _, batch in prefetch_to_device(it, device=self.device):
                    state.opt_state, metrics = self.train_step(
                        state.model, state.opt_state, batch)
                    if on_step(metrics, fetch_every_step=True):
                        stop = True
                        break
            self.logger.info("epoch %d done in %.2fs (step %d)", epoch,
                             time.time() - epoch_start, state.step)
            if stop:
                break
        self.evaluate(state)
        self._log_best()
        if checkpointer is not None:
            checkpointer.save(state, cursor=self._cursor_for_save())
        return state
