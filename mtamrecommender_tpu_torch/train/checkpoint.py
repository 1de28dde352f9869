"""Checkpoint / resume with the reference's three load modes (twin of
mtamrecommender_tpu/train/checkpoint.py).

The JAX package writes Orbax checkpoints; Orbax imports jax, so the port
writes its own with ``torch.save``.  A checkpoint directory holds one
directory a step::

    <directory>/<step>/state.pt      params, optimizer state, step
    <directory>/<step>/cursor.json   the data cursor, where one was given

``state.pt`` holds only tensors, ints and dicts, so it loads with
``torch.load(weights_only=True)``.  Tensors are written from the CPU: a
checkpoint written on the card loads on the CPU and the other way round;
`Checkpointer.restore` places them on the template's device.  A step is
written under a temporary name and renamed into place, so `latest_step`
sees only complete steps; the oldest steps past ``max_to_keep`` are
removed only after a save has succeeded.

Load modes (`apply_load_type`):

  * from_scratch — ignore any checkpoint
  * full         — restore params, optimizer state and step from the
                   run's dir
  * fine_tune    — restore params only (fresh optimizer state, step 0)
                   from `fine_tune_load_path`

The optimizer state is any of `train.trainer`'s (Adam, Adadelta, RMSprop,
SGD) in any layout (per leaf, ``flatten_optimizer``'s one vector,
``pack_small_leaves``' packed vectors), saved as its kind, its count and
its moment tensors by layout key; a restore checks them against the
template's.  The cursor is a JSON-able dict stored beside the tensors
and handed back unchanged; `Trainer._cursor_for_save` fills it with the
epoch, the step at the epoch's start, the shuffle's numpy state, the
step generator's state and the best metrics so far, and
`Trainer.resume_from_cursor` reads it back for an exact resume.

A sharded run (``placement``, a `parallel.sharding.Placement`) writes the
same single-device format: every rank gathers the table shards and their
optimizer moments over the model group, rank 0 writes, and a barrier
follows.  A restore reads the whole state on every rank and keeps this
rank's part, so a checkpoint from 2 ranks restores on 1 and the other
way round.  The directory must be one that every rank reads.  The
port cannot read an Orbax directory, nor the
JAX package's pre-Composite "legacy" layout: a JAX checkpoint reaches the
port by restoring it with JAX and converting the arrays with
`bridge.load_jax_params` and `bridge.opt_state_from_jax`.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from mtamrecommender_tpu_torch.config import TrainConfig
from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
from mtamrecommender_tpu_torch.parallel import sharding
from mtamrecommender_tpu_torch.train.trainer import (OPT_STATES, AdamState,
                                                     TrainState, moments)

Cursor = Dict[str, Any]   # JSON-able: epoch, step_at_epoch_start, rng states

STATE_FILE = "state.pt"
CURSOR_FILE = "cursor.json"


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu() for n, t in tensors.items()}


def _check_names(what: str, got: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor], shapes: bool = True) -> None:
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    if missing or unexpected:
        raise KeyError(f"restore: {what} without a saved tensor {missing}; "
                       f"saved tensors without a {what} {unexpected}")
    for name, t in (got.items() if shapes else ()):
        if tuple(t.shape) != tuple(want[name].shape):
            raise ValueError(f"restore: {what} {name} is {tuple(t.shape)} in "
                             f"the checkpoint but {tuple(want[name].shape)} "
                             "in the template")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 placement: Optional[sharding.Placement] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.placement = placement

    @property
    def _writer(self) -> bool:
        return self.placement is None or self.placement.mesh.rank == 0

    def _barrier(self) -> None:
        if self.placement is not None:
            mesh_lib.barrier(self.placement.mesh)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """The complete steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, cursor: Optional[Cursor] = None,
             wait: bool = False) -> bool:
        """Write ``state`` (and ``cursor``) as step ``state.step``.  As
        Orbax's manager does, a step no newer than the latest saved one
        is skipped (returns False).  The write is synchronous: ``wait``
        is accepted for the JAX package's signature.  With a placement
        every rank calls it (collective) and rank 0 writes."""
        del wait
        step = int(state.step)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        params = dict(state.model.named_parameters())
        opt_state = state.opt_state
        if self.placement is not None:
            pl = self.placement
            params = sharding.gather_tensors(pl.mesh, pl.cfg, params)
            if opt_state is not None:
                opt_state = sharding.gather_opt_state(pl, opt_state,
                                                      state.model)
        if self._writer:
            self._write(step, params, opt_state, cursor)
        self._barrier()
        return True

    def _write(self, step: int, params: Dict[str, torch.Tensor], opt_state,
               cursor: Optional[Cursor]) -> None:
        payload = {
            "params": _cpu(params),
            "opt_state": (None if opt_state is None else {
                "kind": opt_state.kind,
                "count": int(opt_state.count),
                **{k: _cpu(m) for k, m in moments(opt_state).items()}}),
            "step": step}
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            if cursor is not None:
                with open(os.path.join(tmp, CURSOR_FILE), "w") as f:
                    json.dump(cursor, f)
            os.rename(tmp, self._step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore(self, template: TrainState, step: Optional[int] = None,
                with_cursor: bool = False):
        """A new TrainState from step ``step`` (the latest by default):
        a copy of ``template.model`` with the saved parameters, and the
        saved optimizer state (of the template's kind and layout) on the
        devices of the template's, or None where
        ``template.opt_state`` is None.  Names and shapes must match the
        template's; the template is left as it was.  With a placement
        the template is a placed state and each rank keeps its part of
        the saved whole.  With ``with_cursor=True`` also the cursor (None
        where the step has none), as a second return value."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = os.path.join(self._step_dir(step), STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.directory}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model: nn.Module = copy.deepcopy(template.model)
        own = dict(model.named_parameters())
        saved_params = payload["params"]
        if self.placement is not None:
            _check_names("parameter", saved_params, own, shapes=False)
            saved_params = sharding.place_tensors(
                self.placement.mesh, self.placement.cfg, saved_params)
        _check_names("parameter", saved_params, own)
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(saved_params[name])
        opt_state = None
        if template.opt_state is not None:
            saved = payload["opt_state"]
            if saved is None:
                raise KeyError(f"restore: step {step} holds no optimizer "
                               "state")
            cls = type(template.opt_state)
            # checkpoints written before the other optimizers hold Adam's
            kind = saved.get("kind", AdamState.kind)
            if OPT_STATES.get(kind) is not cls:
                raise TypeError(f"restore: step {step} holds a {kind} "
                                f"state, the template a {cls.kind} one")
            fields = moments(template.opt_state)
            if self.placement is not None:
                whole = cls(int(saved["count"]), *(saved[k] for k in fields))
                saved = {"count": saved["count"], **moments(
                    sharding.place_opt_state(self.placement, whole, model))}
            restored = {}
            for key, like in fields.items():
                _check_names(f"{kind} {key}", saved[key], like)
                restored[key] = {n: t.to(device=like[n].device,
                                         dtype=like[n].dtype)
                                 for n, t in saved[key].items()}
            opt_state = cls.from_dict({"count": saved["count"], **restored})
        state = TrainState(model=model, opt_state=opt_state, step=int(step))
        if not with_cursor:
            return state
        cursor_path = os.path.join(self._step_dir(step), CURSOR_FILE)
        cursor = None
        if os.path.isfile(cursor_path):
            with open(cursor_path) as f:
                cursor = json.load(f)
        return state, cursor

    def close(self) -> None:
        """Nothing is left in flight (saves are synchronous); kept for the
        JAX package's signature."""


def apply_load_type(cfg: TrainConfig, state: TrainState, run_ckpt_dir: str,
                    optimizer_init: Optional[Callable[[nn.Module],
                                                      Any]] = None,
                    with_cursor: bool = False,
                    placement: Optional[sharding.Placement] = None):
    """Dispatch on ``cfg.load_type`` (base_model.init_variables:48-69).

    With ``with_cursor=True`` returns ``(state, cursor_or_None)`` so the
    caller can resume the data stream (load_type='full' only — fine_tune
    starts a fresh run by definition).  ``placement``: ``state`` is a
    sharded run's placed state (`Checkpointer`)."""
    if cfg.load_type == "from_scratch":
        return (state, None) if with_cursor else state
    if cfg.load_type == "full":
        ckpt = Checkpointer(run_ckpt_dir, placement=placement)
        try:
            return ckpt.restore(state, with_cursor=with_cursor)
        finally:
            ckpt.close()
    if cfg.load_type == "fine_tune":
        if not cfg.fine_tune_load_path:
            raise ValueError("fine_tune requires fine_tune_load_path")
        ckpt = Checkpointer(cfg.fine_tune_load_path, placement=placement)
        try:
            restored = ckpt.restore(TrainState(state.model, None, state.step))
        finally:
            ckpt.close()
        # params only; fresh optimizer state + step (var-list restore analogue)
        opt_state = (optimizer_init(restored.model)
                     if optimizer_init is not None else state.opt_state)
        out = TrainState(model=restored.model, opt_state=opt_state, step=0)
        return (out, None) if with_cursor else out
    raise ValueError(f"unknown load_type {cfg.load_type!r}")
