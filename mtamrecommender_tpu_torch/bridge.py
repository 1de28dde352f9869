"""Weight bridge: JAX parameter pytrees -> the port's state_dict.

The JAX package's parameters are nested dicts and lists of arrays (what
``jax.device_get(model.init(...))`` yields).  Their key paths join with
dots into the port's parameter names, e.g. ``{"att": [{"q": {"w": ..}}]}``
-> ``att.0.q.w``.  Arrays keep their shapes and the JAX ``[in, out]``
weight layout: nothing is transposed.  A gradient tree of the same
structure (``jax.grad`` of a loss over the parameters) converts the same
way, so the port's gradients can be compared with JAX's leaf by leaf.
`opt_state_from_jax` carries an optimizer state across (``jax.device_get``
of the chain state of the JAX package's `make_optimizer`): adam,
adadelta, rmsprop or sgd, per leaf, flattened or packed, as the port's
state of the same kind and layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mtamrecommender_tpu_torch.train.trainer import OPT_STATES, Layout


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for key, value in tree.items():
            _flatten(value, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _flatten(value, f"{prefix}{i}.", out)
    elif hasattr(tree, "__array__"):
        out[prefix[:-1]] = np.asarray(tree)
    else:
        raise TypeError(f"params_from_jax: leaf {prefix[:-1]!r} is a "
                        f"{type(tree).__name__}, not an array")


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """A JAX parameter (or gradient) pytree -> {dotted name: f32 CPU
    tensor}."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    out = {}
    for name, arr in flat.items():
        if not np.issubdtype(arr.dtype, np.floating) and arr.dtype.name != "bfloat16":
            raise TypeError(f"params_from_jax: {name} has dtype {arr.dtype}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def load_jax_params(model: nn.Module, tree: Any) -> nn.Module:
    """Set every parameter of ``model`` from a JAX parameter pytree.

    Strict: every JAX leaf must name a parameter, every parameter must be
    set, and shapes must match; otherwise it raises and changes nothing."""
    incoming = params_from_jax(tree)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(incoming))
    unexpected = sorted(set(incoming) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_jax_params: parameters without a JAX leaf "
                       f"{missing}; JAX leaves without a parameter "
                       f"{unexpected}")
    for name, value in incoming.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"load_jax_params: {name} is "
                             f"{tuple(value.shape)} in JAX but "
                             f"{tuple(own[name].shape)} in the port")
    with torch.no_grad():
        for name, param in own.items():
            param.copy_(incoming[name])
    return model


# the JAX package's optimizer chain (train/trainer.py make_optimizer):
# clip_by_global_norm's empty state, the core's state, then
# scale_by_schedule's count.  Each core: optax's state type name and
# fields, and the port's kind
_CORES = {("ScaleByAdamState", ("count", "mu", "nu")): "adam",
          ("ScaleByAdaDeltaState", ("e_g", "e_x")): "adadelta",
          ("ScaleByRmsState", ("nu",)): "rmsprop",
          ("EmptyState", ()): "sgd"}


def _check_type(opt_state, i: int, name: str, fields: tuple) -> None:
    got = type(opt_state[i]).__name__
    if got != name or tuple(getattr(opt_state[i], "_fields", ())) != fields:
        raise TypeError(f"opt_state_from_jax: opt_state[{i}] is a {got}, "
                        f"not the chain's {name}")


def _moment(tree: Any, where: str, model: Optional[nn.Module]
            ) -> Dict[str, torch.Tensor]:
    """One moment in the layout it was saved in: a parameter tree (per
    leaf), one vector (flatten_optimizer, key "flat"), or a list
    (pack_small_leaves: the small leaves' vectors a dtype, then the
    tables, named by `trainer.Layout` over ``model``'s parameters)."""
    if isinstance(tree, Mapping):
        return params_from_jax(tree)
    if isinstance(tree, (list, tuple)):
        if model is None:
            raise ValueError(f"opt_state_from_jax: {where} is packed "
                             "(pack_small_leaves); pass model= to name its "
                             "entries")
        keys = Layout("packed", {n: (p.shape, p.dtype) for n, p in
                                 model.named_parameters()}).keys
        if len(keys) != len(tree):
            raise ValueError(f"opt_state_from_jax: {where} has {len(tree)} "
                             f"entries, the model's packed layout "
                             f"{len(keys)}")
        return {k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in zip(keys, tree)}
    if hasattr(tree, "__array__") and np.ndim(tree) == 1:
        return {"flat": torch.from_numpy(np.array(tree, dtype=np.float32))}
    raise TypeError(f"opt_state_from_jax: {where} is a "
                    f"{type(tree).__name__}, not a parameter tree, a flat "
                    "vector or a packed list")


def opt_state_from_jax(opt_state: Any, model: Optional[nn.Module] = None):
    """optax's state of the JAX package's optimizer chain -> the port's
    state of the same optimizer (`trainer.OPT_STATES`) and layout.

    The state is the chain's tuple: the clip's empty state, the core's
    state (``ScaleByAdamState(count, mu, nu)``,
    ``ScaleByAdaDeltaState(e_g, e_x)``, ``ScaleByRmsState(nu)``, or
    sgd's ``EmptyState``) and ``ScaleByScheduleState(count)``; Adam's
    count must agree with the schedule's.  The moments are parameter
    trees, ``flatten_optimizer``'s vectors or ``pack_small_leaves``'
    lists; the last need ``model`` (the port's, of the same parameters)
    to name their entries.  Any other structure raises, naming the
    entry.  Matched by type name and fields: the port imports no optax."""
    if not isinstance(opt_state, (tuple, list)) or len(opt_state) != 3 \
            or hasattr(opt_state, "_fields"):
        raise TypeError(f"opt_state_from_jax: opt_state is a "
                        f"{type(opt_state).__name__}, not the optimizer "
                        "chain's 3-tuple")
    _check_type(opt_state, 0, "EmptyState", ())
    _check_type(opt_state, 2, "ScaleByScheduleState", ("count",))
    core = opt_state[1]
    kind = _CORES.get((type(core).__name__,
                       tuple(getattr(core, "_fields", ()))))
    if kind is None:
        raise TypeError(f"opt_state_from_jax: opt_state[1] is a "
                        f"{type(core).__name__}, not the state of adam, "
                        "adadelta, rmsprop or sgd")
    count = int(np.asarray(opt_state[2].count))
    if kind == "adam" and int(np.asarray(core.count)) != count:
        raise ValueError(f"opt_state_from_jax: opt_state[1].count is "
                         f"{int(np.asarray(core.count))} but "
                         f"opt_state[2].count is {count}")
    cls = OPT_STATES[kind]
    return cls(count, *(_moment(getattr(core, f), f"opt_state[1].{f}", model)
                        for f in cls._fields[1:]))
