"""Weight bridge: JAX parameter pytrees -> the port's state_dict.

The JAX package's parameters are nested dicts and lists of arrays (what
``jax.device_get(model.init(...))`` yields).  Their key paths join with
dots into the port's parameter names, e.g. ``{"att": [{"q": {"w": ..}}]}``
-> ``att.0.q.w``.  Arrays keep their shapes and the JAX ``[in, out]``
weight layout: nothing is transposed.  A gradient tree of the same
structure (``jax.grad`` of a loss over the parameters) converts the same
way, so the port's gradients can be compared with JAX's leaf by leaf.
`opt_state_from_jax` carries the adam preset's optimizer state across
(``jax.device_get`` of optax's chain state) as the port's `AdamState`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from mtamrecommender_tpu_torch.train.trainer import AdamState


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


# the adam preset's chain (JAX train/trainer.py: clip_by_global_norm,
# scale_by_adam, scale_by_schedule): each state's type name and fields
_ADAM_CHAIN = (("EmptyState", ()),
               ("ScaleByAdamState", ("count", "mu", "nu")),
               ("ScaleByScheduleState", ("count",)))


def opt_state_from_jax(opt_state: Any) -> AdamState:
    """optax's state of the adam preset -> the port's `AdamState`.

    The state is the chain's tuple: the clip's empty state,
    ``ScaleByAdamState(count, mu, nu)`` and ``ScaleByScheduleState(count)``,
    with ``mu`` and ``nu`` parameter trees; both counts must agree.  Any
    other structure (another optimizer, ``flatten_optimizer``'s flat
    vectors, ``pack_small_leaves``' packed lists) raises, naming the
    leaf.  Matched by type name and fields: the port imports no optax."""
    if not isinstance(opt_state, (tuple, list)) or \
            len(opt_state) != len(_ADAM_CHAIN):
        raise TypeError(f"opt_state_from_jax: opt_state is a "
                        f"{type(opt_state).__name__}, not the adam chain's "
                        f"{len(_ADAM_CHAIN)}-tuple")
    for i, (name, fields) in enumerate(_ADAM_CHAIN):
        got = type(opt_state[i]).__name__
        if got != name or tuple(getattr(opt_state[i], "_fields", ())) \
                != fields:
            raise TypeError(f"opt_state_from_jax: opt_state[{i}] is a {got}"
                            f", not the adam chain's {name}")
    adam, sched = opt_state[1], opt_state[2]
    for field in ("mu", "nu"):
        if not isinstance(getattr(adam, field), Mapping):
            raise TypeError(
                f"opt_state_from_jax: opt_state[1].{field} is a "
                f"{type(getattr(adam, field)).__name__}, not a parameter "
                "tree (flatten_optimizer and pack_small_leaves are not "
                "ported)")
    count, sched_count = int(np.asarray(adam.count)), \
        int(np.asarray(sched.count))
    if count != sched_count:
        raise ValueError(f"opt_state_from_jax: opt_state[1].count is {count} "
                         f"but opt_state[2].count is {sched_count}")
    return AdamState(count=count, mu=params_from_jax(adam.mu),
                     nu=params_from_jax(adam.nu))
