"""Weight bridge: JAX parameter pytrees -> the port's state_dict.

The JAX package's parameters are nested dicts and lists of arrays (what
``jax.device_get(model.init(...))`` yields).  Their key paths join with
dots into the port's parameter names, e.g. ``{"att": [{"q": {"w": ..}}]}``
-> ``att.0.q.w``.  Arrays keep their shapes and the JAX ``[in, out]``
weight layout: nothing is transposed.  A gradient tree of the same
structure (``jax.grad`` of a loss over the parameters) converts the same
way, so the port's gradients can be compared with JAX's leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


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
