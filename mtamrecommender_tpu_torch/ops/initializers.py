"""Parameter initializers (twin of mtamrecommender_tpu/ops/initializers.py).

Same distributions as the JAX package, drawn from a `torch.Generator`;
the bits differ from JAX's threefry draws, so parity tests load JAX's
parameters through `bridge.params_from_jax` instead of re-drawing them.
"""

from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, low: float, high: float,
            dtype=torch.float32) -> torch.Tensor:
    """U(low, high) on the generator's device."""
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    out.uniform_(low, high, generator=gen)
    return out.to(dtype)


def glorot_uniform(gen: torch.Generator, shape, dtype=torch.float32
                   ) -> torch.Tensor:
    """tf.get_variable / tf.layers.dense default initializer; for 1-D
    shapes both fans equal shape[0]."""
    if len(shape) >= 2:
        fan_in, fan_out = shape[-2], shape[-1]
    else:
        fan_in = fan_out = shape[0] if shape else 1
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(gen, shape, -limit, limit, dtype)


def embedding_uniform(gen: torch.Generator, shape, dtype=torch.float32
                      ) -> torch.Tensor:
    """Lookup-table init U(-r, r), r = sqrt(6 / embedding_dim)."""
    r = math.sqrt(6.0 / shape[-1])
    return uniform(gen, shape, -r, r, dtype)
