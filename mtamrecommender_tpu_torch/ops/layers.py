"""Small building blocks (twin of mtamrecommender_tpu/ops/layers.py).

Weights keep the JAX package's ``[in, out]`` layout, so ``dense`` is
``x @ w + b`` and every parameter converts from JAX without a transpose.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from mtamrecommender_tpu_torch.ops import initializers as init


class ParamModule(nn.Module):
    """A module whose parameters are a dict's tensors, registered under
    the dict's keys, so parameter names follow the JAX key paths."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))


# ---- dense ----

def init_dense(gen: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True) -> Dict[str, torch.Tensor]:
    params = {"w": init.glorot_uniform(gen, (in_dim, out_dim))}
    if use_bias:
        params["b"] = torch.zeros((out_dim,), device=gen.device)
    return params


class Dense(ParamModule):
    """Parameters ``w`` [in, out] and, optionally, ``b`` [out]."""


def dense(p: nn.Module, x: torch.Tensor,
          activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
          ) -> torch.Tensor:
    y = torch.matmul(x, p.w)
    if "b" in p._parameters:
        y = y + p.b
    if activation is not None:
        y = activation(y)
    return y


# ---- normalization ----

def init_layer_norm(dim: int, device="cpu") -> Dict[str, torch.Tensor]:
    return {"gamma": torch.ones((dim,), device=device),
            "beta": torch.zeros((dim,), device=device)}


class LayerNorm(ParamModule):
    """Parameters ``gamma`` and ``beta`` [dim]."""


def layer_norm(p: nn.Module, x: torch.Tensor,
               epsilon: float = 1e-12) -> torch.Tensor:
    """tf.contrib.layers.layer_norm over the last axis; TF's
    variance_epsilon is 1e-12."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    normed = (x - mean) * torch.rsqrt(var + epsilon)
    return p.gamma * normed + p.beta


def normalize(p: nn.Module, x: torch.Tensor,
              epsilon: float = 1e-8) -> torch.Tensor:
    """The attention modules' in-house layer norm:
    (x-mean)/(var+eps)**0.5 * gamma + beta."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    normed = (x - mean) / torch.sqrt(var + epsilon)
    return p.gamma * normed + p.beta


# ---- sequence utilities ----

def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """tf.sequence_mask: [B, maxlen] boolean."""
    pos = torch.arange(maxlen, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def gather_positions(sequence: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Vector at a per-row position.  sequence: [B, L, D]; positions: [B]
    -> [B, D].

    A negative position counts from the end, as numpy indexing and JAX's
    ``take_along_axis`` do (an empty history gathers at ``seq_len-2 =
    -1``, i.e. position L-1); ``torch.gather`` would raise on it."""
    length = sequence.shape[1]
    idx = torch.remainder(positions.long(), length)
    idx = idx[:, None, None].expand(-1, 1, sequence.shape[2])
    return torch.gather(sequence, 1, idx)[:, 0, :]
