"""Small building blocks (twin of mtamrecommender_tpu/ops/layers.py).

Weights keep the JAX package's ``[in, out]`` layout, so ``dense`` is
``x @ w + b`` and every parameter converts from JAX without a transpose.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Union

import torch
from torch import nn

from mtamrecommender_tpu_torch.ops import initializers as init
from mtamrecommender_tpu_torch.parallel import sharding


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


# ---- dropout ----

# Where a training forward's dropout masks come from: a torch.Generator to
# draw them from, or an iterator of masks drawn elsewhere
MaskSource = Union[torch.Generator, Iterator[torch.Tensor]]


def draw_drop_mask(gen: MaskSource, b: int, tq: int, tk: int, rate: float,
                   device, num_heads: int = 1) -> torch.Tensor:
    """A pre-scaled attention-weight dropout mask, f32 [B, Tq, Tk] (with
    ``num_heads`` h > 1, [B, h, Tq, Tk], the shape of the jnp path's
    weights) with values 0 or 1/(1-rate): tf.layers.dropout's inverted
    dropout applied to ones (the JAX package's `_draw_drop_mask`, and
    `dropout` on the multi-head weights), each element kept with
    probability 1-rate.  ``gen`` is a generator on ``device`` to draw
    from, or an iterator whose next mask is returned: torch cannot draw
    JAX's threefry bits, so that is how a mask drawn elsewhere (by JAX, or
    on another device) takes the place of a draw.  Inside a data-parallel
    `parallel.sharding.mesh_scope` a generator draws the global batch's
    mask and this rank keeps its rows, so the ranks draw what one rank
    draws for the whole batch."""
    shape = (b, tq, tk) if num_heads == 1 else (b, num_heads, tq, tk)
    if not isinstance(gen, torch.Generator):
        mask = next(gen)
        if tuple(mask.shape) != shape or mask.dtype != torch.float32:
            raise ValueError(f"drop mask: want float32 {shape}, got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        return mask
    keep = 1.0 - rate
    b_all, lo = sharding.data_rows(b)
    draw = torch.rand((b_all,) + shape[1:], generator=gen, device=device)
    kept = draw[lo:lo + b] < keep
    return kept.float() / keep


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


def sequential_average_pooling(sequence: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Masked mean over time: the live positions' sum over the padded
    length L, as the reference's reduce_mean divides (net_utils.py:94-100).
    sequence: [B, L, D]; lengths: [B] -> [B, D]."""
    mask = sequence_mask(lengths, sequence.shape[1]).to(sequence.dtype)
    return torch.mean(sequence * mask[:, :, None], dim=1)


def sequential_max_pooling(sequence: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Masked max over time (net_utils.sequential_max_pooling:102-110):
    padded positions hold -2^32+1, so a live one wins wherever there is
    one.  sequence: [B, L, D]; lengths: [B] -> [B, D]."""
    mask = sequence_mask(lengths, sequence.shape[1])[:, :, None]
    neg = torch.full_like(sequence, -(2.0 ** 32) + 1.0)
    return torch.amax(torch.where(mask, sequence, neg), dim=1)


# ---- activations (net_utils.py:8-61,131-144) ----

def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(x)
    return torch.maximum(zero, x) + alpha * torch.minimum(zero, x)


def dice(x: torch.Tensor, alpha: torch.Tensor, axis: int = -1,
         epsilon: float = 1e-9) -> torch.Tensor:
    """Dice: a sigmoid gate on x standardized over every axis but
    ``axis``, blending x and alpha * x."""
    axes = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    mean = torch.mean(x, dim=axes, keepdim=True)
    std = torch.sqrt(torch.mean(torch.square(x - mean) + epsilon, dim=axes,
                                keepdim=True))
    x_p = torch.sigmoid((x - mean) / (std + epsilon))
    return alpha * (1.0 - x_p) * x + x_p * x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU's tanh approximation, as jax.nn.gelu(approximate=True)."""
    return torch.nn.functional.gelu(x, approximate="tanh")
