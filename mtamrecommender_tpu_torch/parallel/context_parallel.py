"""Key-axis context parallelism for the time-aware attention (the
counterpart of mtamrecommender_tpu/parallel/context_parallel.py).

With the scalar-Δt gate (``model.time_gate_mode='scalar'``) the gate is
a pointwise function of (q, k, Δt), so the KEY axis can split over the
model axis: each rank projects and scores only its own block of keys,
its slice of the decay gate included, and the softmax is assembled
exactly with the blockwise online-softmax exchange (the max of the
blocks' maxima, then the sums of the rescaled numerators and
denominators), the flash-attention identity over ranks.

Every rank holds the whole encoder output (the GRU runs replicated);
each takes its block of keys from it.  Every replicated tensor that
enters the block (the queries, their hours, the parameters and the
encoder output) passes through `mesh.copy_to_group`, so its gradient sums
the blocks' partial contributions; the numerator and denominator leave
through `mesh.reduce_from_group`, and the max, a pure shift of a
shift-invariant softmax, through the detached `mesh.all_reduce_max`.

`cp_scope` marks the sharded step's work; `ops/attention.
time_aware_multihead_attention` routes here while it is entered, and the
Tq = 1 readout stacks keep the per-hop loop (neither the chain readout
nor the fused readout runs), as in the JAX package.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
from mtamrecommender_tpu_torch.parallel.mesh import Mesh

NEG_FILL = -(2.0 ** 32) + 1.0

_GATE_KEYS = ("time_input_w", "time_input_w1", "time_input_b1",
              "time_output_w1", "time_output_w2", "time_output_b")

_ACTIVE: list = []


@contextmanager
def cp_scope(mesh: Mesh, key_axis: str = "model", data_axis: str = "data"):
    """Route the time-aware attention through the key-sharded path for
    the work inside the scope (no-op on a 1-wide key axis)."""
    if mesh.axis_size(key_axis) <= 1:
        yield
        return
    _ACTIVE.append((mesh, key_axis, data_axis))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_cp() -> Optional[Tuple[Mesh, str, str]]:
    return _ACTIVE[-1] if _ACTIVE else None


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).permute(0, 2, 1, 3)


def _local_block(params, queries, k_raw, key_len, t_q, t_k, offset: int,
                 num_heads: int, group) -> torch.Tensor:
    """Project and score this rank's key block and assemble the exact
    softmax with the other blocks.  queries [B, Tq, d] whole; k_raw
    [B, Tkl, d] and t_k [B, Tkl] this rank's block, starting at key
    ``offset``.  Returns the softmax-weighted value sum [B, h, Tq, dh],
    the same on every rank of the group."""
    def dense(name, x):
        return torch.relu(torch.matmul(x, params[f"{name}.w"])
                          + params[f"{name}.b"])

    # relu projections, this rank's keys only
    q = _heads(dense("q", queries), num_heads)
    k = _heads(dense("k", k_raw), num_heads)
    v = _heads(dense("v", k_raw), num_heads)
    # content-time kernel on the RAW queries and keys
    time_qk = torch.tanh(torch.matmul(
        torch.matmul(queries, params["time_input_w"]), k_raw.transpose(1, 2)))
    delta = torch.abs(t_q[:, :, None] - t_k[:, None, :])
    decay = torch.tanh(torch.log1p(delta) * params["time_input_w1"]
                       + params["time_input_b1"])
    gate = (params["time_output_w1"] * decay
            + params["time_output_w2"] * time_qk + params["time_output_b"])
    scores = torch.matmul(q, k.transpose(-1, -2))
    scores = scores * torch.sigmoid(gate)[:, None, :, :]
    scores = scores / (k.shape[-1] ** 0.5)
    # the key mask against GLOBAL positions (tf.sequence_mask semantics)
    j = offset + torch.arange(k_raw.shape[1], device=k_raw.device)
    live = j[None, :] < key_len[:, None]                      # [B, Tkl]
    scores = torch.where(live[:, None, None, :], scores,
                         torch.full_like(scores, NEG_FILL))
    # the blockwise online softmax, rescaled by the GLOBAL max (detached:
    # a shift the softmax does not see)
    m = mesh_lib.all_reduce_max(scores.amax(dim=-1), group)   # [B, h, Tq]
    p = torch.exp(scores - m[..., None])
    s = mesh_lib.reduce_from_group(p.sum(dim=-1), group)
    o = mesh_lib.reduce_from_group(torch.matmul(p, v), group)
    return o / s[..., None]


def cp_time_attention(p, queries: torch.Tensor, keys: torch.Tensor,
                      key_len: torch.Tensor, t_queries: torch.Tensor,
                      t_keys: torch.Tensor, *, num_heads: int
                      ) -> torch.Tensor:
    """Exact time-aware attention with the keys split over the active CP
    axis.  ``p`` is a `TimeAttentionBlock`.  Returns the pre-tail output
    [B, Tq, d] (the softmax-weighted sum, heads joined); the caller
    applies the query mask, the residual and the normalize."""
    mesh, key_axis, _ = active_cp()
    if p.time_input_w1.dim() != 0:
        raise ValueError(
            "context_parallel requires model.time_gate_mode='scalar': the "
            "positional [Tq,Tk] gate parameters cannot shard over the key "
            "axis")
    shards, index = mesh.axis_size(key_axis), mesh.axis_index(key_axis)
    tk = keys.shape[1]
    if tk % shards != 0:
        raise ValueError(f"key length {tk} not divisible by the "
                         f"{key_axis} axis ({shards}); pad max_seq_len")
    group = mesh.group(key_axis)
    named = {f"{blk}.{w}": getattr(getattr(p, blk), w)
             for blk in ("q", "k", "v") for w in ("w", "b")}
    named.update({k: getattr(p, k) for k in _GATE_KEYS})
    params = {k: mesh_lib.copy_to_group(v, group) for k, v in named.items()}
    queries = mesh_lib.copy_to_group(queries, group)
    t_queries = mesh_lib.copy_to_group(t_queries, group)
    keys = mesh_lib.copy_to_group(keys, group)
    block = tk // shards
    lo = index * block
    out = _local_block(params, queries, keys[:, lo:lo + block], key_len,
                       t_queries, t_keys[:, lo:lo + block], lo, num_heads,
                       group)
    b, h, tq, dh = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, tq, h * dh)
