"""MTAM's time-aware attention readout (twin of the time kind in
mtamrecommender_tpu/ops/attention.py).

A hop is MTAM's memory reader: relu Q/K/V projections, scores scaled by
sigmoid(decay gate), key mask, softmax, weighted sum, residual and the
attention modules' normalize (eps 1e-8).  Two routes, as in the JAX
package's `vanilla_attention_stack` for Tq=1 stacks:

  * serving (``train=False``): hop by hop, the middle of every hop the
    `fused_attention` kernel (ops/kernels/attention_kernel.py) in time
    mode, the projections matmuls outside it -- the JAX kernel route
    (`_time_attention_pallas` + `_pallas_tail`), including the scalar
    gate mode, whose scalars are broadcast to the kernel's [Tq, Tk] tiles;
  * training (``train=True``): the hop-batched readout
    (`_fused_single_query_readout`) in plain PyTorch.  JAX computes it
    outside Pallas at every width the port takes, and the kernel above
    has no backward.

Faithfulness notes kept from the JAX package:
  * the content-time term tanh(Q W_t K^T) uses the RAW queries/keys;
  * masked keys are filled with -2^32+1;
  * the decay-gate params are position-indexed [Tq, Tk] ('positional')
    or scalars ('scalar').
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from mtamrecommender_tpu_torch.ops import initializers as init
from mtamrecommender_tpu_torch.ops import layers
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel

Params = Dict[str, object]

NEG_FILL = -(2.0 ** 32) + 1.0  # the reference's key-mask fill

GATE_PARAMS = ("time_input_w1", "time_input_b1", "time_output_w1",
               "time_output_w2", "time_output_b")


def init_mha_block(gen: torch.Generator, num_units: int) -> Params:
    return {
        "q": layers.init_dense(gen, num_units, num_units),
        "k": layers.init_dense(gen, num_units, num_units),
        "v": layers.init_dense(gen, num_units, num_units),
        "ln": layers.init_layer_norm(num_units, gen.device),
    }


def init_time_mha_block(gen: torch.Generator, num_units: int, t_q_len: int,
                        t_k_len: int, gate_mode: str = "positional"
                        ) -> Params:
    """Decay-gate parameters: 'positional' keeps the reference's [Tq,Tk]
    position-indexed shape; 'scalar' makes each gate weight a scalar."""
    params = init_mha_block(gen, num_units)
    if gate_mode == "positional":
        ginit = lambda: init.glorot_uniform(gen, (t_q_len, t_k_len))  # noqa: E731
    elif gate_mode == "scalar":
        # the positional glorot bound at Tq=1, Tk=50 is sqrt(6/51) ~ 0.34
        ginit = lambda: init.uniform(gen, (), -0.34, 0.34)  # noqa: E731
    else:
        raise ValueError(f"unknown time_gate_mode {gate_mode!r}; "
                         "known: ('positional', 'scalar')")
    params["time_input_w"] = init.glorot_uniform(gen, (num_units, num_units))
    for name in GATE_PARAMS:
        params[name] = ginit()
    return params


def init_attention_stack(gen: torch.Generator, num_blocks: int,
                         num_units: int, *, kind: str = "time",
                         t_q_len: int = 0, t_k_len: int = 0,
                         gate_mode: str = "positional") -> List[Params]:
    if kind != "time":
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet; the port has the "
            "'time' kind (ROADMAP.md, Queue 1)")
    return [init_time_mha_block(gen, num_units, t_q_len, t_k_len, gate_mode)
            for _ in range(num_blocks)]


class TimeAttentionBlock(nn.Module):
    """One hop's parameters: Dense ``q``, ``k``, ``v``; LayerNorm ``ln``;
    ``time_input_w`` [d, d] and the five decay-gate params."""

    def __init__(self, params: Params):
        super().__init__()
        self.q = layers.Dense(params["q"])
        self.k = layers.Dense(params["k"])
        self.v = layers.Dense(params["v"])
        self.ln = layers.LayerNorm(params["ln"])
        for name in ("time_input_w",) + GATE_PARAMS:
            self.register_parameter(name, nn.Parameter(params[name]))


def _gate_tile(x: torch.Tensor, t_q_len: int, t_k_len: int) -> torch.Tensor:
    """A gate param as the kernel's [Tq, Tk] tile (scalars broadcast)."""
    if x.dim() == 0:
        return x.expand(t_q_len, t_k_len).contiguous()
    return x


def _tail(p: TimeAttentionBlock, out: torch.Tensor, queries: torch.Tensor,
          query_len: torch.Tensor) -> torch.Tensor:
    """Query-mask -> residual -> normalize (eps 1e-8)."""
    qmask = layers.sequence_mask(query_len, queries.shape[1]
                                 ).to(out.dtype)[:, :, None]
    return layers.normalize(p.ln, out * qmask + queries)


def time_aware_multihead_attention(p: TimeAttentionBlock,
                                   queries: torch.Tensor, keys: torch.Tensor,
                                   key_len: torch.Tensor,
                                   query_len: torch.Tensor,
                                   t_queries: torch.Tensor,
                                   t_keys: torch.Tensor, *,
                                   num_heads: int = 1) -> torch.Tensor:
    """MTAM's memory reader.  queries: [B, Tq, d]; keys: [B, Tk, d];
    t_queries: [B, Tq] hours; t_keys: [B, Tk] hours.  Returns [B, Tq, d]
    in the queries' type.  The reference leaves dropout off here."""
    if num_heads != 1:
        raise NotImplementedError(
            "the fused attention kernel takes one head; multi-head time "
            "attention is not ported yet")
    q = layers.dense(p.q, queries, torch.relu)
    k = layers.dense(p.k, keys, torch.relu)
    v = layers.dense(p.v, keys, torch.relu)
    tqw = torch.matmul(queries, p.time_input_w)
    t_q_len, t_k_len = queries.shape[1], keys.shape[1]
    gates = [_gate_tile(getattr(p, name), t_q_len, t_k_len)
             for name in GATE_PARAMS]
    out = attention_kernel.fused_attention(
        "time", q, k, v, t_queries.contiguous(), t_keys.contiguous(), tqw,
        keys.contiguous(), *gates, key_len.to(torch.int32))
    return _tail(p, out.to(queries.dtype), queries, query_len)


def _stack(blocks, get) -> torch.Tensor:
    return torch.stack([get(p) for p in blocks])


def single_query_readout(blocks, enc: torch.Tensor, dec: torch.Tensor,
                         key_len: torch.Tensor, query_len: torch.Tensor, *,
                         num_heads: int, t_queries: torch.Tensor,
                         t_keys: torch.Tensor) -> torch.Tensor:
    """The n Tq=1 time-attention hops with the memory-side work batched
    across hops (twin of the JAX `_fused_single_query_readout`, time
    kind).  The K/V projections and the content-time precursor
    ``enc @ W_t^T`` of all hops are three einsums, the decay part of the
    gate is precomputed, and only the query chain dec_0 -> dec_1 -> ...
    runs hop by hop.  enc: [B, Tk, d]; dec: [B, 1, d]; returns [B, d]."""
    if num_heads != 1:
        raise NotImplementedError(
            "multi-head time attention is not ported yet (ROADMAP.md)")
    n = len(blocks)
    b_sz, tk, d = enc.shape
    k_all = torch.relu(torch.einsum("bld,nde->nble", enc,
                                    _stack(blocks, lambda p: p.k.w))
                       + _stack(blocks, lambda p: p.k.b)[:, None, None, :])
    v_all = torch.relu(torch.einsum("bld,nde->nble", enc,
                                    _stack(blocks, lambda p: p.v.w))
                       + _stack(blocks, lambda p: p.v.b)[:, None, None, :])
    tprec = torch.einsum("ble,nde->nbld", enc,
                         _stack(blocks, lambda p: p.time_input_w))
    delta = torch.abs(t_queries[:, :, None] - t_keys[:, None, :])  # [B,1,Tk]

    def gate(name):
        # positional [1, Tk] -> [n, 1, 1, Tk]; scalar [] -> [n, 1, 1, 1]
        x = _stack(blocks, lambda p: getattr(p, name))
        return x.reshape((n, 1) + tuple(x.shape[1:])) if x.dim() > 1 \
            else x.reshape(n, 1, 1, 1)

    decay = torch.tanh(torch.log1p(delta)[None] * gate("time_input_w1")
                       + gate("time_input_b1"))                   # [n,B,1,Tk]
    gate_part = gate("time_output_w1") * decay + gate("time_output_b")
    wo2 = _stack(blocks, lambda p: p.time_output_w2)
    kmask = layers.sequence_mask(key_len, tk)                      # [B, Tk]
    # the per-hop query mask: a row with query_len == 0 keeps only its
    # residual and normalize
    qz = (query_len > 0).to(dec.dtype)[:, None]                    # [B, 1]
    cur = dec[:, 0, :]
    for i, p in enumerate(blocks):
        q = layers.dense(p.q, cur, torch.relu)
        scores = torch.einsum("be,ble->bl", q, k_all[i])
        tqk = torch.tanh(torch.einsum("bd,bld->bl", cur, tprec[i]))
        scores = scores * torch.sigmoid(gate_part[i][:, 0, :] + wo2[i] * tqk)
        scores = scores / d ** 0.5
        scores = torch.where(kmask, scores, torch.full_like(scores, NEG_FILL))
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bl,ble->be", weights, v_all[i])
        cur = layers.normalize(p.ln, out * qz + cur)
    return cur


def vanilla_attention_stack(blocks, enc: torch.Tensor, dec: torch.Tensor,
                            key_len: torch.Tensor, query_len: torch.Tensor,
                            *, kind: str, num_heads: int,
                            t_queries: torch.Tensor, t_keys: torch.Tensor,
                            train: bool = False) -> torch.Tensor:
    """Decoder cross-attention hops; returns [B*Tq, d].  ``train=True``
    with one query takes the hop-batched `single_query_readout` (the
    JAX package's training route); otherwise the hops run one after
    another on the fused attention kernel (its serving route at L=50)."""
    if kind != "time":
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet (ROADMAP.md)")
    if train and dec.shape[1] == 1 and len(blocks) > 0:
        return single_query_readout(blocks, enc, dec, key_len, query_len,
                                    num_heads=num_heads, t_queries=t_queries,
                                    t_keys=t_keys)
    for p in blocks:
        dec = time_aware_multihead_attention(
            p, dec, enc, key_len, query_len, t_queries, t_keys,
            num_heads=num_heads)
    return dec.reshape(-1, dec.shape[-1])
