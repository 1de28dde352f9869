"""Attention modules (twin of mtamrecommender_tpu/ops/attention.py).

Plain multi-head attention (SASrec), MTAM's time-gated attention and the
TiSAS log-interval bias, with ``num_heads`` heads.  Every variant takes
the JAX package's kernel route: relu Q/K/V projections as matmuls, the
middle (scores -> gate or bias -> key mask -> softmax -> dropout ->
weighted sum) through `fused_attention_vjp`
(ops/kernels/attention_kernel.py), then `_tail`: query mask, residual
and the attention modules' normalize (eps 1e-8).  The middle routes by
head and key count (`_middle`), as JAX's does: at one head up to 1024
keys the single-tile `fused_attention` kernel, whose backward is the
`fused_attention_bwd` kernel; above, up to 32768 keys and without
dropout, the blockwise kernel, whose backward is JAX's recompute through
autograd of `reference_middle`; more than one head (the kernels take
one, as the Pallas kernels do), a drop mask above 1024 keys, or more
than 32768 keys takes the dense route (`dense_attention`, plain PyTorch,
JAX's jnp path there), with the heads on an einsum axis of their own.
The head count must divide d (`ValueError` otherwise).

  * `self_attention_stack` (Tq = Tk = L) trains and serves the three
    self-attention models.  Plain and TiSAS attention drop attention
    weights in training through the kernel's '*_drop' modes with one
    mask per block, taken from ``gen`` (`layers.draw_drop_mask`); the
    time kind never drops.
  * `vanilla_attention_stack` runs the Tq=1 readouts of MTAM's family
    and NARM's, in the time or the plain kind.  Time kind: over 256 to
    1024 keys (`READOUT_KERNEL_MIN_KEYS`, `readout_kernel.MAX_KEYS`) all
    hops, projections included, take the `fused_readout` kernel
    (`fused_readout_stack`), in training and serving, as in the JAX
    package.  Below and above that, serving runs hop by hop on the
    attention kernel (single-tile or blockwise).  Training batches the
    memory-side projections across hops (`_readout_precompute`); below
    256 keys the query chain takes the `readout_chain` kernel pair
    (`readout_chain_stack`, JAX's chain kernel route, which JAX keeps
    opt-in on the strength of a TPU measurement), past 1024 keys it runs
    in plain PyTorch (`single_query_readout`), as JAX's jnp path.  Plain
    kind: both readout kernels are time-only, so training runs
    `plain_single_query_readout` (plain PyTorch, JAX's hop-batched jnp
    readout) at every length, with one attention-weight dropout mask a
    hop from ``gen``; serving runs hop by hop on the attention kernel in
    plain mode.  The readout kernels take one head: with more, training
    runs `single_query_readout` / `plain_single_query_readout` at every
    length and serving runs hop by hop on the dense route, as JAX does.

Faithfulness notes kept from the JAX package:
  * the content-time term tanh(Q W_t K^T) uses the RAW queries/keys;
  * masked keys are filled with -2^32+1;
  * the decay-gate params are position-indexed [Tq, Tk] ('positional')
    or scalars ('scalar'), which are broadcast to the kernel's tiles;
  * the JAX package keeps train-time dropout on its jnp path below 256
    keys (`DROPOUT_KERNEL_MIN_KEYS`), a TPU measurement; the port takes
    the kernel there, up to 1024 keys, where JAX's dropout kernel stops
    (`attention_kernel.dropout_supported`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from mtamrecommender_tpu_torch.ops import initializers as init
from mtamrecommender_tpu_torch.ops import layers
from mtamrecommender_tpu_torch.ops.kernels import (attention_kernel,
                                                   readout_chain_kernel,
                                                   readout_kernel)
from mtamrecommender_tpu_torch.parallel import context_parallel as cp_lib

Params = Dict[str, object]

NEG_FILL = -(2.0 ** 32) + 1.0  # the reference's key-mask fill

# The shortest memory whose Tq=1 readout takes the fused readout kernel,
# as in the JAX package: the threshold picks which TPU kernel a shape
# runs, and the port keeps the JAX path at every shape.
READOUT_KERNEL_MIN_KEYS = 256

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
    if kind in ("plain", "tisas"):
        return [init_mha_block(gen, num_units) for _ in range(num_blocks)]
    if kind == "time":
        return [init_time_mha_block(gen, num_units, t_q_len, t_k_len,
                                    gate_mode) for _ in range(num_blocks)]
    raise ValueError(f"unknown attention kind {kind!r}")


class MHABlock(nn.Module):
    """One block's parameters: Dense ``q``, ``k``, ``v``; LayerNorm
    ``ln``."""

    def __init__(self, params: Params):
        super().__init__()
        self.q = layers.Dense(params["q"])
        self.k = layers.Dense(params["k"])
        self.v = layers.Dense(params["v"])
        self.ln = layers.LayerNorm(params["ln"])


class TimeAttentionBlock(MHABlock):
    """An `MHABlock` with ``time_input_w`` [d, d] and the five decay-gate
    params."""

    def __init__(self, params: Params):
        super().__init__(params)
        for name in ("time_input_w",) + GATE_PARAMS:
            self.register_parameter(name, nn.Parameter(params[name]))


def attention_block(params: Params) -> MHABlock:
    """A block of `init_mha_block`'s or `init_time_mha_block`'s params:
    a `TimeAttentionBlock` where they hold the time parameters."""
    if "time_input_w" in params:
        return TimeAttentionBlock(params)
    return MHABlock(params)


def _gate_tile(x: torch.Tensor, t_q_len: int, t_k_len: int) -> torch.Tensor:
    """A gate param as the kernel's [Tq, Tk] tile (scalars broadcast)."""
    if x.dim() == 0:
        return x.expand(t_q_len, t_k_len).contiguous()
    return x


def _tail(p: MHABlock, out: torch.Tensor, queries: torch.Tensor,
          query_len: torch.Tensor) -> torch.Tensor:
    """Query-mask -> residual -> normalize (eps 1e-8)."""
    qmask = layers.sequence_mask(query_len, queries.shape[1]
                                 ).to(out.dtype)[:, :, None]
    return layers.normalize(p.ln, out * qmask + queries)


def _head_width(d: int, num_heads: int) -> int:
    """d / num_heads, the width of a head; a count that does not divide d
    raises."""
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"num_heads={num_heads} must divide the width "
                         f"d={d}")
    return d // num_heads


def _project(p: MHABlock, queries: torch.Tensor, keys: torch.Tensor):
    """relu Q/K/V projections."""
    return (layers.dense(p.q, queries, torch.relu),
            layers.dense(p.k, keys, torch.relu),
            layers.dense(p.v, keys, torch.relu))


def _drop_mask(queries, keys, dropout_rate: float, train: bool,
               gen: Optional[layers.MaskSource],
               num_heads: int) -> Optional[torch.Tensor]:
    """The mask a dropping call applies: the next from ``gen`` in
    training at a positive rate, [B, Tq, Tk] at one head and [B, h, Tq,
    Tk] at h > 1; None (no dropout) otherwise, as in the JAX package
    without an rng."""
    if not train or dropout_rate <= 0.0 or gen is None:
        return None
    return layers.draw_drop_mask(gen, queries.shape[0], queries.shape[1],
                                 keys.shape[1], dropout_rate, queries.device,
                                 num_heads)


def _untimed_attention(kind: str, p: MHABlock, queries, keys, key_len,
                       query_len, t_queries, t_keys, dm,
                       num_heads: int) -> torch.Tensor:
    """Plain or TiSAS attention on the kernel route (`_plain_attention_
    pallas` / `_tisas_attention_pallas`): the modes that read no gate
    take zeros for it, plain mode zeros for the hour stamps too."""
    q, k, v = _project(p, queries, keys)
    b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
    if kind == "plain":
        t_queries = q.new_zeros((b, tq))
        t_keys = q.new_zeros((b, tk))
    zg = q.new_zeros((tq, tk))
    mode = kind if dm is None else f"{kind}_drop"
    out = _middle(mode, q, k, v, t_queries.contiguous(), t_keys.contiguous(),
                  torch.zeros_like(q), torch.zeros_like(k), zg, zg, zg, zg, zg,
                  key_len.to(torch.int32), dm, num_heads=num_heads)
    return _tail(p, out.to(queries.dtype), queries, query_len)


def _middle(mode: str, *args, num_heads: int) -> torch.Tensor:
    """The attention middle by `attention_kernel.route`: the kernels
    through `fused_attention_vjp` (one head: single tile up to 1024 keys,
    blockwise above), or `dense_attention` where they do not reach (more
    than one head, a drop mask above 1024 keys, or more than
    `attention_kernel.MAX_KEYS`), as the JAX package takes its jnp path
    there.  ``args``: those of `fused_attention`, the drop mask (or None)
    last."""
    _head_width(args[0].shape[-1], num_heads)
    if attention_kernel.route(args[1].shape[1], args[-1] is not None,
                              num_heads) == "dense":
        return attention_kernel.dense_attention(mode, *args,
                                                num_heads=num_heads)
    return attention_kernel.fused_attention_vjp(mode, *args)


def multihead_attention(p: MHABlock, queries: torch.Tensor,
                        keys: torch.Tensor, key_len: torch.Tensor,
                        query_len: torch.Tensor, *, num_heads: int = 1,
                        dropout_rate: float = 0.0, train: bool = True,
                        gen: Optional[layers.MaskSource] = None
                        ) -> torch.Tensor:
    """Plain MHA (multihead_attention.py:71-193) with attention-weight
    dropout in training: one f32 mask (0 or 1/keep), [B, Tq, Tk] at one
    head and [B, h, Tq, Tk] at h > 1, drawn from ``gen``, or the next of
    the masks it yields.  Returns [B, Tq, d] in the queries' type."""
    dm = _drop_mask(queries, keys, dropout_rate, train, gen, num_heads)
    return _untimed_attention("plain", p, queries, keys, key_len, query_len,
                              None, None, dm, num_heads)


def tisas_multihead_attention(p: MHABlock, queries: torch.Tensor,
                              keys: torch.Tensor, key_len: torch.Tensor,
                              query_len: torch.Tensor,
                              t_queries: torch.Tensor, t_keys: torch.Tensor,
                              *, num_heads: int = 1,
                              dropout_rate: float = 0.0, train: bool = True,
                              gen: Optional[layers.MaskSource] = None
                              ) -> torch.Tensor:
    """TiSAS: scores += log(|dt|+1) (time_aware_attention.py:73-214),
    with dropout as `multihead_attention`.  The bias is one per (row,
    query, key), shared by the heads."""
    dm = _drop_mask(queries, keys, dropout_rate, train, gen, num_heads)
    return _untimed_attention("tisas", p, queries, keys, key_len, query_len,
                              t_queries, t_keys, dm, num_heads)


def time_aware_multihead_attention(p: TimeAttentionBlock,
                                   queries: torch.Tensor, keys: torch.Tensor,
                                   key_len: torch.Tensor,
                                   query_len: torch.Tensor,
                                   t_queries: torch.Tensor,
                                   t_keys: torch.Tensor, *,
                                   num_heads: int = 1) -> torch.Tensor:
    """MTAM's time-gated attention.  queries: [B, Tq, d]; keys: [B, Tk, d];
    t_queries: [B, Tq] hours; t_keys: [B, Tk] hours.  Returns [B, Tq, d]
    in the queries' type, differentiable through the backward kernel.
    The reference leaves dropout off here.  Scalar gates are broadcast
    to the kernel's [Tq, Tk] tiles, and autograd sums their gradients
    back (JAX keeps scalar gates on its jnp path, with the same math).
    With h > 1 heads the gate, its content term on the raw queries and
    keys, is one per (row, query, key) and scales every head's scores.
    Inside a `parallel.context_parallel.cp_scope` the key axis is split
    over the mesh (`cp_time_attention`, plain PyTorch; the scalar gate
    only), then the same tail."""
    if cp_lib.active_cp() is not None:
        out = cp_lib.cp_time_attention(p, queries, keys, key_len, t_queries,
                                       t_keys, num_heads=num_heads)
        return _tail(p, out.to(queries.dtype), queries, query_len)
    q, k, v = _project(p, queries, keys)
    tqw = torch.matmul(queries, p.time_input_w)
    t_q_len, t_k_len = queries.shape[1], keys.shape[1]
    gates = [getattr(p, name) for name in GATE_PARAMS]
    if attention_kernel.route(t_k_len, False, num_heads) != "dense":
        gates = [_gate_tile(g, t_q_len, t_k_len) for g in gates]
    out = _middle("time", q, k, v, t_queries.contiguous(),
                  t_keys.contiguous(), tqw, keys.contiguous(), *gates,
                  key_len.to(torch.int32), None, num_heads=num_heads)
    return _tail(p, out.to(queries.dtype), queries, query_len)


def self_attention_stack(blocks, enc: torch.Tensor, key_len: torch.Tensor,
                         query_len: torch.Tensor, *, kind: str,
                         num_heads: int, dropout_rate: float, train: bool,
                         gen: Optional[layers.MaskSource] = None,
                         t_queries: Optional[torch.Tensor] = None,
                         t_keys: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Attention.self_attention / Time_Aware_Attention.{self,Tiself}_
    attention: the blocks one after another with enc as queries and keys
    (no feed-forward: the reference's is commented out).  In training the
    plain and tisas kinds drop weights with one mask per block, in block
    order, from ``gen``."""
    for p in blocks:
        if kind == "plain":
            enc = multihead_attention(
                p, enc, enc, key_len, query_len, num_heads=num_heads,
                dropout_rate=dropout_rate, train=train, gen=gen)
        elif kind == "time":
            enc = time_aware_multihead_attention(
                p, enc, enc, key_len, query_len, t_queries, t_keys,
                num_heads=num_heads)
        elif kind == "tisas":
            enc = tisas_multihead_attention(
                p, enc, enc, key_len, query_len, t_queries, t_keys,
                num_heads=num_heads, dropout_rate=dropout_rate, train=train,
                gen=gen)
        else:
            raise ValueError(f"unknown attention kind {kind!r}")
    return enc


def _stack(blocks, get) -> torch.Tensor:
    return torch.stack([get(p) for p in blocks])


def _kv_precompute(blocks, enc: torch.Tensor):
    """The n hops' relu K and V projections of the memory as two einsums:
    k_all, v_all [n, B, Tk, d].  enc: [B, Tk, d]."""
    def project(get):
        return torch.relu(
            torch.einsum("bld,nde->nble", enc,
                         _stack(blocks, lambda p: get(p).w))
            + _stack(blocks, lambda p: get(p).b)[:, None, None, :])

    return project(lambda p: p.k), project(lambda p: p.v)


def _readout_precompute(blocks, enc: torch.Tensor, t_queries: torch.Tensor,
                        t_keys: torch.Tensor):
    """The memory-side work of the n Tq=1 time hops, batched across hops
    (the JAX `_fused_single_query_readout`'s precompute): the K/V
    projections and the content-time precursor ``enc @ W_t^T`` of all
    hops as three einsums, the decay part of the gate, and the ``wo2``
    gates as [n, Tk] rows (a scalar broadcast: autograd sums its
    cotangent back; a positional [1, Tk] reshaped).  enc: [B, Tk, d].
    Returns k_all, v_all, tprec [n, B, Tk, d], gate_part [n, B, Tk] and
    the wo2 rows."""
    n, tk = len(blocks), enc.shape[1]
    k_all, v_all = _kv_precompute(blocks, enc)
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
    wo2 = wo2.reshape(n, tk) if wo2.dim() > 1 \
        else wo2[:, None].expand(n, tk)
    return k_all, v_all, tprec, gate_part[:, :, 0, :], wo2


def single_query_readout(blocks, enc: torch.Tensor, dec: torch.Tensor,
                         key_len: torch.Tensor, query_len: torch.Tensor, *,
                         num_heads: int, t_queries: torch.Tensor,
                         t_keys: torch.Tensor) -> torch.Tensor:
    """The n Tq=1 time-attention hops in plain PyTorch (twin of the JAX
    `_fused_single_query_readout`, time kind): `_readout_precompute`,
    then only the query chain dec_0 -> dec_1 -> ... hop by hop, under
    autograd.  With h heads K and V split [n, B, Tk, h, d/h] and each
    hop's query [B, h, d/h]; the gate, [B, Tk], scales every head's
    scores.  enc: [B, Tk, d]; dec: [B, 1, d]; returns [B, d]."""
    b, tk, d = enc.shape
    dh = _head_width(d, num_heads)
    k_all, v_all, tprec, gate_part, wo2 = _readout_precompute(
        blocks, enc, t_queries, t_keys)
    k_all = k_all.reshape(len(blocks), b, tk, num_heads, dh)
    v_all = v_all.reshape(len(blocks), b, tk, num_heads, dh)
    kmask = layers.sequence_mask(key_len, tk)[:, None, :]          # [B,1,Tk]
    # the per-hop query mask: a row with query_len == 0 keeps only its
    # residual and normalize
    qz = (query_len > 0).to(dec.dtype)[:, None]                    # [B, 1]
    cur = dec[:, 0, :]
    for i, p in enumerate(blocks):
        q = layers.dense(p.q, cur, torch.relu).reshape(b, num_heads, dh)
        scores = torch.einsum("bhe,blhe->bhl", q, k_all[i])
        tqk = torch.tanh(torch.einsum("bd,bld->bl", cur, tprec[i]))
        gate = torch.sigmoid(gate_part[i] + wo2[i] * tqk)        # [B, Tk]
        scores = scores * gate[:, None, :] / dh ** 0.5
        scores = torch.where(kmask, scores, torch.full_like(scores, NEG_FILL))
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhl,blhe->bhe", weights, v_all[i]).reshape(b, d)
        cur = layers.normalize(p.ln, out * qz + cur)
    return cur


def plain_single_query_readout(blocks, enc: torch.Tensor, dec: torch.Tensor,
                               key_len: torch.Tensor, query_len: torch.Tensor,
                               *, num_heads: int, dropout_rate: float = 0.0,
                               train: bool = False,
                               gen: Optional[layers.MaskSource] = None
                               ) -> torch.Tensor:
    """The n Tq=1 plain-attention hops in plain PyTorch (twin of the JAX
    `_fused_single_query_readout`, plain kind): the K/V projections of
    all hops batched (`_kv_precompute`), then the query chain hop by hop
    under autograd, with the heads split as in `single_query_readout`.
    In training at a positive rate each hop drops attention weights with
    its own mask from ``gen`` (`layers.draw_drop_mask`), f32 [B, 1, Tk]
    at one head and [B, h, 1, Tk] at h > 1, drawn in hop order; JAX
    folds the hop index into its rng for the same [B, h, 1, Tk] draw.
    enc: [B, Tk, d]; dec: [B, 1, d]; returns [B, d]."""
    b, tk, d = enc.shape
    dh = _head_width(d, num_heads)
    k_all, v_all = _kv_precompute(blocks, enc)
    k_all = k_all.reshape(len(blocks), b, tk, num_heads, dh)
    v_all = v_all.reshape(len(blocks), b, tk, num_heads, dh)
    kmask = layers.sequence_mask(key_len, tk)[:, None, :]          # [B,1,Tk]
    qz = (query_len > 0).to(dec.dtype)[:, None]                    # [B, 1]
    cur = dec[:, 0, :]
    for i, p in enumerate(blocks):
        q = layers.dense(p.q, cur, torch.relu).reshape(b, num_heads, dh)
        scores = torch.einsum("bhe,blhe->bhl", q, k_all[i]) / dh ** 0.5
        scores = torch.where(kmask, scores, torch.full_like(scores, NEG_FILL))
        weights = torch.softmax(scores, dim=-1)                  # [B,h,Tk]
        if train and dropout_rate > 0.0 and gen is not None:
            mask = layers.draw_drop_mask(gen, b, 1, tk, dropout_rate,
                                         enc.device, num_heads)
            weights = weights * mask.reshape(b, num_heads, tk).to(
                weights.dtype)
        out = torch.einsum("bhl,blhe->bhe", weights, v_all[i]).reshape(b, d)
        cur = layers.normalize(p.ln, out * qz + cur)
    return cur


def readout_chain_stack(blocks, enc: torch.Tensor, dec: torch.Tensor,
                        key_len: torch.Tensor, query_len: torch.Tensor, *,
                        num_heads: int, t_queries: torch.Tensor,
                        t_keys: torch.Tensor) -> torch.Tensor:
    """The n Tq=1 time-attention hops as `_readout_precompute` and the
    query chain in one `readout_chain` call per direction (the JAX
    `_fused_single_query_readout` with its chain kernel): the cotangents
    of k_all, v_all, tprec and gate_part leave the chain's backward and
    autograd carries them through the precompute.  enc: [B, Tk, d]; dec:
    [B, 1, d]; returns [B, d] in dec's type.  The kernels take one
    head."""
    if num_heads != 1:
        raise NotImplementedError(
            f"the readout_chain kernels take one head, not {num_heads}; "
            "vanilla_attention_stack takes single_query_readout there")
    k_all, v_all, tprec, gate_part, wo2 = _readout_precompute(
        blocks, enc, t_queries, t_keys)
    out = readout_chain_kernel.readout_chain_vjp(
        dec.contiguous(), key_len.to(torch.int32).contiguous(),
        (query_len > 0).float(), k_all.contiguous(), v_all.contiguous(),
        tprec.contiguous(), gate_part.contiguous(), wo2.contiguous(),
        _stack(blocks, lambda p: p.q.w), _stack(blocks, lambda p: p.q.b),
        _stack(blocks, lambda p: p.ln.gamma),
        _stack(blocks, lambda p: p.ln.beta))
    return out.to(dec.dtype)


def fused_readout_stack(blocks, enc: torch.Tensor, dec: torch.Tensor,
                        key_len: torch.Tensor, query_len: torch.Tensor, *,
                        t_queries: torch.Tensor, t_keys: torch.Tensor
                        ) -> torch.Tensor:
    """All n Tq=1 time-attention hops, projections included, in one
    `fused_readout` call per direction (twin of the JAX
    `_fused_readout_pallas`).  The per-hop params are stacked, and each
    gate param becomes an f32 [n, Tk] row here, outside the autograd
    function: a scalar is broadcast (autograd sums its cotangent back), a
    positional [1, Tk] is reshaped.  enc: [B, Tk, d]; dec: [B, 1, d];
    returns [B, d] in dec's type."""
    n, tk = len(blocks), enc.shape[1]

    def gate_row(name):
        x = _stack(blocks, lambda p: getattr(p, name)).float()
        if x.dim() == 1:                      # scalar gates, stacked: [n]
            return x[:, None].expand(n, tk).contiguous()
        return x.reshape(n, tk)               # positional [n, 1, Tk]

    logdt = torch.log1p(torch.abs(t_queries[:, 0:1] - t_keys)).float()
    out = readout_kernel.fused_readout_vjp(
        enc.contiguous(), dec[:, 0, :].contiguous(), logdt.contiguous(),
        key_len.to(torch.int32), (query_len > 0).float(),
        _stack(blocks, lambda p: p.q.w), _stack(blocks, lambda p: p.q.b),
        _stack(blocks, lambda p: p.k.w), _stack(blocks, lambda p: p.k.b),
        _stack(blocks, lambda p: p.v.w), _stack(blocks, lambda p: p.v.b),
        _stack(blocks, lambda p: p.time_input_w),
        *(gate_row(name) for name in GATE_PARAMS),
        _stack(blocks, lambda p: p.ln.gamma),
        _stack(blocks, lambda p: p.ln.beta))
    return out.to(dec.dtype)


def vanilla_attention_stack(blocks, enc: torch.Tensor, dec: torch.Tensor,
                            key_len: torch.Tensor, query_len: torch.Tensor,
                            *, kind: str, num_heads: int,
                            t_queries: Optional[torch.Tensor] = None,
                            t_keys: Optional[torch.Tensor] = None,
                            dropout_rate: float = 0.0, train: bool = False,
                            gen: Optional[layers.MaskSource] = None
                            ) -> torch.Tensor:
    """Decoder cross-attention hops of ``kind`` "time" or "plain";
    returns [B*Tq, d].  Only the time kind at one head reaches the
    readout kernels, which are time-only and take one head: one time
    query over `READOUT_KERNEL_MIN_KEYS` to `readout_kernel.MAX_KEYS` keys
    takes `fused_readout_stack`, in training and serving alike; otherwise
    ``train=True`` with one time query takes `readout_chain_stack` where
    `readout_chain_kernel.supported` (one head below 256 keys: the JAX
    package's chain kernel route) and `single_query_readout` elsewhere
    (past 1024 keys, and at every length with more than one head), both
    hop-batched.  One plain query in training takes
    `plain_single_query_readout` at every length, dropping weights per
    hop at ``dropout_rate`` with masks from ``gen``.  Serving runs hop by
    hop through the attention variants (at one head the fused attention
    kernel: its hop design at L=50, the blockwise kernel past 1024 keys;
    with more the dense route, one call a hop).  The time kind never
    drops.  Inside a `parallel.context_parallel.cp_scope` every case
    runs hop by hop, where the key-sharded attention routes, as in the
    JAX package."""
    if kind not in ("plain", "time"):
        raise ValueError(f"unknown attention kind {kind!r}; the readout "
                         "takes 'plain' or 'time'")
    one_query = (dec.shape[1] == 1 and len(blocks) > 0
                 and cp_lib.active_cp() is None)
    if (kind == "time" and one_query and num_heads == 1
            and READOUT_KERNEL_MIN_KEYS <= enc.shape[1]
            <= readout_kernel.MAX_KEYS):
        return fused_readout_stack(blocks, enc, dec, key_len, query_len,
                                   t_queries=t_queries, t_keys=t_keys)
    if train and one_query and kind == "plain":
        return plain_single_query_readout(
            blocks, enc, dec, key_len, query_len, num_heads=num_heads,
            dropout_rate=dropout_rate, train=train, gen=gen)
    if train and one_query:
        readout = (readout_chain_stack if readout_chain_kernel.supported(
            enc.shape[1], enc.shape[2], num_heads) else single_query_readout)
        return readout(blocks, enc, dec, key_len, query_len,
                       num_heads=num_heads, t_queries=t_queries,
                       t_keys=t_keys)
    for p in blocks:
        if kind == "plain":
            dec = multihead_attention(
                p, dec, enc, key_len, query_len, num_heads=num_heads,
                dropout_rate=dropout_rate, train=train, gen=gen)
        else:
            dec = time_aware_multihead_attention(
                p, dec, enc, key_len, query_len, t_queries, t_keys,
                num_heads=num_heads)
    return dec.reshape(-1, dec.shape[-1])
