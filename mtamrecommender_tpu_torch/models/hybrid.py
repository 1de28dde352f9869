"""Hybrid baselines: the NARM family, the LSTUR family and STAMP (twin of
mtamrecommender_tpu/models/hybrid.py).

  * NARM, NARM+, NARM++: a GRU encoder (plain, or the T-GRU in NARM++)
    whose states are the memory of one single-query attention block, one
    head, read by the layer-normed intent; the prediction
    ln_out([intent, readout]) [B, 2d] goes through the concat head.
    NARM's readout is the plain kind, with attention-weight dropout in
    training; NARM+ and NARM++ read with the time kind, which never
    drops.
  * LSTUR, LSTUR_time_rnn: a GRU started from the user's embedding.
  * STAMP: tri-linear attention over the history with an external
    memory (the sum) and the last click, two bias-free dense layers, an
    elementwise product.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mtamrecommender_tpu_torch.models import base, mtam, rnn
from mtamrecommender_tpu_torch.ops import attention
from mtamrecommender_tpu_torch.ops import initializers as init
from mtamrecommender_tpu_torch.ops import layers, time_gru
from mtamrecommender_tpu_torch.ops.embedding import (BehaviorEmbedding,
                                                     init_behavior_embedding)

# ---------------------------------------------------------------- NARM family


def _init_narm(gen: torch.Generator, cfg, meta, *, cell: str,
               att_kind: str) -> mtam.MTAM:
    """``embedding``, ``rnn`` (the ``cell``), ``ln_intent``, ``ln_out``
    [2d], one attention block ``att.0`` of ``att_kind`` and the concat
    head's glorot ``output_w`` [2d, d], in the MTAM family's module."""
    d = cfg.num_units
    params = {
        "embedding": init_behavior_embedding(
            gen, meta, d, vocab_pad_multiple=cfg.vocab_pad_multiple),
        "ln_intent": layers.init_layer_norm(d, gen.device),
        "ln_out": layers.init_layer_norm(2 * d, gen.device),
        # NARM runs exactly 1 block and 1 head
        # (hybird_baseline_models.py:99,129,159)
        "att": attention.init_attention_stack(
            gen, 1, d, kind=att_kind, t_q_len=1, t_k_len=meta.max_seq_len,
            gate_mode=cfg.time_gate_mode),
        "output_w": init.glorot_uniform(gen, (2 * d, d)),
        "rnn": (time_gru.init_gru(gen, d, d) if cell == "plain"
                else time_gru.init_time_aware_gru(gen, cell, d, d)),
    }
    return mtam.MTAM(params, cell)


def _apply_narm(model: mtam.MTAM, cfg, batch, *, cell: str, att_kind: str,
                train: bool, gen: Optional[layers.MaskSource]
                ) -> base.ModelOutput:
    """The GRU's states [B, L, d] are the memory (key length seq_len);
    the layer-normed state at seq_len - 2 is the intent and the query."""
    e = base.embed(model, batch)
    states, intent = mtam._intent(model, batch, e, cell)
    intent = layers.layer_norm(model.ln_intent, intent)
    ones = torch.ones_like(batch.seq_len)
    readout = attention.vanilla_attention_stack(
        model.att, states, intent[:, None, :], key_len=batch.seq_len,
        query_len=ones, kind=att_kind, num_heads=1,
        t_queries=batch.target_time[:, None], t_keys=batch.times,
        dropout_rate=cfg.dropout, train=train, gen=gen)
    pred = layers.layer_norm(model.ln_out,
                             torch.cat([intent, readout], dim=1))
    return base.ModelOutput(pred, e)


def init_narm(gen, cfg, meta):
    return _init_narm(gen, cfg, meta, cell="plain", att_kind="plain")


def apply_narm(model, cfg, batch, *, train, gen=None):
    """NARM (hybird_baseline_models.py:137-164): plain GRU encoder, one
    plain cross-attention block with weight dropout, the concat head."""
    return _apply_narm(model, cfg, batch, cell="plain", att_kind="plain",
                       train=train, gen=gen)


def init_narm_time_att(gen, cfg, meta):
    return _init_narm(gen, cfg, meta, cell="plain", att_kind="time")


def apply_narm_time_att(model, cfg, batch, *, train, gen=None):
    """NARM+ (hybird_baseline_models.py:107-136): time-aware attention."""
    return _apply_narm(model, cfg, batch, cell="plain", att_kind="time",
                       train=train, gen=gen)


def init_narm_time_att_time_rnn(gen, cfg, meta):
    return _init_narm(gen, cfg, meta, cell="new", att_kind="time")


def apply_narm_time_att_time_rnn(model, cfg, batch, *, train, gen=None):
    """NARM++ (hybird_baseline_models.py:73-106): the T-GRU encoder and
    time-aware attention."""
    return _apply_narm(model, cfg, batch, cell="new", att_kind="time",
                       train=train, gen=gen)


# ---------------------------------------------------------------- LSTUR family

def init_lstur(gen, cfg, meta):
    """Gru4Rec's parameters: the embedding, a plain GRU and ``ln_out``."""
    return rnn.init_gru4rec(gen, cfg, meta)


def apply_lstur(model, cfg, batch, *, train, gen=None):
    """LSTUR (hybird_baseline_models.py:40-54): the plain GRU started
    from the user embedding."""
    e = base.embed(model, batch)
    out = time_gru.gru_net(model.rnn, e.behavior_emb, batch.seq_len - 1,
                           initial_state=e.user_emb)
    return rnn.gru_head(model, batch, out, e)


def init_lstur_time_rnn(gen, cfg, meta):
    """The embedding, the T-SeqRec cell on d - 2 inputs (see
    apply_lstur_time_rnn) and ``ln_out``."""
    d = cfg.num_units
    return mtam.MTAM({
        "embedding": init_behavior_embedding(
            gen, meta, d, vocab_pad_multiple=cfg.vocab_pad_multiple),
        "rnn": time_gru.init_tseqrec(gen, d - 2, d),
        "ln_out": layers.init_layer_norm(d, gen.device),
    }, "T-SeqRec")


def apply_lstur_time_rnn(model, cfg, batch, *, train, gen=None):
    """LSTUR_time_rnn (hybird_baseline_models.py:55-72): the T-SeqRec
    cell started from the user embedding.  As in the reference, the cell
    reads the behavior embedding itself, not [emb; time_last; time_now]:
    dims 0..d-3 are its content and dims d-2 and d-1 its two time
    signals (the reference's cell strips the last two input dims as time
    scores, time_aware_rnn.py:73-75), so the time signals are learned
    and differentiable."""
    e = base.embed(model, batch)
    emb = e.behavior_emb
    out = time_gru.tseqrec_net(model.rnn, emb[:, :, :-2], emb[:, :, -2],
                               emb[:, :, -1], batch.seq_len - 1,
                               initial_state=e.user_emb)
    return rnn.gru_head(model, batch, out, e)


# ---------------------------------------------------------------- STAMP

class STAMP(nn.Module):
    """Parameter names follow the JAX key paths: ``embedding.*``,
    ``att_w0`` [d, 1], ``att_w1..3`` [d, d], the bias-free ``mlp_a.w``
    and ``mlp_b.w``, ``ln_mem.*`` and ``ln_out.*``."""

    def __init__(self, params: dict):
        super().__init__()
        self.embedding = BehaviorEmbedding(params["embedding"])
        for name in ("att_w0", "att_w1", "att_w2", "att_w3"):
            self.register_parameter(name, nn.Parameter(params[name]))
        self.mlp_a = layers.Dense(params["mlp_a"])
        self.mlp_b = layers.Dense(params["mlp_b"])
        self.ln_mem = layers.LayerNorm(params["ln_mem"])
        self.ln_out = layers.LayerNorm(params["ln_out"])


def init_stamp(gen, cfg, meta):
    d = cfg.num_units
    return STAMP({
        "embedding": init_behavior_embedding(
            gen, meta, d, vocab_pad_multiple=cfg.vocab_pad_multiple),
        "att_w0": init.glorot_uniform(gen, (d, 1)),
        "att_w1": init.glorot_uniform(gen, (d, d)),
        "att_w2": init.glorot_uniform(gen, (d, d)),
        "att_w3": init.glorot_uniform(gen, (d, d)),
        "mlp_a": layers.init_dense(gen, d, d, use_bias=False),
        "mlp_b": layers.init_dense(gen, d, d, use_bias=False),
        "ln_mem": layers.init_layer_norm(d, gen.device),
        "ln_out": layers.init_layer_norm(d, gen.device),
    })


def apply_stamp(model, cfg, batch, *, train, gen=None):
    """STAMP (hybird_baseline_models.py:165-213), as the JAX package
    reads it: the external memory is the layer-normed sum over all L
    positions, padding included; the attention weights
    sigmoid(h W1 + m W2 + x_last W3) W0 [B, L] weight a sum over the
    history (the reference's `matmul` then `reduce_sum` type-checks only
    so); its declared `att_b` is unused on the live path, so there is
    none."""
    e = base.embed(model, batch)
    history = e.behavior_emb
    memory = layers.layer_norm(model.ln_mem, history.sum(dim=1))
    last_click = layers.gather_positions(history, batch.seq_len - 2)
    a_hist = torch.einsum("btd,de->bte", history, model.att_w1)
    a_mem = torch.matmul(memory, model.att_w2)
    a_last = torch.matmul(last_click, model.att_w3)
    att = torch.sigmoid(a_hist + a_mem[:, None, :] + a_last[:, None, :])
    att = torch.einsum("btd,do->bt", att, model.att_w0)
    ms = torch.einsum("bt,btd->bd", att, history)
    hs = layers.dense(model.mlp_a, ms, torch.relu)
    ht = layers.dense(model.mlp_b, last_click, torch.relu)
    return base.ModelOutput(layers.layer_norm(model.ln_out, hs * ht), e)
