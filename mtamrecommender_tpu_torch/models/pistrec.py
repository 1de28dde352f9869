"""PISTRec: a time-aware self-attention encoder and a long / short /
hybrid switch network (twin of mtamrecommender_tpu/models/pistrec.py).

The JAX package implements the reference's evident design (its
`PISTRec_model.py` is partly bit-rotted), and so does the port:

  * long-term preference = time-aware self-attention over the history
    (Tq = Tk = L), gathered at the mask slot;
  * short-term intent = the T-SeqRec cell, gathered at the last history
    event;
  * hybrid preference = the single-query time-aware cross attention from
    the intent over the self-attended history;
  * switch z = softmax(dense(concat(long, short, hybrid))) [B, 3], which
    combines the three by ``cfg.pistrec_type``: "soft" (the z-weighted
    sum), "hard" (each row's argmax branch, the first on ties, so the
    switch gets no gradient), "short", "long" or "hybird" (one branch);
    then a layer norm.
"""

from __future__ import annotations

import torch
from torch import nn

from mtamrecommender_tpu_torch.models import base
from mtamrecommender_tpu_torch.ops import attention, layers, time_gru
from mtamrecommender_tpu_torch.ops.embedding import (BehaviorEmbedding,
                                                     init_behavior_embedding)

PISTREC_TYPES = ("soft", "hard", "short", "long", "hybird")


class PISTRec(nn.Module):
    """Parameter names follow the JAX key paths: ``embedding.*``,
    ``self_att.<block>.*``, ``rnn.*``, ``cross_att.<hop>.*``,
    ``switch.w`` [3d, 3], ``switch.b`` [3] and ``ln_out.*``."""

    def __init__(self, params: dict):
        super().__init__()
        self.embedding = BehaviorEmbedding(params["embedding"])
        self.self_att = nn.ModuleList(attention.TimeAttentionBlock(p)
                                      for p in params["self_att"])
        self.rnn = time_gru.TimeGRU(params["rnn"])
        self.cross_att = nn.ModuleList(attention.TimeAttentionBlock(p)
                                       for p in params["cross_att"])
        self.switch = layers.Dense(params["switch"])
        self.ln_out = layers.LayerNorm(params["ln_out"])


def init_pistrec(gen, cfg, meta):
    d = cfg.num_units
    return PISTRec({
        "embedding": init_behavior_embedding(
            gen, meta, d, vocab_pad_multiple=cfg.vocab_pad_multiple),
        "self_att": attention.init_attention_stack(
            gen, cfg.num_blocks, d, kind="time",
            t_q_len=meta.max_seq_len, t_k_len=meta.max_seq_len,
            gate_mode=cfg.time_gate_mode),
        "rnn": time_gru.init_tseqrec(gen, d, d),
        "cross_att": attention.init_attention_stack(
            gen, cfg.num_blocks, d, kind="time", t_q_len=1,
            t_k_len=meta.max_seq_len, gate_mode=cfg.time_gate_mode),
        "switch": layers.init_dense(gen, 3 * d, 3),
        "ln_out": layers.init_layer_norm(d, gen.device),
    })


def branches(model, cfg, batch, *, train, gen=None):
    """((long_term, short_term, hybrid) [B, d] each, the switch z [B, 3],
    the embedded batch).  Both attention stacks are the time kind, which
    draws nothing."""
    e = base.embed(model, batch)
    enc = attention.self_attention_stack(
        model.self_att, e.behavior_emb, key_len=batch.seq_len,
        query_len=batch.seq_len, kind="time", num_heads=cfg.num_heads,
        dropout_rate=cfg.dropout, train=train, gen=gen,
        t_queries=batch.times, t_keys=batch.times)
    long_term = layers.gather_positions(enc, batch.seq_len - 1)
    states = time_gru.tseqrec_net(model.rnn, e.behavior_emb, batch.time_last,
                                  batch.time_now, batch.seq_len - 1)
    short_term = layers.gather_positions(states, batch.seq_len - 2)
    ones = torch.ones_like(batch.seq_len)
    hybrid = attention.vanilla_attention_stack(
        model.cross_att, enc, short_term[:, None, :], key_len=batch.seq_len,
        query_len=ones, kind="time", num_heads=cfg.num_heads,
        t_queries=batch.target_time[:, None], t_keys=batch.times,
        dropout_rate=cfg.dropout, train=train, gen=gen)
    z = torch.softmax(layers.dense(
        model.switch, torch.cat([long_term, short_term, hybrid], dim=1)),
        dim=-1)
    return (long_term, short_term, hybrid), z, e


def combine(kind: str, parts, z: torch.Tensor) -> torch.Tensor:
    """The prediction before ``ln_out`` by ``pistrec_type``."""
    long_term, short_term, hybrid = parts
    if kind == "soft":
        return (z[:, 0:1] * long_term + z[:, 1:2] * short_term
                + z[:, 2:3] * hybrid)
    if kind == "hard":
        # each row's argmax branch (the reference's python `if` on a
        # tensor, PISTRec_model.py:158-164, never type-checked)
        stacked = torch.stack(parts, dim=1)
        rows = torch.arange(stacked.shape[0], device=stacked.device)
        return stacked[rows, torch.argmax(z, dim=1)]
    return {"short": short_term, "long": long_term, "hybird": hybrid}[kind]


def apply_pistrec(model, cfg, batch, *, train, gen=None):
    kind = cfg.pistrec_type
    if kind not in PISTREC_TYPES:
        raise ValueError(f"unknown pistrec_type {kind!r}; known: "
                         f"{PISTREC_TYPES}")
    parts, z, e = branches(model, cfg, batch, train=train, gen=gen)
    return base.ModelOutput(
        layers.layer_norm(model.ln_out, combine(kind, parts, z)), e)
