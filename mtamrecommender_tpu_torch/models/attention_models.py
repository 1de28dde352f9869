"""Self-attention baselines: SASRec, time-aware SA, TiSASRec (twin of
mtamrecommender_tpu/models/attention_models.py).

The behavior embedding goes through `num_blocks` self-attention blocks
(queries = keys = the sequence, key and query lengths = seq_len), is
gathered at ``seq_len - 1`` (the mask-token slot; the RNN family
gathers one earlier), then layer-normed.  Every block's middle is the
`fused_attention` kernel and its backward: plain (SASrec), time
(Time_Aware_Self_Attention_Model, whose [L, L] gate params are indexed
by query and key position) or tisas (Ti_Self_Attention_Model).  SASrec
and TiSAS drop attention weights in training with one mask per block
from ``gen`` (`layers.draw_drop_mask`); the time kind never drops.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mtamrecommender_tpu_torch.config import ModelConfig
from mtamrecommender_tpu_torch.models import base
from mtamrecommender_tpu_torch.ops import attention, layers
from mtamrecommender_tpu_torch.ops.embedding import (BehaviorEmbedding,
                                                     init_behavior_embedding)
from mtamrecommender_tpu_torch.types import Batch, DatasetMeta

_BLOCKS = {"plain": attention.MHABlock, "tisas": attention.MHABlock,
           "time": attention.TimeAttentionBlock}


class SelfAttentionModel(nn.Module):
    """Parameter names follow the JAX key paths: ``embedding.*``,
    ``att.<block>.*`` and ``ln_out.*``."""

    def __init__(self, params: dict, kind: str):
        super().__init__()
        self.embedding = BehaviorEmbedding(params["embedding"])
        self.att = nn.ModuleList(_BLOCKS[kind](p) for p in params["att"])
        self.ln_out = layers.LayerNorm(params["ln_out"])


def _init(gen: torch.Generator, cfg: ModelConfig, meta: DatasetMeta,
          kind: str) -> SelfAttentionModel:
    d = cfg.num_units
    return SelfAttentionModel({
        "embedding": init_behavior_embedding(
            gen, meta, d, vocab_pad_multiple=cfg.vocab_pad_multiple),
        "att": attention.init_attention_stack(
            gen, cfg.num_blocks, d, kind=kind, t_q_len=meta.max_seq_len,
            t_k_len=meta.max_seq_len, gate_mode=cfg.time_gate_mode),
        "ln_out": layers.init_layer_norm(d, gen.device),
    }, kind)


def _apply(model: SelfAttentionModel, cfg: ModelConfig, batch: Batch,
           kind: str, train: bool,
           gen: Optional[layers.MaskSource]) -> base.ModelOutput:
    e = base.embed(model, batch)
    enc = attention.self_attention_stack(
        model.att, e.behavior_emb, key_len=batch.seq_len,
        query_len=batch.seq_len, kind=kind, num_heads=cfg.num_heads,
        dropout_rate=cfg.dropout, train=train, gen=gen,
        t_queries=batch.times, t_keys=batch.times)
    pred = layers.gather_positions(enc, batch.seq_len - 1)
    return base.ModelOutput(layers.layer_norm(model.ln_out, pred), e)


def init_sasrec(gen, cfg, meta):
    return _init(gen, cfg, meta, "plain")


def apply_sasrec(model, cfg, batch, *, train, gen=None):
    """Self_Attention_Model (attention_baseline_models.py:33-46)."""
    return _apply(model, cfg, batch, "plain", train, gen)


def init_time_aware_sa(gen, cfg, meta):
    return _init(gen, cfg, meta, "time")


def apply_time_aware_sa(model, cfg, batch, *, train, gen=None):
    """Time_Aware_Self_Attention_Model (attention_baseline_models.py:47-65):
    multiplicative decay-gated self-attention; draws nothing."""
    return _apply(model, cfg, batch, "time", train, gen)


def init_tisas(gen, cfg, meta):
    return _init(gen, cfg, meta, "tisas")


def apply_tisas(model, cfg, batch, *, train, gen=None):
    """Ti_Self_Attention_Model / TiSASRec (attention_baseline_models.py:66-84):
    additive log-interval attention bias."""
    return _apply(model, cfg, batch, "tisas", train, gen)
