"""MTAM (twin of mtamrecommender_tpu/models/mtam.py, the MTAM entry).

A short-term-intent encoder (the T-GRU over the behavior sequence), a
gather at the last history position, and a multi-hop single-query
time-aware attention readout over the behavior embeddings, then a layer
norm.  The ablations of the JAX module come in a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from mtamrecommender_tpu_torch.config import ModelConfig
from mtamrecommender_tpu_torch.models import base
from mtamrecommender_tpu_torch.ops import attention, layers, time_gru
from mtamrecommender_tpu_torch.ops.embedding import (BehaviorEmbedding,
                                                     init_behavior_embedding)
from mtamrecommender_tpu_torch.types import Batch, DatasetMeta


class MTAM(nn.Module):
    """Parameter names follow the JAX key paths: ``embedding.*``,
    ``rnn.*``, ``att.<hop>.*`` and ``ln_out.*``."""

    def __init__(self, params: dict):
        super().__init__()
        self.embedding = BehaviorEmbedding(params["embedding"])
        self.rnn = time_gru.TimeGRU(params["rnn"])
        self.att = nn.ModuleList(attention.TimeAttentionBlock(p)
                                 for p in params["att"])
        self.ln_out = layers.LayerNorm(params["ln_out"])


def _init_common(gen: torch.Generator, cfg: ModelConfig,
                 meta: DatasetMeta) -> dict:
    """MTAM's parameters: T-GRU ("new" cell) and time-kind attention (the
    ablations' other cells and kinds are not ported yet)."""
    d = cfg.num_units
    return {
        "embedding": init_behavior_embedding(
            gen, meta, d, vocab_pad_multiple=cfg.vocab_pad_multiple),
        "ln_out": layers.init_layer_norm(d, gen.device),
        "rnn": time_gru.init_tgru(gen, d, d),
        "att": attention.init_attention_stack(
            gen, cfg.num_blocks, d, kind="time", t_q_len=1,
            t_k_len=meta.max_seq_len, gate_mode=cfg.time_gate_mode),
    }


def _intent(model: MTAM, cfg: ModelConfig, batch: Batch, embedded):
    """Short-term intent: T-GRU over the behavior sequence, gathered at
    seq_len - 2 (the last history event).  The recurrence length is
    seq_len - 1, the history without the mask slot."""
    out = time_gru.time_aware_gru_net(
        model.rnn, "new", embedded.behavior_emb, batch.time_last,
        batch.time_now, batch.seq_len - 1)
    return out, layers.gather_positions(out, batch.seq_len - 2)


def _readout(model: MTAM, cfg: ModelConfig, batch: Batch, memory,
             intent, train: bool) -> torch.Tensor:
    """Multi-hop single-query attention over the memory: hop-batched in
    training, hop by hop on the attention kernel in serving."""
    ones = torch.ones_like(batch.seq_len)
    return attention.vanilla_attention_stack(
        model.att, memory, intent[:, None, :], key_len=batch.seq_len,
        query_len=ones, kind="time", num_heads=cfg.num_heads,
        t_queries=batch.target_time[:, None], t_keys=batch.times,
        train=train)


def init_mtam(gen: torch.Generator, cfg: ModelConfig,
              meta: DatasetMeta) -> MTAM:
    """A fresh MTAM on the generator's device."""
    return MTAM(_init_common(gen, cfg, meta))


def apply_mtam(model: MTAM, cfg: ModelConfig, batch: Batch, *,
               train: bool) -> base.ModelOutput:
    """T-GRU intent -> time-aware multi-hop attention over the raw
    behavior embeddings -> layer norm.  MTAM draws no random numbers;
    ``train`` picks the readout's route, not its math."""
    e = base.embed(model, batch)
    _, intent = _intent(model, cfg, batch, e)
    hybrid = _readout(model, cfg, batch, e.behavior_emb, intent, train)
    return base.ModelOutput(layers.layer_norm(model.ln_out, hybrid), e)
