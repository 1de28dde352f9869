"""MTAM and its ablations (twin of mtamrecommender_tpu/models/mtam.py).

Each shares a short-term-intent encoder (a GRU variant over the behavior
sequence), a gather at the last history position, and, where the model
has one, a multi-hop single-query attention readout over a memory (the
behavior embeddings, or the GRU's states in the ``via`` models), then a
layer norm.  The cells: "new" (T-GRU), "T-SeqRec" and "plain".  The
readout is time-aware, except in MTAM_no_time_aware_att: the plain
kind, with attention-weight dropout in training and no layer norm.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mtamrecommender_tpu_torch.config import ModelConfig
from mtamrecommender_tpu_torch.models import base
from mtamrecommender_tpu_torch.ops import attention, initializers, layers
from mtamrecommender_tpu_torch.ops import time_gru
from mtamrecommender_tpu_torch.ops.embedding import (BehaviorEmbedding,
                                                     init_behavior_embedding)
from mtamrecommender_tpu_torch.types import Batch, DatasetMeta


class MTAM(nn.Module):
    """MTAM, its ablations and the RNN baselines (models/rnn.py).
    Parameter names follow the JAX key paths: ``embedding.*``, ``rnn.*``,
    and where the model has them ``att.<hop>.*``, ``ln_intent.*``, then
    ``ln_out.*`` and ``output_w``."""

    def __init__(self, params: dict, rnn: str):
        super().__init__()
        self.embedding = BehaviorEmbedding(params["embedding"])
        self.rnn = (time_gru.GRU(params["rnn"]) if rnn == "plain"
                    else time_gru.TimeGRU(params["rnn"]))
        if "att" in params:
            self.att = nn.ModuleList(attention.attention_block(p)
                                     for p in params["att"])
        if "ln_intent" in params:
            self.ln_intent = layers.LayerNorm(params["ln_intent"])
        self.ln_out = layers.LayerNorm(params["ln_out"])
        if "output_w" in params:
            self.output_w = nn.Parameter(params["output_w"])


def init_family(gen: torch.Generator, cfg: ModelConfig, meta: DatasetMeta,
                *, rnn: str, att_kind: Optional[str],
                ln_intent: bool = False, concat_output: bool = False) -> MTAM:
    """A fresh model: the ``rnn`` cell ("plain", "new" or "T-SeqRec"),
    an attention stack of ``att_kind`` (None: none), the intent's layer
    norm, and the concat head's output_w drawn from U(±sqrt(6 / 3d))."""
    d = cfg.num_units
    params = {
        "embedding": init_behavior_embedding(
            gen, meta, d, vocab_pad_multiple=cfg.vocab_pad_multiple),
        "ln_out": layers.init_layer_norm(d, gen.device),
        "rnn": (time_gru.init_gru(gen, d, d) if rnn == "plain"
                else time_gru.init_time_aware_gru(gen, rnn, d, d)),
    }
    if att_kind is not None:
        params["att"] = attention.init_attention_stack(
            gen, cfg.num_blocks, d, kind=att_kind, t_q_len=1,
            t_k_len=meta.max_seq_len, gate_mode=cfg.time_gate_mode)
    if ln_intent:
        params["ln_intent"] = layers.init_layer_norm(d, gen.device)
    if concat_output:
        limit = (6.0 / (3 * d)) ** 0.5
        params["output_w"] = initializers.uniform(gen, (2 * d, d), -limit,
                                                  limit)
    return MTAM(params, rnn)


def _intent(model: MTAM, batch: Batch, embedded, rnn: str):
    """Short-term intent: the GRU over the behavior sequence, gathered at
    seq_len - 2 (the last history event).  The recurrence length is
    seq_len - 1, the history without the mask slot.  Returns (the GRU's
    states [B, L, d], the intent [B, d])."""
    lengths = batch.seq_len - 1
    if rnn == "plain":
        out = time_gru.gru_net(model.rnn, embedded.behavior_emb, lengths)
    else:
        out = time_gru.time_aware_gru_net(
            model.rnn, rnn, embedded.behavior_emb, batch.time_last,
            batch.time_now, lengths)
    return out, layers.gather_positions(out, batch.seq_len - 2)


def _readout(model: MTAM, cfg: ModelConfig, batch: Batch, memory,
             intent, train: bool, kind: str = "time",
             gen: Optional[layers.MaskSource] = None) -> torch.Tensor:
    """Multi-hop single-query attention of ``kind`` over the memory.  The
    route depends on the kind and the memory's length
    (`attention.vanilla_attention_stack`): in the time kind, over 256 to
    1024 keys the whole readout is one fused readout kernel call per
    direction, in training and serving; below 256 keys training batches
    the projections across hops and runs the query chain in one
    readout_chain kernel call per direction, past 1024 keys in plain
    PyTorch.  The plain kind trains in plain PyTorch at every length,
    dropping attention weights at ``cfg.dropout`` with one mask a hop
    from ``gen``.  Outside 256 to 1024 time keys serving runs hop by hop
    on the attention kernel.  The key length is seq_len, the mask slot
    included, whichever the memory."""
    ones = torch.ones_like(batch.seq_len)
    return attention.vanilla_attention_stack(
        model.att, memory, intent[:, None, :], key_len=batch.seq_len,
        query_len=ones, kind=kind, num_heads=cfg.num_heads,
        t_queries=batch.target_time[:, None], t_keys=batch.times,
        dropout_rate=cfg.dropout, train=train, gen=gen)


def _apply(model: MTAM, cfg: ModelConfig, batch: Batch, train: bool, *,
           rnn: str, memory: str = "embedding", hybrid: bool = False,
           kind: str = "time", ln_readout: bool = True,
           gen: Optional[layers.MaskSource] = None) -> base.ModelOutput:
    """The family's forward.  Without an attention stack the prediction
    is the layer-normed intent.  ``memory`` "states" attends over the
    GRU's states with a layer-normed intent (the ``via`` models);
    ``hybrid`` predicts [intent, ln_out(readout)] for the concat head;
    without ``ln_readout`` the readout is the prediction as it is.  Only
    the plain ``kind`` draws random numbers (its dropout masks, from
    ``gen``); ``train`` and the history's length pick the time
    readout's route, not its math."""
    e = base.embed(model, batch)
    states, intent = _intent(model, batch, e, rnn)
    if not hasattr(model, "att"):
        return base.ModelOutput(layers.layer_norm(model.ln_out, intent), e)
    if memory == "states":
        intent = layers.layer_norm(model.ln_intent, intent)
        mem = states
    else:
        mem = e.behavior_emb
    readout = _readout(model, cfg, batch, mem, intent, train, kind, gen)
    if not ln_readout:
        return base.ModelOutput(readout, e)
    readout = layers.layer_norm(model.ln_out, readout)
    if hybrid:
        return base.ModelOutput(torch.cat([intent, readout], dim=1), e)
    return base.ModelOutput(readout, e)


# ------------------------------------------------------------ the family

def init_mtam(gen, cfg, meta):
    """A fresh MTAM on the generator's device."""
    return init_family(gen, cfg, meta, rnn="new", att_kind="time")


def apply_mtam(model, cfg, batch, *, train, gen=None):
    """MTAM (MTAMRec_model.py:61-92): T-GRU intent -> time-aware
    multi-hop attention over the raw behavior embeddings -> layer
    norm."""
    return _apply(model, cfg, batch, train, rnn="new")


def init_t_gru(gen, cfg, meta):
    return init_family(gen, cfg, meta, rnn="T-SeqRec", att_kind=None)


def apply_t_gru(model, cfg, batch, *, train, gen=None):
    """MTAM_only_time_aware_RNN (MTAMRec_model.py:40-59): the T-SeqRec
    cell's intent, layer-normed; no attention."""
    return _apply(model, cfg, batch, train, rnn="T-SeqRec")


def init_mtam_no_time_rnn(gen, cfg, meta):
    return init_family(gen, cfg, meta, rnn="plain", att_kind="time")


def apply_mtam_no_time_rnn(model, cfg, batch, *, train, gen=None):
    """MTAM_no_time_aware_rnn (MTAMRec_model.py:93-127): MTAM with the
    plain GRU."""
    return _apply(model, cfg, batch, train, rnn="plain")


def init_mtam_no_time_att(gen, cfg, meta):
    return init_family(gen, cfg, meta, rnn="new", att_kind="plain")


def apply_mtam_no_time_att(model, cfg, batch, *, train, gen=None):
    """MTAM_no_time_aware_att (MTAMRec_model.py:128-164): the T-GRU's
    intent, then the plain multi-hop readout over the behavior
    embeddings, with attention-weight dropout in training.  The
    reference does not layer-norm this readout (:158), so ``ln_out``
    gets no gradient."""
    return _apply(model, cfg, batch, train, rnn="new", kind="plain",
                  ln_readout=False, gen=gen)


def init_mtam_via_t_gru(gen, cfg, meta):
    return init_family(gen, cfg, meta, rnn="new", att_kind="time",
                       ln_intent=True)


def apply_mtam_via_t_gru(model, cfg, batch, *, train, gen=None):
    """MTAM_via_T_GRU (MTAMRec_model.py:167-205): memory = the T-GRU's
    states; intent layer-normed before the attention."""
    return _apply(model, cfg, batch, train, rnn="new", memory="states")


def init_mtam_via_rnn(gen, cfg, meta):
    return init_family(gen, cfg, meta, rnn="plain", att_kind="time",
                       ln_intent=True)


def apply_mtam_via_rnn(model, cfg, batch, *, train, gen=None):
    """MTAM_via_rnn (MTAMRec_model.py:206-239): memory = the plain GRU's
    states."""
    return _apply(model, cfg, batch, train, rnn="plain", memory="states")


def init_mtam_hybird(gen, cfg, meta):
    return init_family(gen, cfg, meta, rnn="new", att_kind="time",
                       concat_output=True)


def apply_mtam_hybird(model, cfg, batch, *, train, gen=None):
    """MTAM_hybird (MTAMRec_model.py:240-273): concat(intent,
    ln(attention)) -> the concat head."""
    return _apply(model, cfg, batch, train, rnn="new", hybrid=True)


def init_mtam_with_t_seqrec(gen, cfg, meta):
    return init_family(gen, cfg, meta, rnn="T-SeqRec", att_kind="time")


def apply_mtam_with_t_seqrec(model, cfg, batch, *, train, gen=None):
    """MTAM_with_T_SeqRec (MTAMRec_model.py:275-306): MTAM with the
    T-SeqRec cell."""
    return _apply(model, cfg, batch, train, rnn="T-SeqRec")
