"""RNN baselines: Gru4Rec, Vallina_Gru4Rec, T_SeqRec (twin of
mtamrecommender_tpu/models/rnn.py).

A GRU over the sequence at length ``seq_len - 1`` (the history without
the mask slot), its state gathered at ``seq_len - 2`` (the last history
event; -1, the last position, for an empty history), then a layer norm.
"""

from __future__ import annotations

import torch

from mtamrecommender_tpu_torch.models import base, mtam
from mtamrecommender_tpu_torch.ops import layers, time_gru


def _init(gen: torch.Generator, cfg, meta, rnn: str) -> mtam.MTAM:
    """The embedding, the ``rnn`` cell and ``ln_out``: MTAM's family
    without a readout."""
    return mtam.init_family(gen, cfg, meta, rnn=rnn, att_kind=None)


def gru_head(model: mtam.MTAM, batch, out: torch.Tensor,
             embedded) -> base.ModelOutput:
    """The GRU's state at ``seq_len - 2``, layer-normed by ``ln_out``."""
    intent = layers.gather_positions(out, batch.seq_len - 2)
    return base.ModelOutput(layers.layer_norm(model.ln_out, intent),
                            embedded)


def init_gru4rec(gen, cfg, meta):
    return _init(gen, cfg, meta, "plain")


def apply_gru4rec(model, cfg, batch, *, train, gen=None):
    """Gru4Rec (RNN_baesline_models.py:55-70): plain GRU over the fused
    behavior embedding."""
    e = base.embed(model, batch)
    return gru_head(model, batch, time_gru.gru_net(
        model.rnn, e.behavior_emb, batch.seq_len - 1), e)


def init_vallina_gru4rec(gen, cfg, meta):
    return _init(gen, cfg, meta, "plain")


def apply_vallina_gru4rec(model, cfg, batch, *, train, gen=None):
    """Vallina_Gru4Rec (RNN_baesline_models.py:72-87): plain GRU over the
    raw item embeddings only."""
    e = base.embed(model, batch)
    return gru_head(model, batch, time_gru.gru_net(
        model.rnn, e.item_emb, batch.seq_len - 1), e)


def init_t_seqrec(gen, cfg, meta):
    return _init(gen, cfg, meta, "T-SeqRec")


def apply_t_seqrec(model, cfg, batch, *, train, gen=None):
    """T_SeqRec (RNN_baesline_models.py:33-53): the SLi-Rec style
    time-aware GRU over the behavior embedding and the two time
    features."""
    e = base.embed(model, batch)
    return gru_head(model, batch, time_gru.tseqrec_net(
        model.rnn, e.behavior_emb, batch.time_last, batch.time_now,
        batch.seq_len - 1), e)
