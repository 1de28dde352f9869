"""BPRMF: matrix factorization with a pairwise BPR loss (twin of
mtamrecommender_tpu/models/bprmf.py).

The forward is the user embedding; the "bpr" output mode's loss, with
one shared negative a step and the item bias, is `models.base.bpr_loss`,
and scoring is the plain mode's: user_emb @ item_table^T, no bias.
"""

from __future__ import annotations

from torch import nn

from mtamrecommender_tpu_torch.models import base
from mtamrecommender_tpu_torch.ops import initializers as init
from mtamrecommender_tpu_torch.ops.embedding import (BehaviorEmbedding,
                                                     init_behavior_embedding,
                                                     pad_vocab)


class BPRMF(nn.Module):
    """``embedding.*`` and ``item_bias`` [padded item vocab, 1]."""

    def __init__(self, params: dict):
        super().__init__()
        self.embedding = BehaviorEmbedding(params["embedding"])
        self.item_bias = nn.Parameter(params["item_bias"])


def init_bprmf(gen, cfg, meta):
    return BPRMF({
        "embedding": init_behavior_embedding(
            gen, meta, cfg.num_units,
            vocab_pad_multiple=cfg.vocab_pad_multiple),
        # the item bias table [item_count+3, 1] (BPRMF.py:34-35)
        "item_bias": init.embedding_uniform(
            gen, (pad_vocab(meta.item_vocab, cfg.vocab_pad_multiple), 1)),
    })


def apply_bprmf(model, cfg, batch, *, train, gen=None):
    e = base.embed(model, batch)
    return base.ModelOutput(e.user_emb, e)
