"""Behavior-sequence embedding (twin of mtamrecommender_tpu/ops/embedding.py).

Four lookup tables (user/item/category/position, each with +3 vocab
slack rows) and the fused behavior embedding
``ReLU(concat(item_emb, cat_emb) @ dense_w) + position_emb``.  Every
lookup is `take_dtable` (ops/kernels/embedding_kernel.py): a row gather
whose table gradient is the `dtable` kernel.  The JAX package routes its
table backwards by TPU thresholds (a one-hot matmul, XLA's scatter or
its Pallas dtable kernel); all three compute the same sum, which the
port always takes through its one kernel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from mtamrecommender_tpu_torch.ops import initializers as init
from mtamrecommender_tpu_torch.ops.kernels.embedding_kernel import take_dtable
from mtamrecommender_tpu_torch.ops.layers import ParamModule
from mtamrecommender_tpu_torch.types import Batch, DatasetMeta


class EmbeddedBatch(NamedTuple):
    user_emb: torch.Tensor       # [B, d]
    behavior_emb: torch.Tensor   # [B, L, d]
    item_emb: torch.Tensor       # [B, L, d]
    cat_emb: torch.Tensor        # [B, L, d]
    pos_emb: torch.Tensor        # [B, L, d]


def pad_vocab(count: int, multiple: int) -> int:
    """Round a vocab size up to a multiple.  Padded rows are physical
    only: logits for ids >= the logical vocab are masked in
    models/base.item_logits."""
    if multiple <= 1:
        return count
    return ((count + multiple - 1) // multiple) * multiple


def init_behavior_embedding(gen: torch.Generator, meta: DatasetMeta,
                            num_units: int, vocab_pad_multiple: int = 1
                            ) -> Dict[str, torch.Tensor]:
    pad = lambda n: pad_vocab(n, vocab_pad_multiple)  # noqa: E731
    return {
        "user_table": init.embedding_uniform(gen, (pad(meta.user_vocab), num_units)),
        "item_table": init.embedding_uniform(gen, (pad(meta.item_vocab), num_units)),
        "cat_table": init.embedding_uniform(gen, (pad(meta.category_vocab), num_units)),
        "pos_table": init.embedding_uniform(gen, (pad(meta.position_vocab), num_units)),
        # relu dense over concat(item, cat), use_bias=False
        "dense_w": init.glorot_uniform(gen, (2 * num_units, num_units)),
    }


class BehaviorEmbedding(ParamModule):
    """Parameters ``user_table``, ``item_table``, ``cat_table``,
    ``pos_table`` [vocab, d] and ``dense_w`` [2d, d]."""


def behavior_embedding(p: BehaviorEmbedding, batch: Batch) -> EmbeddedBatch:
    user_emb = take_dtable(p.user_table, batch.user_id)
    item_emb = take_dtable(p.item_table, batch.items)
    cat_emb = take_dtable(p.cat_table, batch.cats)
    pos_emb = take_dtable(p.pos_table, batch.positions)
    concat = torch.cat([item_emb, cat_emb], dim=-1)
    behavior = torch.relu(torch.matmul(concat, p.dense_w)) + pos_emb
    return EmbeddedBatch(user_emb=user_emb, behavior_emb=behavior,
                         item_emb=item_emb, cat_emb=cat_emb, pos_emb=pos_emb)
