"""Behavior-sequence embedding (twin of mtamrecommender_tpu/ops/embedding.py).

Four lookup tables (user/item/category/position, each with +3 vocab
slack rows) and the fused behavior embedding
``ReLU(concat(item_emb, cat_emb) @ dense_w) + position_emb``.  By default
every lookup is `take_dtable` (ops/kernels/embedding_kernel.py): a row
gather whose table gradient is the `dtable` kernel; ``gather=`` swaps in
another lookup, as in the JAX package: `embedding_kernel.gather` takes
the gather kernel, with the scatter-add kernel as its backward.  Inside a
`parallel.embedding_shard.engine_scope` (a sharded step with row-sharded
tables) the default lookup is the scope's engine (`active_gather`), as
JAX's `gather_rows` routes.  The JAX package routes its
table backwards by TPU thresholds (a one-hot matmul, XLA's scatter or
its Pallas dtable kernel); all three compute the same sum, which the
port always takes through its one kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from mtamrecommender_tpu_torch.ops import initializers as init
from mtamrecommender_tpu_torch.ops.kernels.embedding_kernel import take_dtable
from mtamrecommender_tpu_torch.ops.layers import ParamModule
from mtamrecommender_tpu_torch.parallel import embedding_shard
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


def behavior_embedding(p: BehaviorEmbedding, batch: Batch,
                       gather: Optional[Callable] = None) -> EmbeddedBatch:
    """The four lookups through ``gather(table, ids)`` (by default the
    active engine's inside an `embedding_shard.engine_scope`, else
    `take_dtable`) and the fused behavior embedding."""
    if gather is None:
        gather = embedding_shard.active_gather() or take_dtable
    user_emb = gather(p.user_table, batch.user_id)
    item_emb = gather(p.item_table, batch.items)
    cat_emb = gather(p.cat_table, batch.cats)
    pos_emb = gather(p.pos_table, batch.positions)
    concat = torch.cat([item_emb, cat_emb], dim=-1)
    behavior = torch.relu(torch.matmul(concat, p.dense_w)) + pos_emb
    return EmbeddedBatch(user_emb=user_emb, behavior_emb=behavior,
                         item_emb=item_emb, cat_emb=cat_emb, pos_emb=pos_emb)
