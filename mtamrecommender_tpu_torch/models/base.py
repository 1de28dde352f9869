"""Shared model contract: embedding trunk, casting, scoring (twin of
mtamrecommender_tpu/models/base.py, serving part).

A model is an ``nn.Module`` made by ``ModelDef.init(gen, cfg, meta)``
and run by ``ModelDef.apply(model, cfg, batch, train=...)``.  Losses
come with the training slice.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from mtamrecommender_tpu_torch.config import ModelConfig
from mtamrecommender_tpu_torch.ops import embedding as emb_ops
from mtamrecommender_tpu_torch.types import Batch

NEG_FILL = -(2.0 ** 32) + 1.0  # the reference's mask fill


class ModelOutput(NamedTuple):
    predict_emb: torch.Tensor          # [B, d]
    embedded: emb_ops.EmbeddedBatch    # residuals for the L2 term


class ModelDef(NamedTuple):
    name: str
    init: Callable[..., nn.Module]       # (gen, cfg, meta) -> model
    apply: Callable[..., ModelOutput]    # (model, cfg, batch, *, train)
    output_mode: str = "plain"           # plain | concat | bpr


def embed(model: nn.Module, batch: Batch) -> emb_ops.EmbeddedBatch:
    return emb_ops.behavior_embedding(model.embedding, batch)


def item_logits(item_table: torch.Tensor, predict_emb: torch.Tensor,
                valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Full-catalog logits against the item table.  ``valid_vocab`` is the
    logical vocab (item_count+3); columns of a padded table past it are
    masked so they can never win a rank."""
    logits = torch.matmul(predict_emb, item_table.T)
    if valid_vocab is not None and valid_vocab < item_table.shape[0]:
        col = torch.arange(item_table.shape[0], device=logits.device)
        logits = torch.where(col[None, :] < valid_vocab, logits,
                             torch.full_like(logits, NEG_FILL))
    return logits


def cast_floats(x: Any, dtype: torch.dtype) -> Any:
    """Cast the floating tensors of a module (a copy, unless it is already
    in ``dtype``), of a NamedTuple of tensors, or of one tensor."""
    if isinstance(x, nn.Module):
        if all(p.dtype == dtype for p in x.parameters()
               if p.is_floating_point()):
            return x
        return copy.deepcopy(x).to(dtype)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(cast_floats(f, dtype) for f in x))
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return _COMPUTE_DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; "
                         f"known: {sorted(_COMPUTE_DTYPES)}") from None


def _compute_cast(cfg: ModelConfig, model: nn.Module, batch: Batch):
    """bfloat16 compute: bf16 parameters and activations, including every
    float of the batch (the hour stamps too, which lose their low bits
    in bf16, exactly as in the JAX package)."""
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        return model, batch
    return cast_floats(model, dtype), cast_floats(batch, dtype)


def scores_for_eval(model_def: ModelDef, model: nn.Module, cfg: ModelConfig,
                    batch: Batch, valid_vocab: Optional[int] = None
                    ) -> torch.Tensor:
    """Full-catalog ranking scores [B, vocab] in f32.  Under bf16 compute
    the scores are f32 products against the bf16-rounded item table."""
    if model_def.output_mode != "plain":
        raise NotImplementedError(
            f"output mode {model_def.output_mode!r} is not ported yet")
    model_c, batch_c = _compute_cast(cfg, model, batch)
    out = model_def.apply(model_c, cfg, batch_c, train=False)
    return item_logits(model_c.embedding.item_table.float(),
                       out.predict_emb.float(), valid_vocab)
