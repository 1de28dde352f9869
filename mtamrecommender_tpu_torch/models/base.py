"""Shared model contract: embedding trunk, casting, losses, scoring
(twin of mtamrecommender_tpu/models/base.py).

A model is an ``nn.Module`` made by ``ModelDef.init(gen, cfg, meta)``
and run by ``ModelDef.apply(model, cfg, batch, train=...)``.  Training
takes `compute_loss` (full-catalog softmax cross-entropy plus the L2 of
the lookups, in f32); serving takes `scores_for_eval`.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.func import functional_call

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


# ------------------------------------------------------------ training loss

def l2_of_lookups(embedded: emb_ops.EmbeddedBatch,
                  valid: torch.Tensor) -> torch.Tensor:
    """tf.nn.l2_loss over the looked-up item/category/position/user rows:
    a sum over every position, padding included, zeroed for filler rows
    by ``valid``."""
    v_seq = valid[:, None, None]
    v_row = valid[:, None]
    return 0.5 * ((embedded.item_emb.square() * v_seq).sum()
                  + (embedded.cat_emb.square() * v_seq).sum()
                  + (embedded.pos_emb.square() * v_seq).sum()
                  + (embedded.user_emb.square() * v_row).sum())


def softmax_ce_loss(item_table: torch.Tensor, predict_emb: torch.Tensor,
                    embedded: emb_ops.EmbeddedBatch, batch: Batch,
                    cfg: ModelConfig, valid_vocab: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Full-softmax cross-entropy on the target item, averaged over the
    valid rows, plus the scaled L2 of the lookups."""
    logits = item_logits(item_table, predict_emb, valid_vocab)
    log_probs = torch.log_softmax(logits, dim=-1)
    ce = -log_probs.gather(1, batch.target_id.long()[:, None])[:, 0]
    n_valid = batch.valid.sum().clamp(min=1.0)
    ce_mean = (ce * batch.valid).sum() / n_valid
    l2 = l2_of_lookups(embedded, batch.valid)
    return {"loss": cfg.regulation_rate * l2 + ce_mean, "ce": ce_mean,
            "l2": l2}


class _TrainApply(nn.Module):
    """``model_def.apply(model, ..., train=True)`` as a module, so that
    `functional_call` can run it on cast views of the parameters."""

    def __init__(self, model_def: ModelDef, model: nn.Module,
                 cfg: ModelConfig):
        super().__init__()
        self.model_def, self.model, self.cfg = model_def, model, cfg

    def forward(self, batch: Batch) -> ModelOutput:
        return self.model_def.apply(self.model, self.cfg, batch, train=True)


def compute_loss(model_def: ModelDef, model: nn.Module, cfg: ModelConfig,
                 batch: Batch, valid_vocab: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
    """{"loss", "ce", "l2"} of one training batch, differentiable with
    respect to the model's parameters.

    bfloat16 compute runs the model on bf16 views ``p.to(bf16)`` of the
    f32 master parameters (so gradients flow back through the casts, as
    through JAX's ``cast_floats``) and on a bf16 batch; the loss is f32:
    the prediction and the looked-up rows are upcast, the logits use the
    bf16-rounded item table upcast to f32, and ``valid`` and the targets
    come from the original batch."""
    if model_def.output_mode != "plain":
        raise NotImplementedError(
            f"output mode {model_def.output_mode!r} is not ported yet "
            "(ROADMAP.md, Queue 1)")
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        out = model_def.apply(model, cfg, batch, train=True)
        return softmax_ce_loss(model.embedding.item_table, out.predict_emb,
                               out.embedded, batch, cfg, valid_vocab)
    cast = {f"model.{name}": p.to(dtype)
            for name, p in model.named_parameters()}
    out = functional_call(_TrainApply(model_def, model, cfg), cast,
                          (cast_floats(batch, dtype),))
    return softmax_ce_loss(cast["model.embedding.item_table"].float(),
                           out.predict_emb.float(),
                           cast_floats(out.embedded, torch.float32), batch,
                           cfg, valid_vocab)
