"""Shared model contract: embedding trunk, casting, losses, scoring
(twin of mtamrecommender_tpu/models/base.py).

A model is an ``nn.Module`` made by ``ModelDef.init(gen, cfg, meta)``
and run by ``ModelDef.apply(model, cfg, batch, train=..., gen=...)``:
``gen`` is where a training forward's dropout masks come from, a
generator or an iterator of masks drawn elsewhere, one per dropping
block (`ops.layers.draw_drop_mask`).  Training takes `compute_loss`
(full-catalog softmax cross-entropy plus the L2 of the lookups, in f32);
serving takes `scores_for_eval`.  A model of the "concat" output mode
predicts [B, 2d], which `project_concat` maps through its ``output_w``
[2d, d] before the item table (output_concat).  The "bpr" mode (BPRMF)
trains on `bpr_loss`, a pairwise loss against one shared negative item
a step, and scores as the plain mode does.

Inside a `parallel.sharding.mesh_scope` (one rank's part of a sharded
step) the losses count the valid rows of the global batch, and with the
item table row-sharded over the model axis the logits are vocab-parallel:
`item_logits` gives this shard's columns, padded columns masked by their
global index; `softmax_ce_loss` assembles the log-sum-exp with a
detached max and a sum over the model group and takes the target's logit
from its owner; `scores_for_eval` returns this shard's columns.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.func import functional_call

from mtamrecommender_tpu_torch.config import ModelConfig
from mtamrecommender_tpu_torch.ops import embedding as emb_ops
from mtamrecommender_tpu_torch.ops.kernels.embedding_kernel import take_dtable
from mtamrecommender_tpu_torch.ops.layers import MaskSource
from mtamrecommender_tpu_torch.parallel import embedding_shard
from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
from mtamrecommender_tpu_torch.parallel import sharding
from mtamrecommender_tpu_torch.types import Batch

NEG_FILL = -(2.0 ** 32) + 1.0  # the reference's mask fill


class ModelOutput(NamedTuple):
    predict_emb: torch.Tensor          # [B, d] ([B, 2d] for concat)
    embedded: emb_ops.EmbeddedBatch    # residuals for the L2 term


class ModelDef(NamedTuple):
    name: str
    init: Callable[..., nn.Module]       # (gen, cfg, meta) -> model
    apply: Callable[..., ModelOutput]    # (model, cfg, batch, *, train,
                                         #  gen=None)
    output_mode: str = "plain"           # plain | concat | bpr


def embed(model: nn.Module, batch: Batch) -> emb_ops.EmbeddedBatch:
    return emb_ops.behavior_embedding(model.embedding, batch)


OUTPUT_MODES = ("plain", "concat", "bpr")

# BPRMF's fixed L2 rate (BPRMF.py:59)
BPR_L2_RATE = 5e-5


def _check_output_mode(model_def: ModelDef) -> None:
    if model_def.output_mode not in OUTPUT_MODES:
        raise ValueError(f"unknown output mode {model_def.output_mode!r}; "
                         f"known: {OUTPUT_MODES}")


def project_concat(output_w: torch.Tensor,
                   predict_emb: torch.Tensor) -> torch.Tensor:
    """The concat head's [2d, d] projection before the item table."""
    return torch.matmul(predict_emb, output_w)


def _head(model_def: ModelDef, output_w: Optional[torch.Tensor],
          predict_emb: torch.Tensor) -> torch.Tensor:
    """The prediction the item table scores: in the concat mode projected
    by ``output_w`` upcast to f32 (under bf16 compute the bf16-rounded
    weight, as JAX's loss and scoring take it), else as it is."""
    if model_def.output_mode == "concat":
        return project_concat(output_w.float(), predict_emb)
    return predict_emb


def vocab_shard():
    """(model group, first global row of this rank's item rows) inside a
    `mesh_scope` whose tables are row-sharded; None elsewhere."""
    scope = sharding.active()
    if scope is None or not scope.tables_sharded:
        return None
    mesh = scope.mesh
    return mesh.group(mesh.model_axis_name), mesh.model_index


def table_rows(table: torch.Tensor) -> int:
    """The rows of the whole table of which ``table`` is this rank's
    part (the table itself outside a sharded scope)."""
    scope = sharding.active()
    if scope is None or not scope.tables_sharded:
        return table.shape[0]
    return table.shape[0] * scope.mesh.model


def item_logits(item_table: torch.Tensor, predict_emb: torch.Tensor,
                valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Full-catalog logits against the item table.  ``valid_vocab`` is the
    logical vocab (item_count+3); columns of a padded table past it are
    masked so they can never win a rank.  With the table row-sharded
    (`vocab_shard`), this shard's columns: the prediction enters through
    `copy_to_group`, so its gradient sums the shards' parts."""
    shard = vocab_shard()
    offset = 0
    if shard is not None:
        group, index = shard
        predict_emb = mesh_lib.copy_to_group(predict_emb, group)
        offset = index * item_table.shape[0]
    logits = torch.matmul(predict_emb, item_table.T)
    if valid_vocab is not None and \
            valid_vocab < offset + item_table.shape[0]:
        col = offset + torch.arange(item_table.shape[0],
                                    device=logits.device)
        logits = torch.where(col[None, :] < valid_vocab, logits,
                             torch.full_like(logits, NEG_FILL))
    return logits


def _target_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[target] a row; vocab-parallel where the
    logits are a shard's columns: the log-sum-exp from a detached max
    and a sum over the model group, the target's logit from its owner."""
    target = target.long()
    shard = vocab_shard()
    if shard is None:
        log_probs = torch.log_softmax(logits, dim=-1)
        return -log_probs.gather(1, target[:, None])[:, 0]
    group, index = shard
    rows = logits.shape[1]
    m = mesh_lib.all_reduce_max(logits.amax(dim=1), group)
    sumexp = mesh_lib.reduce_from_group(
        torch.exp(logits - m[:, None]).sum(dim=1), group)
    local = target - index * rows
    mine = (local >= 0) & (local < rows)
    picked = logits.gather(1, local.clamp(0, rows - 1)[:, None])[:, 0]
    target_logit = mesh_lib.reduce_from_group(
        torch.where(mine, picked, torch.zeros_like(picked)), group)
    return m + torch.log(sumexp) - target_logit


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
    the scores are f32 products against the bf16-rounded item table
    (and, in the concat mode, the bf16-rounded ``output_w``)."""
    _check_output_mode(model_def)
    model_c, batch_c = _compute_cast(cfg, model, batch)
    out = model_def.apply(model_c, cfg, batch_c, train=False)
    predict = _head(model_def, getattr(model_c, "output_w", None),
                    out.predict_emb.float())
    return item_logits(model_c.embedding.item_table.float(), predict,
                       valid_vocab)


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
    ce = _target_ce(logits, batch.target_id)
    n_valid = sharding.data_sum(batch.valid.sum()).clamp(min=1.0)
    ce_mean = (ce * batch.valid).sum() / n_valid
    l2 = l2_of_lookups(embedded, batch.valid)
    return {"loss": cfg.regulation_rate * l2 + ce_mean, "ce": ce_mean,
            "l2": l2}


def bpr_loss(item_table: torch.Tensor, item_bias: torch.Tensor,
             embedded: emb_ops.EmbeddedBatch, batch: Batch,
             neg_id: torch.Tensor) -> Dict[str, torch.Tensor]:
    """BPRMF's loss (BPRMF.py:41-61): x = b[pos] - b[neg] + u . (pos -
    neg) against ONE negative item shared by the batch (``neg_id``, [1]),
    -mean(log_sigmoid(x)) over the valid rows plus 5e-5 times the L2 of
    the user, positive and negative rows (the negative's once).  The
    table rows come through `take_dtable` (one lookup of the targets and
    the negative together), the bias rows by indexing.  ``log_sigmoid``
    is the JAX package's documented divergence from the reference's
    ``tf.log(tf.sigmoid(x))``, which underflows to -inf for x below
    about -88.  Under bf16 compute the bias difference is taken in
    bf16 and the rest in f32, as in the JAX package.  Inside an
    `embedding_shard.engine_scope` the rows and biases come through its
    engine."""
    u = embedded.user_emb
    ids = torch.cat([batch.target_id, neg_id.to(batch.target_id.dtype)])
    gather = embedding_shard.active_gather()
    if gather is None:
        rows = take_dtable(item_table, ids)
        bias = item_bias[ids.long(), 0]
    else:
        rows = gather(item_table, ids)
        bias = gather(item_bias, ids)[:, 0]
    pos, neg = rows[:-1], rows[-1:]
    x = (bias[:-1] - bias[-1:]) + (u * (pos - neg)).sum(dim=1)
    valid = batch.valid
    # the negative's L2 is counted once a step: on the first data rank
    neg_l2 = neg.square().sum() * float(sharding.first_data_rank())
    l2 = 0.5 * ((u.square() * valid[:, None]).sum()
                + (pos.square() * valid[:, None]).sum() + neg_l2)
    n_valid = sharding.data_sum(valid.sum()).clamp(min=1.0)
    rank_term = (torch.nn.functional.logsigmoid(x) * valid).sum() / n_valid
    return {"loss": BPR_L2_RATE * l2 - rank_term, "ce": -rank_term,
            "l2": l2}


def draw_negative(gen: Optional[MaskSource], item_count: int,
                  device) -> torch.Tensor:
    """The bpr loss's shared negative, [1] int32 uniform in [0,
    item_count), from the step's generator (JAX draws it with
    ``randint(split(rng)[1], (1,), 0, item_count)``)."""
    if not isinstance(gen, torch.Generator):
        raise ValueError("the bpr loss draws its negative item from a "
                         "torch.Generator: pass gen=, or neg_id=")
    return torch.randint(0, item_count, (1,), generator=gen,
                         device=device, dtype=torch.int32)


def _loss(model_def: ModelDef, item_table, item_bias, output_w, predict,
          embedded, batch: Batch, cfg: ModelConfig,
          valid_vocab: Optional[int], gen, neg_id) -> Dict[str, torch.Tensor]:
    if model_def.output_mode == "bpr":
        if neg_id is None:
            vocab = table_rows(item_table) if valid_vocab is None \
                else valid_vocab
            neg_id = draw_negative(gen, vocab - 3, batch.target_id.device)
        return bpr_loss(item_table, item_bias, embedded, batch, neg_id)
    return softmax_ce_loss(item_table, _head(model_def, output_w, predict),
                           embedded, batch, cfg, valid_vocab)


class _TrainApply(nn.Module):
    """``model_def.apply(model, ..., train=True)`` as a module, so that
    `functional_call` can run it on cast views of the parameters."""

    def __init__(self, model_def: ModelDef, model: nn.Module,
                 cfg: ModelConfig):
        super().__init__()
        self.model_def, self.model, self.cfg = model_def, model, cfg

    def forward(self, batch: Batch, gen=None) -> ModelOutput:
        return self.model_def.apply(self.model, self.cfg, batch, train=True,
                                    gen=gen)


def compute_loss(model_def: ModelDef, model: nn.Module, cfg: ModelConfig,
                 batch: Batch, valid_vocab: Optional[int] = None,
                 gen: Optional[MaskSource] = None,
                 neg_id: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """{"loss", "ce", "l2"} of one training batch, differentiable with
    respect to the model's parameters.  The forward's dropout masks come
    from ``gen`` (none without it, as in the JAX package without an
    rng).  The bpr mode's negative item is ``neg_id`` ([1] int) where
    given, else drawn from ``gen`` after the forward, in [0, vocab - 3)
    (``ce`` is then the negated rank term).

    bfloat16 compute runs the model on bf16 views ``p.to(bf16)`` of the
    f32 master parameters (so gradients flow back through the casts, as
    through JAX's ``cast_floats``) and on a bf16 batch; the loss is f32:
    the prediction and the looked-up rows are upcast, the logits use the
    bf16-rounded item table (and concat head) upcast to f32, and
    ``valid`` and the targets come from the original batch."""
    _check_output_mode(model_def)
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        out = model_def.apply(model, cfg, batch, train=True, gen=gen)
        return _loss(model_def, model.embedding.item_table,
                     getattr(model, "item_bias", None),
                     getattr(model, "output_w", None), out.predict_emb,
                     out.embedded, batch, cfg, valid_vocab, gen, neg_id)
    cast = {f"model.{name}": p.to(dtype)
            for name, p in model.named_parameters()}
    out = functional_call(_TrainApply(model_def, model, cfg), cast,
                          (cast_floats(batch, dtype), gen))
    return _loss(model_def, cast["model.embedding.item_table"].float(),
                 cast.get("model.item_bias"), cast.get("model.output_w"),
                 out.predict_emb.float(),
                 cast_floats(out.embedded, torch.float32), batch, cfg,
                 valid_vocab, gen, neg_id)
