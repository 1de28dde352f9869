"""Full-catalog top-K evaluation: HR@k (recall) and NDCG@k (twin of
mtamrecommender_tpu/train/evaluate.py).

Rank the target item against the entire catalog (predict_emb @
item_table^T, no sampled negatives), HR@k = P(rank < k), NDCG@k =
log 2 / log(rank+2) for hits.  Rank ties break toward the lower item
index, matching tf.nn.top_k's ordering.  Per-batch means are then
averaged across batches with equal weight, a padded last batch
included, as the reference's eval loop does.

Plain PyTorch: the scoring step runs the model's kernels
(`models.base.scores_for_eval`), the metrics are a few tensor ops on the
scores' device.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from mtamrecommender_tpu_torch.config import ModelConfig
from mtamrecommender_tpu_torch.data.device_data import (DeviceDataset,
                                                         gather_batch)
from mtamrecommender_tpu_torch.models import base
from mtamrecommender_tpu_torch.models.base import ModelDef, scores_for_eval
from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
from mtamrecommender_tpu_torch.types import Batch

TOPK: Tuple[int, ...] = (1, 5, 10, 30, 50)


def ranks_from_scores(scores: torch.Tensor, targets: torch.Tensor,
                      offset: int = 0, group=None) -> torch.Tensor:
    """0-based rank of the target under descending score, ties broken by
    lower index first (tf.nn.top_k order).  With ``group`` the scores are
    vocab-parallel, this rank's columns from global index ``offset``: the
    target's score comes from its owner, and each shard's ``greater``
    and ``tie_before``, counted with global indices, are summed over the
    group."""
    targets = targets.long()[:, None]
    cols = scores.shape[1]
    idx = offset + torch.arange(cols, device=scores.device)[None, :]
    if group is None:
        target_score = torch.gather(scores, 1, targets)
    else:
        local = targets - offset
        mine = (local >= 0) & (local < cols)
        picked = torch.gather(scores, 1, local.clamp(0, cols - 1))
        target_score = mesh_lib.all_reduce_(
            torch.where(mine, picked, torch.zeros_like(picked)), group)
    greater = (scores > target_score).sum(dim=1)
    tie_before = ((scores == target_score) & (idx < targets)).sum(dim=1)
    return mesh_lib.all_reduce_(greater + tie_before, group)


def metrics_from_ranks(rank: torch.Tensor, valid: torch.Tensor,
                       ks: Sequence[int] = TOPK) -> Dict[str, torch.Tensor]:
    """HR@k and NDCG@k, means over the valid rows, from the targets'
    0-based ranks."""
    valid = valid.float()
    n = torch.clamp(valid.sum(), min=1.0)
    log2 = torch.log(torch.tensor(2.0, device=rank.device))
    rank_f = rank.float()
    out: Dict[str, torch.Tensor] = {}
    for k in ks:
        hit = (rank < k).float() * valid
        out[f"hr@{k}"] = hit.sum() / n
        ndcg = torch.where(rank < k, log2 / torch.log(rank_f + 2.0),
                           torch.zeros_like(rank_f)) * valid
        out[f"ndcg@{k}"] = ndcg.sum() / n
    return out


def topk_metrics(scores: torch.Tensor, targets: torch.Tensor,
                 valid: torch.Tensor, ks: Sequence[int] = TOPK
                 ) -> Dict[str, torch.Tensor]:
    return metrics_from_ranks(ranks_from_scores(scores, targets), valid, ks)


def auc(scores: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
        gen: Optional[torch.Generator] = None, num_negatives: int = 1,
        negatives: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise AUC against sampled negatives, P(score[target] >
    score[random negative]) — the reference's disabled AUC path made
    usable.  The negatives [B, num_negatives] are drawn from ``gen`` (a
    generator on the scores' device) or given as ``negatives``; torch's
    global generator is never used."""
    b, v = scores.shape
    if negatives is None:
        if gen is None:
            raise ValueError("auc needs gen= (a torch.Generator) or "
                             "negatives=; it never draws from torch's global "
                             "generator")
        negatives = torch.randint(0, v, (b, num_negatives), generator=gen,
                                  device=scores.device)
    pos_s = torch.gather(scores, 1, targets.long()[:, None])
    neg_s = torch.gather(scores, 1, negatives.to(scores.device).long())
    wins = (pos_s > neg_s).float() + 0.5 * (pos_s == neg_s).float()
    valid = valid.float()
    n = torch.clamp(valid.sum(), min=1.0)
    return (wins.mean(dim=1) * valid).sum() / n


class EvalStep:
    """``step(model, batch) -> {metric: 0-dim tensor}``: full-catalog
    scores under ``torch.no_grad()``, then `topk_metrics`.  `cast` makes
    the compute-dtype copy of a model once (`evaluate_dataset` calls it
    once an evaluation); given that copy, a step casts nothing."""

    def __init__(self, model_def: ModelDef, cfg: ModelConfig,
                 ks: Sequence[int] = TOPK, valid_vocab: Optional[int] = None):
        self.model_def, self.cfg = model_def, cfg
        self.ks, self.valid_vocab = tuple(ks), valid_vocab

    def cast(self, model: nn.Module) -> nn.Module:
        return base.cast_floats(model, base.compute_dtype(self.cfg))

    def __call__(self, model: nn.Module,
                 batch: Batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            scores = scores_for_eval(self.model_def, model, self.cfg, batch,
                                     self.valid_vocab)
            return topk_metrics(scores, batch.target_id, batch.valid,
                                self.ks)


def make_eval_step(model_def: ModelDef, cfg: ModelConfig,
                   ks: Sequence[int] = TOPK,
                   valid_vocab: Optional[int] = None) -> EvalStep:
    """One eval step: (model, batch) -> per-batch metric dict."""
    return EvalStep(model_def, cfg, ks, valid_vocab)


def eval_batches(data: DeviceDataset, batch_size: int
                 ) -> Iterator[Tuple[int, Batch]]:
    """(step, Batch) over ``data`` in order, the last batch padded with
    rows of ``valid=0`` (`gather_batch`'s order = -1 slots): the batches
    of the JAX package's unshuffled ``batch_iterator``."""
    n = int(data.seq_len.shape[0])
    n_steps = -(-n // batch_size)
    order = torch.full((n_steps * batch_size,), -1, dtype=torch.int32,
                       device=data.seq_len.device)
    order[:n] = torch.arange(n, dtype=torch.int32, device=order.device)
    for step in range(n_steps):
        yield step, gather_batch(data, order, step, batch_size)


def evaluate_dataset(eval_step: EvalStep, model: nn.Module,
                     batches: Iterable[Tuple[int, Batch]]
                     ) -> Dict[str, float]:
    """Average per-batch metrics across batches (equal weight per batch,
    mirroring train_process.py:268-277).  The model is cast to the
    compute dtype once; the per-batch values reach the host once, at the
    end, and are summed there in batch order."""
    model_c = eval_step.cast(model)
    per_batch = [eval_step(model_c, batch) for _, batch in batches]
    if not per_batch:
        return {}
    keys = list(per_batch[0])
    values = torch.stack([torch.stack([m[k] for k in keys])
                          for m in per_batch]).cpu().tolist()
    sums = dict.fromkeys(keys, 0.0)
    for row in values:
        for k, v in zip(keys, row):
            sums[k] += v
    return {k: v / len(values) for k, v in sums.items()}
