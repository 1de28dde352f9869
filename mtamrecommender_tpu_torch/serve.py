"""Batch inference / serving: raw histories -> top-k recommendations
(twin of mtamrecommender_tpu/serve.py).

A `Recommender` wraps a registry model with one scoring step:

    scores = model(batch).predict_emb @ item_table^T        (vocab-masked)
    top-k with torch.topk on the device, ids + scores to the host

History tensors are built with the same windowing and time-feature rules
as training: pass raw (item, category, unix_seconds) event triples and a
request time.  The scoring step runs on CUDA unless the caller passes
``device="cpu"``, where the kernels' plain twins run instead.
Restoring from a checkpoint (``from_checkpoint``) and the JSON-lines
service (``main``) are not ported yet: they wait for the checkpoint
module (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mtamrecommender_tpu_torch.bridge import load_jax_params
from mtamrecommender_tpu_torch.config import ExperimentConfig
from mtamrecommender_tpu_torch.models import base
from mtamrecommender_tpu_torch.models.base import ModelDef, scores_for_eval
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.types import Batch, DatasetMeta, batch_from_numpy


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    return device


class Recommender:
    """``model_or_params`` is a model of the port (an nn.Module) or the JAX
    package's parameter pytree, converted by `bridge.load_jax_params`."""

    def __init__(self, cfg: ExperimentConfig, meta: DatasetMeta,
                 model_or_params, device=None,
                 model_def: Optional[ModelDef] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.meta = meta
        self.model_def = model_def or get_model(cfg.model.experiment_type)
        if isinstance(model_or_params, nn.Module):
            model = model_or_params
        else:
            skeleton = self.model_def.init(torch.Generator().manual_seed(0),
                                           cfg.model, meta)
            model = load_jax_params(skeleton, model_or_params)
        self.model = model.to(self.device)
        # the compute-dtype copy is made once, not per request
        self._model_c = base.cast_floats(self.model,
                                         base.compute_dtype(cfg.model))

    # ------------------------------------------------------------ scoring

    def _score_impl(self, batch: Batch, k: int):
        with torch.no_grad():
            scores = scores_for_eval(self.model_def, self._model_c,
                                     self.cfg.model, batch,
                                     self.meta.item_vocab)
            top_scores, top_ids = torch.topk(scores, k, dim=1)
        return top_ids, top_scores

    def batch_from_histories(
            self,
            histories: Sequence[Sequence[Tuple[int, int, float]]],
            request_times: Sequence[float],
            user_ids: Optional[Sequence[int]] = None) -> Batch:
        """(item, category, unix_seconds) event triples -> a scoring Batch.

        Reproduces the training-side example layout (windowed last
        max_seq_len-1 events, hours, mask token, timelast/timenow with the
        request time standing in for the target time)."""
        L = self.meta.max_seq_len
        B = len(histories)
        items = np.zeros((B, L), np.int32)
        cats = np.zeros((B, L), np.int32)
        times = np.zeros((B, L), np.float32)
        tl = np.zeros((B, L), np.float32)
        tn = np.zeros((B, L), np.float32)
        pos = np.zeros((B, L), np.int32)
        slen = np.zeros((B,), np.int32)
        t_req = np.zeros((B,), np.float32)
        for b, events in enumerate(histories):
            ev = sorted(events, key=lambda e: e[2])[-(L - 1):]
            req_hour = int(request_times[b] // 3600)
            hours = [int(t // 3600) for (_, _, t) in ev]
            n = len(ev)
            for i, (item, cat, _) in enumerate(ev):
                items[b, i] = item
                cats[b, i] = cat
                times[b, i] = hours[i]
                tl[b, i] = 0 if i == 0 else hours[i] - hours[i - 1]
                tn[b, i] = req_hour - hours[i]
                pos[b, i] = i
            items[b, n] = self.meta.item_count + 1
            cats[b, n] = self.meta.category_count + 1
            times[b, n] = req_hour
            pos[b, n] = min(n, L - 1)
            slen[b] = n + 1
            t_req[b] = req_hour
        uids = np.asarray(user_ids, np.int32) if user_ids is not None \
            else np.zeros((B,), np.int32)
        return batch_from_numpy(dict(
            user_id=uids, items=items, cats=cats, times=times,
            time_last=tl, time_now=tn, positions=pos,
            target_id=np.zeros((B,), np.int32),
            target_cat=np.zeros((B,), np.int32), target_time=t_req,
            seq_len=slen, valid=np.ones((B,), np.float32)), self.device)

    def recommend(self,
                  histories: Sequence[Sequence[Tuple[int, int, float]]],
                  request_times: Sequence[float],
                  k: int = 10,
                  user_ids: Optional[Sequence[int]] = None,
                  exclude_history: bool = True
                  ) -> List[List[Tuple[int, float]]]:
        """Top-k (item_id, score) per request."""
        batch = self.batch_from_histories(histories, request_times, user_ids)
        fetch = k + self.meta.max_seq_len if exclude_history else k
        fetch = min(fetch, self.meta.item_vocab)
        ids, scores = self._score_impl(batch, fetch)
        ids = ids.cpu().numpy()
        scores = scores.cpu().numpy()
        out: List[List[Tuple[int, float]]] = []
        for b, events in enumerate(histories):
            seen = {e[0] for e in events} if exclude_history else set()
            recs = [(int(i), float(s)) for i, s in zip(ids[b], scores[b])
                    if int(i) not in seen][:k]
            out.append(recs)
        return out
