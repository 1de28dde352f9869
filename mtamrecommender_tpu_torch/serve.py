"""Batch inference / serving: raw histories -> top-k recommendations
(twin of mtamrecommender_tpu/serve.py).

A `Recommender` wraps a registry model with one scoring step:

    scores = model(batch).predict_emb @ item_table^T        (vocab-masked)
    top-k with torch.topk on the device, ids + scores to the host

History tensors are built with the same windowing and time-feature rules
as training: pass raw (item, category, unix_seconds) event triples and a
request time.  The scoring step runs on CUDA unless the caller passes
``device="cpu"``, where the kernels' plain twins run instead.
`Recommender.from_checkpoint` restores a model the port's
`train.checkpoint.Checkpointer` saved; `main` is the JSON-lines service,
``python -m mtamrecommender_tpu_torch.serve``.  The port cannot read an
Orbax directory: a JAX checkpoint reaches it by restoring it with JAX and
passing the parameters to `Recommender` (`bridge.load_jax_params`).
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
from mtamrecommender_tpu_torch.types import (Batch, DatasetMeta,
                                             batch_from_numpy, resolve_device)


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

    @classmethod
    def from_checkpoint(cls, cfg: ExperimentConfig, meta: DatasetMeta,
                        checkpoint_dir: str, device=None) -> "Recommender":
        """The latest step under ``checkpoint_dir`` (the port's
        `Checkpointer` layout), its parameters only, on ``device``."""
        from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer
        from mtamrecommender_tpu_torch.train.trainer import TrainState

        device = resolve_device(device)
        model_def = get_model(cfg.model.experiment_type)
        skeleton = model_def.init(torch.Generator().manual_seed(0), cfg.model,
                                  meta).to(device)
        ckpt = Checkpointer(checkpoint_dir)
        try:
            state = ckpt.restore(TrainState(model=skeleton, opt_state=None))
        finally:
            ckpt.close()
        return cls(cfg, meta, state.model, device=device, model_def=model_def)

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


def main(argv=None) -> int:
    """JSON-lines scoring service.

    Reads one request per stdin line:
        {"history": [[item, cat, unix_seconds], ...],
         "request_time": unix_seconds, "user_id": 0, "k": 10}
    writes one response per line:
        {"items": [id, ...], "scores": [s, ...]}

    Usage (``--device cpu`` runs the kernels' plain twins on the CPU):
        python -m mtamrecommender_tpu_torch.serve --checkpoint ckpt/run \\
            --experiment_type MTAM --items 3706 --users 6040 --categories 18
    """
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(prog="mtamrecommender_tpu_torch.serve")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--experiment_type", default="MTAM")
    ap.add_argument("--items", type=int, required=True)
    ap.add_argument("--users", type=int, required=True)
    ap.add_argument("--categories", type=int, required=True)
    ap.add_argument("--max_seq_len", type=int, default=50)
    ap.add_argument("--num_units", type=int, default=128)
    ap.add_argument("--num_blocks", type=int, default=3)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ExperimentConfig().with_overrides(**{
        "model.experiment_type": args.experiment_type,
        "model.num_units": args.num_units,
        "model.num_blocks": args.num_blocks,
        "data.max_seq_len": args.max_seq_len,
        **{kv.partition("=")[0]: json.loads(kv.partition("=")[2])
           for kv in args.set}})
    meta = DatasetMeta(user_count=args.users, item_count=args.items,
                       category_count=args.categories,
                       max_seq_len=args.max_seq_len)
    rec = Recommender.from_checkpoint(cfg, meta, args.checkpoint,
                                      device=args.device)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        req = json.loads(line)
        out = rec.recommend(
            [[tuple(e) for e in req["history"]]],
            [req["request_time"]], k=int(req.get("k", args.k)),
            user_ids=[int(req.get("user_id", 0))])[0]
        print(json.dumps({"items": [i for i, _ in out],
                          "scores": [round(s, 5) for _, s in out]}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
