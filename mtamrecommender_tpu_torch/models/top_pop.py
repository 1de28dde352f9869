"""Non-learned popularity baselines: TopPop and P-Pop (a copy of
mtamrecommender_tpu/models/top_pop.py over the port's `Example`).

Port of the reference's `top_pop_model.py:18-168` +
`Prepare/prepare_data_top_pop.py`:

  * TopPop — rank every user's next item by GLOBAL interaction counts
    (one shared ranking).
  * P-Pop  — rank by the user's OWN historical consumption counts
    (personal re-consumption), falling back to global popularity for the
    tail (the reference pads personal lists with globally popular items).

Both report HR@k / NDCG@k with the same math as the learned models'
eval (`train/evaluate.topk_metrics`), over the same leave-last-out test
examples, so their numbers are directly comparable cheap floors.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mtamrecommender_tpu_torch.data.prepare import Example

TOPK: Tuple[int, ...] = (1, 5, 10, 30, 50)


def _hit_metrics(rank: int, ks: Sequence[int], out: Dict[str, float]) -> None:
    for k in ks:
        if rank < k:
            out[f"hr@{k}"] += 1.0
            out[f"ndcg@{k}"] += float(np.log(2.0) / np.log(rank + 2.0))


def _finalize(out: Dict[str, float], n: int) -> Dict[str, float]:
    return {k: v / max(n, 1) for k, v in out.items()}


def global_popularity(train_set: List[Example]) -> List[int]:
    """Items by descending global count (top_pop_model.py:24-40).
    History positions carry the mask token in the last slot; only real
    events (all but the final slot) count."""
    counts: Counter = Counter()
    for ex in train_set:
        items, seq_len = ex[1], ex[8]
        counts.update(items[:seq_len - 1])
        counts.update([ex[7][0]])   # the target is a real interaction too
    return [item for item, _ in counts.most_common()]


def eval_top_pop(train_set: List[Example], test_set: List[Example],
                 ks: Sequence[int] = TOPK) -> Dict[str, float]:
    """TopPop: one global ranking for everyone (top_pop_model.py:18-98)."""
    ranking = global_popularity(train_set)
    pos = {item: r for r, item in enumerate(ranking)}
    out = {f"{m}@{k}": 0.0 for k in ks for m in ("hr", "ndcg")}
    for ex in test_set:
        target = ex[7][0]
        rank = pos.get(target, len(pos))
        _hit_metrics(rank, ks, out)
    return _finalize(out, len(test_set))


def eval_p_pop(train_set: List[Example], test_set: List[Example],
               ks: Sequence[int] = TOPK) -> Dict[str, float]:
    """P-Pop: per-user re-consumption ranking with global fallback
    (top_pop_model.py:101-168)."""
    global_rank = global_popularity(train_set)
    out = {f"{m}@{k}": 0.0 for k in ks for m in ("hr", "ndcg")}
    for ex in test_set:
        items, seq_len, target = ex[1], ex[8], ex[7][0]
        history = items[:seq_len - 1]
        personal = [item for item, _ in Counter(history).most_common()]
        seen = set(personal)
        ranking = personal + [i for i in global_rank if i not in seen]
        try:
            rank = ranking.index(target)
        except ValueError:
            rank = len(ranking)
        _hit_metrics(rank, ks, out)
    return _finalize(out, len(test_set))
