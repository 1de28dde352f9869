"""Train/test example construction (the counterpart of
mtamrecommender_tpu/data/prepare.py, without pandas).

Behavioral port of the reference's `Prepare/prepare_data_base.py`:
label-encode ids, sort by (user, time), group by user, emit one example
per history position with leave-last-out test split, truncate to the
last ``max_seq_len - 1`` events, convert time to hours, append the mask
token, compute timelast/timenow/position features, cap the test set at
``test_cap``, and persist the reference's ``train_data.txt`` /
``test_data.txt`` (python-repr lines) + ``parameters.pkl`` cache, which
either package reads back.

The order of ties is pandas', reproduced with numpy:

  * `map_process` sorts by (user_id, time_stamp) stably, as pandas'
    two-column sort does (``np.lexsort``);
  * `dedup_sort_user` drops full-row duplicates keeping the last, then
    sorts one column with pandas' default ``kind="quicksort"``, which is
    ``np.argsort(stamps, kind="quicksort")`` on the deduped stamps: equal
    stamps come out as that sort leaves them, not as a stable sort
    would.
"""

from __future__ import annotations

import ast
import os
import pickle
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from mtamrecommender_tpu_torch.config import DataConfig
from mtamrecommender_tpu_torch.data import masking
from mtamrecommender_tpu_torch.data.ingest import COLUMNS, EventLog
from mtamrecommender_tpu_torch.types import DatasetMeta

# the reference example 9-tuple (prepare_data_base.py:299-314)
Example = Tuple[int, List[int], List[int], List[int], List[int], List[int],
                List[int], List[int], int]


@dataclass
class PreparedData:
    train_set: List[Example]
    test_set: List[Example]
    meta: DatasetMeta
    gap: np.ndarray
    item_category: Dict[int, int] = field(default_factory=dict)


def label_encode(values: np.ndarray) -> Tuple[np.ndarray, int]:
    """sklearn.LabelEncoder semantics (prepare_data_base.map_process:115-154):
    sorted unique values -> 0..n-1."""
    classes, encoded = np.unique(np.asarray(values), return_inverse=True)
    return encoded.reshape(-1).astype(np.int64), len(classes)


def map_process(origin_data: EventLog) -> Tuple[EventLog, DatasetMeta,
                                                Dict[int, int]]:
    """Encode ids and sort by (user_id, time_stamp) (map_process:115-154)."""
    item_id, item_count = label_encode(origin_data.item_id)
    user_id, user_count = label_encode(origin_data.user_id)
    cat_id, category_count = label_encode(origin_data.cat_id)
    # last co-occurrence wins, as in the reference's dict-fill loop (:136-138)
    item_category = dict(zip(item_id.tolist(), cat_id.tolist()))
    log = EventLog(user_id=user_id, item_id=item_id,
                   time_stamp=origin_data.time_stamp, cat_id=cat_id)
    log = log.select(np.lexsort((log.time_stamp, log.user_id)))
    meta = DatasetMeta(user_count=user_count, item_count=item_count,
                       category_count=category_count, max_seq_len=0)
    return log, meta, item_category


def build_user_examples(user_id: int, items: List[int], cats: List[int],
                        stamps: List[int], *, item_count: int,
                        category_count: int,
                        item_category: Dict[int, int],
                        cfg: DataConfig,
                        py_random: random.Random = random,
                        ) -> Tuple[List[Example], List[Example]]:
    """Emit (train, test) examples for one user's time-sorted sequence.

    Mirrors data_handle_process (prepare_data_base.py:252-314).  The last
    maskable index (== len(mask_index_list)) becomes the single test
    example (leave-last-out).
    """
    length = len(items)
    train: List[Example] = []
    test: List[Example] = []
    mask_indices = masking.mask_index_list_behavior(length)
    time_window = 24 * 3600 * cfg.time_window_days
    for index in mask_indices:
        start, end = masking.select_window(
            cfg.causality, index, stamps, mask_indices,
            time_window=time_window, length_limit=cfg.max_seq_len,
            py_random=py_random)
        item_seq = list(items[start:end])
        cat_seq = list(cats[start:end])
        time_seq = [int(t / masking.HOUR) for t in stamps[start:end]]
        target_time = int(stamps[index] / masking.HOUR)

        item_seq.append(item_count + 1)     # mask token (:283)
        cat_seq.append(category_count + 1)  # (:285)

        timelast, timenow = masking.time_features(time_seq, target_time)
        position = masking.position_features(len(time_seq))

        time_seq.append(target_time)
        timelast.append(0)
        timenow.append(0)
        position.append(index if index <= cfg.max_seq_len - 1
                        else cfg.max_seq_len - 1)  # (:295-298)

        target_id = items[index]
        target_category = item_category[target_id]
        example: Example = (user_id, item_seq, cat_seq, time_seq, timelast,
                            timenow, position,
                            [target_id, target_category, target_time],
                            len(item_seq))
        # leave-last-out quirk: `index == len(mask_index_list)` (:303),
        # i.e. index == length-1, routes to the test set.
        if index == len(mask_indices):
            test.append(example)
        else:
            train.append(example)
    return train, test


def keep_last_duplicates(log: EventLog) -> np.ndarray:
    """Indices, ascending, of the rows ``drop_duplicates(keep="last")``
    keeps: of each set of equal rows (all four columns), the last."""
    n = len(log)
    if n == 0:
        return np.zeros((0,), np.int64)
    cols = [log[c] for c in COLUMNS]
    order = np.lexsort(cols[::-1])        # stable: equal rows by index
    same_as_next = np.ones((n - 1,), bool)
    for c in cols:
        s = c[order]
        same_as_next &= s[1:] == s[:-1]
    last = np.ones((n,), bool)
    last[:-1] = ~same_as_next
    return np.sort(order[last])


def dedup_sort_user(frame: EventLog, remove_duplicate: bool) -> EventLog:
    """data_handle_process_base (prepare_data_base.py:219-249): full-row
    dedup keeping the last occurrence, then the time sort pandas'
    ``sort_values(by=["time_stamp"])`` makes (numpy's quicksort)."""
    seq = frame
    if remove_duplicate:
        seq = seq.select(keep_last_duplicates(seq))
    stamps = seq.time_stamp
    if stamps.dtype.kind == "f":
        # na_position="first": NaN stamps first, in row order
        nan = np.flatnonzero(np.isnan(stamps))
        rest = np.flatnonzero(~np.isnan(stamps))
        order = np.concatenate(
            [nan, rest[np.argsort(stamps[rest], kind="quicksort")]])
    else:
        order = np.argsort(stamps, kind="quicksort")
    return seq.select(order)


def user_slices(user_col: np.ndarray) -> List[Tuple[int, int]]:
    """[lo, hi) row ranges of each user in a log sorted by user."""
    bounds = np.flatnonzero(np.diff(user_col)) + 1
    edges = np.concatenate(([0], bounds, [len(user_col)])).tolist()
    return [(lo, hi) for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]


def prepare_examples(origin_data: EventLog, cfg: DataConfig,
                     cache_dir: Optional[str] = None,
                     force_rebuild: bool = False) -> PreparedData:
    """End-to-end example construction with reference-compatible caching.

    prepare_data_base.__init__/get_train_test (prepare_data_base.py:28-217).
    """
    if cache_dir is not None and not force_rebuild:
        cached = _load_cache(cache_dir, cfg)
        if cached is not None:
            return cached

    log, meta, item_category = map_process(origin_data)
    meta = meta._replace(max_seq_len=cfg.max_seq_len)
    gap = masking.gap_list(cfg.gap_num)

    py_random = random.Random(cfg.seed)
    train_set: List[Example] = []
    test_set: List[Example] = []
    now_count = 0
    for lo, hi in user_slices(log.user_id):
        if now_count > cfg.user_count_limit:  # (:243-246) checks before increment
            break
        now_count += 1
        seq = dedup_sort_user(log.select(slice(lo, hi)), cfg.remove_duplicate)
        tr, te = build_user_examples(
            int(seq.user_id[0]), seq.item_id.tolist(),
            seq.cat_id.tolist(), seq.time_stamp.tolist(),
            item_count=meta.item_count, category_count=meta.category_count,
            item_category=item_category, cfg=cfg, py_random=py_random)
        train_set.extend(tr)
        test_set.extend(te)

    py_random.shuffle(train_set)
    py_random.shuffle(test_set)
    if len(test_set) > cfg.test_cap:  # (:195-196)
        test_set = py_random.sample(test_set, cfg.test_cap)

    prepared = PreparedData(train_set=train_set, test_set=test_set, meta=meta,
                            gap=gap, item_category=item_category)
    if cache_dir is not None:
        _save_cache(cache_dir, prepared)
    return prepared


# --- reference-compatible cache (train_data.txt / test_data.txt / parameters.pkl,
#     prepare_data_base.py:61-63,79-110,204-215,334-339) ---

def _cache_paths(cache_dir: str) -> Tuple[str, str, str]:
    return (os.path.join(cache_dir, "parameters.pkl"),
            os.path.join(cache_dir, "train_data.txt"),
            os.path.join(cache_dir, "test_data.txt"))


def _save_cache(cache_dir: str, prepared: PreparedData) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    pkl, train_p, test_p = _cache_paths(cache_dir)
    with open(pkl, "wb") as f:
        pickle.dump({"item_count": prepared.meta.item_count,
                     "user_count": prepared.meta.user_count,
                     "category_count": prepared.meta.category_count,
                     "gap": prepared.gap,
                     "item_category": prepared.item_category},
                    f, pickle.HIGHEST_PROTOCOL)
    for path, data in ((train_p, prepared.train_set), (test_p, prepared.test_set)):
        with open(path, "w") as f:
            for example in data:
                f.write(str(example) + "\n")


def _load_cache(cache_dir: str, cfg: DataConfig) -> Optional[PreparedData]:
    pkl, train_p, test_p = _cache_paths(cache_dir)
    if not all(os.path.exists(p) for p in (pkl, train_p, test_p)):
        return None
    with open(pkl, "rb") as f:
        dic = pickle.load(f)

    def read_examples(path: str) -> List[Example]:
        # python-repr lines (prepare_data_base.py:334-339); literal_eval
        # parses them without eval's code-execution surface
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(ast.literal_eval(line))
        return out

    meta = DatasetMeta(user_count=dic["user_count"], item_count=dic["item_count"],
                       category_count=dic["category_count"],
                       max_seq_len=cfg.max_seq_len)
    return PreparedData(train_set=read_examples(train_p),
                        test_set=read_examples(test_p), meta=meta,
                        gap=np.asarray(dic["gap"]),
                        item_category=dict(dic["item_category"]))
