"""Per-user-sequence masking / windowing / time-feature construction (a
copy of mtamrecommender_tpu/data/masking.py: numpy and `random` only).

Behavioral port of the reference's `Prepare/mask_data_process.py` as pure
functions over plain lists (the reference wraps a pandas slice in a class;
nothing here needs pandas).  Every function documents the reference lines
whose behavior it reproduces.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np

HOUR = 3600
DAY = 24 * 3600


def mask_index_list_behavior(length: int, only_last: bool = False) -> List[int]:
    """Indices whose item becomes a prediction target.

    mask_data_process.get_mask_index_list_behaivor (mask_data_process.py:59-72):
    every position 1..L-1, or just the last.
    """
    if only_last:
        return [length - 1]
    return list(range(1, length))


def mask_index_list_bert(length: int, mask_rate: float,
                         rng: np.random.RandomState) -> List[int]:
    """BERT-style random target selection (mask_data_process.py:75-94)."""
    num_to_predict = int(mask_rate * length)
    return list(rng.randint(0, length - 1, size=num_to_predict))


def window_start(index: int, length_limit: int) -> int:
    """Prefix truncation rule (mask_data_process.py:181-184).

    Note the reference's `temp_index - lengeth_limit + 1` keeps at most
    ``length_limit - 1`` history events, leaving one slot for the appended
    mask token so the padded row is exactly ``length_limit`` wide.
    """
    start = index - length_limit + 1
    return start if start > 0 else 0


def select_window(causality: str, index: int, time_stamps: Sequence[int],
                  mask_indices: Sequence[int], time_window: int = 35 * DAY,
                  length_limit: int = 50,
                  py_random: random.Random = random) -> Tuple[int, int]:
    """Pick the (start, end) half-open item range that forms the history.

    mask_process_unidirectional (mask_data_process.py:153-190):
      * 'unidirection' : everything before `index`
      * 'random'       : a random cut between the previous mask index and `index`
      * 'time_window'  : first event within `time_window` of the target
    then truncate to the last `length_limit - 1` events.
    """
    if causality == "unidirection":
        temp_index = index
    elif causality == "random":
        pos = list(mask_indices).index(index)
        start_prev = 0 if pos - 1 < 0 else mask_indices[pos - 1]
        temp_index = py_random.randint(start_prev + 1, index)
    elif causality == "time_window":
        target_time = time_stamps[index]
        temp_index = index
        for i in range(0, index + 1):
            if target_time - time_stamps[i] <= time_window:
                temp_index = i
                break
    else:
        raise ValueError(f"unknown causality {causality!r}")
    return window_start(temp_index, length_limit), temp_index


def time_features(time_list_hours: Sequence[int],
                  target_time_hours: int) -> Tuple[List[int], List[int]]:
    """timelast / timenow construction (pro_time_method,
    mask_data_process.py:250-255).

    timelast[0] = 0, timelast[i] = t[i] - t[i-1];
    timenow[i]  = target_time - t[i].
    Both computed over the history *before* the mask slot is appended.
    """
    timelast = [time_list_hours[i + 1] - time_list_hours[i]
                for i in range(len(time_list_hours) - 1)]
    timelast.insert(0, 0)
    timenow = [target_time_hours - t for t in time_list_hours]
    return timelast, timenow


def position_features(history_len: int) -> List[int]:
    """proc_pos_emb (mask_data_process.py:245-247): 0..len-1."""
    return list(range(history_len))


def time_bucket_features(time_stamp_seq: Sequence[int], mask_time: int,
                         gap: np.ndarray) -> List[int]:
    """Bucketed |Δt| interval ids (proc_time_emb, mask_data_process.py:239-242)."""
    return [int(np.sum(abs(t - mask_time) >= gap)) for t in time_stamp_seq]


def gap_list(gap_num: int) -> np.ndarray:
    """Exponential interval-bucket boundaries (prepare_data_base.get_gap_list:321-331):
    [60, 3600, 86400*2^(i-3) for i>=3]."""
    gap = []
    for i in range(1, gap_num):
        if i == 1:
            gap.append(60)
        elif i == 2:
            gap.append(60 * 60)
        else:
            gap.append(3600 * 24 * int(np.power(2, i - 3)))
    return np.array(gap)


def negative_items(item_seq: Sequence[int], mask_indices: Sequence[int],
                   item_count: int, number: int,
                   rng: np.random.RandomState, low: int = 0) -> List[int]:
    """Rejection-sampled negatives avoiding the masked positives
    (get_neg_item, mask_data_process.py:208-220)."""
    masked = {item_seq[i] for i in mask_indices}
    neg: List[int] = []
    while len(neg) < number:
        cand = int(rng.randint(low, item_count))
        if cand not in neg and cand not in masked:
            neg.append(cand)
    return neg
