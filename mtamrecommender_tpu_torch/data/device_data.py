"""Device-resident dataset: the whole packed example set lives in device
memory and each train step gathers its batch there (twin of
mtamrecommender_tpu/data/device_data.py).

`to_device` takes a `data.pipeline.PackedDataset` or any mapping of its
arrays by field name.  `epoch_order` consumes the same
``np.random.RandomState`` stream as the JAX package's, and
`gather_batch` keeps its padding semantics: a pad slot (order == -1)
becomes an all-zero row with ``seq_len=2`` and ``valid=0``, which
carries no loss or gradient.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import numpy as np
import torch

from mtamrecommender_tpu_torch.types import Batch, resolve_device


class DeviceDataset(NamedTuple):
    """Struct-of-arrays form of a packed dataset, on one device."""

    user_id: torch.Tensor      # [N]   int32
    items: torch.Tensor        # [N,L] int32
    cats: torch.Tensor         # [N,L] int32
    times: torch.Tensor        # [N,L] float32
    time_last: torch.Tensor    # [N,L] float32
    time_now: torch.Tensor     # [N,L] float32
    positions: torch.Tensor    # [N,L] int32
    target_id: torch.Tensor    # [N]   int32
    target_cat: torch.Tensor   # [N]   int32
    target_time: torch.Tensor  # [N]   float32
    seq_len: torch.Tensor      # [N]   int32


_FLOAT_FIELDS = ("times", "time_last", "time_now", "target_time")


def to_device(arrays: Mapping[str, np.ndarray], device=None) -> DeviceDataset:
    """One bulk copy of the packed arrays (a PackedDataset, or numpy
    arrays keyed by field name) to ``device``: CUDA unless the caller
    passes ``device="cpu"``."""
    device = resolve_device(device)
    return DeviceDataset(**{
        name: torch.tensor(
            np.asarray(arrays[name], np.float32 if name in _FLOAT_FIELDS
                       else np.int32), device=device)
        for name in DeviceDataset._fields})


def epoch_order(n: int, batch_size: int,
                np_rng: np.random.RandomState) -> Tuple[np.ndarray, int]:
    """One epoch's shuffled row order, padded with -1 to a whole number
    of steps (one ``shuffle`` of ``arange(n)`` from ``np_rng``)."""
    order = np.arange(n)
    np_rng.shuffle(order)
    n_steps = -(-n // batch_size)
    padded = np.full((n_steps * batch_size,), -1, np.int32)
    padded[:n] = order
    return padded, n_steps


def gather_batch(data: DeviceDataset, order: torch.Tensor, step_index: int,
                 batch_size: int) -> Batch:
    """Step ``step_index``'s batch, gathered on the data's device by the
    rows ``order[step_index*batch_size:][:batch_size]``."""
    lo = step_index * batch_size
    raw = order[lo:lo + batch_size]
    valid = raw >= 0
    idx = torch.where(valid, raw, torch.zeros_like(raw)).long()

    def row(a: torch.Tensor) -> torch.Tensor:
        g = a[idx]
        mask = valid.reshape((-1,) + (1,) * (g.dim() - 1))
        return torch.where(mask, g, torch.zeros_like(g))

    seq_len = torch.where(valid, data.seq_len[idx],
                          torch.full_like(data.seq_len[idx], 2))
    return Batch(
        user_id=row(data.user_id), items=row(data.items),
        cats=row(data.cats), times=row(data.times),
        time_last=row(data.time_last), time_now=row(data.time_now),
        positions=row(data.positions), target_id=row(data.target_id),
        target_cat=row(data.target_cat), target_time=row(data.target_time),
        seq_len=seq_len.to(torch.int32), valid=valid.to(torch.float32))
