"""Host input pipeline: pack once, slice per step, copy ahead (the
counterpart of mtamrecommender_tpu/data/pipeline.py).

The whole example list is packed ONCE into dense numpy arrays
(`PackedDataset`); `batch_iterator` slices a batch at a time into host
tensors, a partial last batch padded to the fixed shape and masked by
``Batch.valid``; `prefetch_to_device` copies batches to the card ahead
of the step that reads them.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from mtamrecommender_tpu_torch.data.prepare import Example
from mtamrecommender_tpu_torch.types import (Batch, DatasetMeta,
                                             batch_from_numpy, resolve_device)


@dataclass
class PackedDataset:
    """Struct-of-arrays form of an example list."""

    user_id: np.ndarray      # [N]
    items: np.ndarray        # [N,L]
    cats: np.ndarray         # [N,L]
    times: np.ndarray        # [N,L]
    time_last: np.ndarray    # [N,L]
    time_now: np.ndarray     # [N,L]
    positions: np.ndarray    # [N,L]
    target_id: np.ndarray    # [N]
    target_cat: np.ndarray   # [N]
    target_time: np.ndarray  # [N]
    seq_len: np.ndarray      # [N]
    meta: DatasetMeta

    def __len__(self) -> int:
        return int(self.user_id.shape[0])

    def __getitem__(self, name: str) -> np.ndarray:
        """An array by field name, as `data.device_data.to_device` reads a
        mapping of them."""
        if name == "meta" or name not in self.__dataclass_fields__:
            raise KeyError(name)
        return getattr(self, name)

    def select(self, idx: np.ndarray) -> "PackedDataset":
        return PackedDataset(
            user_id=self.user_id[idx], items=self.items[idx],
            cats=self.cats[idx], times=self.times[idx],
            time_last=self.time_last[idx], time_now=self.time_now[idx],
            positions=self.positions[idx], target_id=self.target_id[idx],
            target_cat=self.target_cat[idx], target_time=self.target_time[idx],
            seq_len=self.seq_len[idx], meta=self.meta)


def pack_examples(examples: List[Example], meta: DatasetMeta,
                  max_len: Optional[int] = None) -> PackedDataset:
    """Zero-pad each example to ``max_len`` (the reference's per-batch
    np.pad, done once for the whole set)."""
    length = max_len or meta.max_seq_len
    n = len(examples)
    user_id = np.zeros((n,), np.int32)
    items = np.zeros((n, length), np.int32)
    cats = np.zeros((n, length), np.int32)
    times = np.zeros((n, length), np.float32)
    time_last = np.zeros((n, length), np.float32)
    time_now = np.zeros((n, length), np.float32)
    positions = np.zeros((n, length), np.int32)
    target_id = np.zeros((n,), np.int32)
    target_cat = np.zeros((n,), np.int32)
    target_time = np.zeros((n,), np.float32)
    seq_len = np.zeros((n,), np.int32)
    for k, ex in enumerate(examples):
        sl = min(int(ex[8]), length)
        user_id[k] = ex[0]
        items[k, :sl] = ex[1][:sl]
        cats[k, :sl] = ex[2][:sl]
        times[k, :sl] = ex[3][:sl]
        time_last[k, :sl] = ex[4][:sl]
        time_now[k, :sl] = ex[5][:sl]
        positions[k, :sl] = ex[6][:sl]
        target_id[k] = ex[7][0]
        target_cat[k] = ex[7][1]
        target_time[k] = ex[7][2]
        seq_len[k] = sl
    return PackedDataset(user_id=user_id, items=items, cats=cats, times=times,
                         time_last=time_last, time_now=time_now,
                         positions=positions, target_id=target_id,
                         target_cat=target_cat, target_time=target_time,
                         seq_len=seq_len,
                         meta=meta._replace(max_seq_len=length))


def _slice_to_batch(ds: PackedDataset, lo: int, hi: int,
                    batch_size: int) -> Batch:
    n = hi - lo
    pad = batch_size - n

    def pad0(a: np.ndarray) -> np.ndarray:
        if pad == 0:
            return a[lo:hi]
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a[lo:hi], width, mode="constant")

    valid = np.zeros((batch_size,), np.float32)
    valid[:n] = 1.0
    seq_len = pad0(ds.seq_len)
    if pad:
        seq_len = seq_len.copy()
        seq_len[n:] = 2  # keep gather indices (seq_len-2) in range for pad rows
    return batch_from_numpy({
        "user_id": pad0(ds.user_id), "items": pad0(ds.items),
        "cats": pad0(ds.cats), "times": pad0(ds.times),
        "time_last": pad0(ds.time_last), "time_now": pad0(ds.time_now),
        "positions": pad0(ds.positions), "target_id": pad0(ds.target_id),
        "target_cat": pad0(ds.target_cat), "target_time": pad0(ds.target_time),
        "seq_len": seq_len, "valid": valid,
    }, device="cpu")


def batch_iterator(ds: PackedDataset, batch_size: int, *,
                   shuffle: bool = False,
                   rng: Optional[np.random.RandomState] = None,
                   drop_remainder: bool = False,
                   ) -> Iterator[Tuple[int, Batch]]:
    """(step, Batch) pairs of host (CPU) tensors; `prefetch_to_device`
    moves them to the card.  With ``shuffle`` one ``rng.shuffle`` of
    ``arange(n)`` an epoch, the draw `device_data.epoch_order` makes."""
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(order)
        ds = ds.select(order)
    step = 0
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        if drop_remainder and hi - lo < batch_size:
            break
        yield step, _slice_to_batch(ds, lo, hi, batch_size)
        step += 1


def prefetch_to_device(batches: Iterator[Tuple[int, Batch]],
                       size: int = 2,
                       device=None) -> Iterator[Tuple[int, Batch]]:
    """Keep ``size`` batches in flight to ``device`` (CUDA unless the
    caller passes ``device="cpu"``, where batches pass through as they
    are).  Each batch is pinned on the host and copied with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on
    the copy's event before the batch is yielded, and the copies are
    recorded on that stream so their memory is not reused while it may
    still read them."""
    device = resolve_device(device)
    if device.type != "cuda":
        yield from batches
        return
    side = torch.cuda.Stream(device=device)
    queue: collections.deque = collections.deque()

    def put(item):
        step, batch = item
        with torch.cuda.stream(side):
            placed = Batch(*(t.pin_memory().to(device, non_blocking=True)
                             for t in batch))
            done = torch.cuda.Event()
            done.record(side)
        queue.append((step, placed, done))

    def get():
        step, placed, done = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in placed:
            t.record_stream(consumer)
        return step, placed

    for item in batches:
        put(item)
        if len(queue) >= size:
            yield get()
    while queue:
        yield get()
