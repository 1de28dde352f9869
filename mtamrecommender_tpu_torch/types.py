"""Core data contracts (twin of mtamrecommender_tpu/types.py).

`Batch` is the fixed-shape struct of arrays that every model reads, here
as torch tensors; `DatasetMeta` carries the vocabulary sizes with the
reference's +3 slack rows per table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Batch(NamedTuple):
    """A fixed-shape packed batch.  L == DataConfig.max_seq_len.

    The final valid position of every row (index ``seq_len-1``) holds the
    mask token (item_count+1 / category_count+1).
    """

    user_id: torch.Tensor      # [B]   int32
    items: torch.Tensor        # [B,L] int32, zero-padded past seq_len
    cats: torch.Tensor         # [B,L] int32
    times: torch.Tensor        # [B,L] float32 (hours)
    time_last: torch.Tensor    # [B,L] float32  Δt to previous event
    time_now: torch.Tensor     # [B,L] float32  target_time - t_i
    positions: torch.Tensor    # [B,L] int32
    target_id: torch.Tensor    # [B]   int32
    target_cat: torch.Tensor   # [B]   int32
    target_time: torch.Tensor  # [B]   float32 (hours)
    seq_len: torch.Tensor      # [B]   int32 (includes the mask-token slot)
    valid: torch.Tensor        # [B]   float32 1.0 real rows, 0.0 padding rows


class DatasetMeta(NamedTuple):
    """Vocabulary sizes (label-encoded)."""

    user_count: int
    item_count: int
    category_count: int
    max_seq_len: int

    @property
    def item_vocab(self) -> int:
        # +3 slack rows for padding/mask/reserved ids
        return self.item_count + 3

    @property
    def user_vocab(self) -> int:
        return self.user_count + 3

    @property
    def category_vocab(self) -> int:
        return self.category_count + 3

    @property
    def position_vocab(self) -> int:
        return self.max_seq_len + 3


_INT_FIELDS = ("user_id", "items", "cats", "positions", "target_id",
               "target_cat", "seq_len")


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    return device


def batch_from_numpy(arrays: dict, device=None) -> Batch:
    """numpy arrays keyed by field name -> a Batch on ``device``: CUDA
    unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    return Batch(**{
        name: torch.tensor(arrays[name],
                           dtype=(torch.int32 if name in _INT_FIELDS
                                  else torch.float32), device=device)
        for name in Batch._fields})
