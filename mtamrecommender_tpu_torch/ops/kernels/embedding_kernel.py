"""Embedding-table backward: CUDA kernel and plain twin.

Counterpart of mtamrecommender_tpu/ops/pallas/embedding_kernel.py
(`take_dtable` and its backward kernel `_dtable_kernel`).  The kernel is
csrc/embedding_dtable.cu:

    dtable[v, :] = sum_n [ids[n] == v] * ct[n, :]

summed in f32 in a fixed order (no float atomics) and written once in
ct's type.  `take_dtable` is the lookup whose backward it is: a row
gather forward (JAX's is `jnp.take`, no kernel), `dtable` backward.
"""

from __future__ import annotations

import ctypes

import torch

from mtamrecommender_tpu_torch.ops.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
KERNEL_WIDTHS = (32, 64, 128, 256)   # d the kernel takes

# kernel launches (the plain twin is not counted)
launches = {"dtable": 0}


def _check(ct, ids, vocab) -> None:
    if ct.dim() != 2 or ids.dim() != 1 or ids.shape[0] != ct.shape[0]:
        raise ValueError(f"dtable: ct must be [n, d] and ids [n], got "
                         f"{tuple(ct.shape)} and {tuple(ids.shape)}")
    if ct.dtype not in DTYPES:
        raise TypeError(f"dtable: ct must be float32 or bfloat16, got {ct.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"dtable: ids must be int32, got {ids.dtype}")
    if vocab < 0:
        raise ValueError(f"dtable: vocab must be >= 0, got {vocab}")


def dtable(ct: torch.Tensor, ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """ct: [n, d] f32 or bf16; ids: [n] int32 -> [vocab, d] in ct's type.

    CPU tensors run `dtable_plain` after a check that raises on an id
    outside [0, vocab).  CUDA tensors launch the kernel, which does not read ids
    back to the host (that would stall the step): an id outside
    [0, vocab) matches no row there, and chip_smoke.py checks on the card
    that the training step's ids are in range."""
    _check(ct, ids, vocab)
    if ct.device.type == "cpu":
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= vocab):
            raise ValueError(f"dtable: ids must lie in [0, {vocab}), got "
                             f"[{int(ids.min())}, {int(ids.max())}]")
        return dtable_plain(ct, ids, vocab)
    if ct.device.type != "cuda":
        raise ValueError(f"dtable: no kernel for device {ct.device}")
    return _launch(ct, ids, vocab)


def _launch(ct, ids, vocab) -> torch.Tensor:
    device, stream = build.launch_context((ct, ids), "dtable")
    n, d = ct.shape
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"dtable: the kernel takes d in {KERNEL_WIDTHS}, "
                         f"got d={d}")
    lib = _library()
    out = torch.empty((vocab, d), dtype=ct.dtype, device=ct.device)
    ws = torch.empty((lib.dtable_workspace_floats(n, vocab, d),),
                     dtype=torch.float32, device=ct.device)
    status = lib.dtable_launch(int(ct.dtype == torch.bfloat16), ct.data_ptr(),
                               ids.data_ptr(), out.data_ptr(), ws.data_ptr(),
                               n, vocab, d, device, stream)
    build.check(lib, status, "dtable")
    launches["dtable"] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("embedding_dtable")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dtable_launch.argtypes = [ci] + [vp] * 4 + [ci, ci, ci, ci, vp]
        lib.dtable_launch.restype = ci
        lib.dtable_workspace_floats.argtypes = [ci, ci, ci]
        lib.dtable_workspace_floats.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def dtable_plain(ct: torch.Tensor, ids: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Plain PyTorch twin: an f32 index_add_, rounded once to ct's type."""
    out = torch.zeros((vocab, ct.shape[1]), dtype=torch.float32,
                      device=ct.device)
    return out.index_add_(0, ids.long(), ct.float()).to(ct.dtype)


class TakeDtable(torch.autograd.Function):
    """Row gather whose table gradient is `dtable` (JAX's `take_dtable`)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return table[ids.long()]

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        d = ct.shape[-1]
        flat_ids = ids.reshape(-1).to(torch.int32).contiguous()
        return dtable(ct.reshape(-1, d).contiguous(), flat_ids,
                      ctx.vocab), None


def take_dtable(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for ids of any shape; the table's gradient comes from
    the `dtable` kernel (its plain twin on the CPU)."""
    return TakeDtable.apply(table, ids)
