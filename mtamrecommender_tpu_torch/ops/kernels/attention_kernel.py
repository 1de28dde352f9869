"""Fused attention middle (single tile): CUDA kernel and plain twin.

Counterpart of mtamrecommender_tpu/ops/pallas/attention_kernel.py
(`fused_attention`, forward, single-tile path).  The kernel is
csrc/fused_attention.cu.  Per batch row and query row:

    scores   = Q K^T
    time_qk  = tanh((Q_raw W_t) K_raw^T)            [time mode]
    decay    = tanh(log1p|t_q - t_k| * w1 + b1)     [time mode]
    gate     = wo1*decay + wo2*time_qk + bo         [time mode]
    scores   = scores * sigmoid(gate) / sqrt(d)     [time mode]
    scores   = (scores + log1p|t_q - t_k|)/sqrt(d)  [tisas mode]
    scores   = scores / sqrt(d)                     [plain mode]
    key mask (-2^32+1) -> softmax -> out = W V

Products sum in f32; the softmax weights are rounded to v's type before
``@ v``; the output is f32 [B, Tq, d].  A row with ``key_len == 0`` gets a
uniform softmax over its Tk keys.
"""

from __future__ import annotations

import ctypes

import torch

from mtamrecommender_tpu_torch.ops.kernels import build

MODES = ("plain", "time", "tisas")
DTYPES = (torch.float32, torch.bfloat16)
NEG_FILL = -(2.0 ** 32) + 1.0
SINGLE_TILE_KEYS = 1024   # longer memories need the blockwise kernel

# kernel launches per mode (the plain twin is not counted)
launches = {mode: 0 for mode in MODES}


def _check(mode, q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo,
           key_len) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown fused_attention mode {mode!r}; "
                         f"known: {MODES}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("fused_attention: q must be [B,Tq,d] and k [B,Tk,d]")
    b, tq, d = q.shape
    tk = k.shape[1]
    want = {"k": (b, tk, d), "v": (b, tk, d), "t_q": (b, tq), "t_k": (b, tk),
            "tqw": (b, tq, d), "rawk": (b, tk, d), "w1": (tq, tk),
            "b1": (tq, tk), "wo1": (tq, tk), "wo2": (tq, tk),
            "bo": (tq, tk), "key_len": (b,)}
    got = {"k": k, "v": v, "t_q": t_q, "t_k": t_k, "tqw": tqw, "rawk": rawk,
           "w1": w1, "b1": b1, "wo1": wo1, "wo2": wo2, "bo": bo,
           "key_len": key_len}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"fused_attention: {name} must be {shape}, "
                             f"got {tuple(got[name].shape)}")
    if key_len.dtype != torch.int32:
        raise TypeError("fused_attention: key_len must be int32, "
                        f"got {key_len.dtype}")
    floats = [q] + [t for n, t in got.items() if n != "key_len"]
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in floats):
        raise TypeError("fused_attention: floating operands must all be "
                        "float32 or all bfloat16, got "
                        f"{sorted({str(t.dtype) for t in floats})}")


def fused_attention(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                    w1, b1, wo1, wo2, bo, key_len) -> torch.Tensor:
    """q, tqw: [B,Tq,d]; k, v, rawk: [B,Tk,d]; t_q: [B,Tq]; t_k: [B,Tk];
    gate params w1, b1, wo1, wo2, bo: [Tq,Tk]; key_len: [B] int32.
    Modes that do not read an operand still take it at its shape.
    Returns f32 [B,Tq,d].  CPU tensors run `fused_attention_plain`; CUDA
    tensors launch the kernel (Tk <= SINGLE_TILE_KEYS)."""
    args = (q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo, key_len)
    _check(mode, *args)
    if q.device.type == "cpu":
        return fused_attention_plain(mode, *args)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    return _launch(mode, *args)


def _launch(mode, *args) -> torch.Tensor:
    q, k = args[0], args[1]
    device, stream = build.launch_context(args, "fused_attention")
    b, tq, d = q.shape
    tk = k.shape[1]
    if not 1 <= tk <= SINGLE_TILE_KEYS:
        raise ValueError(
            f"fused_attention: the single-tile kernel takes 1 <= Tk <= "
            f"{SINGLE_TILE_KEYS}, got Tk={tk} (the blockwise kernel for "
            "longer memories is not ported yet)")
    lib = _library()
    out = torch.empty((b, tq, d), dtype=torch.float32, device=q.device)
    status = lib.fused_attention_launch(
        MODES.index(mode), int(q.dtype == torch.bfloat16),
        *(t.data_ptr() for t in args), out.data_ptr(), b, tq, tk, d,
        1.0 / d ** 0.5, device, stream)
    build.check(lib, status, "fused_attention")
    launches[mode] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("fused_attention")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_launch.argtypes = (
            [ci, ci] + [vp] * 14 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.fused_attention_launch.restype = ci
        lib._port_typed = True
    return lib


def fused_attention_plain(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                          w1, b1, wo1, wo2, bo, key_len) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the math of the JAX package's
    `_reference_middle`, with the kernel's operand rounding)."""
    d = q.shape[-1]
    scale = 1.0 / d ** 0.5
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    if mode in ("time", "tisas"):
        logdt = torch.log1p(torch.abs(t_q.float()[:, :, None]
                                      - t_k.float()[:, None, :]))
    if mode == "time":
        time_qk = torch.tanh(torch.einsum("bqd,bkd->bqk", tqw.float(),
                                          rawk.float()))
        decay = torch.tanh(logdt * w1.float() + b1.float())
        gate = wo1.float() * decay + wo2.float() * time_qk + bo.float()
        scores = scores * torch.sigmoid(gate) * scale
    elif mode == "tisas":
        scores = (scores + logdt) * scale
    else:
        scores = scores * scale
    col = torch.arange(scores.shape[2], device=scores.device)
    live = col[None, None, :] < key_len[:, None, None]
    scores = torch.where(live, scores, torch.full_like(scores, NEG_FILL))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", weights.to(v.dtype).float(),
                        v.float())
