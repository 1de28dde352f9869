"""Fused attention middle: CUDA kernels and plain twins.

Counterpart of mtamrecommender_tpu/ops/pallas/attention_kernel.py: the
forward `fused_attention`, its backward `fused_attention_bwd` and
`fused_attention_vjp`, the autograd function that joins them as JAX's
custom_vjp does.  The forward routes by key count as `_fused_attention_fwd`
does (`route`): up to SINGLE_TILE_KEYS keys the single-tile kernel (the
Pallas `_attn_kernel`) in the design `attention_fwd_design` picks (with 2
to TILE_KEYS queries and up to TILE_KEYS keys csrc/fused_attention_tile.cu,
a block a batch row; with one query and up to HOP_KEYS keys
csrc/fused_attention_hop.cu, a block a batch row; with one query past
HOP_KEYS keys csrc/fused_attention_blocked.cu, a block a batch row with
its rows streamed through a ring; with 2 or more queries
past TILE_KEYS keys or queries csrc/fused_attention_wide.cu, a block 16
query rows of a batch row over a score strip; else
csrc/fused_attention.cu, a block a query row), above that, up to
MAX_KEYS and without a dropout mask, the blockwise kernel
(csrc/fused_attention_blockwise.cu, the Pallas `_attn_kernel_blockwise`:
an online softmax over KEY_BLOCK-key blocks; for Tq > 1 tensor-core tiles
in bf16 and register-tiled FMA in f32, at Tq = 1 each row's keys split
across blocks and merged, by `blockwise_design`).  The backward is the
single-tile kernel (the Pallas `_attn_bwd_kernel`) up to SINGLE_TILE_KEYS
keys, in the design `attention_bwd_design` picks (up to TILE_KEYS queries
and keys csrc/fused_attention_bwd_tile.cu, a block a batch row; with 2 or
more queries past TILE_KEYS keys or queries
csrc/fused_attention_bwd_wide.cu, a query pass of 16-row blocks over
score strips and a key pass; else csrc/fused_attention_bwd.cu, a block a
query row) and, above, autograd of
`reference_middle`, as `_fa_bwd` recomputes through `jax.vjp`.  The
kernels take one head, as the Pallas kernels do (`supported`): more heads
take the dense route, `dense_attention`, at every length.  Per batch
row and query row:

    scores   = Q K^T
    time_qk  = tanh((Q_raw W_t) K_raw^T)            [time mode]
    decay    = tanh(log1p|t_q - t_k| * w1 + b1)     [time mode]
    gate     = wo1*decay + wo2*time_qk + bo         [time mode]
    scores   = scores * sigmoid(gate) / sqrt(d)     [time mode]
    scores   = (scores + log1p|t_q - t_k|)/sqrt(d)  [tisas mode]
    scores   = scores / sqrt(d)                     [plain mode]
    key mask (-2^32+1) -> softmax -> (x dm) -> out = W V

The '*_drop' modes (plain_drop, tisas_drop) multiply the softmax weights
by a pre-drawn dropout mask ``dm`` [B, Tq, Tk] f32 (values 0 or
1/keep) before ``@ V``.  Products sum in f32; the weights are rounded to
v's type before ``@ v`` (the blockwise route rounds each block's
unnormalised exp(s - m) instead, and divides the f32 sum at the end, as
its Pallas kernel does); the output is f32 [B, Tq, d].  A row with
``key_len == 0`` gets a uniform softmax over its Tk keys, and no score
gradient, as in the unpadded jnp reference.
"""

from __future__ import annotations

import ctypes

import torch

from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as chain

MODES = ("plain", "time", "tisas", "plain_drop", "tisas_drop")
DTYPES = (torch.float32, torch.bfloat16)
NEG_FILL = -(2.0 ** 32) + 1.0
SINGLE_TILE_KEYS = 1024   # <= this: the single-tile kernels
KEY_BLOCK = 512           # > that: online-softmax blocks of this many keys
MAX_KEYS = 32768          # the blockwise kernel's cap; longer: the dense route
BLOCKWISE_MODES = ("plain", "time", "tisas")
BLOCKWISE_MAX_D = 256     # the blockwise kernel holds outputs in registers
BLOCKWISE_DESIGNS = ("mma", "regtile", "split", "simt")   # `blockwise_design`
TILED_MAX_D = 128         # the tiled designs' d: 16, 32, ..., 128
# the split design's keys a block (Tq = 1): one length for every Tk and
# batch, so a row's output has the same bits alone or in a batch
SPLIT_KEYS = 256
SPLIT_MAX_KEYS = 1024     # the longest split its kernel takes
BWD_SMEM_BYTES = 48 * 1024   # the rows design's per-(row, query) scratch
# the backward's designs (`attention_bwd_design`): "tile", a block a batch
# row with its whole Tq x Tk problem in shared memory, padded to TILE_KEYS;
# "wide", past TILE_KEYS keys or queries, a query pass of 16-row blocks
# over f32 score strips, then a key pass; "rows", the earlier, a
# block a (batch row, query row)
BWD_DESIGNS = ("tile", "wide", "rows")
TILE_KEYS = 64            # the tile design's largest Tq and Tk
TILE_WIDTHS = (16, 32, 64, 128)   # its d: the powers of two to TILED_MAX_D
GATE_ROWS = 32            # batch rows a part of the tile design's gate sums
GATE_MAX_ROWS = 4096      # batch rows a gate-sum launch takes (128 parts)
GATE_WORKSPACE_CAP = 1 << 25   # f32 gate terms a chunk of rows may hold
# the single-tile forward's designs (`attention_fwd_design`): "tile", a
# block a batch row with its whole Tq x Tk problem in shared memory (the
# backward's layout); "hop", a block a batch row of one query (MTAM's
# readout hops) with its rows in shared memory; "blocked", a block a
# batch row of one query past HOP_KEYS keys, its rows streamed in 64-key
# blocks (the chain readout's BLOCK_KEYS) through a ring of shared-memory
# slots and its f32 scores in a strip; "wide", past TILE_KEYS keys or
# queries, a block 16 query rows of a batch row with their f32 score strip
# in shared memory; "query", the earlier, a block a (batch row, query row)
FWD_DESIGNS = ("tile", "hop", "blocked", "wide", "query")
HOP_KEYS = 64             # the hop design's largest Tk
WIDE_KEY_PAD = 32         # their strips' (and planes') Tk padded to this
# their keys a step, by input type (the products' blocking)
WIDE_KEY_BLOCK = {torch.bfloat16: 32, torch.float32: 16}
WIDE_QUERY_STEP = 32      # the wide backward's key pass: queries a step
# the operands each design's launch copies 16 bytes at a time, by index in
# the forward's arguments: always, and in time mode also
FWD_ALIGNED = {"tile": ((0, 1, 2), (5, 6)), "hop": ((1, 2), (6,)),
               "blocked": ((1, 2), (6,)), "wide": ((0, 1, 2), (5, 6))}

# kernel launches per mode (the plain twins are not counted)
launches = {mode: 0 for mode in MODES}            # either forward design
fwd_hop_launches = {mode: 0 for mode in MODES}    # the hop design alone
fwd_blocked_launches = {mode: 0 for mode in MODES}   # the blocked design
fwd_wide_launches = {mode: 0 for mode in MODES}   # the wide design alone
fwd_query_launches = {mode: 0 for mode in MODES}  # the query design alone
bwd_launches = {mode: 0 for mode in MODES}     # any design
bwd_wide_launches = {mode: 0 for mode in MODES}   # the wide design alone
bwd_rows_launches = {mode: 0 for mode in MODES}   # the rows design alone
# the blockwise kernel's four designs: SIMT (forced, or Tq > 1 at a d the
# tiles do not take), tensor cores (bf16, Tq > 1), register tiles (f32, Tq
# > 1) and split keys (Tq = 1; its two launches, splits and merge, count
# once)
blockwise_launches = {mode: 0 for mode in BLOCKWISE_MODES}
blockwise_mma_launches = {mode: 0 for mode in BLOCKWISE_MODES}
blockwise_regtile_launches = {mode: 0 for mode in BLOCKWISE_MODES}
blockwise_split_launches = {mode: 0 for mode in BLOCKWISE_MODES}
# calls of the dense route (`dense_attention`, plain PyTorch on every
# device, as JAX's jnp route): forwards past the kernels' reach (more
# than one head at any length among them), and the backward's recompute
# above SINGLE_TILE_KEYS keys
dense_fwd = {mode: 0 for mode in MODES}
dense_bwd = {mode: 0 for mode in MODES}


def base_mode(mode: str) -> str:
    """'plain_drop' -> 'plain', 'tisas_drop' -> 'tisas', else the mode."""
    return mode[:-len("_drop")] if mode.endswith("_drop") else mode


def supported(tk: int, num_heads: int) -> bool:
    """Whether a call takes a kernel at all (JAX `supported`)."""
    return num_heads == 1 and tk <= MAX_KEYS


def dropout_supported(tk: int) -> bool:
    """Attention-weight dropout rides the single-tile kernel only (JAX
    `dropout_supported`)."""
    return tk <= SINGLE_TILE_KEYS


def route(tk: int, drop: bool, num_heads: int = 1) -> str:
    """The forward's route for Tk keys: 'single_tile', 'blockwise', or
    'dense' (more than one head, a drop mask past SINGLE_TILE_KEYS, or
    more than MAX_KEYS keys), where the kernels do not reach and the
    caller takes `dense_attention`."""
    if not supported(tk, num_heads) or (drop and not dropout_supported(tk)):
        return "dense"
    return "single_tile" if tk <= SINGLE_TILE_KEYS else "blockwise"


def _check(mode, q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo,
           key_len, dm) -> None:
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
    if mode.endswith("_drop"):
        if dm is None or tuple(dm.shape) != (b, tq, tk) \
                or dm.dtype != torch.float32:
            raise ValueError(
                f"fused_attention {mode}: dm must be a float32 {(b, tq, tk)} "
                "mask, got "
                f"{None if dm is None else (dm.dtype, tuple(dm.shape))}")
    elif dm is not None:
        raise ValueError(f"fused_attention {mode}: only the '*_drop' modes "
                         "take a dropout mask")


def fused_attention(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                    w1, b1, wo1, wo2, bo, key_len, dm=None) -> torch.Tensor:
    """q, tqw: [B,Tq,d]; k, v, rawk: [B,Tk,d]; t_q: [B,Tq]; t_k: [B,Tk];
    gate params w1, b1, wo1, wo2, bo: [Tq,Tk]; key_len: [B] int32; dm:
    the '*_drop' modes' f32 [B,Tq,Tk] mask (None otherwise).  Modes that
    do not read an operand still take it at its shape.  Returns f32
    [B,Tq,d].  By `route`: up to SINGLE_TILE_KEYS keys CPU tensors run
    `fused_attention_plain` and CUDA tensors launch the single-tile
    kernel in the design `attention_fwd_design` picks; above, the
    blockwise kernel (`fused_attention_blockwise`, its twin
    `fused_attention_blockwise_plain` on the CPU; on CUDA the design
    `blockwise_design` picks).  A drop mask above
    SINGLE_TILE_KEYS keys, or more than MAX_KEYS keys, raises: the caller
    takes `dense_attention` there, as JAX takes its jnp path."""
    args = (q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo, key_len, dm)
    _check(mode, *args)
    tk = k.shape[1]
    taken = route(tk, dm is not None)
    if taken == "dense":
        raise ValueError(
            f"fused_attention {mode}: no kernel takes Tk={tk}"
            + (" with a dropout mask" if dm is not None else "")
            + f" (the single-tile kernels take Tk <= {SINGLE_TILE_KEYS}, the "
            f"blockwise kernel no mask and Tk <= {MAX_KEYS}); use "
            "dense_attention")
    if taken == "blockwise":
        return fused_attention_blockwise(mode, *args[:-1])
    if q.device.type == "cpu":
        return fused_attention_plain(mode, *args)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    return _launch(mode, *args)


def _single_tile(what, tk) -> None:
    if not 1 <= tk <= SINGLE_TILE_KEYS:
        raise ValueError(
            f"{what}: the single-tile kernel takes 1 <= Tk <= "
            f"{SINGLE_TILE_KEYS}, got Tk={tk}")


def attention_fwd_design(dtype: torch.dtype, tq: int, tk: int,
                         d: int) -> str:
    """The single-tile forward's design for a shape.  "tile" where 2 <= Tq
    <= TILE_KEYS, 1 <= Tk <= TILE_KEYS and d is one of TILE_WIDTHS, in
    both dtypes (bf16 products on the tensor cores, f32 on the FMA
    units): one block a batch row holds its whole problem in shared
    memory, padded to TILE_KEYS x TILE_KEYS (the self-attention blocks'
    Tq = Tk = 50).  "hop" where Tq = 1, 1 <= Tk <= HOP_KEYS and d is a
    multiple of 16 up to TILED_MAX_D, in both dtypes: one block a batch
    row stages its rows in shared memory by bulk copies (MTAM's readout
    hops at L=50).  "blocked" where Tq = 1, HOP_KEYS < Tk <=
    SINGLE_TILE_KEYS and d is a multiple of 16 up to TILED_MAX_D, in both
    dtypes: one block a batch row streams its rows through a ring of
    64-key shared-memory slots by bulk copies and keeps its f32 scores in
    a strip (MTAM's serving hops at 65 <= L <= 255, the plain-kind
    readout's up to SINGLE_TILE_KEYS).  "wide" where 2 <= Tq
    <= SINGLE_TILE_KEYS, 1 <= Tk <= SINGLE_TILE_KEYS, Tq or Tk past
    TILE_KEYS and d is one of TILE_WIDTHS, in both dtypes: one block 16
    query rows of a batch row keeps their f32 score strip in shared
    memory and streams the keys through it (the self-attention blocks at
    64 < L <= 1024).  "query" elsewhere (other widths, up to
    SINGLE_TILE_KEYS).  The tile and wide launches also want q, k, v
    (and in time mode tqw and rawk), the hop and blocked launches k and v
    (and rawk), 16-byte aligned (FWD_ALIGNED), and refuse them
    otherwise."""
    if dtype not in DTYPES:
        raise TypeError(f"fused_attention: no design for {dtype}")
    if 2 <= tq <= TILE_KEYS and 1 <= tk <= TILE_KEYS and d in TILE_WIDTHS:
        return "tile"
    if tq == 1 and d % 16 == 0 and 16 <= d <= TILED_MAX_D:
        if 1 <= tk <= HOP_KEYS:
            return "hop"
        if HOP_KEYS < tk <= SINGLE_TILE_KEYS:
            return "blocked"
    if _wide_takes(tq, tk, d):
        return "wide"
    return "query"


def _wide_takes(tq: int, tk: int, d: int) -> bool:
    """The shapes of both wide designs: 2 <= Tq <= SINGLE_TILE_KEYS, 1 <=
    Tk <= SINGLE_TILE_KEYS, past the tile designs' TILE_KEYS in Tq or Tk,
    d one of TILE_WIDTHS."""
    return (2 <= tq <= SINGLE_TILE_KEYS and 1 <= tk <= SINGLE_TILE_KEYS
            and max(tq, tk) > TILE_KEYS and d in TILE_WIDTHS)


def _launch(mode, *args, _design=None) -> torch.Tensor:
    """Launch the single-tile forward in the design `attention_fwd_design`
    picks.  ``_design="query"`` forces the earlier design (chip_smoke.py
    holds and times it beside the tile, hop, blocked and wide designs);
    "tile", "hop", "blocked" and "wide" only where they are picked.  The
    main path passes nothing.  A design that fails to build or launch, or
    an operand its copies cannot take (FWD_ALIGNED), raises: there is no
    fallback."""
    q, k, dm = args[0], args[1], args[-1]
    b, tq, d = q.shape
    tk = k.shape[1]
    picked = attention_fwd_design(q.dtype, tq, tk, d)
    design = picked if _design is None else _design
    if design not in (picked, "query"):
        raise ValueError(
            f"fused_attention: design {design!r} does not take Tq={tq}, "
            f"Tk={tk}, d={d} (attention_fwd_design: {picked!r})")
    if design in FWD_ALIGNED:
        always, timed = FWD_ALIGNED[design]
        read = always + (timed if base_mode(mode) == "time" else ())
        if any(args[i].data_ptr() % 16 for i in read):
            names = ("q", "k", "v", "t_q", "t_k", "tqw", "rawk")
            raise ValueError(
                f"fused_attention: the {design} design takes "
                f"{', '.join(names[i] for i in always)} (and "
                f"{', '.join(names[i] for i in timed)} in time mode) "
                "16-byte aligned")
    tensors = args[:-1] if dm is None else args
    device, stream = build.launch_context(tensors, "fused_attention")
    _single_tile("fused_attention", tk)
    out = torch.empty((b, tq, d), dtype=torch.float32, device=q.device)
    ptrs = (*(None if t is None else t.data_ptr() for t in args),
            out.data_ptr(), b, tq, tk, d, 1.0 / d ** 0.5, device, stream)
    mode_id, is_bf16 = MODES.index(mode), int(q.dtype == torch.bfloat16)
    if design == "tile":
        lib = _tile_library()
        status = lib.fused_attention_tile_launch(mode_id, is_bf16, *ptrs)
        build.check(lib, status, "fused_attention (tile)")
    elif design == "hop":
        lib = _hop_library()
        status = lib.fused_attention_hop_launch(mode_id, is_bf16, *ptrs)
        build.check(lib, status, "fused_attention (hop)")
        fwd_hop_launches[mode] += 1
    elif design == "blocked":
        lib = _blocked_library()
        status = lib.fused_attention_blocked_launch(mode_id, is_bf16, *ptrs)
        build.check(lib, status, "fused_attention (blocked)")
        fwd_blocked_launches[mode] += 1
    elif design == "wide":
        lib = _wide_library()
        status = lib.fused_attention_wide_launch(mode_id, is_bf16, *ptrs)
        build.check(lib, status, "fused_attention (wide)")
        fwd_wide_launches[mode] += 1
    else:
        lib = _library()
        status = lib.fused_attention_launch(mode_id, is_bf16, *ptrs)
        build.check(lib, status, "fused_attention")
        fwd_query_launches[mode] += 1
    launches[mode] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("fused_attention")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_launch.argtypes = (
            [ci, ci] + [vp] * 15 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.fused_attention_launch.restype = ci
        lib._port_typed = True
    return lib


def _tile_library() -> ctypes.CDLL:
    lib = build.library("fused_attention_tile")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_tile_launch.argtypes = (
            [ci, ci] + [vp] * 15 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.fused_attention_tile_launch.restype = ci
        lib.fused_attention_tile_smem_bytes.argtypes = [ci, ci, ci]
        lib.fused_attention_tile_smem_bytes.restype = ctypes.c_longlong
        lib.fused_attention_tile_blocks_per_sm.argtypes = [ci, ci, ci, ci]
        lib.fused_attention_tile_blocks_per_sm.restype = ci
        lib._port_typed = True
    return lib


def _hop_library() -> ctypes.CDLL:
    lib = build.library("fused_attention_hop")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_hop_launch.argtypes = (
            [ci, ci] + [vp] * 15 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.fused_attention_hop_launch.restype = ci
        lib.fused_attention_hop_smem_bytes.argtypes = [ci] * 4
        lib.fused_attention_hop_smem_bytes.restype = ctypes.c_longlong
        lib.fused_attention_hop_blocks_per_sm.argtypes = [ci] * 5
        lib.fused_attention_hop_blocks_per_sm.restype = ci
        lib._port_typed = True
    return lib


def _blocked_library() -> ctypes.CDLL:
    lib = build.library("fused_attention_blocked")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_blocked_launch.argtypes = (
            [ci, ci] + [vp] * 15 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.fused_attention_blocked_launch.restype = ci
        lib.fused_attention_blocked_smem_bytes.argtypes = [ci] * 4
        lib.fused_attention_blocked_smem_bytes.restype = ctypes.c_longlong
        lib.fused_attention_blocked_blocks_per_sm.argtypes = [ci] * 5
        lib.fused_attention_blocked_blocks_per_sm.restype = ci
        lib._port_typed = True
    return lib


def _wide_library() -> ctypes.CDLL:
    lib = build.library("fused_attention_wide")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_wide_launch.argtypes = (
            [ci, ci] + [vp] * 15 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.fused_attention_wide_launch.restype = ci
        lib.fused_attention_wide_smem_bytes.argtypes = [ci] * 4
        lib.fused_attention_wide_smem_bytes.restype = ctypes.c_longlong
        lib.fused_attention_wide_blocks_per_sm.argtypes = [ci] * 5
        lib.fused_attention_wide_blocks_per_sm.restype = ci
        lib._port_typed = True
    return lib


def _scores(mode, q, k, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo):
    """The f32 scores before the key mask, and the time mode's
    intermediates (s0 = QK^T, logdt, time_qk, decay, sigmoid(gate))."""
    base = base_mode(mode)
    scale = 1.0 / q.shape[-1] ** 0.5
    s0 = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    parts = {"s0": s0}
    if base in ("time", "tisas"):
        parts["logdt"] = torch.log1p(torch.abs(t_q.float()[:, :, None]
                                               - t_k.float()[:, None, :]))
    if base == "time":
        parts["time_qk"] = torch.tanh(torch.einsum(
            "bqd,bkd->bqk", tqw.float(), rawk.float()))
        parts["decay"] = torch.tanh(parts["logdt"] * w1.float() + b1.float())
        parts["sig"] = torch.sigmoid(wo1.float() * parts["decay"]
                                     + wo2.float() * parts["time_qk"]
                                     + bo.float())
        return s0 * parts["sig"] * scale, parts
    if base == "tisas":
        return (s0 + parts["logdt"]) * scale, parts
    return s0 * scale, parts


def _live(key_len, tk, device) -> torch.Tensor:
    col = torch.arange(tk, device=device)
    return col[None, None, :] < key_len[:, None, None]


def fused_attention_plain(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                          w1, b1, wo1, wo2, bo, key_len, dm=None
                          ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the math of the JAX package's
    `_reference_middle`, with the kernel's operand rounding)."""
    scores, _ = _scores(mode, q, k, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo)
    live = _live(key_len, k.shape[1], q.device)
    scores = torch.where(live, scores, torch.full_like(scores, NEG_FILL))
    weights = torch.softmax(scores, dim=-1)
    if dm is not None:
        weights = weights * dm
    return torch.einsum("bqk,bkd->bqd", weights.to(v.dtype).float(),
                        v.float())


def _tile_fwd_design_plain(mode: str, q, k, v, t_q, t_k, tqw, rawk, w1, b1,
                           wo1, wo2, bo, key_len, dm=None) -> torch.Tensor:
    """The forward tile design's arithmetic in plain PyTorch (the
    arguments and result of `fused_attention`): q and tqw padded to
    TILE_KEYS rows with zeros; k and rawk zero past each row's live keys,
    v past the keys its weights reach (all Tk in a row with none live),
    padded the same way; the score planes S0 and TQK as f32 products of
    those; the middle as the kernel's warps compute it, each key's score
    from its own plane values, -2^32 + 1 at masked keys, the softmax over
    the Tk keys, then dm; the weights rounded to v's type and zero-padded
    to TILE_KEYS x TILE_KEYS; the output the f32 product of that plane
    and the padded v, its first Tq rows."""
    base = base_mode(mode)
    b, tq, d = q.shape
    tk = k.shape[1]
    n = TILE_KEYS
    scale = 1.0 / d ** 0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    live = key_len.long().clamp(0, tk)
    span = torch.where(live > 0, live, torch.full_like(live, tk))
    row = torch.arange(n, device=q.device)[None, :, None]

    def pad(x, rows, valid=None):
        x = torch.cat([x.float(), torch.zeros((b, n - rows, d), **f32)],
                      dim=1)
        if valid is None:
            return x
        return torch.where(row < valid[:, None, None], x,
                           torch.zeros((), **f32))

    qp, tqwp = pad(q, tq), pad(tqw, tq)
    kp, rawkp, vp = pad(k, tk, live), pad(rawk, tk, live), pad(v, tk, span)
    nt = lambda x, y: torch.einsum("bqd,bkd->bqk", x, y)  # noqa: E731
    s0 = nt(qp, kp)[:, :tq, :tk]
    if base in ("time", "tisas"):
        ldt = torch.log1p(torch.abs(t_q.float()[:, :, None]
                                    - t_k.float()[:, None, :]))
    if base == "time":
        tqk = nt(tqwp, rawkp)[:, :tq, :tk]
        dec = torch.tanh(ldt * w1.float() + b1.float())
        sig = torch.sigmoid(wo1.float() * dec + wo2.float() * torch.tanh(tqk)
                            + bo.float())
        sc = s0 * sig * scale
    elif base == "tisas":
        sc = (s0 + ldt) * scale
    else:
        sc = s0 * scale
    lv = torch.arange(tk, device=q.device)[None, None, :] \
        < live[:, None, None]
    s = torch.where(lv, sc, torch.full_like(sc, NEG_FILL))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    if dm is not None:
        w = w * dm
    plane = torch.nn.functional.pad(w.to(v.dtype).float(),
                                    (0, n - tk, 0, n - tq))
    return torch.einsum("bqk,bkd->bqd", plane, vp)[:, :tq]


def _hop_fwd_design_plain(mode: str, q, k, v, t_q, t_k, tqw, rawk, w1, b1,
                          wo1, wo2, bo, key_len, dm=None) -> torch.Tensor:
    """The forward hop design's arithmetic in plain PyTorch (the arguments
    and result of `fused_attention`, at Tq = 1 and the shapes
    `attention_fwd_design` gives "hop"), on the chain readout's staged
    layout: k and rawk staged zero past each row's live keys and v past
    the keys its weights reach (all Tk in a row with none live), zero-
    padded to HOP_KEYS rows; the rest as `_one_query_design_plain`."""
    return _one_query_design_plain("hop", mode, q, k, v, t_q, t_k, tqw, rawk,
                                   w1, b1, wo1, wo2, bo, key_len, dm)


def _blocked_fwd_design_plain(mode: str, q, k, v, t_q, t_k, tqw, rawk, w1,
                              b1, wo1, wo2, bo, key_len, dm=None
                              ) -> torch.Tensor:
    """The forward blocked design's arithmetic in plain PyTorch (the
    arguments and result of `fused_attention`, at Tq = 1 and the shapes
    `attention_fwd_design` gives "blocked"): the hop design's over whole
    key blocks, k and rawk zero past each row's live keys and v past the
    keys its weights reach, zero-padded to a multiple of the chain
    readout's BLOCK_KEYS rows (the ring's slots), the score dots a block
    at a time into the f32 strip of all Tk keys, and o by the 16 key
    slices h, h+16, ... taken in key order across the blocks
    (`_one_query_design_plain`)."""
    return _one_query_design_plain("blocked", mode, q, k, v, t_q, t_k, tqw,
                                   rawk, w1, b1, wo1, wo2, bo, key_len, dm)


def _strip_sum(x) -> torch.Tensor:
    """[B, n] -> [B]: the sum over a row as a warp takes a strip's sum
    (chain_staged.cuh `strip_sum`): lane j its keys j, j + 32, ... in
    order, then the 32 lanes by xor shuffles (offsets 16, 8, 4, 2, 1)."""
    b, n = x.shape
    padded = torch.nn.functional.pad(x, (0, -n % 32))
    lanes = torch.zeros((b, 32), dtype=x.dtype, device=x.device)
    for j0 in range(0, padded.shape[1], 32):
        lanes = lanes + padded[:, j0:j0 + 32]
    idx = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    return lanes[:, 0]


def _one_query_design_plain(design: str, mode: str, q, k, v, t_q, t_k, tqw,
                            rawk, w1, b1, wo1, wo2, bo, key_len, dm=None
                            ) -> torch.Tensor:
    """The hop and blocked designs' arithmetic (Tq = 1, a block a batch
    row on the chain readout's thread mapping): the rows as the design
    stages them (`chain._staged`, zero-padded as the chain readout's
    staged and blocked designs pad, `chain._padded_keys`); the score dots
    q . k_c and tqw . rawk_c by the lane columns and a half-warp's
    butterfly; the gate, the scale, -2^32 + 1 at masked keys; the softmax
    over the Tk keys with the strip's sum (`_strip_sum`), then dm; the
    weights rounded to v's type; out = sum_c w_c v_c by 16 key slices in
    order (the kernel's half-warps), then the warps in order."""
    base = base_mode(mode)
    b, tq, d = q.shape
    tk = k.shape[1]
    if attention_fwd_design(q.dtype, tq, tk, d) != design:
        raise ValueError(f"_{design}_fwd_design_plain: the {design} design "
                         f"does not take Tq={tq}, Tk={tk}, d={d}")
    keys = chain._padded_keys("staged" if design == "hop" else "blocked", tk)
    scale = 1.0 / d ** 0.5
    cols = chain._lane_columns(d, q.dtype)
    live_rows, reached_rows = chain._staged_masks(key_len, tk, keys)
    s0 = chain._lanes_dot(q.float(), chain._staged(k, live_rows),
                          cols)[:, :tk]
    if base in ("time", "tisas"):
        ldt = torch.log1p(torch.abs(t_q.float() - t_k.float()))
    if base == "time":
        tqk = chain._lanes_dot(tqw.float(), chain._staged(rawk, live_rows),
                               cols)[:, :tk]
        dec = torch.tanh(ldt * w1.float() + b1.float())
        sig = torch.sigmoid(wo1.float() * dec + wo2.float() * torch.tanh(tqk)
                            + bo.float())
        sc = s0 * sig * scale
    elif base == "tisas":
        sc = (s0 + ldt) * scale
    else:
        sc = s0 * scale
    lv = torch.arange(tk, device=q.device)[None, :] \
        < key_len.long()[:, None]
    s = torch.where(lv, sc, torch.full_like(sc, NEG_FILL))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / _strip_sum(e)[:, None]
    if dm is not None:
        w = w * dm[:, 0]
    w = w.to(v.dtype).float()
    return chain._key_slices(chain._pad_keys(w, keys),
                             chain._staged(v, reached_rows))[:, None, :]


def _wide_scores(mode, q, k, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo,
                 key_len):
    """The wide designs' scores in plain PyTorch: k and rawk zero past
    each row's live keys; S0 = q k^T and TQK = tqw rawk^T as f32 products;
    each live key's score from its own values (the gate, the scale), -2^32
    + 1 at a masked key.  Returns (the scores [B, Tq, Tk], the live-key
    mask [B, 1, Tk], and the intermediates s0, ldt, dec, tqk and sig, each
    0 at a masked key)."""
    base = base_mode(mode)
    b, tq, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / d ** 0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    zero = torch.zeros((), **f32)
    lv = torch.arange(tk, device=q.device)[None, None, :] \
        < key_len.long().clamp(0, tk)[:, None, None]
    live_rows = lv.transpose(1, 2)                       # [B, Tk, 1]
    nt = lambda x, y: torch.einsum("bqd,bkd->bqk", x, y)  # noqa: E731
    live_only = lambda x: torch.where(lv, x, zero)  # noqa: E731
    s0 = live_only(nt(q.float(), torch.where(live_rows, k.float(), zero)))
    parts = {"s0": s0}
    if base in ("time", "tisas"):
        parts["ldt"] = live_only(torch.log1p(torch.abs(
            t_q.float()[:, :, None] - t_k.float()[:, None, :])))
    if base == "time":
        tqk = live_only(torch.tanh(nt(tqw.float(), torch.where(
            live_rows, rawk.float(), zero))))
        dec = live_only(torch.tanh(parts["ldt"] * w1.float() + b1.float()))
        sig = live_only(torch.sigmoid(wo1.float() * dec + wo2.float() * tqk
                                      + bo.float()))
        parts.update(tqk=tqk, dec=dec, sig=sig)
        sc = s0 * sig * scale
    elif base == "tisas":
        sc = (s0 + parts["ldt"]) * scale
    else:
        sc = s0 * scale
    return torch.where(lv, sc, torch.full_like(sc, NEG_FILL)), lv, parts


def _key_blocks(tk, step):
    return [slice(c0, min(c0 + step, tk)) for c0 in range(0, tk, step)]


def _wide_fwd_design_plain(mode: str, q, k, v, t_q, t_k, tqw, rawk, w1, b1,
                           wo1, wo2, bo, key_len, dm=None) -> torch.Tensor:
    """The forward wide design's arithmetic in plain PyTorch (the
    arguments and result of `fused_attention`, at the shapes
    `attention_fwd_design` gives "wide"): the scores of `_wide_scores`
    (the kernel's strip), the softmax over the Tk keys, then dm; the
    weights rounded to v's type; v zero past the keys the weights reach
    (all Tk in a row with none live); the output summed over the key
    blocks (WIDE_KEY_BLOCK keys) in order, each block's product in f32."""
    b, tq, d = q.shape
    tk = k.shape[1]
    if attention_fwd_design(q.dtype, tq, tk, d) != "wide":
        raise ValueError(f"_wide_fwd_design_plain: the wide design does not "
                         f"take Tq={tq}, Tk={tk}, d={d}")
    s, _, _ = _wide_scores(mode, q, k, t_q, t_k, tqw, rawk, w1, b1, wo1,
                           wo2, bo, key_len)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    if dm is not None:
        w = w * dm
    w = w.to(v.dtype).float()
    live = key_len.long().clamp(0, tk)
    span = torch.where(live > 0, live, torch.full_like(live, tk))
    vr = torch.where(torch.arange(tk, device=q.device)[None, :, None]
                     < span[:, None, None], v.float(),
                     torch.zeros((), dtype=torch.float32, device=q.device))
    out = torch.zeros((b, tq, d), dtype=torch.float32, device=q.device)
    for blk in _key_blocks(tk, WIDE_KEY_BLOCK[q.dtype]):
        out = out + torch.einsum("bqk,bkd->bqd", w[:, :, blk], vr[:, blk])
    return out


# ------------------------------------------------------------ blockwise

def fused_attention_blockwise(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                              w1, b1, wo1, wo2, bo, key_len) -> torch.Tensor:
    """The forward above SINGLE_TILE_KEYS keys (`fused_attention` routes
    there): modes plain, time and tisas, the arguments of
    `fused_attention` without a mask.  Returns f32 [B,Tq,d].  CPU tensors
    run `fused_attention_blockwise_plain`; CUDA tensors launch the
    blockwise kernel (1 <= Tk <= MAX_KEYS, d <= BLOCKWISE_MAX_D) in the
    design `blockwise_design` picks."""
    if mode not in BLOCKWISE_MODES:
        raise ValueError(f"fused_attention_blockwise: mode {mode!r} is not "
                         f"one of {BLOCKWISE_MODES}")
    args = (q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo, key_len)
    _check(mode, *args, None)
    if q.device.type == "cpu":
        return fused_attention_blockwise_plain(mode, *args)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_blockwise: no kernel for device "
                         f"{q.device}")
    return _launch_blockwise(mode, *args)


def blockwise_design(dtype: torch.dtype, tq: int, d: int) -> str:
    """The blockwise kernel's design for a shape.  Tq = 1: "split" (each
    row's keys in SPLIT_KEYS-key splits, a block each, then a merge),
    since one block a row leaves most SMs idle at serving batches.  With
    Tq > 1 and d a multiple of 16 up to TILED_MAX_D, tiles of 64 queries:
    "mma" (tensor cores, mma.sync) for bf16, "regtile" (f32 FMA from
    registers, 8 or 4 queries x 4 keys a thread) for f32, whose 1e-4
    agreement TF32 tensor cores cannot give.  "simt" (FMA from shared
    memory, a block a row and query tile) for any other d."""
    if tq == 1:
        return "split"
    if d % 16 == 0 and 16 <= d <= TILED_MAX_D:
        return "mma" if dtype == torch.bfloat16 else "regtile"
    return "simt"


def _launch_blockwise(mode, *args, _design=None,
                      _split=None) -> torch.Tensor:
    """Launch the blockwise kernel in the design `blockwise_design` picks.
    ``_design="simt"`` forces the SIMT design (chip_smoke.py holds and
    times it beside the design picked); "mma", "regtile" and "split" only
    where they are picked.  ``_split`` sets the split design's keys a
    split in place of SPLIT_KEYS (chip_smoke.py's probe of the length).
    The main path passes neither.  A design that fails to build or launch
    raises: there is no fallback."""
    q, k = args[0], args[1]
    b, tq, d = q.shape
    tk = k.shape[1]
    picked = blockwise_design(q.dtype, tq, d)
    design = picked if _design is None else _design
    if design not in (picked, "simt"):
        raise ValueError(
            f"fused_attention_blockwise: design {design!r} does not take "
            f"{q.dtype} with Tq={tq}, d={d} (blockwise_design: {picked!r})")
    split = SPLIT_KEYS if _split is None else _split
    if design == "split" and not 1 <= split <= SPLIT_MAX_KEYS:
        raise ValueError(f"fused_attention_blockwise: a split takes 1 to "
                         f"{SPLIT_MAX_KEYS} keys, got {split}")
    device, stream = build.launch_context(args, "fused_attention_blockwise")
    if not 1 <= tk <= MAX_KEYS or not 1 <= d <= BLOCKWISE_MAX_D:
        raise ValueError(
            f"fused_attention_blockwise: the kernel takes 1 <= Tk <= "
            f"{MAX_KEYS} and 1 <= d <= {BLOCKWISE_MAX_D}, got Tk={tk}, d={d}")
    lib = _blockwise_library()
    out = torch.empty((b, tq, d), dtype=torch.float32, device=q.device)
    ptrs = [t.data_ptr() for t in args]
    if design == "split":
        # each split's (m, l, acc[d]), freed when the call returns
        ws = torch.empty((b * -(-tk // split) * (d + 2),),
                         dtype=torch.float32, device=q.device)
        status = lib.fused_attention_blockwise_split_launch(
            BLOCKWISE_MODES.index(mode), int(q.dtype == torch.bfloat16),
            *ptrs, out.data_ptr(), ws.data_ptr(), b, tk, d, split,
            1.0 / d ** 0.5, device, stream)
        build.check(lib, status, "fused_attention_blockwise (split)")
        blockwise_split_launches[mode] += 1
        return out
    if design != "simt":
        # q, k, v, tqw and rawk are staged 16 bytes at a time
        if any(ptrs[i] % 16 for i in (0, 1, 2, 5, 6)):
            raise ValueError(f"fused_attention_blockwise: the {design} "
                             "design takes q, k, v, tqw and rawk 16-byte "
                             "aligned")
        launch, counts = ((lib.fused_attention_blockwise_mma_launch,
                           blockwise_mma_launches) if design == "mma" else
                          (lib.fused_attention_blockwise_regtile_launch,
                           blockwise_regtile_launches))
        status = launch(BLOCKWISE_MODES.index(mode), *ptrs, out.data_ptr(),
                        b, tq, tk, d, 1.0 / d ** 0.5, device, stream)
        build.check(lib, status, f"fused_attention_blockwise ({design})")
        counts[mode] += 1
        return out
    status = lib.fused_attention_blockwise_launch(
        BLOCKWISE_MODES.index(mode), int(q.dtype == torch.bfloat16),
        *ptrs, out.data_ptr(), b, tq, tk, d, 1.0 / d ** 0.5, device, stream)
    build.check(lib, status, "fused_attention_blockwise")
    blockwise_launches[mode] += 1
    return out


def _blockwise_library() -> ctypes.CDLL:
    lib = build.library("fused_attention_blockwise")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_blockwise_launch.argtypes = (
            [ci, ci] + [vp] * 14 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.fused_attention_blockwise_launch.restype = ci
        lib.fused_attention_blockwise_split_launch.argtypes = (
            [ci, ci] + [vp] * 15 + [ci] * 4 + [ctypes.c_float, ci, vp])
        lib.fused_attention_blockwise_split_launch.restype = ci
        for tiled in (lib.fused_attention_blockwise_mma_launch,
                      lib.fused_attention_blockwise_regtile_launch):
            tiled.argtypes = (
                [ci] + [vp] * 14 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
            tiled.restype = ci
        lib._port_typed = True
    return lib


def fused_attention_blockwise_plain(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                                    w1, b1, wo1, wo2, bo, key_len,
                                    key_block: int = KEY_BLOCK
                                    ) -> torch.Tensor:
    """Plain PyTorch twin of the blockwise kernel, block by block as the
    Pallas `_attn_kernel_blockwise` computes: f32 scores per ``key_block``
    keys, m = max(m, block max), p = exp(s - m), l = l*alpha + sum(p)
    from the unrounded p, acc = acc*alpha + round(p) @ v in f32 with p
    rounded to v's type; the result is acc / l.  The last block stops at
    Tk (Pallas pads it with masked keys, which add nothing except in a row
    with no live key: see `fused_attention`).  ``key_block`` (KEY_BLOCK,
    Pallas's, by default) only moves float rounding in f32, where p is not
    rounded: the register-tiled design moves the max every 64 keys."""
    b, tq, d = q.shape
    tk = k.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, tq, 1), -float("inf"), **f32)
    l = torch.zeros((b, tq, 1), **f32)
    acc = torch.zeros((b, tq, d), **f32)
    for c0 in range(0, tk, key_block):
        cols = slice(c0, min(c0 + key_block, tk))
        scores, _ = _scores(mode, q, k[:, cols], t_q, t_k[:, cols], tqw,
                            rawk[:, cols], w1[:, cols], b1[:, cols],
                            wo1[:, cols], wo2[:, cols], bo[:, cols])
        col = torch.arange(cols.start, cols.stop, device=q.device)
        scores = scores.masked_fill(
            col[None, None, :] >= key_len[:, None, None], NEG_FILL)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd",
                                         p.to(v.dtype).float(),
                                         v[:, cols].float())
        m = m_new
    return acc / l


def _split_design_plain(mode: str, q, k, v, t_q, t_k, tqw, rawk, w1, b1,
                        wo1, wo2, bo, key_len, split=None) -> torch.Tensor:
    """The split design's arithmetic in plain PyTorch, at Tq = 1: for
    each split of ``split`` keys (SPLIT_KEYS by default) its max m_s
    over the keys the weights reach, l_s the sum of the unrounded p =
    exp(s - m_s), acc_s the f32 sum of p rounded to v's type times v (a
    split wholly past those keys: m_s = -inf, l_s = 0); then, over the
    splits in order, m = max m_s, l = sum l_s exp(m_s - m), acc the same,
    and acc / l."""
    b, tq, d = q.shape
    tk = k.shape[1]
    split = SPLIT_KEYS if split is None else split
    live = key_len.long().clamp(0, tk)
    key_end = torch.where(live > 0, live, torch.full_like(live, tk))
    parts = []
    for lo in range(0, tk, split):
        cols = slice(lo, min(lo + split, tk))
        scores, _ = _scores(mode, q, k[:, cols], t_q, t_k[:, cols], tqw,
                            rawk[:, cols], w1[:, cols], b1[:, cols],
                            wo1[:, cols], wo2[:, cols], bo[:, cols])
        col = torch.arange(cols.start, cols.stop, device=q.device)
        scores = scores.masked_fill(
            col[None, None, :] >= key_len[:, None, None], NEG_FILL)
        reach = col[None, None, :] < key_end[:, None, None]
        m = scores.masked_fill(~reach, -float("inf")).amax(-1, keepdim=True)
        p = torch.where(reach, torch.exp(scores - m.clamp_min(NEG_FILL)),
                        torch.zeros_like(scores))
        acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(),
                           v[:, cols].float())
        parts.append((m, p.sum(-1, keepdim=True), acc))
    m = torch.stack([m_s for m_s, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, tq, d), dtype=torch.float32, device=q.device)
    for m_s, l_s, acc_s in parts:
        f = torch.where(m_s > -float("inf"), torch.exp(m_s - m),
                        torch.zeros_like(m_s))
        l = l + l_s * f
        acc = acc + acc_s * f
    return acc / l


def reference_middle(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                     w1, b1, wo1, wo2, bo, key_len, dm=None,
                     num_heads: int = 1,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX package's `_reference_middle` in plain PyTorch, computed
    in ``dtype`` (f32 unless told): the whole [B, Tq, Tk] scores, gate
    and softmax at once.  The gate params may be [Tq, Tk] tiles or
    scalars (they broadcast).  With ``num_heads`` h > 1 it is the JAX jnp
    path's multi-head middle (`_project_qkv` to `_finish`): q, k and v
    split [B, T, h, d/h] -> [B, h, T, d/h]; the time gate (its content
    term on the raw tqw and rawk) and the TiSAS bias once per (row,
    query, key), broadcast over the heads; scores scaled by sqrt(d/h);
    ``dm`` [B, h, Tq, Tk] (at h = 1 [B, Tq, Tk]); the heads merged back.
    Returns [B, Tq, d] in ``dtype``; differentiable."""
    base = base_mode(mode)
    f = lambda x: x.to(dtype)  # noqa: E731
    b, tq, d = q.shape
    dh = d // num_heads

    def heads(x):                              # [B, T, d] -> [B, h, T, dh]
        return f(x).reshape(b, x.shape[1], num_heads, dh).transpose(1, 2)

    scores = torch.einsum("bhqe,bhke->bhqk", heads(q), heads(k))
    if base in ("time", "tisas"):
        logdt = torch.log1p(torch.abs(f(t_q)[:, :, None]
                                      - f(t_k)[:, None, :]))
    if base == "time":
        time_qk = torch.tanh(torch.einsum("bqd,bkd->bqk", f(tqw), f(rawk)))
        decay = torch.tanh(logdt * f(w1) + f(b1))
        gate = f(wo1) * decay + f(wo2) * time_qk + f(bo)
        scores = scores * torch.sigmoid(gate)[:, None] / dh ** 0.5
    elif base == "tisas":
        scores = (scores + logdt[:, None]) / dh ** 0.5
    else:
        scores = scores / dh ** 0.5
    col = torch.arange(scores.shape[-1], device=q.device)
    scores = scores.masked_fill(
        col[None, None, None, :] >= key_len[:, None, None, None], NEG_FILL)
    weights = torch.softmax(scores, dim=-1)
    if dm is not None:
        weights = weights * f(dm if dm.dim() == 4 else dm[:, None])
    out = torch.einsum("bhqk,bhke->bhqe", weights, heads(v))
    return out.transpose(1, 2).reshape(b, tq, d)


def dense_attention(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                    w1, b1, wo1, wo2, bo, key_len, dm=None,
                    num_heads: int = 1) -> torch.Tensor:
    """The dense route (JAX's jnp path where no kernel reaches: more than
    one head, attention-weight dropout above SINGLE_TILE_KEYS keys, or
    more than MAX_KEYS keys): `reference_middle` under autograd, on any
    device, counted in ``dense_fwd[mode]``.  With more than one head it
    computes in q's type, as JAX's jnp path does under bf16 compute; at
    one head in f32 (ROADMAP.md, Queue 3, settled item 6).  Returns
    [B, Tq, d] in that type."""
    dense_fwd[mode] += 1
    return reference_middle(mode, q, k, v, t_q, t_k, tqw, rawk,
                            w1, b1, wo1, wo2, bo, key_len, dm, num_heads,
                            q.dtype if num_heads > 1 else torch.float32)


# ------------------------------------------------------------- backward

def fused_attention_bwd(mode: str, g, q, k, v, t_q, t_k, tqw, rawk,
                        w1, b1, wo1, wo2, bo, key_len, dm=None):
    """Backward of `fused_attention`: g is the f32 cotangent [B,Tq,d] of
    its output; the other arguments are its inputs.  Returns the f32
    cotangents (dq, dk, dv, dtqw, drawk, dw1, db1, dwo1, dwo2, dbo); the
    five gate cotangents are summed over the batch.  Outside time mode
    the output does not depend on tqw, rawk or the gate params, and all
    but dq, dk and dv are None (nothing is computed or written for
    them).  The scores, gate and softmax are recomputed from the inputs.
    CPU tensors run `fused_attention_bwd_plain`; CUDA tensors launch the
    kernel in the design `attention_bwd_design` picks."""
    args = (q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo, key_len, dm)
    _check(mode, *args)
    if tuple(g.shape) != tuple(q.shape) or g.dtype != torch.float32:
        raise ValueError(f"fused_attention_bwd: g must be f32 "
                         f"{tuple(q.shape)}, got {g.dtype} {tuple(g.shape)}")
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(mode, g, *args)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: no kernel for device "
                         f"{q.device}")
    return _launch_bwd(mode, g, *args)


def attention_bwd_design(dtype: torch.dtype, tq: int, tk: int, d: int) -> str:
    """The backward's design for a shape.  "tile" where Tq and Tk are at
    most TILE_KEYS and d is one of TILE_WIDTHS, in both dtypes (bf16
    products on the tensor cores, f32 on the FMA units): one block a
    batch row holds its whole problem in shared memory, padded to
    TILE_KEYS x TILE_KEYS (the self-attention steps' Tq = Tk = 50).
    "wide" at the forward's wide shapes (`_wide_takes`: 2 <= Tq, Tk <=
    SINGLE_TILE_KEYS, one past TILE_KEYS, d one of TILE_WIDTHS), in both
    dtypes: a query pass, a block 16 query rows of a batch row
    over f32 score strips, writes the rounded ds0, weights and dpre_tqk
    planes; a key pass sums dk, dv and drawk over them (the self-attention
    steps at 64 < L <= 1024).  "rows" elsewhere (MTAM's Tq = 1 over up to
    1024 keys, other widths).  The tile and wide launches also want g, q,
    k, v (and in time mode tqw and rawk) 16-byte aligned, and refuse them
    otherwise."""
    if dtype not in DTYPES:
        raise TypeError(f"fused_attention_bwd: no design for {dtype}")
    if 1 <= tq <= TILE_KEYS and 1 <= tk <= TILE_KEYS and d in TILE_WIDTHS:
        return "tile"
    if _wide_takes(tq, tk, d):
        return "wide"
    return "rows"


def gate_chunk_rows(b: int, tq: int, tk: int, forced=None) -> int:
    """The batch rows the tile design takes a launch in time mode (its
    gate terms' workspace holds a chunk's rows; the kernel sums the gate
    terms in GATE_ROWS-row parts, so a chunk short of the batch is whole
    parts): ``forced`` (a positive multiple of GATE_ROWS up to
    GATE_MAX_ROWS), or as many whole parts as GATE_WORKSPACE_CAP floats
    hold, at least one and at most GATE_MAX_ROWS; never more than ``b``."""
    if forced is not None:
        if forced <= 0 or forced % GATE_ROWS or forced > GATE_MAX_ROWS:
            raise ValueError(f"fused_attention_bwd: a chunk takes a positive "
                             f"multiple of {GATE_ROWS} rows up to "
                             f"{GATE_MAX_ROWS}, got {forced}")
        rows = forced
    else:
        rows = GATE_WORKSPACE_CAP // (5 * tq * tk) // GATE_ROWS * GATE_ROWS
        rows = min(max(rows, GATE_ROWS), GATE_MAX_ROWS)
    return min(rows, b)


def wide_chunk_rows(b: int, tq: int, tk: int, time_mode: bool,
                    forced=None) -> int:
    """The batch rows a wide backward pass takes: its workspaces hold a
    chunk's rounded planes (ds0, the dropped weights and, in time mode,
    dpre_tqk: each [rows, Tq, Tk padded to WIDE_KEY_PAD]) and, in time
    mode, its five [rows, Tq, Tk] f32 gate terms.  As many rows as
    GATE_WORKSPACE_CAP floats hold (a plane element counted as a float):
    in time mode whole GATE_ROWS-row parts, at least one and at most
    GATE_MAX_ROWS, as `gate_chunk_rows`; else at least one; never more
    than ``b``.  ``forced`` sets it (in time mode as `gate_chunk_rows`
    takes it, else any positive count)."""
    tkp = -(-tk // WIDE_KEY_PAD) * WIDE_KEY_PAD
    if time_mode:
        if forced is not None:
            return gate_chunk_rows(b, tq, tk, forced)
        rows = GATE_WORKSPACE_CAP // (5 * tq * tk + 3 * tq * tkp)
        rows = min(max(rows // GATE_ROWS * GATE_ROWS, GATE_ROWS),
                   GATE_MAX_ROWS)
    elif forced is not None:
        if forced <= 0:
            raise ValueError(f"fused_attention_bwd: a chunk takes a positive "
                             f"count of rows, got {forced}")
        rows = forced
    else:
        rows = max(GATE_WORKSPACE_CAP // (2 * tq * tkp), 1)
    return min(rows, b)


def _launch_bwd(mode, g, *args, _design=None, _chunk_rows=None):
    """Launch the backward in the design `attention_bwd_design` picks.
    ``_design="rows"`` forces the earlier design (chip_smoke.py holds and
    times it beside the tile and wide designs); "tile" and "wide" only
    where they are picked.  ``_chunk_rows`` sets the rows a tile launch
    takes in time mode (`gate_chunk_rows`), or a wide pass in any mode
    (`wide_chunk_rows`; chip_smoke.py's check that the chunking moves no
    bit).  The main path passes neither.  A design that fails to build or
    launch raises: there is no fallback."""
    q, k, dm = args[0], args[1], args[-1]
    b, tq, d = q.shape
    tk = k.shape[1]
    picked = attention_bwd_design(q.dtype, tq, tk, d)
    design = picked if _design is None else _design
    if design not in (picked, "rows"):
        raise ValueError(
            f"fused_attention_bwd: design {design!r} does not take Tq={tq}, "
            f"Tk={tk}, d={d} (attention_bwd_design: {picked!r})")
    time_mode = base_mode(mode) == "time"
    if design in ("tile", "wide"):
        # the batch rows a launch takes: in time mode as many as the gate
        # terms' workspace holds (the wide design's planes too)
        if design == "wide":
            rows = wide_chunk_rows(b, tq, tk, time_mode, _chunk_rows)
        else:
            rows = gate_chunk_rows(b, tq, tk, _chunk_rows) if time_mode \
                else b
        read = (g, q, k, args[2]) + ((args[5], args[6]) if time_mode
                                     else ())
        if any(t.data_ptr() % 16 for t in read):
            raise ValueError(f"fused_attention_bwd: the {design} design "
                             "takes g, q, k, v (and tqw, rawk in time mode) "
                             "16-byte aligned")
    tensors = (g,) + (args[:-1] if dm is None else args)
    device, stream = build.launch_context(tensors, "fused_attention_bwd")
    _single_tile("fused_attention_bwd", tk)
    f32 = dict(dtype=torch.float32, device=q.device)
    # dq, dk, dv (and dtqw, drawk): at Tq = Tk slices of one allocation
    # (the wrapper's host time is most of a call's at the training shape)
    per_row = 5 if time_mode else 3
    if tq == tk:
        grads = torch.empty((per_row, b, tq, d), **f32).unbind(0)
    else:
        grads = tuple(torch.empty((b, t, d), **f32)
                      for t in (tq, tk, tk, tq, tk)[:per_row])
    if time_mode:   # the five gate gradients
        grads += torch.empty((5, tq, tk), **f32).unbind(0)
    grads += (None,) * (10 - len(grads))
    mode_id = MODES.index(mode)
    ptrs = (g.data_ptr(),
            *(None if t is None else t.data_ptr() for t in args),
            *(None if t is None else t.data_ptr() for t in grads))
    is_bf16 = int(q.dtype == torch.bfloat16)
    if design == "tile":
        lib = _bwd_tile_library()
        ws = torch.empty((5 * rows * tq * tk,), **f32) if time_mode else None
        status = lib.fused_attention_bwd_tile_launch(
            mode_id, is_bf16, *ptrs, None if ws is None else ws.data_ptr(),
            b, tq, tk, d, 1.0 / d ** 0.5, rows, device, stream)
        build.check(lib, status, "fused_attention_bwd (tile)")
    elif design == "wide":
        lib = _bwd_wide_library()
        tkp = -(-tk // WIDE_KEY_PAD) * WIDE_KEY_PAD
        planes = torch.empty(((3 if time_mode else 2) * rows * tq * tkp,),
                             dtype=q.dtype, device=q.device)
        ws = torch.empty((5 * rows * tq * tk,), **f32) if time_mode else None
        status = lib.fused_attention_bwd_wide_launch(
            mode_id, is_bf16, *ptrs, planes.data_ptr(),
            None if ws is None else ws.data_ptr(), b, tq, tk, d,
            1.0 / d ** 0.5, rows, device, stream)
        build.check(lib, status, "fused_attention_bwd (wide)")
        bwd_wide_launches[mode] += 1
    else:
        lib = _bwd_library()
        if lib.fused_attention_bwd_smem_bytes(tk, d) > BWD_SMEM_BYTES:
            raise ValueError(
                f"fused_attention_bwd: the rows design keeps (7*Tk + 3*d) "
                f"f32 in {BWD_SMEM_BYTES} bytes of shared memory; got "
                f"Tk={tk}, d={d}")
        ws = torch.empty((lib.fused_attention_bwd_workspace_floats(
            mode_id, b, tq, tk),), **f32)
        status = lib.fused_attention_bwd_launch(
            mode_id, is_bf16, *ptrs, ws.data_ptr(), b, tq, tk, d,
            1.0 / d ** 0.5, device, stream)
        build.check(lib, status, "fused_attention_bwd")
        bwd_rows_launches[mode] += 1
    bwd_launches[mode] += 1
    return grads


def _bwd_library() -> ctypes.CDLL:
    lib = build.library("fused_attention_bwd")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_bwd_launch.argtypes = (
            [ci, ci] + [vp] * 26 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.fused_attention_bwd_launch.restype = ci
        lib.fused_attention_bwd_smem_bytes.argtypes = [ci, ci]
        lib.fused_attention_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.fused_attention_bwd_workspace_floats.argtypes = [ci, ci, ci, ci]
        lib.fused_attention_bwd_workspace_floats.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def _bwd_tile_library() -> ctypes.CDLL:
    lib = build.library("fused_attention_bwd_tile")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_bwd_tile_launch.argtypes = (
            [ci, ci] + [vp] * 26
            + [ci, ci, ci, ci, ctypes.c_float, ci, ci, vp])
        lib.fused_attention_bwd_tile_launch.restype = ci
        lib._port_typed = True
    return lib


def _bwd_wide_library() -> ctypes.CDLL:
    lib = build.library("fused_attention_bwd_wide")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_bwd_wide_launch.argtypes = (
            [ci, ci] + [vp] * 27
            + [ci, ci, ci, ci, ctypes.c_float, ci, ci, vp])
        lib.fused_attention_bwd_wide_launch.restype = ci
        lib.fused_attention_bwd_wide_smem_bytes.argtypes = [ci] * 5
        lib.fused_attention_bwd_wide_smem_bytes.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def fused_attention_bwd_plain(mode: str, g, q, k, v, t_q, t_k, tqw, rawk,
                              w1, b1, wo1, wo2, bo, key_len, dm=None):
    """Plain PyTorch twin of the backward kernel: `_attn_bwd_kernel`'s
    math with its operand rounding (each product operand rounded to the
    input type, f32 sums), the score gradient zeroed at masked keys (the
    jnp reference's ``where``; the Pallas kernel relies on zero weights
    there, which a row with ``key_len == 0`` does not have).  Returns
    None where the kernel does: dtqw, drawk and the gate cotangents
    outside time mode."""
    dt = q.dtype
    op = lambda x: x.to(dt).float()  # noqa: E731  (a product operand)
    base = base_mode(mode)
    scale = 1.0 / q.shape[-1] ** 0.5
    scores, parts = _scores(mode, q, k, t_q, t_k, tqw, rawk, w1, b1, wo1,
                            wo2, bo)
    live = _live(key_len, k.shape[1], q.device)
    scores = torch.where(live, scores, torch.full_like(scores, NEG_FILL))
    weights = torch.softmax(scores, dim=-1)
    dropped = weights if dm is None else weights * dm
    gr = op(g)
    dv = torch.einsum("bqk,bqd->bkd", op(dropped), gr)
    dwei = torch.einsum("bqd,bkd->bqk", gr, v.float())
    if dm is not None:
        dwei = dwei * dm
    ds = weights * (dwei - (dwei * weights).sum(dim=-1, keepdim=True))
    ds = torch.where(live, ds, torch.zeros_like(ds))
    if base == "time":
        sig, decay, tqk = parts["sig"], parts["decay"], parts["time_qk"]
        ds0 = ds * sig * scale
        dgate = ds * parts["s0"] * scale * sig * (1.0 - sig)
        dpre_dec = dgate * wo1.float() * (1.0 - decay * decay)
        dpre_tqk = dgate * wo2.float() * (1.0 - tqk * tqk)
        gate_grads = [(dpre_dec * parts["logdt"]).sum(0), dpre_dec.sum(0),
                      (dgate * decay).sum(0), (dgate * tqk).sum(0),
                      dgate.sum(0)]
        dtqw = torch.einsum("bqk,bkd->bqd", op(dpre_tqk), rawk.float())
        drawk = torch.einsum("bqk,bqd->bkd", op(dpre_tqk), tqw.float())
    else:
        ds0 = ds * scale
        gate_grads = [None] * 5
        dtqw = drawk = None
    dq = torch.einsum("bqk,bkd->bqd", op(ds0), k.float())
    dk = torch.einsum("bqk,bqd->bkd", op(ds0), q.float())
    return (dq, dk, dv, dtqw, drawk, *gate_grads)


def _gate_sum(terms, rows):
    """The tile design's sum of [B, Tq, Tk] gate terms over the batch, in
    its launches' order: chunks of ``rows`` batch rows in turn; in each,
    every GATE_ROWS-row part summed over its rows in order from 0, then
    the parts added in order to the sums of the earlier chunks (0 at
    first).  Chunks of whole parts give the same bits as one chunk."""
    total = torch.zeros(terms.shape[1:], dtype=torch.float32,
                        device=terms.device)
    for c0 in range(0, terms.shape[0], max(rows, 1)):
        chunk = terms[c0:c0 + rows]
        for p0 in range(0, chunk.shape[0], GATE_ROWS):
            part = torch.zeros_like(total)
            for row in chunk[p0:p0 + GATE_ROWS]:
                part = part + row
            total = total + part
    return total


def _tile_design_plain(mode: str, g, q, k, v, t_q, t_k, tqw, rawk, w1, b1,
                       wo1, wo2, bo, key_len, dm=None, chunk_rows=None):
    """The tile design's arithmetic in plain PyTorch (the arguments and
    results of `fused_attention_bwd`): q, g (rounded) and tqw padded to
    TILE_KEYS rows with zeros, k, v and rawk zero past each row's live
    keys and padded the same way; the three score planes as f32 products;
    the middle as the kernel's warps compute it, each key from its own
    plane values, gate operands read at live keys only (0 elsewhere),
    the softmax over the Tk keys, D_i over the live ones; ds0, dpre_tqk
    and the dropped weights rounded to the input type and zero-padded to
    TILE_KEYS x TILE_KEYS; the gradients as f32 products of those padded
    planes and operands; the gate terms summed by `_gate_sum` in chunks
    of `gate_chunk_rows` rows (``chunk_rows`` forced as the launch's
    ``_chunk_rows``)."""
    dt = q.dtype
    op = lambda x: x.to(dt).float()  # noqa: E731  (a product operand)
    base = base_mode(mode)
    b, tq, d = q.shape
    tk = k.shape[1]
    n = TILE_KEYS
    scale = 1.0 / d ** 0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    live = key_len.long().clamp(0, tk)
    key_ok = torch.arange(n, device=q.device)[None, :, None] \
        < live[:, None, None]

    def pad(x, rows):
        return torch.cat([x.float(), torch.zeros((b, n - rows, d), **f32)],
                         dim=1)

    def keys(x):
        return torch.where(key_ok, pad(x, tk), torch.zeros((), **f32))

    qp, tqwp, gp = pad(q, tq), pad(tqw, tq), pad(op(g), tq)
    kp, vp, rawkp = keys(k), keys(v), keys(rawk)
    nt = lambda x, y: torch.einsum("bqd,bkd->bqk", x, y)  # noqa: E731
    s0 = nt(qp, kp)[:, :tq, :tk]
    dw = nt(gp, vp)[:, :tq, :tk]
    lv = torch.arange(tk, device=q.device)[None, None, :] \
        < live[:, None, None]
    zero = torch.zeros((), **f32)
    live_only = lambda x: torch.where(lv, x, zero)  # noqa: E731
    if base in ("time", "tisas"):
        ldt = live_only(torch.log1p(torch.abs(
            t_q.float()[:, :, None] - t_k.float()[:, None, :])))
    if base == "time":
        tqk = live_only(torch.tanh(nt(tqwp, rawkp)[:, :tq, :tk]))
        dec = live_only(torch.tanh(ldt * w1.float() + b1.float()))
        sig = live_only(torch.sigmoid(wo1.float() * dec + wo2.float() * tqk
                                      + bo.float()))
        sc = s0 * sig * scale
    elif base == "tisas":
        sc = (s0 + ldt) * scale
    else:
        sc = s0 * scale
    s = torch.where(lv, sc, torch.full_like(sc, NEG_FILL))
    dw = live_only(dw)
    if dm is not None:
        dw = dw * dm
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    dsum = (dw * w).sum(dim=-1, keepdim=True)
    ds = live_only(w * (dw - dsum))
    planes = {"w": op(w if dm is None else w * dm)}
    if base == "time":
        dsig = ds * s0 * scale
        planes["s"] = op(ds * sig * scale)
        dgate = dsig * sig * (1.0 - sig)
        dpre_dec = dgate * wo1.float() * (1.0 - dec * dec)
        planes["t"] = op(dgate * wo2.float() * (1.0 - tqk * tqk))
        rows = gate_chunk_rows(b, tq, tk, chunk_rows)
        gate_grads = [_gate_sum(x, rows) for x in (
            dpre_dec * ldt, dpre_dec, dgate * dec, dgate * tqk, dgate)]
    else:
        planes["s"] = op(ds * scale)
        gate_grads = [None] * 5
    for key, x in planes.items():
        planes[key] = torch.nn.functional.pad(x, (0, n - tk, 0, n - tq))
    nn = lambda p, x: torch.einsum("bqk,bkd->bqd", p, x)  # noqa: E731
    tn = lambda p, x: torch.einsum("bqk,bqd->bkd", p, x)  # noqa: E731
    dq = nn(planes["s"], kp)[:, :tq]
    dk = tn(planes["s"], qp)[:, :tk]
    dv = tn(planes["w"], gp)[:, :tk]
    if base == "time":
        dtqw = nn(planes["t"], rawkp)[:, :tq]
        drawk = tn(planes["t"], tqwp)[:, :tk]
    else:
        dtqw = drawk = None
    return (dq, dk, dv, dtqw, drawk, *gate_grads)


def _wide_design_plain(mode: str, g, q, k, v, t_q, t_k, tqw, rawk, w1, b1,
                       wo1, wo2, bo, key_len, dm=None, chunk_rows=None):
    """The backward wide design's arithmetic in plain PyTorch (the
    arguments and results of `fused_attention_bwd`, at the shapes
    `attention_bwd_design` gives "wide"): the query pass's scores
    (`_wide_scores`), DW = g v^T with g rounded and v zero past the live
    keys, read at live keys only, times dm; the softmax over the Tk keys,
    D_i over the live ones, ds, ds0, dgate, dpre_dec and dpre_tqk; ds0,
    dpre_tqk and the dropped weights rounded to the input type (the
    planes); dq and dtqw summed over the key blocks (WIDE_KEY_BLOCK keys)
    in order, dk, dv and drawk (the key pass) over WIDE_QUERY_STEP-query
    steps in order, each block's product in f32; the gate terms summed by
    `_gate_sum` in chunks of `wide_chunk_rows` rows (``chunk_rows`` forced
    as the launch's ``_chunk_rows``)."""
    dt = q.dtype
    op = lambda x: x.to(dt).float()  # noqa: E731  (a product operand)
    base = base_mode(mode)
    b, tq, d = q.shape
    tk = k.shape[1]
    if attention_bwd_design(dt, tq, tk, d) != "wide":
        raise ValueError(f"_wide_design_plain: the wide design does not "
                         f"take Tq={tq}, Tk={tk}, d={d}")
    scale = 1.0 / d ** 0.5
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s, lv, parts = _wide_scores(mode, q, k, t_q, t_k, tqw, rawk, w1, b1,
                                wo1, wo2, bo, key_len)
    live_rows = lv.transpose(1, 2)
    keys = lambda x: torch.where(live_rows, x.float(), zero)  # noqa: E731
    gr = op(g)
    dw = torch.where(lv, torch.einsum("bqd,bkd->bqk", gr, keys(v)), zero)
    if dm is not None:
        dw = dw * dm
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    dsum = (dw * w).sum(dim=-1, keepdim=True)
    ds = torch.where(lv, w * (dw - dsum), zero)
    planes = {"w": op(w if dm is None else w * dm)}
    if base == "time":
        sig, dec, tqk = parts["sig"], parts["dec"], parts["tqk"]
        dgate = ds * parts["s0"] * scale * sig * (1.0 - sig)
        dpre_dec = dgate * wo1.float() * (1.0 - dec * dec)
        planes["s"] = op(ds * sig * scale)
        planes["t"] = op(dgate * wo2.float() * (1.0 - tqk * tqk))
        rows = wide_chunk_rows(b, tq, tk, True, chunk_rows)
        gate_grads = [_gate_sum(x, rows) for x in (
            dpre_dec * parts["ldt"], dpre_dec, dgate * dec, dgate * tqk,
            dgate)]
    else:
        planes["s"] = op(ds * scale)
        gate_grads = [None] * 5

    def by_keys(p, x):        # the query pass: sum over key blocks
        out = torch.zeros((b, tq, d), dtype=torch.float32, device=q.device)
        for blk in _key_blocks(tk, WIDE_KEY_BLOCK[dt]):
            out = out + torch.einsum("bqk,bkd->bqd", p[:, :, blk], x[:, blk])
        return out

    def by_queries(p, x):     # the key pass: sum over query steps
        out = torch.zeros((b, tk, d), dtype=torch.float32, device=q.device)
        for blk in _key_blocks(tq, WIDE_QUERY_STEP):
            out = out + torch.einsum("bqk,bqd->bkd", p[:, blk], x[:, blk])
        return out

    dq = by_keys(planes["s"], keys(k))
    dk = by_queries(planes["s"], q.float())
    dv = by_queries(planes["w"], gr)
    if base == "time":
        dtqw = by_keys(planes["t"], keys(rawk))
        drawk = by_queries(planes["t"], tqw.float())
    else:
        dtqw = drawk = None
    return (dq, dk, dv, dtqw, drawk, *gate_grads)


# the positions, among fused_attention's tensor arguments, of q, k, v,
# tqw, rawk and the five gate params: the order of the backward's outputs
_DIFFERENTIABLE = (0, 1, 2, 5, 6, 7, 8, 9, 10, 11)


class FusedAttentionFunction(torch.autograd.Function):
    """`fused_attention` with `fused_attention_bwd` as its backward, and
    above SINGLE_TILE_KEYS keys `_dense_vjp` (the
    JAX package's custom_vjp: `_fa_fwd` saves the inputs, not the
    [Tq, Tk] weights, which the backward recomputes; `_fa_bwd` casts each
    cotangent back to its input's type).  t_q, t_k, key_len and dm get
    no gradient, nor do tqw, rawk and the gate params outside time mode
    (the output does not depend on them there)."""

    @staticmethod
    def forward(ctx, mode, *args):
        out = fused_attention(mode, *args)
        ctx.mode = mode
        ctx.save_for_backward(*args)
        return out

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        if args[1].shape[1] > SINGLE_TILE_KEYS:
            return (None, *_dense_vjp(ctx.mode, g, args,
                                      ctx.needs_input_grad[1:]))
        outs = fused_attention_bwd(ctx.mode, g.float().contiguous(), *args)
        grads = [None] * len(args)
        for i, d in zip(_DIFFERENTIABLE, outs):
            if d is not None and ctx.needs_input_grad[1 + i]:
                grads[i] = d.to(args[i].dtype)
        return (None, *grads)


def _dense_vjp(mode, g, args, needs):
    """The backward above SINGLE_TILE_KEYS keys: the JAX `_fa_bwd`'s
    recompute, autograd of `reference_middle` (plain PyTorch on the
    card, as JAX computes it outside Pallas), counted in
    ``dense_bwd[mode]``.  Returns a gradient per argument of the forward
    (None where none is needed or the output does not depend on it),
    each in its input's type."""
    dense_bwd[mode] += 1
    wanted = [i for i in _DIFFERENTIABLE if needs[i]]
    with torch.enable_grad():
        inputs = list(args)
        for i in wanted:
            inputs[i] = args[i].detach().requires_grad_(True)
        out = reference_middle(mode, *inputs)
        got = torch.autograd.grad(out, [inputs[i] for i in wanted], g.float(),
                                  allow_unused=True)
    grads = [None] * len(args)
    for i, d in zip(wanted, got):
        grads[i] = None if d is None else d.to(args[i].dtype)
    return grads


def fused_attention_vjp(mode: str, q, k, v, t_q, t_k, tqw, rawk,
                        w1, b1, wo1, wo2, bo, key_len, dm=None
                        ) -> torch.Tensor:
    """Differentiable `fused_attention` (same arguments and result)."""
    return FusedAttentionFunction.apply(mode, q, k, v, t_q, t_k, tqw, rawk,
                                        w1, b1, wo1, wo2, bo, key_len, dm)
