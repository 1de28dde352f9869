"""Embedding lookups and their table backwards: CUDA kernels and plain
twins.

Counterpart of mtamrecommender_tpu/ops/pallas/embedding_kernel.py, whose
three kernels the port has:

  * `dtable` (csrc/embedding_dtable.cu, the Pallas `_dtable_kernel`):
        dtable[v, :] = sum_n [ids[n] == v] * ct[n, :]
    summed in f32 in a fixed order (no float atomics) and written once in
    ct's type: a first pass sorts each chunk of ids and sums each id's
    rows, a second writes each table row from the chunks' partials in
    chunk order; up to SMALL_N ids one pass sums each row's ids directly
    (`dtable_plan` picks the chunk and sizes the workspace).
    `take_dtable` is the lookup whose backward it is: a row
    gather forward (JAX's is `jnp.take`, no kernel), `dtable` backward.
    Every lookup of `ops/embedding.behavior_embedding` takes it by
    default.
  * `gather_rows` (csrc/embedding_gather.cu, the Pallas `_gather_kernel`):
    out[i, :] = table[ids[i], :].  Rows of a multiple of 16 bytes take the
    "vector" design: the output as 16-byte words, a warp a tile of 32
    rows (its ids read once and shuffled to the lanes) and GATHER_STEPS
    words a lane in flight, on a grid of at most GATHER_BLOCKS_PER_SM
    blocks an SM (`gather_design` picks it, `gather_grid` sizes it);
    other rows take the earlier "warp_row" design, a warp a row.
  * `scatter_add` (csrc/embedding_gather.cu, the Pallas `_scatter_kernel`):
    the sequential scatter-add, each row's cotangents added in ascending
    position order and rounded to their type after every add.  Each
    (row, column) is a chain no add may be reordered in, so the kernel
    spreads rows and column slices: up to SMALL_N ids one pass, else a
    sort of the ids into each row's list, then a block a (hot row, 32
    columns) fed by a cp.async ring and a warp a cold row
    (`scatter_plan` picks the route and sizes the workspace).
    `gather` is the lookup whose backward it is, as JAX's custom_vjp
    `gather`; `behavior_embedding(gather=embedding_kernel.gather)` takes
    it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mtamrecommender_tpu_torch.ops.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
KERNEL_WIDTHS = (32, 64, 128, 256)   # d the kernels take (others: padded)
# dtable's plan: up to SMALL_N ids one pass; past it a first pass of one
# block a chunk of ids: the small chunk while that needs at most
# WAVE_BLOCKS blocks (one wave on the H100's 132 SMs), else the large one
SMALL_N = 256
CHUNKS = (256, 1024)
WAVE_BLOCKS = 128
MAX_VOCAB = (1 << 22) - 1    # the sort key: id << log2(1024) | position
# scatter_add's designs: the default, then the earlier one (forced only,
# by `scatter_add(..., _design="segments")`); its routes, in the C
# interface's order (the columns design takes "small" up to SMALL_N ids)
SCATTER_DESIGNS = ("columns", "segments")
SCATTER_ROUTES = ("small", "columns", "segments")
SCATTER_SLICE = 32     # columns a hot row's chain warp owns, a lane each
SCATTER_HOT = 64       # a row with more ids takes column-sliced chains
SORT_CHUNK = 1024      # ids a sorting block owns
# gather's designs, in the C interface's order: the default for rows of a
# multiple of GATHER_WORD bytes, then the earlier one (every other row,
# and forced by `gather_rows(..., _design="warp_row")`)
GATHER_DESIGNS = ("vector", "warp_row")
GATHER_WORD = 16           # bytes of the vector design's word
GATHER_TILE = 32           # rows a warp's item covers, an id a lane
GATHER_STEPS = 8           # words a lane loads before its first store
GATHER_WARPS = 8           # warps a block
GATHER_BLOCKS_PER_SM = 16  # the vector design's most blocks an SM

# kernel launches (the plain twins are not counted); "gather" counts both
# designs' launches, "gather_warp_row" the earlier design's
launches = {"dtable": 0}
gather_launches = {"gather": 0, "gather_warp_row": 0, "scatter_add": 0}


def _check_ids(what, ids, vocab) -> None:
    """On the CPU: raise on an id outside [0, vocab).  On the card the
    kernels do not read ids back to the host (that would stall the step):
    there an id outside the table matches no row (gather writes zeros for
    it), and chip_smoke.py checks on the card that a step's ids are in
    range."""
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= vocab):
        raise ValueError(f"{what}: ids must lie in [0, {vocab}), got "
                         f"[{int(ids.min())}, {int(ids.max())}]")


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
    outside [0, vocab).  CUDA tensors launch the kernel (d up to 256,
    zero-padded to one of KERNEL_WIDTHS), which does not read ids back to
    the host (that would stall the step): an id outside
    [0, vocab) matches no row there, and chip_smoke.py checks on the card
    that the training step's ids are in range."""
    _check(ct, ids, vocab)
    where = ct.device
    if where.type == "cpu":
        _check_ids("dtable", ids, vocab)
        return dtable_plain(ct, ids, vocab)
    if where.type != "cuda":
        raise ValueError(f"dtable: no kernel for device {where}")
    return _launch(ct, ids, vocab, where)


def dtable_plan(n: int, d: int, vocab: int) -> Tuple[int, int]:
    """(chunk, workspace bytes) of one `dtable` call on n ids.  Chunk 0:
    one pass, no workspace (n <= SMALL_N).  Else the first pass takes the
    ids ``chunk`` at a time, and the workspace holds up to n f32 partial
    rows of width d, n ids and one count a chunk.  Raises for a vocab
    above MAX_VOCAB (the sort key holds the id in 22 bits)."""
    if vocab > MAX_VOCAB:
        raise ValueError(f"dtable: the kernel takes vocab <= {MAX_VOCAB} "
                         f"(the id and its position share a 32-bit sort "
                         f"key), got {vocab}")
    if n <= SMALL_N:
        return 0, 0
    chunk = next((c for c in CHUNKS if -(-n // c) <= WAVE_BLOCKS),
                 CHUNKS[-1])
    return chunk, 4 * (n * d + n + -(-n // chunk))


def kernel_width(what: str, d: int) -> int:
    """The narrowest of KERNEL_WIDTHS that holds d columns; raises past
    the widest."""
    for width in KERNEL_WIDTHS:
        if d <= width:
            return width
    raise ValueError(f"{what}: the kernel takes d up to {KERNEL_WIDTHS[-1]} "
                     f"(padded to one of {KERNEL_WIDTHS}), got d={d}")


def _pad_columns(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [n, d] with zero columns up to ``width``.  A table gradient's
    column sums only its own column of the cotangent, so the padded
    columns come out 0 and the real ones do not move."""
    return F.pad(x, (0, width - x.shape[1]))


def _launch(ct, ids, vocab, where) -> torch.Tensor:
    """Launch the kernel, a width it does not take zero-padded to
    `kernel_width` and the table gradient sliced back."""
    d = ct.shape[1]
    width = kernel_width("dtable", d)
    if width != d:
        return _launch(_pad_columns(ct, width), ids, vocab,
                       where)[:, :d].contiguous()
    device, stream = build.launch_context((ct, ids), "dtable")
    n = ct.shape[0]
    chunk, ws_bytes = dtable_plan(n, d, vocab)
    lib = _library()
    ct_ptr = ct.data_ptr()
    if ct_ptr % 16:                 # the kernel loads 16-byte words
        ct = ct.clone()
        ct_ptr = ct.data_ptr()
    out = ct.new_empty((vocab, d))
    ws_ptr = (_workspace(ws_bytes, device, stream, where).data_ptr()
              if ws_bytes else None)
    status = lib.dtable_launch(int(ct.dtype == torch.bfloat16), ct_ptr,
                               ids.data_ptr(), out.data_ptr(), ws_ptr,
                               n, vocab, d, chunk, device, stream)
    build.check(lib, status, "dtable")
    launches["dtable"] += 1
    return out


# dtable's and scatter_add's scratch, one buffer per (device, stream),
# kept between calls and grown to the largest call: kernels on one stream
# run in order, so a call never writes scratch an earlier call still
# reads, and a call is spared an allocation (host time is most of a small
# call's time)
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(nbytes: int, device: int, stream: int,
               where: torch.device) -> torch.Tensor:
    ws = _workspaces.get((device, stream))
    if ws is None or ws.numel() < nbytes:
        ws = torch.empty((nbytes,), dtype=torch.uint8, device=where)
        _workspaces[(device, stream)] = ws
    return ws


def _library() -> ctypes.CDLL:
    lib = build.library("embedding_dtable")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dtable_launch.argtypes = [ci] + [vp] * 4 + [ci] * 5 + [vp]
        lib.dtable_launch.restype = ci
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


# ------------------------------------------------------- gather / scatter

def _check_rows(what, x, ids) -> None:
    if x.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"{what}: want a [rows, d] tensor and [n] ids, got "
                         f"{tuple(x.shape)} and {tuple(ids.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{what}: want float32 or bfloat16, got {x.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"{what}: ids must be int32, got {ids.dtype}")


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                _design: Optional[str] = None) -> torch.Tensor:
    """table: [V, d] f32 or bf16; ids: [n] int32 -> table[ids], [n, d] in
    the table's type.  CPU tensors run `gather_plain` after a range check;
    CUDA tensors launch the gather kernel in the design `gather_design`
    picks, where an id outside [0, V) gives a zero row.
    ``_design="warp_row"`` forces the earlier design (chip_smoke.py holds
    and times it beside the default); the main path passes none.  An
    unknown design, or "vector" on rows it does not take, raises before
    any build; a design that fails to build or launch raises: there is no
    fallback."""
    _check_rows("gather", table, ids)
    design = _gather_pick(table, _design)
    if table.device.type == "cpu":
        _check_ids("gather", ids, table.shape[0])
        return gather_plain(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"gather: no kernel for device {table.device}")
    return _launch_gather(table, ids, design)


def gather_design(row_bytes: int) -> str:
    """The gather design a table row of ``row_bytes`` bytes takes:
    "vector" for a multiple of GATHER_WORD (every d that is a multiple of
    8 in bf16 or of 4 in f32), else "warp_row".  The kernel library's
    gather_design agrees (chip_smoke.py compares them)."""
    return GATHER_DESIGNS[0] if row_bytes % GATHER_WORD == 0 else \
        GATHER_DESIGNS[1]


def gather_grid(n: int, row_bytes: int, sms: int) -> int:
    """Blocks of a vector-design launch over n rows on a card of ``sms``
    SMs: one warp an item (a tile of GATHER_TILE rows times a batch of
    GATHER_STEPS steps of its words), GATHER_WARPS warps a block, at most
    GATHER_BLOCKS_PER_SM blocks an SM (the warps then walk the items with
    a stride of the grid's warps).  The kernel library's
    gather_vector_blocks agrees (chip_smoke.py compares them)."""
    items = -(-n // GATHER_TILE) * -(-(row_bytes // GATHER_WORD)
                                      // GATHER_STEPS)
    return min(-(-items // GATHER_WARPS), sms * GATHER_BLOCKS_PER_SM)


def _gather_pick(table: torch.Tensor, forced: Optional[str]) -> str:
    row_bytes = table.shape[1] * table.element_size()
    if forced is None:
        return gather_design(row_bytes)
    if forced not in GATHER_DESIGNS:
        raise ValueError(f"gather: unknown design {forced!r}, want one of "
                         f"{GATHER_DESIGNS}")
    if forced == "vector" and gather_design(row_bytes) != "vector":
        raise ValueError(f"gather: the vector design does not take rows of "
                         f"{row_bytes} bytes (it takes multiples of "
                         f"{GATHER_WORD})")
    return forced


# the gather library and its typed launch function, kept from the first
# launch on (a launch then looks nothing up and takes no lock)
_gather_entry: Optional[tuple] = None


def _launch_gather(table, ids, design) -> torch.Tensor:
    """Launch ``design`` on CUDA tensors (a table not aligned to the
    kernels' 16-byte words copied first)."""
    global _gather_entry
    device, stream = build.launch_context((table, ids), "gather")
    if _gather_entry is None:
        lib = _gather_library()
        _gather_entry = (lib, lib.gather_launch)
    lib, launch = _gather_entry
    if table.data_ptr() % GATHER_WORD:
        table = table.clone()
    n, (vocab, d) = ids.shape[0], table.shape
    out = table.new_empty((n, d))
    status = launch(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
                    vocab, d * table.element_size(),
                    GATHER_DESIGNS.index(design), device, stream)
    build.check(lib, status, "gather")
    gather_launches["gather"] += 1
    if design == "warp_row":
        gather_launches["gather_warp_row"] += 1
    return out


def scatter_add(grad: torch.Tensor, ids: torch.Tensor, vocab: int,
                _design: Optional[str] = None) -> torch.Tensor:
    """grad: [n, d] f32 or bf16; ids: [n] int32 -> [vocab, d] in grad's
    type: zeros, then for i = 0, 1, ..., n-1 in order out[ids[i]] +=
    grad[i], rounded to grad's type after every add (the Pallas
    `_scatter_kernel`'s sequential semantics).  CPU tensors run
    `scatter_add_plain` after a range check; CUDA tensors launch the
    kernel (d up to 256, zero-padded to one of KERNEL_WIDTHS and the
    result sliced back) in the route `scatter_plan` picks.
    ``_design="segments"`` forces the earlier design (chip_smoke.py holds
    and times it beside the default); the main path passes none.  A
    design that fails to build or launch raises: there is no fallback."""
    _check_rows("scatter_add", grad, ids)
    if ids.shape[0] != grad.shape[0] or vocab < 0:
        raise ValueError(f"scatter_add: want [n] ids for the n rows of grad "
                         f"and vocab >= 0, got {tuple(ids.shape)}, "
                         f"{tuple(grad.shape)} and {vocab}")
    if _design not in (None,) + SCATTER_DESIGNS:
        raise ValueError(f"scatter_add: unknown design {_design!r}, want "
                         f"one of {SCATTER_DESIGNS}")
    if grad.device.type == "cpu":
        _check_ids("scatter_add", ids, vocab)
        return scatter_add_plain(grad, ids, vocab)
    if grad.device.type != "cuda":
        raise ValueError(f"scatter_add: no kernel for device {grad.device}")
    return _launch_scatter(grad, ids, vocab, _design or SCATTER_DESIGNS[0])


def scatter_plan(n: int, d: int, vocab: int) -> Tuple[str, int, int]:
    """(route, slice width, workspace bytes) of one default `scatter_add`
    call on n ids into vocab rows at kernel width d.  "small" (n <=
    SMALL_N, or no row to write): one pass, a warp a row over its d
    columns, no workspace.  "columns": the ids sorted into each row's
    list, then a row with more than SCATTER_HOT ids as chains over slices
    of SCATTER_SLICE columns (the card decides which rows from the run
    lengths), every other row a warp over its d columns; the workspace
    holds two ints an id of each SORT_CHUNK-id chunk, a count for each
    (chunk, row), three ints a row, each row's list (an int an id) and 4
    counters, each array rounded up to 16 bytes.  Raises above MAX_VOCAB
    there (the sort key holds the id in 22 bits)."""
    if n <= SMALL_N or vocab == 0:
        return "small", d, 0
    if vocab > MAX_VOCAB:
        raise ValueError(f"scatter_add: the kernel takes vocab <= "
                         f"{MAX_VOCAB} past {SMALL_N} ids (the id and its "
                         f"position share a 32-bit sort key), got {vocab}")
    chunks = -(-n // SORT_CHUNK)
    ints = (4 + 2 * chunks * SORT_CHUNK + _round4(chunks * vocab)
            + 3 * _round4(vocab) + _round4(n))
    return "columns", SCATTER_SLICE, 4 * ints


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _segments_bytes(n: int, vocab: int) -> int:
    """The segments design's workspace: a count for each (1,024-id
    segment, row), the rows' starts and each row's list."""
    if vocab == 0:
        return 0
    return 4 * (-(-n // 1024) * vocab + vocab + 1 + n)


def _launch_scatter(grad, ids, vocab, design) -> torch.Tensor:
    """Launch `design` ("columns" in the route `scatter_plan` picks, or
    "segments"), a width the kernel does not take zero-padded to
    `kernel_width` and the table gradient sliced back."""
    n, d = grad.shape
    width = kernel_width("scatter_add", d)
    if width != d:
        return _launch_scatter(_pad_columns(grad, width), ids, vocab,
                               design)[:, :d].contiguous()
    if design == "segments":
        route, ws_bytes = design, _segments_bytes(n, vocab)
    else:
        route, _, ws_bytes = scatter_plan(n, d, vocab)
    device, stream = build.launch_context((grad, ids), "scatter_add")
    lib = _gather_library()
    if grad.data_ptr() % 16:        # the kernel loads 16-byte words
        grad = grad.clone()
    out = grad.new_empty((vocab, d))
    ws_ptr = (_workspace(ws_bytes, device, stream, grad.device).data_ptr()
              if ws_bytes else None)
    status = lib.scatter_add_launch(int(grad.dtype == torch.bfloat16),
                                    grad.data_ptr(), ids.data_ptr(),
                                    out.data_ptr(), ws_ptr, ws_bytes, n,
                                    vocab, d, SCATTER_ROUTES.index(route),
                                    device, stream)
    build.check(lib, status, "scatter_add")
    gather_launches["scatter_add"] += 1
    return out


def _gather_library() -> ctypes.CDLL:
    lib = build.library("embedding_gather")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gather_launch.argtypes = [vp, vp, vp, ci, ci, ctypes.c_longlong,
                                      ci, ci, vp]
        lib.gather_launch.restype = ci
        lib.gather_design.argtypes = [ctypes.c_longlong]
        lib.gather_design.restype = ci
        lib.gather_vector_blocks.argtypes = [ci, ctypes.c_longlong, ci]
        lib.gather_vector_blocks.restype = ci
        lib.scatter_add_launch.argtypes = ([ci] + [vp] * 4
                                           + [ctypes.c_longlong]
                                           + [ci] * 5 + [vp])
        lib.scatter_add_launch.restype = ci
        lib.scatter_workspace_bytes.argtypes = [ci, ci, ci]
        lib.scatter_workspace_bytes.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the gather kernel: table[ids]."""
    return table[ids.long()]


def _gather_design_plain(table: torch.Tensor, ids: torch.Tensor,
                         sms: int = 132) -> torch.Tensor:
    """The vector design's work in plain PyTorch (the CPU tests hold it):
    the output as n x W words of GATHER_WORD bytes, the launcher's grid
    (`gather_grid` on ``sms`` SMs) walked pass by pass, warp g of the grid
    taking items g, g + warps, ...; item k is tile k // batches (rows 32t
    to 32t + 31) and steps s0 = (k % batches) * GATHER_STEPS on, lane l
    of step s taking the tile's word w = s * 32 + l (row w // W, column w
    % W).  Lane r loads the id of the tile's row r only when the item's
    words fall in that row, and each word takes its id from its row's
    lane (the shuffle); an id outside [0, V) gives zeros.  Raises unless
    every word is written exactly once."""
    n, d = ids.shape[0], table.shape[1]
    vocab = table.shape[0]
    row_bytes = d * table.element_size()
    if gather_design(row_bytes) != "vector":
        raise ValueError(f"gather: the vector design does not take rows of "
                         f"{row_bytes} bytes")
    W = row_bytes // GATHER_WORD
    words = table.contiguous().view(torch.int32).reshape(vocab, W, 4)
    out = torch.zeros((n * W, 4), dtype=torch.int32)
    written = torch.zeros(n * W, dtype=torch.long)
    ids = ids.long()
    batches = -(-W // GATHER_STEPS)
    items = -(-n // GATHER_TILE) * batches
    warps = gather_grid(n, row_bytes, sms) * GATHER_WARPS
    lane = torch.arange(GATHER_TILE)
    step = torch.arange(GATHER_STEPS)
    for first in range(0, items, warps):          # the grid-stride passes
        item = torch.arange(first, min(first + warps, items))
        tile = item // batches
        s0 = (item % batches) * GATHER_STEPS
        steps = (W - s0).clamp(max=GATHER_STEPS)
        rows = (n - tile * GATHER_TILE).clamp(max=GATHER_TILE)
        lo = s0 * 32 // W
        hi = ((s0 + steps) * 32 - 1) // W
        loads = ((lane >= lo[:, None]) & (lane <= hi[:, None])
                 & (lane < rows[:, None]))
        lane_id = torch.where(
            loads, ids[(tile[:, None] * GATHER_TILE + lane).clamp(max=n - 1)],
            -1)                                           # [items, lanes]
        w = (s0[:, None, None] + step[None, :, None]) * 32 + lane
        r = w // W                                    # [items, steps, lanes]
        live = (step[None, :, None] < steps[:, None, None]) & (
            r < rows[:, None, None])
        row_id = torch.gather(lane_id, 1, (r % 32).flatten(1)).view_as(r)
        valid = live & (row_id >= 0) & (row_id < vocab)
        got = words[row_id.clamp(0, max(vocab - 1, 0)), w % W]
        got = torch.where(valid[..., None], got, 0)
        at = (tile[:, None, None] * GATHER_TILE * W + w)[live]
        out[at] = got[live]
        written.index_add_(0, at, torch.ones_like(at))
    if not bool((written == 1).all()):
        raise AssertionError("gather: the vector design's items do not "
                             "cover every word exactly once")
    return out.reshape(n, W * 4).view(table.dtype).reshape(n, d)


def scatter_add_plain(grad: torch.Tensor, ids: torch.Tensor,
                      vocab: int) -> torch.Tensor:
    """Plain PyTorch twin of the scatter-add kernel: one vectorised step
    per occurrence rank.  Step r adds the r-th occurrence (in position
    order) of every id to its row and rounds to grad's type, so each row
    sees its cotangents in ascending position order, rounded after every
    add, with no Python loop over ids."""
    n, d = grad.shape
    out = torch.zeros((vocab, d), dtype=grad.dtype, device=grad.device)
    if n == 0:
        return out
    ids = ids.long()
    order = torch.sort(ids, stable=True).indices      # by id, then position
    pos = torch.arange(n, device=grad.device)
    first = torch.ones(n, dtype=torch.bool, device=grad.device)
    first[1:] = ids[order][1:] != ids[order][:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - run_start
    by_rank = torch.sort(rank, stable=True).indices
    for sel in torch.split(by_rank, torch.bincount(rank).tolist()):
        rows = ids[sel]                                # each id at most once
        out[rows] = (out[rows].float() + grad[sel].float()).to(grad.dtype)
    return out


def _row_lists(ids: torch.Tensor, vocab: int):
    """The columns design's ordering passes in plain PyTorch: each
    SORT_CHUNK-id chunk's keys (id << 10 | position in the chunk, ids
    outside [0, vocab) last) sorted, each entry's rank in its id's run and
    each (chunk, row) count (columns_sort); each row's list, here laid out
    in row order (on the card where its atomicAdd puts it), each chunk's
    run after the row's runs in earlier chunks (columns_rows); each
    position placed (columns_place).  Returns (start, length, lists): row
    v's list is lists[start[v]:start[v] + length[v]]."""
    ids = ids.long().cpu()
    chunks = -(-ids.numel() // SORT_CHUNK)
    col = torch.arange(SORT_CHUNK)
    count = torch.zeros((chunks, vocab), dtype=torch.long)
    runs = []
    for c in range(chunks):
        part = ids[c * SORT_CHUNK:(c + 1) * SORT_CHUNK]
        named = torch.full((SORT_CHUNK,), vocab, dtype=torch.long)
        named[:part.numel()] = torch.where((part >= 0) & (part < vocab),
                                           part, vocab)
        key = torch.sort(named << 10 | col).values
        row = key >> 10
        first = torch.ones(SORT_CHUNK, dtype=torch.bool)
        first[1:] = row[1:] != row[:-1]
        rank = col - torch.cummax(torch.where(first, col, 0), 0).values
        live = row < vocab
        count[c] = torch.bincount(row[live], minlength=vocab)
        runs.append((key[live], rank[live]))
    length = count.sum(0)
    start = torch.cumsum(length, 0) - length
    where = start + torch.cumsum(count, 0) - count
    lists = torch.empty(int(length.sum()), dtype=torch.long)
    for c, (key, rank) in enumerate(runs):
        lists[where[c, key >> 10] + rank] = (c * SORT_CHUNK
                                             + (key & (SORT_CHUNK - 1)))
    return start, length, lists


def _columns_design_plain(grad: torch.Tensor, ids: torch.Tensor,
                          vocab: int) -> torch.Tensor:
    """The default design's work split in plain PyTorch (the CPU tests
    hold it): d padded to `kernel_width`, the route `scatter_plan` picks;
    "small": each row's positions in order (the kernel's ballots);
    "columns": each row's list from `_row_lists`, a row with more than
    SCATTER_HOT ids as one chain a SCATTER_SLICE-column slice, any other
    row as one chain over all its columns.  A chain adds its grad rows
    one at a time in list order, rounded to grad's type after every add;
    the result sliced back to d."""
    n, d = grad.shape
    width = kernel_width("scatter_add", d)
    g = _pad_columns(grad, width)
    route, slice_width, _ = scatter_plan(n, width, vocab)
    out = torch.zeros((vocab, width), dtype=grad.dtype)
    chains = []
    if route == "small":
        named = ids.long()
        chains = [(v, slice(0, width), torch.nonzero(named == v).flatten())
                  for v in range(vocab)]
    else:
        start, length, lists = _row_lists(ids, vocab)
        for v in range(vocab):
            chain = lists[start[v]:start[v] + length[v]]
            cols = ([slice(c, c + slice_width)
                     for c in range(0, width, slice_width)]
                    if length[v] > SCATTER_HOT else [slice(0, width)])
            chains += [(v, c, chain) for c in cols]
    for v, cols, chain in chains:
        acc = out[v, cols]
        for p in chain.tolist():
            acc = (acc.float() + g[p, cols].float()).to(grad.dtype)
        out[v, cols] = acc
    return out[:, :d].contiguous()


class GatherFunction(torch.autograd.Function):
    """`gather_rows` whose table gradient is `scatter_add` (JAX's custom_vjp
    `gather`, `embedding_kernel.py:122-142`)."""

    @staticmethod
    def forward(ctx, table, ids):
        flat = ids.reshape(-1).to(torch.int32).contiguous()
        ctx.save_for_backward(flat)
        ctx.vocab = table.shape[0]
        return gather_rows(table.contiguous(), flat).reshape(
            *ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        d = g.shape[-1]
        return scatter_add(g.reshape(-1, d).contiguous(), flat,
                           ctx.vocab), None


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for ids of any shape, through the gather kernel, with
    the scatter-add kernel as the table's gradient (plain twins on the
    CPU)."""
    return GatherFunction.apply(table, ids)
