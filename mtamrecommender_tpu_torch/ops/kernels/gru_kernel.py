"""Whole-sequence (time-aware) GRU scan: CUDA kernels and plain twins.

Counterpart of mtamrecommender_tpu/ops/pallas/gru_kernel.py: `gru_scan`
(the forward, csrc/gru_scan.cu), `gru_scan_bwd` (the reverse-time
backward, csrc/gru_scan_bwd.cu) and `gru_scan_vjp`, the autograd
function that joins them as JAX's custom_vjp does.

Cell modes:
  plain    new_h = u*h + (1-u)*c
  tseqrec  new_h = u*h*e1[t] + (1-u)*c*e2[t]
  tgru     weight = relu(e1[t] + h*v0); ts = sigmoid(v1*weight + v2*e2[t] + v3)
           new_h = u*h + (1-u)*c*ts
For t >= lengths[b] the output is 0 and the state stays frozen.  Inputs
are all f32 or all bf16; h is carried in f32 and rounded to the input
type only as a product operand; the output is f32 [B, L, u].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mtamrecommender_tpu_torch.ops.kernels import build

MODES = ("plain", "tseqrec", "tgru")
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232_448   # dynamic shared memory a block may opt into
# the forward's designs: "sliced" (4u threads, each product's k in four
# slices) for u a multiple of 32 up to FWD_SLICED_MAX_U, the default;
# "unit_column" (the earlier, u threads) for the wider widths, and forced
# for comparison only (see `_launch`)
FWD_DESIGNS = ("sliced", "unit_column")
FWD_SLICED_MAX_U = 128
# the backward's designs: the default first; "four_product", the earlier,
# launched only when forced (see `_launch_bwd`)
BWD_DESIGNS = ("two_product", "four_product")
BWD_MAX_U = 128            # the two-product chain runs 4u threads a block

# kernel launches per mode (the plain twins are not counted)
launches = {mode: 0 for mode in MODES}
bwd_launches = {mode: 0 for mode in MODES}


def _check(mode, gate_x, cand_x, e1, e2, lengths, h0, w_gate_h, w_cand_h,
           b_gate, b_cand, cell_vecs) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown gru_scan mode {mode!r}; known: {MODES}")
    if gate_x.dim() != 3 or gate_x.shape[2] % 2:
        raise ValueError(f"gate_x must be [B, L, 2u], got {tuple(gate_x.shape)}")
    b, seq, u2 = gate_x.shape
    u = u2 // 2
    want = {"cand_x": (b, seq, u), "e1": (b, seq, u), "e2": (b, seq, u),
            "lengths": (b,), "h0": (b, u), "w_gate_h": (u, 2 * u),
            "w_cand_h": (u, u), "b_gate": (2 * u,), "b_cand": (u,),
            "cell_vecs": (4, u)}
    got = {"cand_x": cand_x, "e1": e1, "e2": e2, "lengths": lengths,
           "h0": h0, "w_gate_h": w_gate_h, "w_cand_h": w_cand_h,
           "b_gate": b_gate, "b_cand": b_cand, "cell_vecs": cell_vecs}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"gru_scan: {name} must be {shape}, "
                             f"got {tuple(got[name].shape)}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"gru_scan: lengths must be int32, got {lengths.dtype}")
    floats = [gate_x] + [t for n, t in got.items() if n != "lengths"]
    if gate_x.dtype not in DTYPES or any(t.dtype != gate_x.dtype
                                         for t in floats):
        raise TypeError("gru_scan: floating operands must all be float32 or "
                        f"all bfloat16, got {sorted({str(t.dtype) for t in floats})}")


def gru_scan(mode: str, gate_x, cand_x, e1, e2, lengths, h0,
             w_gate_h, w_cand_h, b_gate, b_cand, cell_vecs) -> torch.Tensor:
    """gate_x: [B,L,2u]; cand_x, e1, e2: [B,L,u]; lengths: [B] int32;
    h0: [B,u]; w_gate_h: [u,2u]; w_cand_h: [u,u]; b_gate: [2u];
    b_cand: [u]; cell_vecs: [4,u] (read by tgru only).  Returns f32
    outputs [B,L,u].  CPU tensors run `gru_scan_plain`; CUDA tensors
    launch the kernel (at a width it does not take, on operands
    zero-padded to `kernel_width`)."""
    args = (gate_x, cand_x, e1, e2, lengths, h0, w_gate_h, w_cand_h,
            b_gate, b_cand, cell_vecs)
    _check(mode, *args)
    if gate_x.device.type == "cpu":
        return gru_scan_plain(mode, *args)
    if gate_x.device.type != "cuda":
        raise ValueError(f"gru_scan: no kernel for device {gate_x.device}")
    return _launch(mode, *args)


def fwd_design(u: int) -> str:
    """The forward's design for width u, decided before the launch:
    "sliced" for u a multiple of 32 up to FWD_SLICED_MAX_U (every preset),
    "unit_column" for the wider widths the kernel takes (u up to 160 in
    bf16, whose weights fit in shared memory)."""
    return ("sliced" if u % 32 == 0 and 32 <= u <= FWD_SLICED_MAX_U
            else "unit_column")


def kernel_width(u: int) -> int:
    """The width the kernels run a width-u scan at: u rounded up to a
    multiple of 32, at least 32 (`_pad_gru_operands` pads to it)."""
    return max(32, -(-u // 32) * 32)


def _pad_halves(x: torch.Tensor, u: int, width: int) -> torch.Tensor:
    """x [..., 2u] = [r | u] with each half zero-padded to width."""
    pad = (0, width - u)
    return torch.cat([F.pad(x[..., :u], pad), F.pad(x[..., u:], pad)], -1)


def _pad_gru_operands(width, gate_x, cand_x, e1, e2, lengths, h0, w_gate_h,
                      w_cand_h, b_gate, b_cand, cell_vecs):
    """`gru_scan`'s operands at width u zero-padded to ``width``: each half
    of gate_x, w_gate_h's columns and b_gate on its own (padding the 2u
    axis at its end would move the update gate's columns), every other
    unit axis at its end.  A padded unit has zero weights to and from the
    real units, zero inputs and h0 = 0: its candidate is tanh(0) = 0, so
    its h stays 0 in every mode and the real units' outputs do not move."""
    u = cand_x.shape[-1]
    pad = (0, width - u)
    w_gate_h = _pad_halves(F.pad(w_gate_h, (0, 0) + pad), u, width)
    return (_pad_halves(gate_x, u, width), F.pad(cand_x, pad),
            F.pad(e1, pad), F.pad(e2, pad), lengths, F.pad(h0, pad), w_gate_h,
            F.pad(w_cand_h, pad + pad), _pad_halves(b_gate, u, width),
            F.pad(b_cand, pad), F.pad(cell_vecs, pad))


def _slice_gru_grads(u, dgx, dcx, de1, de2, dh0, dwgh, dwch, dbg, dbc, dvecs):
    """`gru_scan_bwd`'s ten cotangents at a padded width sliced back to
    width u (dgx, dW_gh's columns and db_g half by half)."""
    width = dcx.shape[-1]

    def halves(x):
        return torch.cat([x[..., :u], x[..., width:width + u]], -1)

    return (halves(dgx), dcx[..., :u].contiguous(), de1[..., :u].contiguous(),
            de2[..., :u].contiguous(), dh0[:, :u].contiguous(),
            halves(dwgh[:u]), dwch[:u, :u].contiguous(), halves(dbg),
            dbc[:u].contiguous(), dvecs[:, :u].contiguous())


def _launch(mode, gate_x, cand_x, e1, e2, lengths, h0, w_gate_h, w_cand_h,
            b_gate, b_cand, cell_vecs, _design=None) -> torch.Tensor:
    """Launch the forward in the design `fwd_design` picks for its width,
    a width the kernel does not take zero-padded to `kernel_width` and
    the output sliced back.  ``_design="unit_column"`` forces the earlier
    design (chip_smoke.py holds and times it beside the default); the
    main path never passes it.  A failed launch raises: there is no
    fallback."""
    if _design is not None and _design not in FWD_DESIGNS:
        raise ValueError(f"gru_scan: design {_design!r} is not one of "
                         f"{FWD_DESIGNS}")
    b, seq, u2 = gate_x.shape
    u = u2 // 2
    if kernel_width(u) != u:
        padded = _pad_gru_operands(
            kernel_width(u), gate_x, cand_x, e1, e2, lengths, h0, w_gate_h,
            w_cand_h, b_gate, b_cand, cell_vecs)
        return _launch(mode, *padded, _design=_design)[..., :u].contiguous()
    design = fwd_design(u) if _design is None else _design
    if design == "sliced" and fwd_design(u) != "sliced":
        raise ValueError(f"gru_scan: the sliced design takes u a multiple "
                         f"of 32 up to {FWD_SLICED_MAX_U}; got u={u}")
    # the sliced design copies gx, cx, e1 and e2 in 16-byte pieces: a view
    # that starts off that alignment is copied first
    args = (_aligned16(gate_x), _aligned16(cand_x), _aligned16(e1),
            _aligned16(e2), lengths, h0, w_gate_h, w_cand_h, b_gate, b_cand,
            cell_vecs)
    device, stream = build.launch_context(args, "gru_scan")
    is_bf16 = int(gate_x.dtype == torch.bfloat16)
    lib = _library()
    code = FWD_DESIGNS.index(design)
    if u % 32 or not 32 <= u <= 512 \
            or lib.gru_scan_smem_bytes(u, is_bf16, code) > MAX_SMEM_BYTES:
        raise ValueError(
            f"gru_scan: the kernel takes u up to 512 (padded to a multiple "
            f"of 32) whose weights fit in shared memory; got u={u} in "
            f"{gate_x.dtype}")
    out = torch.empty((b, seq, u), dtype=torch.float32, device=gate_x.device)
    status = lib.gru_scan_launch(
        MODES.index(mode), is_bf16, code, *(t.data_ptr() for t in args),
        out.data_ptr(), b, seq, u, device, stream)
    build.check(lib, status, "gru_scan")
    launches[mode] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("gru_scan")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gru_scan_launch.argtypes = [ci, ci, ci] + [vp] * 12 + [ci, ci,
                                                                 ci, ci, vp]
        lib.gru_scan_launch.restype = ci
        lib.gru_scan_smem_bytes.argtypes = [ci, ci, ci]
        lib.gru_scan_smem_bytes.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def gru_scan_plain(mode: str, gate_x, cand_x, e1, e2, lengths, h0,
                   w_gate_h, w_cand_h, b_gate, b_cand, cell_vecs
                   ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same math, one step at a
    time, with the same f32 carry and operand rounding."""
    dt = gate_x.dtype
    u = cand_x.shape[-1]
    wgh, wch = w_gate_h.float(), w_cand_h.float()
    bg, bc, vec = b_gate.float(), b_cand.float(), cell_vecs.float()
    h = h0.float()
    outs = []
    for t in range(gate_x.shape[1]):
        gates = torch.sigmoid(gate_x[:, t].float() + h.to(dt).float() @ wgh
                              + bg)
        r, ug = gates[:, :u], gates[:, u:]
        cand = torch.tanh(cand_x[:, t].float() + (r * h).to(dt).float() @ wch
                          + bc)
        if mode == "plain":
            new_h = ug * h + (1.0 - ug) * cand
        elif mode == "tseqrec":
            new_h = (ug * h * e1[:, t].float()
                     + (1.0 - ug) * cand * e2[:, t].float())
        else:
            weight = torch.relu(e1[:, t].float() + h * vec[0])
            t_state = torch.sigmoid(vec[1] * weight + vec[2] * e2[:, t].float()
                                    + vec[3])
            new_h = ug * h + (1.0 - ug) * cand * t_state
        alive = (t < lengths)[:, None]
        outs.append(torch.where(alive, new_h, torch.zeros_like(new_h)))
        h = torch.where(alive, new_h, h)
    return torch.stack(outs, dim=1)


# ------------------------------------------------------------- backward

def _check_bwd(mode, g, outs, *args) -> None:
    _check(mode, *args)
    b, seq, u2 = args[0].shape
    for name, t in (("g", g), ("outs", outs)):
        if tuple(t.shape) != (b, seq, u2 // 2) or t.dtype != torch.float32:
            raise ValueError(f"gru_scan_bwd: {name} must be f32 "
                             f"{(b, seq, u2 // 2)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def gru_scan_bwd(mode: str, g, outs, gate_x, cand_x, e1, e2, lengths, h0,
                 w_gate_h, w_cand_h, b_gate, b_cand, cell_vecs):
    """Backward of `gru_scan`: g is the f32 cotangent of its outputs and
    outs the f32 outputs it returned.  Returns the f32 cotangents of
    (gate_x, cand_x, e1, e2, h0, w_gate_h, w_cand_h, b_gate, b_cand,
    cell_vecs).  CPU tensors run `gru_scan_bwd_plain`; CUDA tensors
    launch the kernel (at a width it does not take, on operands
    zero-padded to `kernel_width`)."""
    args = (gate_x, cand_x, e1, e2, lengths, h0, w_gate_h, w_cand_h,
            b_gate, b_cand, cell_vecs)
    _check_bwd(mode, g, outs, *args)
    if gate_x.device.type == "cpu":
        return gru_scan_bwd_plain(mode, g, outs, *args)
    if gate_x.device.type != "cuda":
        raise ValueError(f"gru_scan_bwd: no kernel for device {gate_x.device}")
    return _launch_bwd(mode, g, outs, *args)


def _launch_bwd(mode, g, outs, *args, _design=BWD_DESIGNS[0]):
    """Launch the backward in the two-product design (a recompute pass
    over every (b, t) row, then the reverse chain with two products a
    step), a width the kernel does not take zero-padded to `kernel_width`
    (g and outs too: a padded unit's output is 0) and the cotangents
    sliced back.  ``_design="four_product"`` forces the earlier design,
    four dependent products a step (chip_smoke.py holds and times it
    beside the default); the main path never passes it.  A failed launch
    raises: there is no fallback."""
    if _design not in BWD_DESIGNS:
        raise ValueError(f"gru_scan_bwd: design {_design!r} is not one of "
                         f"{BWD_DESIGNS}")
    u = outs.shape[-1]
    width = kernel_width(u)
    if width != u:
        pad = (0, width - u)
        grads = _launch_bwd(mode, F.pad(g, pad), F.pad(outs, pad),
                            *_pad_gru_operands(width, *args), _design=_design)
        return _slice_gru_grads(u, *grads)
    design = BWD_DESIGNS.index(_design)
    # the kernel copies g, outs, e1, e2, w_gate_h and w_cand_h in 16-byte
    # pieces: a view that starts off that alignment is copied first
    g, outs = _aligned16(g), _aligned16(outs)
    args = tuple(_aligned16(t) if i in (2, 3, 6, 7) else t
                 for i, t in enumerate(args))
    gate_x = args[0]
    device, stream = build.launch_context((g, outs) + args, "gru_scan_bwd")
    b, seq, u2 = gate_x.shape
    u = u2 // 2
    is_bf16 = int(gate_x.dtype == torch.bfloat16)
    lib = _bwd_library()
    if u % 32 or not 32 <= u <= BWD_MAX_U \
            or lib.gru_scan_bwd_smem_bytes(u, is_bf16, design) \
            > MAX_SMEM_BYTES:
        raise ValueError(
            f"gru_scan_bwd: the kernel takes u up to {BWD_MAX_U} (padded to "
            f"a multiple of 32) whose weights fit in shared memory; got u={u}")
    f32 = dict(dtype=torch.float32, device=gate_x.device)
    grads = (torch.empty((b, seq, 2 * u), **f32),        # dgx
             torch.empty((b, seq, u), **f32),            # dcx
             torch.empty((b, seq, u), **f32),            # de1
             torch.empty((b, seq, u), **f32),            # de2
             torch.empty((b, u), **f32),                 # dh0
             torch.empty((u, 2 * u), **f32),             # dW_gh
             torch.empty((u, u), **f32),                 # dW_ch
             torch.empty((2 * u,), **f32),               # db_g
             torch.empty((u,), **f32),                   # db_c
             torch.empty((4, u), **f32))                 # dvecs
    ws = torch.empty((lib.gru_scan_bwd_workspace_floats(b, seq, u, device,
                                                        design),), **f32)
    status = lib.gru_scan_bwd_launch(
        MODES.index(mode), is_bf16, design, g.data_ptr(), outs.data_ptr(),
        *(t.data_ptr() for t in args), *(t.data_ptr() for t in grads),
        ws.data_ptr(), b, seq, u, device, stream)
    build.check(lib, status, "gru_scan_bwd")
    bwd_launches[mode] += 1
    return grads


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bwd_library() -> ctypes.CDLL:
    lib = build.library("gru_scan_bwd")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gru_scan_bwd_launch.argtypes = ([ci, ci, ci] + [vp] * 24
                                            + [ci, ci, ci, ci, vp])
        lib.gru_scan_bwd_launch.restype = ci
        lib.gru_scan_bwd_smem_bytes.argtypes = [ci, ci, ci]
        lib.gru_scan_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.gru_scan_bwd_workspace_floats.argtypes = [ci, ci, ci, ci, ci]
        lib.gru_scan_bwd_workspace_floats.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def gru_recompute_plain(gate_x, cand_x, h_prev, w_gate_h, w_cand_h, b_gate,
                        b_cand):
    """Every step's gates and candidate at once from the saved states
    (the kernel's recompute pass): h_prev [B, L, u] f32 is h0 then the
    outputs shifted by one step.  Returns (r, u, c, r * h_prev), f32
    [B, L, u] each, with the product operands rounded to the input
    type."""
    dt = gate_x.dtype
    u = cand_x.shape[-1]
    op = lambda x: x.to(dt).float()  # noqa: E731  (a product operand)
    gates = torch.sigmoid(gate_x.float() + op(h_prev) @ w_gate_h.float()
                          + b_gate.float())
    r, ug = gates[..., :u], gates[..., u:]
    rh = r * h_prev
    cand = torch.tanh(cand_x.float() + op(rh) @ w_cand_h.float()
                      + b_cand.float())
    return r, ug, cand, rh


def gru_scan_bwd_plain(mode: str, g, outs, gate_x, cand_x, e1, e2, lengths,
                       h0, w_gate_h, w_cand_h, b_gate, b_cand, cell_vecs):
    """Plain PyTorch twin of the backward kernel, in its three passes:
    every step's gates and candidate in one batched product from the
    saved outputs (`gru_recompute_plain`), the reverse loop with the
    cell-mode head and the two transposed products, then dW_gh and dW_ch
    as batched products of the rounded operands.  It computes what
    `_gru_scan_bwd_kernel` computes step by step."""
    dt = gate_x.dtype
    u = cand_x.shape[-1]
    op = lambda x: x.to(dt).float()  # noqa: E731  (a product operand)
    wgh, wch = w_gate_h.float(), w_cand_h.float()
    vec = cell_vecs.float()
    outs, g = outs.float(), g.float()
    h_prev = torch.cat([h0.float()[:, None], outs[:, :-1]], dim=1)
    r_all, u_all, c_all, rh_all = gru_recompute_plain(
        gate_x, cand_x, h_prev, w_gate_h, w_cand_h, b_gate, b_cand)
    f32 = dict(dtype=torch.float32, device=gate_x.device)
    dgx = torch.zeros(gate_x.shape, **f32)
    dcx, de1, de2 = (torch.zeros(cand_x.shape, **f32) for _ in range(3))
    dvec = torch.zeros_like(vec)
    dh = torch.zeros_like(outs[:, 0])
    for t in reversed(range(gate_x.shape[1])):
        hp, r, ug, cand = h_prev[:, t], r_all[:, t], u_all[:, t], c_all[:, t]
        alive = (t < lengths)[:, None]
        d_new = torch.where(alive, g[:, t] + dh, torch.zeros_like(dh))
        if mode == "plain":
            du = d_new * (hp - cand)
            dh_next = d_new * ug
            dc = d_new * (1.0 - ug)
        elif mode == "tseqrec":
            e1t, e2t = e1[:, t].float(), e2[:, t].float()
            du = d_new * (hp * e1t - cand * e2t)
            dh_next = d_new * ug * e1t
            dc = d_new * (1.0 - ug) * e2t
            de1[:, t] = d_new * ug * hp
            de2[:, t] = d_new * (1.0 - ug) * cand
        else:
            e1t, e2t = e1[:, t].float(), e2[:, t].float()
            pre = e1t + hp * vec[0]
            w = torch.relu(pre)
            ts = torch.sigmoid(vec[1] * w + vec[2] * e2t + vec[3])
            du = d_new * (hp - cand * ts)
            dc = d_new * (1.0 - ug) * ts
            dz = d_new * (1.0 - ug) * cand * ts * (1.0 - ts)
            dwm = dz * vec[1] * (pre > 0.0).float()
            de1[:, t] = dwm
            de2[:, t] = dz * vec[2]
            dh_next = d_new * ug + dwm * vec[0]
            dvec += torch.stack([(dwm * hp).sum(0), (dz * w).sum(0),
                                 (dz * e2t).sum(0), dz.sum(0)])
        dac = dc * (1.0 - cand * cand)
        dcx[:, t] = dac
        d_rh = op(dac) @ wch.T
        dh_next = dh_next + d_rh * r
        gates = torch.cat([r, ug], dim=1)
        dgates = torch.cat([d_rh * hp, du], dim=1) * gates * (1.0 - gates)
        dgx[:, t] = dgates
        dh_next = dh_next + op(dgates) @ wgh.T
        dh = torch.where(alive, dh_next, dh)
    dwgh = op(h_prev).flatten(0, 1).T @ op(dgx).flatten(0, 1)
    dwch = op(rh_all).flatten(0, 1).T @ op(dcx).flatten(0, 1)
    return (dgx, dcx, de1, de2, dh, dwgh, dwch, dgx.sum((0, 1)),
            dcx.sum((0, 1)), dvec)


class GruScanFunction(torch.autograd.Function):
    """`gru_scan` with `gru_scan_bwd` as its backward (the JAX package's
    `gru_scan_vjp`: `_gs_fwd` saves the inputs and the f32 outputs,
    `_gs_bwd` casts each cotangent back to its input's type)."""

    @staticmethod
    def forward(ctx, mode, *args):
        out = gru_scan(mode, *args)
        ctx.mode = mode
        ctx.save_for_backward(out, *args)
        return out

    @staticmethod
    def backward(ctx, g):
        out, *args = ctx.saved_tensors
        grads = gru_scan_bwd(ctx.mode, g.float().contiguous(), out, *args)
        cast = [d.to(a.dtype) for d, a in
                zip(grads, args[:4] + args[5:])]     # every input but lengths
        return (None, *cast[:4], None, *cast[4:])


def gru_scan_vjp(mode: str, gate_x, cand_x, e1, e2, lengths, h0,
                 w_gate_h, w_cand_h, b_gate, b_cand, cell_vecs
                 ) -> torch.Tensor:
    """Differentiable `gru_scan` (same arguments and result)."""
    return GruScanFunction.apply(mode, gate_x, cand_x, e1, e2, lengths, h0,
                                 w_gate_h, w_cand_h, b_gate, b_cand,
                                 cell_vecs)
