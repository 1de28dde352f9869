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

from mtamrecommender_tpu_torch.ops.kernels import build

MODES = ("plain", "tseqrec", "tgru")
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232_448   # dynamic shared memory a block may opt into

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
    launch the kernel."""
    args = (gate_x, cand_x, e1, e2, lengths, h0, w_gate_h, w_cand_h,
            b_gate, b_cand, cell_vecs)
    _check(mode, *args)
    if gate_x.device.type == "cpu":
        return gru_scan_plain(mode, *args)
    if gate_x.device.type != "cuda":
        raise ValueError(f"gru_scan: no kernel for device {gate_x.device}")
    return _launch(mode, *args)


def _launch(mode, gate_x, cand_x, e1, e2, lengths, h0, w_gate_h, w_cand_h,
            b_gate, b_cand, cell_vecs) -> torch.Tensor:
    args = (gate_x, cand_x, e1, e2, lengths, h0, w_gate_h, w_cand_h,
            b_gate, b_cand, cell_vecs)
    device, stream = build.launch_context(args, "gru_scan")
    b, seq, u2 = gate_x.shape
    u = u2 // 2
    is_bf16 = int(gate_x.dtype == torch.bfloat16)
    lib = _library()
    if u % 32 or not 32 <= u <= 512 \
            or lib.gru_scan_smem_bytes(u, is_bf16) > MAX_SMEM_BYTES:
        raise ValueError(
            f"gru_scan: the kernel takes u a multiple of 32 in [32, 512] "
            f"whose weights fit in shared memory; got u={u} in {gate_x.dtype}")
    out = torch.empty((b, seq, u), dtype=torch.float32, device=gate_x.device)
    status = lib.gru_scan_launch(
        MODES.index(mode), is_bf16, *(t.data_ptr() for t in args),
        out.data_ptr(), b, seq, u, device, stream)
    build.check(lib, status, "gru_scan")
    launches[mode] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("gru_scan")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gru_scan_launch.argtypes = [ci, ci] + [vp] * 12 + [ci, ci, ci,
                                                             ci, vp]
        lib.gru_scan_launch.restype = ci
        lib.gru_scan_smem_bytes.argtypes = [ci, ci]
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
    launch the kernel."""
    args = (gate_x, cand_x, e1, e2, lengths, h0, w_gate_h, w_cand_h,
            b_gate, b_cand, cell_vecs)
    _check_bwd(mode, g, outs, *args)
    if gate_x.device.type == "cpu":
        return gru_scan_bwd_plain(mode, g, outs, *args)
    if gate_x.device.type != "cuda":
        raise ValueError(f"gru_scan_bwd: no kernel for device {gate_x.device}")
    return _launch_bwd(mode, g, outs, *args)


def _launch_bwd(mode, g, outs, *args):
    gate_x = args[0]
    device, stream = build.launch_context((g, outs) + args, "gru_scan_bwd")
    b, seq, u2 = gate_x.shape
    u = u2 // 2
    lib = _bwd_library()
    if u % 32 or not 32 <= u <= 512 \
            or lib.gru_scan_bwd_smem_bytes(u) > MAX_SMEM_BYTES:
        raise ValueError(
            "gru_scan_bwd: the kernel takes u a multiple of 32 in [32, 512] "
            f"whose padded f32 weights fit in shared memory; got u={u}")
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
    ws = torch.empty((lib.gru_scan_bwd_workspace_floats(b, seq, u, device),),
                     **f32)
    status = lib.gru_scan_bwd_launch(
        MODES.index(mode), int(gate_x.dtype == torch.bfloat16),
        g.data_ptr(), outs.data_ptr(), *(t.data_ptr() for t in args),
        *(t.data_ptr() for t in grads), ws.data_ptr(), b, seq, u, device,
        stream)
    build.check(lib, status, "gru_scan_bwd")
    bwd_launches[mode] += 1
    return grads


def _bwd_library() -> ctypes.CDLL:
    lib = build.library("gru_scan_bwd")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gru_scan_bwd_launch.argtypes = ([ci, ci] + [vp] * 24
                                            + [ci, ci, ci, ci, vp])
        lib.gru_scan_bwd_launch.restype = ci
        lib.gru_scan_bwd_smem_bytes.argtypes = [ci]
        lib.gru_scan_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.gru_scan_bwd_workspace_floats.argtypes = [ci, ci, ci, ci]
        lib.gru_scan_bwd_workspace_floats.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def gru_scan_bwd_plain(mode: str, g, outs, gate_x, cand_x, e1, e2, lengths,
                       h0, w_gate_h, w_cand_h, b_gate, b_cand, cell_vecs):
    """Plain PyTorch twin of the backward kernel: `_gru_scan_bwd_kernel`
    step for step in reverse time, recomputing the gates from the saved
    outputs, with the product operands rounded to the input type."""
    dt = gate_x.dtype
    u = cand_x.shape[-1]
    op = lambda x: x.to(dt).float()  # noqa: E731  (a product operand)
    wgh, wch = w_gate_h.float(), w_cand_h.float()
    bg, bc, vec = b_gate.float(), b_cand.float(), cell_vecs.float()
    outs, g = outs.float(), g.float()
    f32 = dict(dtype=torch.float32, device=gate_x.device)
    dgx = torch.zeros(gate_x.shape, **f32)
    dcx, de1, de2 = (torch.zeros(cand_x.shape, **f32) for _ in range(3))
    dwgh, dwch = torch.zeros_like(wgh), torch.zeros_like(wch)
    dbg, dbc, dvec = (torch.zeros_like(bg), torch.zeros_like(bc),
                      torch.zeros_like(vec))
    dh = torch.zeros_like(outs[:, 0])
    for t in reversed(range(gate_x.shape[1])):
        h_prev = h0.float() if t == 0 else outs[:, t - 1]
        gates = torch.sigmoid(gate_x[:, t].float() + op(h_prev) @ wgh + bg)
        r, ug = gates[:, :u], gates[:, u:]
        rh = r * h_prev
        cand = torch.tanh(cand_x[:, t].float() + op(rh) @ wch + bc)
        alive = (t < lengths)[:, None]
        d_new = torch.where(alive, g[:, t] + dh, torch.zeros_like(dh))
        if mode == "plain":
            du = d_new * (h_prev - cand)
            dh_next = d_new * ug
            dc = d_new * (1.0 - ug)
        elif mode == "tseqrec":
            e1t, e2t = e1[:, t].float(), e2[:, t].float()
            du = d_new * (h_prev * e1t - cand * e2t)
            dh_next = d_new * ug * e1t
            dc = d_new * (1.0 - ug) * e2t
            de1[:, t] = d_new * ug * h_prev
            de2[:, t] = d_new * (1.0 - ug) * cand
        else:
            e1t, e2t = e1[:, t].float(), e2[:, t].float()
            pre = e1t + h_prev * vec[0]
            w = torch.relu(pre)
            ts = torch.sigmoid(vec[1] * w + vec[2] * e2t + vec[3])
            du = d_new * (h_prev - cand * ts)
            dc = d_new * (1.0 - ug) * ts
            dz = d_new * (1.0 - ug) * cand * ts * (1.0 - ts)
            dwm = dz * vec[1] * (pre > 0.0).float()
            de1[:, t] = dwm
            de2[:, t] = dz * vec[2]
            dh_next = d_new * ug + dwm * vec[0]
            dvec += torch.stack([(dwm * h_prev).sum(0), (dz * w).sum(0),
                                 (dz * e2t).sum(0), dz.sum(0)])
        dac = dc * (1.0 - cand * cand)
        dcx[:, t] = dac
        dbc += dac.sum(0)
        d_rh = op(dac) @ wch.T
        dwch += op(rh).T @ op(dac)
        dh_next = dh_next + d_rh * r
        dgates = torch.cat([d_rh * h_prev, du], dim=1) * gates * (1.0 - gates)
        dgx[:, t] = dgates
        dbg += dgates.sum(0)
        dh_next = dh_next + op(dgates) @ wgh.T
        dwgh += op(h_prev).T @ op(dgates)
        dh = torch.where(alive, dh_next, dh)
    return dgx, dcx, de1, de2, dh, dwgh, dwch, dbg, dbc, dvec


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
