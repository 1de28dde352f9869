"""Whole-sequence (time-aware) GRU scan: CUDA kernel and plain twin.

Counterpart of mtamrecommender_tpu/ops/pallas/gru_kernel.py (`gru_scan`,
forward of `gru_scan_vjp`).  The kernel is csrc/gru_scan.cu.

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

# kernel launches per mode (the plain twin is not counted)
launches = {mode: 0 for mode in MODES}


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
