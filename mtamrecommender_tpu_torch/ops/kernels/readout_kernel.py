"""Fused multi-hop single-query readout: CUDA kernels and plain twins.

Counterpart of mtamrecommender_tpu/ops/pallas/readout_kernel.py: MTAM's
whole Tq=1 time-attention readout over a row's behaviour memory, every
hop and its projections, in one call per direction.  The forward
`fused_readout` (csrc/fused_readout.cu, the Pallas `_readout_kernel`),
its backward `fused_readout_bwd` (csrc/fused_readout_bwd.cu, the Pallas
`_readout_bwd_kernel`) and `fused_readout_vjp`, the autograd function
that joins them as JAX's custom_vjp does.  Each direction has two
designs (`FWD_DESIGNS`, `BWD_DESIGNS`): "gemm", the default, moves every
[L,d] x [d,d] product to matrix products over all B*L keys (the forward
one, the backward three) around a per-row kernel that runs only the
hops' vector chain; "rows", the first, does it all a row a block.  Per
row and hop i:

    q    = relu(dec_c @ Wq_i + bq_i)            dec_c: dec rounded to mem's type
    K    = relu(mem @ Wk_i + bk_i), V = relu(mem @ Wv_i + bv_i)   (rounded)
    tqk  = tanh((dec_c @ Wt_i) . mem^T)          raw dec and mem, in f32
    gate = wo1_i * tanh(logdt * w1_i + b1_i) + wo2_i * tqk + bo_i
    s    = (q . K^T) * sigmoid(gate) / sqrt(d), key-masked with -2^32+1
    dec  = LN_i(softmax(s) @ V * qmask + dec)    normalize(), eps 1e-8

Products sum in f32; the output is the last hop's f32 [B, d].  The
kernels are built for d in WIDTHS; the gemm designs take any d up to 128
on operands zero-padded to the next of WIDTHS, with the live d passed
beside it: scale = 1/sqrt(d), and each hop's layer norm averages over the
d live lanes and leaves the padded ones 0 (`_pad_readout_operands`; the
twins take ``live_d`` to compute the same at the padded width).  A row with
``key_len == 0`` gets a uniform softmax over its L keys and no score
gradient, as in the jnp reference (the Pallas kernel pads L to 128 first,
and would spread the weights over the padding too).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mtamrecommender_tpu_torch.ops.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
NEG_FILL = -(2.0 ** 32) + 1.0
LN_EPS = 1e-8
MAX_KEYS = 1024          # the kernels' longest memory, as in the JAX package
WIDTHS = (32, 64, 128)   # the kernels' d (the gemm designs pad others)
MAX_SMEM_BYTES = 227 * 1024
# the forward's designs, the default first (the C interface's `design`
# is the index): "gemm" (every hop's K and V projections as one
# block-tiled product over all B*L keys, tensor cores in bf16, then the
# hops' vector chain a row a block) and "rows", the earlier
# one-block-a-row design, kept for comparison
FWD_DESIGNS = ("gemm", "rows")
# the backward's, likewise: "gemm" (the K/V projections, dmem's products
# and dWk / dWv as block-tiled products over all B*L keys) and "rows"
BWD_DESIGNS = ("gemm", "rows")

# the operands after mem and dec, in the order the functions take them
_OPERANDS = ("mem", "dec", "logdt", "key_len", "qmask", "wq", "bq", "wk",
             "bk", "wv", "bv", "wt", "w1", "b1", "wo1", "wo2", "bo", "lng",
             "lnb")
_GATES = ("w1", "b1", "wo1", "wo2", "bo")
_F32 = ("logdt", "qmask") + _GATES

# kernel launches (the plain twins are not counted)
launches = 0
bwd_launches = 0


def _check(args) -> None:
    got = dict(zip(_OPERANDS, args))
    mem = got["mem"]
    if mem.dim() != 3:
        raise ValueError(f"fused_readout: mem must be [B,L,d], got "
                         f"{tuple(mem.shape)}")
    b, tk, d = mem.shape
    n = got["wq"].shape[0] if got["wq"].dim() == 3 else -1
    want = {"dec": (b, d), "logdt": (b, tk), "key_len": (b,), "qmask": (b,),
            "wq": (n, d, d), "bq": (n, d), "wk": (n, d, d), "bk": (n, d),
            "wv": (n, d, d), "bv": (n, d), "wt": (n, d, d),
            **{g: (n, tk) for g in _GATES}, "lng": (n, d), "lnb": (n, d)}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape or n < 1:
            raise ValueError(f"fused_readout: {name} must be {shape} "
                             f"(n >= 1 hops), got {tuple(got[name].shape)}")
    if got["key_len"].dtype != torch.int32:
        raise TypeError("fused_readout: key_len must be int32, got "
                        f"{got['key_len'].dtype}")
    for name in _F32:
        if got[name].dtype != torch.float32:
            raise TypeError(f"fused_readout: {name} must be float32, got "
                            f"{got[name].dtype}")
    typed = [t for name, t in got.items()
             if name not in _F32 and name != "key_len"]
    if mem.dtype not in DTYPES or any(t.dtype != mem.dtype for t in typed):
        raise TypeError("fused_readout: mem, dec, the weights, biases and LN "
                        "params must all be float32 or all bfloat16, got "
                        f"{sorted({str(t.dtype) for t in typed})}")


def _kernel_shape(what: str, mem, design: str) -> int:
    """Raises on a shape the design does not take; returns the width it
    runs at: the narrowest of WIDTHS that holds d for "gemm", d itself
    (one of WIDTHS) for "rows"."""
    b, tk, d = mem.shape
    if not 1 <= tk <= MAX_KEYS or not 1 <= d <= WIDTHS[-1]:
        raise ValueError(
            f"{what}: the kernel takes 1 <= L <= {MAX_KEYS} keys and 1 <= d "
            f"<= {WIDTHS[-1]}, got L={tk}, d={d}")
    if design == "rows" and d not in WIDTHS:
        raise ValueError(f"{what}: the rows design takes d in {WIDTHS} only "
                         f"(the gemm design pads the others), got d={d}")
    return next(w for w in WIDTHS if d <= w)


# the operands with a d axis: position -> the axes padded (mem, dec, the
# [n,d,d] weights, the [n,d] biases and LN parameters)
_PADDED = {0: 1, 1: 1, 5: 2, 6: 1, 7: 2, 8: 1, 9: 2, 10: 1, 11: 2, 17: 1,
           18: 1}


def _pad_readout_operands(args, width):
    """`fused_readout`'s operands at width d zero-padded to ``width``: mem,
    dec, every weight, bias and LN parameter.  A padded lane's q, K, V and
    u are relu(0) = 0 or 0, so no score moves; with the layer norms taken
    over the d live lanes and the padded LN parameters 0, every padded
    output and cotangent lane is 0."""
    out = []
    for i, t in enumerate(args):
        axes = _PADDED.get(i, 0)
        pad = (0, width - t.shape[-1]) * axes
        out.append(F.pad(t, pad) if axes else t)
    return tuple(out)


def _slice_readout_grads(d, grads):
    """`fused_readout_bwd`'s 16 cotangents at a padded width sliced back to
    d (the five gate rows have no d axis)."""
    out = []
    for i, t in zip(_DIFFERENTIABLE, grads):
        axes = _PADDED.get(i, 0)
        out.append(t[..., :d, :d].contiguous() if axes == 2
                   else t[..., :d].contiguous() if axes else t)
    return tuple(out)


def fused_readout(mem, dec, logdt, key_len, qmask, wq, bq, wk, bk, wv, bv,
                  wt, w1, b1, wo1, wo2, bo, lng, lnb) -> torch.Tensor:
    """mem [B,L,d]; dec [B,d]; logdt [B,L] f32 (log1p|t_q - t_k|); key_len
    [B] int32; qmask [B] f32 (1 or 0: a 0 row keeps only its residual and
    normalize each hop); per-hop stacks wq, wk, wv, wt [n,d,d], bq, bk, bv,
    lng, lnb [n,d], gate rows w1, b1, wo1, wo2, bo [n,L] f32.  Returns the
    last hop's output, f32 [B,d].  CPU tensors run `fused_readout_plain`;
    CUDA tensors launch the kernel."""
    args = (mem, dec, logdt, key_len, qmask, wq, bq, wk, bk, wv, bv, wt,
            w1, b1, wo1, wo2, bo, lng, lnb)
    _check(args)
    if mem.device.type == "cpu":
        return fused_readout_plain(*args)
    if mem.device.type != "cuda":
        raise ValueError(f"fused_readout: no kernel for device {mem.device}")
    return _launch(args)


def _aligned(args):
    """The operands, with mem, Wk and Wv copied where a view starts off
    16-byte alignment: the gemm designs read them in 16-byte pieces."""
    return tuple(t.clone() if i in (0, 7, 9) and t.data_ptr() % 16 else t
                 for i, t in enumerate(args))


def _launch(args, _design=FWD_DESIGNS[0]):
    """Launch the forward in the "gemm" design, a d outside WIDTHS on
    operands zero-padded to the next of them and the output sliced back.
    ``_design="rows"`` forces the earlier design (chip_smoke.py holds and
    times it beside the default); the main path never passes it.  A
    failed launch raises: there is no fallback."""
    global launches
    if _design not in FWD_DESIGNS:
        raise ValueError(f"fused_readout: design {_design!r} is not one of "
                         f"{FWD_DESIGNS}")
    design = FWD_DESIGNS.index(_design)
    b, tk, d = args[0].shape
    width = _kernel_shape("fused_readout", args[0], _design)
    if width != d:
        args = _pad_readout_operands(args, width)
    args = _aligned(args)
    mem = args[0]
    device, stream = build.launch_context(args, "fused_readout")
    n = args[5].shape[0]
    lib = _library()
    if lib.fused_readout_smem_bytes(tk, width, n, design) > MAX_SMEM_BYTES:
        raise ValueError(f"fused_readout: L={tk}, d={d} needs more shared "
                         "memory than a block has")
    is_bf16 = int(mem.dtype == torch.bfloat16)
    out = torch.empty((b, width), dtype=torch.float32, device=mem.device)
    # the K and V planes of every hop, freed when the call returns
    ws = torch.empty((lib.fused_readout_workspace_bytes(
        b, tk, width, n, is_bf16, design),), dtype=torch.uint8,
        device=mem.device)
    status = lib.fused_readout_launch(
        is_bf16, design, *(t.data_ptr() for t in args), out.data_ptr(),
        ws.data_ptr(), b, tk, width, n, d, 1.0 / d ** 0.5, device, stream)
    build.check(lib, status, "fused_readout")
    launches += 1
    return out if width == d else out[:, :d].contiguous()


def _library() -> ctypes.CDLL:
    lib = build.library("fused_readout")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_readout_launch.argtypes = (
            [ci, ci] + [vp] * 21 + [ci] * 5 + [ctypes.c_float, ci, vp])
        lib.fused_readout_launch.restype = ci
        lib.fused_readout_smem_bytes.argtypes = [ci] * 4
        lib.fused_readout_smem_bytes.restype = ctypes.c_longlong
        lib.fused_readout_workspace_bytes.argtypes = [ci] * 6
        lib.fused_readout_workspace_bytes.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def _lane_mean(x, live_d):
    """The mean over the last axis, or over its first ``live_d`` lanes
    (the others hold 0)."""
    if live_d is None:
        return x.mean(dim=-1, keepdim=True)
    return x.sum(dim=-1, keepdim=True) / live_d


def _live_lanes(x, live_d):
    """x with the lanes from ``live_d`` on set to 0 (x where None)."""
    if live_d is None:
        return x
    return x * (torch.arange(x.shape[-1], device=x.device) < live_d)


def _hops_plain(mem, dec, logdt, key_len, qmask, wq, bq, wk, bk, wv, bv,
                wt, w1, b1, wo1, wo2, bo, lng, lnb, live_d=None):
    """The forward with the kernel's rounding, hop by hop.  Returns the
    output and, per hop, what its backward reads.  ``live_d``: the
    operands are zero-padded from that width (`_pad_readout_operands`)
    and the layer norms and the scale take the live width, as the
    kernels do."""
    rnd = lambda x: x.to(mem.dtype).float()  # noqa: E731  (a product operand)
    b, tk, d = mem.shape
    scale = 1.0 / (d if live_d is None else live_d) ** 0.5
    memf = mem.float()
    live = torch.arange(tk, device=mem.device)[None, :] < key_len[:, None]
    qz = qmask.float()[:, None]
    cur = dec.float()
    hops = []
    for i in range(wq.shape[0]):
        dec_c = rnd(cur)
        q = torch.relu(dec_c @ wq[i].float() + bq[i].float())
        k = rnd(torch.relu(memf @ wk[i].float() + bk[i].float()))
        v = rnd(torch.relu(memf @ wv[i].float() + bv[i].float()))
        u = dec_c @ wt[i].float()
        tqk = torch.tanh(torch.einsum("bld,bd->bl", memf, u))
        decay = torch.tanh(logdt * w1[i] + b1[i])
        sig = torch.sigmoid(wo1[i] * decay + wo2[i] * tqk + bo[i])
        s0 = torch.einsum("bld,bd->bl", k, q)
        s = torch.where(live, s0 * sig * scale,
                        torch.full_like(s0, NEG_FILL))
        w = torch.softmax(s, dim=-1)
        x = torch.einsum("bl,bld->bd", w, v) * qz + cur
        xc = _live_lanes(x - _lane_mean(x, live_d), live_d)
        inv = 1.0 / torch.sqrt(_lane_mean(torch.square(xc), live_d) + LN_EPS)
        xh = xc * inv
        hops.append(dict(dec=cur, dec_c=dec_c, q=q, k=k, v=v, u=u, tqk=tqk,
                         decay=decay, sig=sig, s0=s0, w=w, xh=xh, inv=inv))
        cur = xh * lng[i].float() + lnb[i].float()
    return cur, hops


def fused_readout_plain(mem, dec, logdt, key_len, qmask, wq, bq, wk, bk,
                        wv, bv, wt, w1, b1, wo1, wo2, bo, lng, lnb,
                        live_d=None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: `_readout_kernel`'s math with its
    operand rounding (K, V and dec_c rounded to mem's type, f32 sums).
    ``live_d``: see `_hops_plain`."""
    return _hops_plain(mem, dec, logdt, key_len, qmask, wq, bq, wk, bk, wv,
                       bv, wt, w1, b1, wo1, wo2, bo, lng, lnb, live_d)[0]


# ------------------------------------------------------------- backward

def fused_readout_bwd(g, mem, dec, logdt, key_len, qmask, wq, bq, wk, bk,
                      wv, bv, wt, w1, b1, wo1, wo2, bo, lng, lnb):
    """Backward of `fused_readout`: g is the f32 cotangent [B,d] of its
    output; the other arguments are its inputs.  Returns the 16 f32
    cotangents (dmem, ddec, dwq, dbq, dwk, dbk, dwv, dbv, dwt, dw1, db1,
    dwo1, dwo2, dbo, dlng, dlnb), the parameter ones summed over the
    batch.  The hops are recomputed from the inputs.  CPU tensors run
    `fused_readout_bwd_plain`; CUDA tensors launch the kernel."""
    args = (mem, dec, logdt, key_len, qmask, wq, bq, wk, bk, wv, bv, wt,
            w1, b1, wo1, wo2, bo, lng, lnb)
    _check(args)
    if tuple(g.shape) != tuple(dec.shape) or g.dtype != torch.float32:
        raise ValueError(f"fused_readout_bwd: g must be f32 "
                         f"{tuple(dec.shape)}, got {g.dtype} {tuple(g.shape)}")
    if mem.device.type == "cpu":
        return fused_readout_bwd_plain(g, *args)
    if mem.device.type != "cuda":
        raise ValueError(f"fused_readout_bwd: no kernel for device "
                         f"{mem.device}")
    return _launch_bwd(g, args)


def _launch_bwd(g, args, _design=BWD_DESIGNS[0]):
    """Launch the backward in the "gemm" design, a d outside WIDTHS on
    operands (g too) zero-padded to the next of them and the cotangents
    sliced back.  ``_design="rows"`` forces the earlier design
    (chip_smoke.py holds and times it beside the default); the main path
    never passes it.  A failed launch raises: there is no fallback."""
    global bwd_launches
    if _design not in BWD_DESIGNS:
        raise ValueError(f"fused_readout_bwd: design {_design!r} is not one "
                         f"of {BWD_DESIGNS}")
    design = BWD_DESIGNS.index(_design)
    live_d = args[0].shape[2]
    d = _kernel_shape("fused_readout_bwd", args[0], _design)
    if d != live_d:
        g = F.pad(g, (0, d - live_d))
        args = _pad_readout_operands(args, d)
    args = _aligned(args)
    mem = args[0]
    device, stream = build.launch_context((g,) + args, "fused_readout_bwd")
    b, tk, _ = mem.shape
    n = args[5].shape[0]
    lib = _bwd_library()
    if lib.fused_readout_bwd_smem_bytes(tk, d, n, design) > MAX_SMEM_BYTES:
        raise ValueError(f"fused_readout_bwd: L={tk}, d={d}, {n} hops need "
                         "more shared memory than a block has")
    is_bf16 = int(mem.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=mem.device)
    shapes = ((b, tk, d), (b, d), (n, d, d), (n, d), (n, d, d), (n, d),
              (n, d, d), (n, d), (n, d, d)) + ((n, tk),) * 5 \
        + ((n, d), (n, d))
    grads = tuple(torch.empty(s, **f32) for s in shapes)
    ws = torch.empty((lib.fused_readout_bwd_workspace_bytes(
        b, tk, d, n, is_bf16, design),), dtype=torch.uint8, device=mem.device)
    status = lib.fused_readout_bwd_launch(
        is_bf16, design, g.data_ptr(), *(t.data_ptr() for t in args),
        *(t.data_ptr() for t in grads), ws.data_ptr(), b, tk, d, n, live_d,
        1.0 / live_d ** 0.5, device, stream)
    build.check(lib, status, "fused_readout_bwd")
    bwd_launches += 1
    return grads if d == live_d else _slice_readout_grads(live_d, grads)


def _bwd_library() -> ctypes.CDLL:
    lib = build.library("fused_readout_bwd")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_readout_bwd_launch.argtypes = (
            [ci, ci] + [vp] * 37 + [ci] * 5 + [ctypes.c_float, ci, vp])
        lib.fused_readout_bwd_launch.restype = ci
        lib.fused_readout_bwd_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.fused_readout_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.fused_readout_bwd_workspace_bytes.argtypes = [ci] * 6
        lib.fused_readout_bwd_workspace_bytes.restype = ctypes.c_longlong
        lib._port_typed = True
    return lib


def fused_readout_bwd_plain(g, mem, dec, logdt, key_len, qmask, wq, bq, wk,
                            bk, wv, bv, wt, w1, b1, wo1, wo2, bo, lng, lnb,
                            live_d=None):
    """Plain PyTorch twin of the backward kernel: `_readout_bwd_kernel`'s
    algebra with its operand rounding (du, dk_pre, dv_pre, dq_pre and the
    hop's query rounded to mem's type before each product; the relu masks
    compare the rounded K and V), the score gradient zeroed at masked keys
    (the jnp reference's ``where``).  ``live_d``: see `_hops_plain`."""
    rnd = lambda x: x.to(mem.dtype).float()  # noqa: E731
    _, hops = _hops_plain(mem, dec, logdt, key_len, qmask, wq, bq, wk, bk,
                          wv, bv, wt, w1, b1, wo1, wo2, bo, lng, lnb, live_d)
    b, tk, d = mem.shape
    n = wq.shape[0]
    scale = 1.0 / (d if live_d is None else live_d) ** 0.5
    memf = mem.float()
    live = torch.arange(tk, device=mem.device)[None, :] < key_len[:, None]
    qz = qmask.float()[:, None]
    f32 = dict(dtype=torch.float32, device=mem.device)
    dmem = torch.zeros((b, tk, d), **f32)
    out = {name: torch.zeros(shape, **f32) for name, shape in (
        ("dwq", (n, d, d)), ("dbq", (n, d)), ("dwk", (n, d, d)),
        ("dbk", (n, d)), ("dwv", (n, d, d)), ("dbv", (n, d)),
        ("dwt", (n, d, d)), ("dw1", (n, tk)), ("db1", (n, tk)),
        ("dwo1", (n, tk)), ("dwo2", (n, tk)), ("dbo", (n, tk)),
        ("dlng", (n, d)), ("dlnb", (n, d)))}
    g = g.float()
    for i in range(n - 1, -1, -1):
        h = hops[i]
        # layer norm backward
        out["dlng"][i] = (g * h["xh"]).sum(0)
        out["dlnb"][i] = g.sum(0)
        dxh = g * lng[i].float()
        dx = _live_lanes((dxh - _lane_mean(dxh, live_d)
                          - h["xh"] * _lane_mean(dxh * h["xh"], live_d))
                         * h["inv"], live_d)
        do = dx * qz                 # o was query-masked; the residual not
        ddec = dx
        # weighted sum and softmax backward
        w = h["w"]
        dw = torch.einsum("bd,bld->bl", do, h["v"])
        dv = w[:, :, None] * do[:, None, :]
        ds = w * (dw - (dw * w).sum(-1, keepdim=True))
        ds = torch.where(live, ds, torch.zeros_like(ds))
        sig, decay, tqk = h["sig"], h["decay"], h["tqk"]
        dgate = ds * h["s0"] * scale * sig * (1.0 - sig)
        ds0 = ds * sig * scale
        dpre_dec = dgate * wo1[i] * (1.0 - decay * decay)
        out["dw1"][i] = (dpre_dec * logdt).sum(0)
        out["db1"][i] = dpre_dec.sum(0)
        out["dwo1"][i] = (dgate * decay).sum(0)
        out["dwo2"][i] = (dgate * tqk).sum(0)
        out["dbo"][i] = dgate.sum(0)
        # content-time term
        dpre_tqk = dgate * wo2[i] * (1.0 - tqk * tqk)
        du = rnd(torch.einsum("bl,bld->bd", dpre_tqk, memf))
        dmem += dpre_tqk[:, :, None] * h["u"][:, None, :]
        ddec = ddec + du @ wt[i].float().T
        out["dwt"][i] = h["dec_c"].T @ du
        # scores and the relu projections
        dq = torch.einsum("bl,bld->bd", ds0, h["k"])
        dk_pre = torch.where(h["k"] > 0, ds0[:, :, None] * h["q"][:, None, :],
                             torch.zeros_like(h["k"]))
        dv_pre = torch.where(h["v"] > 0, dv, torch.zeros_like(dv))
        dq_pre = torch.where(h["q"] > 0, dq, torch.zeros_like(dq))
        dmem += rnd(dk_pre) @ wk[i].float().T
        dmem += rnd(dv_pre) @ wv[i].float().T
        ddec = ddec + rnd(dq_pre) @ wq[i].float().T
        out["dwk"][i] = torch.einsum("bld,ble->de", memf, rnd(dk_pre))
        out["dbk"][i] = dk_pre.sum((0, 1))
        out["dwv"][i] = torch.einsum("bld,ble->de", memf, rnd(dv_pre))
        out["dbv"][i] = dv_pre.sum((0, 1))
        out["dwq"][i] = h["dec_c"].T @ rnd(dq_pre)
        out["dbq"][i] = dq_pre.sum(0)
        g = ddec
    return (dmem, g, out["dwq"], out["dbq"], out["dwk"], out["dbk"],
            out["dwv"], out["dbv"], out["dwt"], out["dw1"], out["db1"],
            out["dwo1"], out["dwo2"], out["dbo"], out["dlng"], out["dlnb"])


# the positions, among fused_readout's arguments, of the operands with a
# cotangent, in the backward's output order (logdt, key_len and qmask
# have none)
_DIFFERENTIABLE = (0, 1) + tuple(range(5, 19))


class FusedReadoutFunction(torch.autograd.Function):
    """`fused_readout` with `fused_readout_bwd` as its backward (the JAX
    package's custom_vjp: `_fr_fwd` saves the inputs, `_fr_bwd` recomputes
    the hops and casts each cotangent to its input's type)."""

    @staticmethod
    def forward(ctx, *args):
        out = fused_readout(*args)
        ctx.save_for_backward(*args)
        return out

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        outs = fused_readout_bwd(g.float().contiguous(), *args)
        grads = [None] * len(args)
        for i, d in zip(_DIFFERENTIABLE, outs):
            if ctx.needs_input_grad[i]:
                grads[i] = d.to(args[i].dtype)
        return tuple(grads)


def fused_readout_vjp(mem, dec, logdt, key_len, qmask, wq, bq, wk, bk, wv,
                      bv, wt, w1, b1, wo1, wo2, bo, lng, lnb) -> torch.Tensor:
    """Differentiable `fused_readout` (same arguments and result)."""
    return FusedReadoutFunction.apply(mem, dec, logdt, key_len, qmask, wq,
                                      bq, wk, bk, wv, bv, wt, w1, b1, wo1,
                                      wo2, bo, lng, lnb)
