"""Sequential-chain Tq=1 readout: CUDA kernels and plain twins.

Counterpart of mtamrecommender_tpu/ops/pallas/readout_chain_kernel.py:
MTAM's n time-attention hops over inputs computed outside the kernel, the
hop-batched projections k_all, v_all, tprec [n, B, L, d] and the decay
half of the gate gate_part [n, B, L].  Only the sequential query chain
runs inside, per row and hop i (cur: the hop's f32 input query):

    q    = relu(cur_c @ Wq_i + bq_i)          cur_c: cur rounded to k's type
    s0   = q . K_i,l        tqk = tanh(cur . tprec_i,l)     (f32 sums)
    gate = gate_part_i,l + wo2_i,l * tqk
    s    = s0 * sigmoid(gate) / sqrt(d), key-masked with -2^32+1
    cur  = LN_i(softmax(s) @ V_i * qz + cur)    normalize(), eps 1e-8

The forward `readout_chain` (csrc/readout_chain.cu, the Pallas
`_chain_fwd_kernel`) returns the last hop's output in dec's type and the
hop-input chain ``curs`` [n, B, d] f32, which its backward
`readout_chain_bwd` (csrc/readout_chain_bwd.cu, `_chain_bwd_kernel`)
replays hop by hop in reverse.  Each takes the design that
`chain_fwd_design` and `chain_bwd_design` pick by one predicate, with d
a multiple of 16 up to 128: "staged" at L <= 64 (each hop's K, V and
tprec rows staged once in shared memory; MTAM's training readout at
L=50), "blocked" at 65 <= L <= 256 (each hop's rows streamed in blocks
of 64 keys through a ring of shared-memory slots, the f32 scores of all
L keys in a strip; MTAM's training readout at the reference's L=150);
"rows" at every other d.  The helpers the designs share are
csrc/chain_staged.cuh.  The cotangents of k_all, v_all, tprec and
gate_part leave as plain outputs, so autograd carries them through the
hop-batched einsums, as XLA's AD does in the JAX package.
`readout_chain_vjp` joins the two as JAX's custom_vjp does.

Like the Pallas kernel, the chain does not pad L: a row with
``key_len == 0`` gets a uniform softmax over its L keys, as in the jnp
reference.  Its backward follows the jnp reference too (no score
gradient at masked keys); the Pallas backward, whose softmax transpose
assumes zero weights there, gives such a row a score gradient.
"""

from __future__ import annotations

import ctypes

import torch

from mtamrecommender_tpu_torch.ops.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
NEG_FILL = -(2.0 ** 32) + 1.0
LN_EPS = 1e-8
MAX_KEYS = 256    # the short-memory regime, as in the JAX package
MAX_D = 128       # the kernels' widest d (every d up to it)
# the designs of the forward (`chain_fwd_design`) and the backward
# (`chain_bwd_design`), picked alike, with d a multiple of 16 up to MAX_D:
# "staged", a block a batch row with each hop's K, V and tprec rows in
# shared memory, at L up to STAGED_KEYS; "blocked", a block a batch row
# with each hop's rows streamed BLOCK_KEYS keys at a time through a ring
# of shared-memory slots, past STAGED_KEYS up to MAX_KEYS; "rows" (the
# first designs, the rows read from global memory key by key) at every
# other shape
FWD_DESIGNS = BWD_DESIGNS = ("staged", "blocked", "rows")
STAGED_KEYS = 64
BLOCK_KEYS = 64
# the staged design's thread mapping: 16 half-warps (the slices of its
# sums over k and over keys) of 16 lanes (a lane 8 columns), 8 warps
HALVES, GROUP, WARPS = 16, 8, 8

# the operands, in the order the functions take them
_OPERANDS = ("dec", "klen", "qz", "k_all", "v_all", "tprec", "gate_part",
             "wo2", "wq", "bq", "lng", "lnb")
_GRADS = ("ddec", "dk", "dv", "dt", "dgp", "dwo2", "dwq", "dbq", "dlng",
          "dlnb")

# kernel launches (the plain twins are not counted)
launches = 0               # every forward design
blocked_launches = 0       # the forward's blocked design alone
rows_launches = 0          # the forward's rows design alone
bwd_launches = 0           # every backward design
bwd_blocked_launches = 0   # the backward's blocked design alone
bwd_rows_launches = 0      # the backward's rows design alone


def supported(tk_len: int, d: int, num_heads: int) -> bool:
    """Whether a Tq=1 time readout over ``tk_len`` keys of width ``d``
    takes the chain: one head and at most MAX_KEYS keys (JAX's
    `supported`), d at most MAX_D."""
    return num_heads == 1 and 1 <= tk_len <= MAX_KEYS and 1 <= d <= MAX_D


def _check(args) -> None:
    """Shapes and types of `readout_chain`'s operands (dec None: the
    backward's, which has none)."""
    got = {name: t for name, t in zip(_OPERANDS, args) if t is not None}
    k = got["k_all"]
    if k.dim() != 4:
        raise ValueError(f"readout_chain: k_all must be [n,B,L,d], got "
                         f"{tuple(k.shape)}")
    n, b, tk, d = k.shape
    want = {"dec": (b, 1, d), "klen": (b,), "qz": (b,), "v_all": (n, b, tk, d),
            "tprec": (n, b, tk, d), "gate_part": (n, b, tk), "wo2": (n, tk),
            "wq": (n, d, d), "bq": (n, d), "lng": (n, d), "lnb": (n, d)}
    for name, shape in want.items():
        if name in got and tuple(got[name].shape) != shape:
            raise ValueError(f"readout_chain: {name} must be {shape}, got "
                             f"{tuple(got[name].shape)}")
    if got["klen"].dtype != torch.int32:
        raise TypeError(f"readout_chain: klen must be int32, got "
                        f"{got['klen'].dtype}")
    if got["qz"].dtype != torch.float32:
        raise TypeError(f"readout_chain: qz must be float32, got "
                        f"{got['qz'].dtype}")
    typed = [t for name, t in got.items() if name not in ("klen", "qz")]
    if k.dtype not in DTYPES or any(t.dtype != k.dtype for t in typed):
        raise TypeError("readout_chain: dec, k_all, v_all, tprec, gate_part, "
                        "wo2 and the hop params must all be float32 or all "
                        "bfloat16, got "
                        f"{sorted({str(t.dtype) for t in typed})}")


def _kernel_shape(what: str, k_all) -> None:
    n, _, tk, d = k_all.shape
    if not (1 <= tk <= MAX_KEYS and 1 <= d <= MAX_D and n >= 1):
        raise ValueError(
            f"{what}: the kernel takes 1 <= L <= {MAX_KEYS} keys, d <= "
            f"{MAX_D} and n >= 1 hops (one head), got L={tk}, d={d}, n={n}")


def readout_chain(dec, klen, qz, k_all, v_all, tprec, gate_part, wo2, wq,
                  bq, lng, lnb):
    """dec [B,1,d]; klen [B] int32 (live keys); qz [B] f32 (1 or 0: a 0
    row keeps only its residual and normalize each hop); k_all, v_all,
    tprec [n,B,L,d]; gate_part [n,B,L]; wo2 [n,L]; wq [n,d,d]; bq, lng,
    lnb [n,d], all in one type.  Returns (out [B,d] in dec's type, curs
    [n,B,d] f32, each hop's input).  CPU tensors run `readout_chain_plain`;
    CUDA tensors launch the kernel in the design `chain_fwd_design`
    picks."""
    args = (dec, klen, qz, k_all, v_all, tprec, gate_part, wo2, wq, bq, lng,
            lnb)
    _check(args)
    if k_all.device.type == "cpu":
        return readout_chain_plain(*args)
    if k_all.device.type != "cuda":
        raise ValueError(f"readout_chain: no kernel for device "
                         f"{k_all.device}")
    return _launch(args)


def _pick_design(what: str, dtype: torch.dtype, tk: int, d: int) -> str:
    """The one predicate of `chain_fwd_design` and `chain_bwd_design`."""
    if dtype not in DTYPES:
        raise TypeError(f"{what}: no design for {dtype}")
    if d % 16 == 0 and 16 <= d <= MAX_D:
        if 1 <= tk <= STAGED_KEYS:
            return "staged"
        if STAGED_KEYS < tk <= MAX_KEYS:
            return "blocked"
    return "rows"


def chain_fwd_design(dtype: torch.dtype, tk: int, d: int) -> str:
    """The forward's design for a shape, the backward's too
    (`chain_bwd_design`), in f32 and bf16, with d a multiple of 16 up to
    MAX_D: "staged" at 1 <= L <= STAGED_KEYS keys (MTAM's training
    readout at L=50, d=128, and the narrow d=16), a block a batch row
    staging each hop's K, V and tprec rows in shared memory once;
    "blocked" at STAGED_KEYS < L <= MAX_KEYS (MTAM's at L=150), a block a
    batch row streaming each hop's rows BLOCK_KEYS keys at a time.
    "rows" at other d.  The staged and blocked launches also want
    k_all, v_all, tprec and wq 16-byte aligned; a launch given others
    takes "rows"."""
    return _pick_design("readout_chain", dtype, tk, d)


def _launch_design(what: str, args4, forced) -> str:
    """The design a launch takes, from k_all, v_all, tprec and wq
    (``args4``), by one rule for the pair: the picked design, or the
    forced one if it is the picked one or "rows" (else a ValueError);
    where "staged" or "blocked" is picked but one of the four is not
    16-byte aligned, "rows" (forced "staged" or "blocked": a
    ValueError).  Raises before any build."""
    k_all = args4[0]
    _, _, tk, d = k_all.shape
    picked = _pick_design(what, k_all.dtype, tk, d)
    design = picked if forced is None else forced
    if design not in (picked, "rows"):
        raise ValueError(
            f"{what}: design {design!r} does not take L={tk}, d={d} "
            f"(picked: {picked!r})")
    if design != "rows" and any(t.data_ptr() % 16 for t in args4):
        if forced is not None:
            raise ValueError(f"{what}: the {design} design takes k_all, "
                             "v_all, tprec and wq 16-byte aligned")
        design = "rows"
    return design


def _launch(args, _design=None):
    """Launch the forward in the design `chain_fwd_design` picks (the
    rows design where the staged or blocked one is picked but an operand
    it reads 16 bytes at a time, k_all, v_all, tprec or wq, is not
    16-byte aligned).  ``_design="rows"`` forces the earlier design
    (chip_smoke.py holds and times it beside the staged and blocked
    designs); "staged" or "blocked" only where it is picked and aligned.
    The main path passes nothing.  A design that fails to build or
    launch raises: there is no fallback."""
    global launches, blocked_launches, rows_launches
    k_all = args[3]
    design = _launch_design("readout_chain",
                            (k_all, args[4], args[5], args[8]), _design)
    device, stream = build.launch_context(args, "readout_chain")
    _kernel_shape("readout_chain", k_all)
    n, b, tk, d = k_all.shape
    lib = _library()
    out = torch.empty((b, d), dtype=k_all.dtype, device=k_all.device)
    curs = torch.empty((n, b, d), dtype=torch.float32, device=k_all.device)
    status = lib.readout_chain_launch(
        FWD_DESIGNS.index(design), int(k_all.dtype == torch.bfloat16),
        *(t.data_ptr() for t in args), out.data_ptr(), curs.data_ptr(), b,
        tk, d, n, 1.0 / d ** 0.5, device, stream)
    build.check(lib, status, f"readout_chain ({design})")
    launches += 1
    blocked_launches += design == "blocked"
    rows_launches += design == "rows"
    return out, curs


def _library() -> ctypes.CDLL:
    lib = build.library("readout_chain")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.readout_chain_launch.argtypes = (
            [ci, ci] + [vp] * 14 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.readout_chain_launch.restype = ci
        lib.readout_chain_staged_smem_bytes.argtypes = [ci] * 3
        lib.readout_chain_staged_smem_bytes.restype = ctypes.c_longlong
        lib.readout_chain_staged_blocks_per_sm.argtypes = [ci] * 4
        lib.readout_chain_staged_blocks_per_sm.restype = ci
        lib.readout_chain_blocked_smem_bytes.argtypes = [ci] * 3
        lib.readout_chain_blocked_smem_bytes.restype = ctypes.c_longlong
        lib.readout_chain_blocked_blocks_per_sm.argtypes = [ci] * 4
        lib.readout_chain_blocked_blocks_per_sm.restype = ci
        lib._port_typed = True
    return lib


def _hop_plain(cur, k, v, t, gp, wo2, wq, bq, lng, lnb, live, qz, scale):
    """One hop of `_hop_fwd` for every row: cur [B,d] f32 -> (the next
    cur, what the backward reads)."""
    cur_c = cur.to(k.dtype).float()
    q = torch.relu(cur_c @ wq.float() + bq.float())
    s0 = torch.einsum("bd,bld->bl", q, k.float())
    tqk = torch.tanh(torch.einsum("bd,bld->bl", cur, t.float()))
    sig = torch.sigmoid(gp.float() + wo2.float() * tqk)
    s = torch.where(live, s0 * sig * scale, torch.full_like(s0, NEG_FILL))
    w = torch.softmax(s, dim=-1)
    x = torch.einsum("bl,bld->bd", w, v.float()) * qz + cur
    mu = x.mean(dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.square(x - mu).mean(dim=-1, keepdim=True)
                           + LN_EPS)
    xh = (x - mu) * inv
    saved = dict(cur_c=cur_c, q=q, s0=s0, tqk=tqk, sig=sig, w=w, xh=xh,
                 inv=inv)
    return xh * lng.float() + lnb.float(), saved


def _row_terms(klen, qz, k_all):
    tk = k_all.shape[2]
    live = torch.arange(tk, device=k_all.device)[None, :] < klen[:, None]
    return live, qz.float()[:, None], 1.0 / k_all.shape[3] ** 0.5


def readout_chain_plain(dec, klen, qz, k_all, v_all, tprec, gate_part, wo2,
                        wq, bq, lng, lnb):
    """Plain PyTorch twin of the forward kernel: `_hop_fwd`'s math with
    its rounding (cur rounded to the input type for the cur @ Wq product
    only; k, v, tprec and gate_part widened to f32; f32 sums)."""
    live, qzf, scale = _row_terms(klen, qz, k_all)
    cur = dec[:, 0, :].float()
    curs = []
    for i in range(k_all.shape[0]):
        curs.append(cur)
        cur, _ = _hop_plain(cur, k_all[i], v_all[i], tprec[i], gate_part[i],
                            wo2[i], wq[i], bq[i], lng[i], lnb[i], live, qzf,
                            scale)
    return cur.to(dec.dtype), torch.stack(curs)


# ------------------------------------------------------------- backward

def readout_chain_bwd(g, klen, qz, k_all, v_all, tprec, gate_part, wo2, wq,
                      bq, lng, lnb, curs):
    """Backward of `readout_chain`: g [B,d] the cotangent of its output,
    in its type; the forward's inputs after dec; ``curs`` its hop-input
    chain.  Returns (ddec [B,d] in g's type, dk, dv, dt [n,B,L,d] and dgp
    [n,B,L] in their inputs' type, and the f32 batch sums dwo2 [n,L], dwq
    [n,d,d], dbq, dlng, dlnb [n,d]).  CPU tensors run
    `readout_chain_bwd_plain`; CUDA tensors launch the kernel in the
    design `chain_bwd_design` picks."""
    args = (klen, qz, k_all, v_all, tprec, gate_part, wo2, wq, bq, lng, lnb)
    n, b, _, d = k_all.shape
    _check((None,) + args)
    if tuple(g.shape) != (b, d) or g.dtype != k_all.dtype:
        raise ValueError(f"readout_chain_bwd: g must be {k_all.dtype} "
                         f"{(b, d)}, got {g.dtype} {tuple(g.shape)}")
    if tuple(curs.shape) != (n, b, d) or curs.dtype != torch.float32:
        raise ValueError(f"readout_chain_bwd: curs must be float32 "
                         f"{(n, b, d)}, got {curs.dtype} "
                         f"{tuple(curs.shape)}")
    if k_all.device.type == "cpu":
        return readout_chain_bwd_plain(g, *args, curs)
    if k_all.device.type != "cuda":
        raise ValueError(f"readout_chain_bwd: no kernel for device "
                         f"{k_all.device}")
    return _launch_bwd(g, args, curs)


def chain_bwd_design(dtype: torch.dtype, tk: int, d: int) -> str:
    """The backward's design for a shape: the forward's
    (`chain_fwd_design`, one predicate), with the same rule for operands
    that are not 16-byte aligned."""
    return _pick_design("readout_chain_bwd", dtype, tk, d)


def _launch_bwd(g, args, curs, _design=None):
    """Launch the backward in the design `chain_bwd_design` picks (the
    rows design where the staged or blocked one is picked but an operand
    it reads 16 bytes at a time, k_all, v_all, tprec or wq, is not
    16-byte aligned: the forward's rule, `_launch_design`).
    ``_design="rows"`` forces the earlier design (chip_smoke.py holds and
    times it beside the staged and blocked designs); "staged" or
    "blocked" only where it is picked and aligned.  The main path passes
    nothing.  A design that fails to build or launch raises: there is no
    fallback."""
    global bwd_launches, bwd_blocked_launches, bwd_rows_launches
    k_all = args[2]
    n, b, tk, d = k_all.shape
    design = _launch_design("readout_chain_bwd",
                            (k_all, args[3], args[4], args[7]), _design)
    device, stream = build.launch_context((g,) + args + (curs,),
                                          "readout_chain_bwd")
    _kernel_shape("readout_chain_bwd", k_all)
    lib = _bwd_library()
    typed = dict(dtype=k_all.dtype, device=k_all.device)
    f32 = dict(dtype=torch.float32, device=k_all.device)
    grads = (torch.empty((b, d), **typed),
             *(torch.empty((n, b, tk, d), **typed) for _ in range(3)),
             torch.empty((n, b, tk), **typed), torch.empty((n, tk), **f32),
             torch.empty((n, d, d), **f32),
             *(torch.empty((n, d), **f32) for _ in range(3)))
    design_id = BWD_DESIGNS.index(design)
    ws = torch.empty((lib.readout_chain_bwd_workspace_bytes(
        design_id, b, tk, d, n),), dtype=torch.uint8, device=k_all.device)
    status = lib.readout_chain_bwd_launch(
        design_id, int(k_all.dtype == torch.bfloat16), g.data_ptr(),
        *(t.data_ptr() for t in args), curs.data_ptr(),
        *(t.data_ptr() for t in grads), ws.data_ptr(), b, tk, d, n,
        1.0 / d ** 0.5, device, stream)
    build.check(lib, status, f"readout_chain_bwd ({design})")
    bwd_launches += 1
    bwd_blocked_launches += design == "blocked"
    bwd_rows_launches += design == "rows"
    return grads


def _bwd_library() -> ctypes.CDLL:
    lib = build.library("readout_chain_bwd")
    if not getattr(lib, "_port_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.readout_chain_bwd_launch.argtypes = (
            [ci, ci] + [vp] * 24 + [ci, ci, ci, ci, ctypes.c_float, ci, vp])
        lib.readout_chain_bwd_launch.restype = ci
        lib.readout_chain_bwd_workspace_bytes.argtypes = [ci] * 5
        lib.readout_chain_bwd_workspace_bytes.restype = ctypes.c_longlong
        lib.readout_chain_bwd_staged_smem_bytes.argtypes = [ci] * 3
        lib.readout_chain_bwd_staged_smem_bytes.restype = ctypes.c_longlong
        lib.readout_chain_bwd_staged_blocks_per_sm.argtypes = [ci] * 4
        lib.readout_chain_bwd_staged_blocks_per_sm.restype = ci
        lib.readout_chain_bwd_blocked_smem_bytes.argtypes = [ci] * 3
        lib.readout_chain_bwd_blocked_smem_bytes.restype = ctypes.c_longlong
        lib.readout_chain_bwd_blocked_blocks_per_sm.argtypes = [ci] * 4
        lib.readout_chain_bwd_blocked_blocks_per_sm.restype = ci
        lib._port_typed = True
    return lib


def readout_chain_bwd_plain(g, klen, qz, k_all, v_all, tprec, gate_part, wo2,
                            wq, bq, lng, lnb, curs):
    """Plain PyTorch twin of the backward kernel: `_chain_bwd_kernel`'s
    algebra, each hop recomputed from ``curs``, with its rounding (dq_pre
    rounded to the input type before dcur += dq_pre Wq^T, dwq += cur_c^T
    dq_pre and dbq; the per-row cotangents cast to their inputs' types),
    the score gradient zeroed at masked keys (the jnp reference's
    ``where``)."""
    live, qzf, scale = _row_terms(klen, qz, k_all)
    n = k_all.shape[0]
    dt_ = k_all.dtype
    dk, dv, dt = (torch.empty_like(x) for x in (k_all, v_all, tprec))
    dgp = torch.empty_like(gate_part)
    f32 = dict(dtype=torch.float32, device=k_all.device)
    dwo2 = torch.zeros(wo2.shape, **f32)
    dwq = torch.zeros(wq.shape, **f32)
    dbq, dlng, dlnb = (torch.zeros(bq.shape, **f32) for _ in range(3))
    dcur = g.float()
    for i in range(n - 1, -1, -1):
        cur = curs[i]
        _, h = _hop_plain(cur, k_all[i], v_all[i], tprec[i], gate_part[i],
                          wo2[i], wq[i], bq[i], lng[i], lnb[i], live, qzf,
                          scale)
        g_i = dcur
        # layer-norm backward (normalize(): (x-mu)*inv*gamma + beta)
        dlng[i] = (g_i * h["xh"]).sum(0)
        dlnb[i] = g_i.sum(0)
        dxh = g_i * lng[i].float()
        dx = (dxh - dxh.mean(-1, keepdim=True)
              - h["xh"] * (dxh * h["xh"]).mean(-1, keepdim=True)) * h["inv"]
        do = dx * qzf
        dcur = dx                                   # the residual branch
        # o = sum_l w_l V_l and the softmax transpose, 0 at masked keys
        w = h["w"]
        dw = torch.einsum("bd,bld->bl", do, v_all[i].float())
        dv[i] = (w[:, :, None] * do[:, None, :]).to(dt_)
        ds = w * (dw - (dw * w).sum(-1, keepdim=True))
        ds = torch.where(live, ds, torch.zeros_like(ds))
        sig, tqk = h["sig"], h["tqk"]
        dgate = ds * h["s0"] * scale * sig * (1.0 - sig)
        ds0 = ds * sig * scale
        dgp[i] = dgate.to(dt_)
        dwo2[i] = (dgate * tqk).sum(0)
        dpre = dgate * wo2[i].float() * (1.0 - tqk * tqk)
        dt[i] = (dpre[:, :, None] * cur[:, None, :]).to(dt_)
        dcur = dcur + torch.einsum("bl,bld->bd", dpre, tprec[i].float())
        # s0 = q . K and q = relu(cur_c Wq + bq)
        dq = torch.einsum("bl,bld->bd", ds0, k_all[i].float())
        dk[i] = (ds0[:, :, None] * h["q"][:, None, :]).to(dt_)
        dq_pre = torch.where(h["q"] > 0, dq, torch.zeros_like(dq)
                             ).to(dt_).float()
        dcur = dcur + dq_pre @ wq[i].float().T
        dwq[i] = h["cur_c"].T @ dq_pre
        dbq[i] = dq_pre.sum(0)
    return (dcur.to(g.dtype), dk, dv, dt, dgp, dwo2, dwq, dbq, dlng, dlnb)


def _warps_in_order(parts):
    """The staged design's combine of HALVES half-warp partials [16, ...]:
    half-warps 2w and 2w+1 added, then the warps' sums in order from 0."""
    pairs = parts[0::2] + parts[1::2]
    out = torch.zeros_like(pairs[0])
    for w in range(WARPS):
        out = out + pairs[w]
    return out


def _lanes_tree(parts):
    """The sum over a half-warp's 16 lanes [16, ...] as its xor shuffles
    take it (offsets 8, 4, 2, 1); lane 0's result."""
    idx = torch.arange(HALVES)
    for off in (8, 4, 2, 1):
        parts = parts + parts[idx ^ off]
    return parts[0]


def _lane_columns(d: int, dtype: torch.dtype) -> torch.Tensor:
    """[d / 8, 8]: the columns lane c of a half-warp owns in the staged
    design, so that a quarter-warp's 16-byte accesses cover 128
    contiguous bytes: bf16 8c .. 8c+7; f32 4c .. 4c+3 and d/2 + 4c ..
    d/2 + 4c+3."""
    c = torch.arange(d // GROUP)[:, None]
    if dtype == torch.bfloat16:
        return GROUP * c + torch.arange(GROUP)[None, :]
    j = torch.arange(GROUP // 2)[None, :]
    return torch.cat([4 * c + j, d // 2 + 4 * c + j], dim=1)


def _lanes_dot(a, x, cols):
    """sum_e a[..., e] x[..., e] the staged design's way: each lane its
    columns ``cols`` [G, 8], then `_lanes_tree` over the 16 lanes (lanes
    past G add 0).  a and x broadcast; the sum leaves the last axis."""
    per_lane = (a[..., cols] * x[..., cols]).sum(-1)         # [..., G]
    lanes = torch.zeros((HALVES,) + per_lane.shape[:-1], dtype=x.dtype,
                        device=x.device)
    lanes[:cols.shape[0]] = per_lane.movedim(-1, 0)
    return _lanes_tree(lanes)


def _key_slices(coef, x):
    """sum_l coef[:, l] x[:, l] over the padded keys the staged and
    blocked designs' way: half-warp h takes keys h, h+16, ... in key
    order (across the blocked design's key blocks too), then
    `_warps_in_order` -> [B,d]."""
    return _warps_in_order(torch.stack([
        torch.einsum("bl,bld->bd", coef[:, h::HALVES], x[:, h::HALVES])
        for h in range(HALVES)]))


def _padded_keys(design: str, tk: int) -> int:
    """The keys the design's model pads a row to: STAGED_KEYS for
    "staged", whole key blocks of BLOCK_KEYS for "blocked"."""
    if design == "staged":
        return STAGED_KEYS
    return -(-tk // BLOCK_KEYS) * BLOCK_KEYS


def _staged_masks(klen, tk, keys=STAGED_KEYS):
    """[B, keys, 1] f32: the rows the designs read, K and tprec at the
    live keys, V at the reached ones (all L keys in a row with none
    live); ``keys`` the padded rows (the staged and hop designs'
    STAGED_KEYS, `_padded_keys`)."""
    n_live = klen.clamp(0, tk)
    reached = torch.where(n_live > 0, n_live, torch.full_like(n_live, tk))
    idx = torch.arange(keys, device=klen.device)[None, :]
    return ((idx < n_live[:, None]).float()[:, :, None],
            (idx < reached[:, None]).float()[:, :, None])


def _staged(x, rows):
    """x [B, L, d] as the designs read it: f32, zero-padded to the rows
    of ``rows`` (`_staged_masks`), zero past the rows it keeps."""
    b, tk, d = x.shape
    out = torch.zeros((b, rows.shape[1], d), dtype=torch.float32,
                      device=x.device)
    out[:, :tk] = x.float()
    return out * rows


def _pad_keys(x, keys=STAGED_KEYS):
    """[B, L] -> [B, keys] f32, zero past L."""
    out = torch.zeros((x.shape[0], keys), dtype=torch.float32,
                      device=x.device)
    out[:, :x.shape[1]] = x
    return out


def _staged_query(cur_c, wq, bq):
    """q = relu(cur_c Wq + bq) the staged and blocked designs' way: the
    sum over k in the 16 slices k = h, h+16, ... combined by
    `_warps_in_order`.  cur_c [..., d] and wq [..., d, d] f32 (leading
    axes batched), bq broadcasting."""
    return torch.relu(_warps_in_order(torch.stack([
        cur_c[..., h::HALVES] @ wq[..., h::HALVES, :]
        for h in range(HALVES)])) + bq)


def _staged_hop(cur, q, ks, vs, ts, gp, wo2, live, qzf, scale, cols):
    """One hop's forward the staged and blocked designs' way, from its
    input cur and query q [B, d] and its rows ks, vs, ts (`_staged`): the
    score dots q.K_l and cur.tprec_l by `_lanes_dot` over the lane
    columns ``cols``, the gate and the softmax, o = sum_l w_l V_l by
    `_key_slices`, the residual and normalize().  Returns (s0, tqk, sig,
    w, xh, inv)."""
    tk = gp.shape[-1]
    s0 = _lanes_dot(q[:, None, :], ks, cols)[:, :tk]
    tqk = torch.tanh(_lanes_dot(cur[:, None, :], ts, cols)[:, :tk])
    sig = torch.sigmoid(gp.float() + wo2.float() * tqk)
    w = torch.softmax(torch.where(live, s0 * sig * scale,
                                  torch.full_like(s0, NEG_FILL)), dim=-1)
    x = _key_slices(_pad_keys(w, ks.shape[1]), vs) * qzf + cur
    mu = x.mean(dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.square(x - mu).mean(dim=-1, keepdim=True)
                           + LN_EPS)
    return s0, tqk, sig, w, (x - mu) * inv, inv


def _design_fwd_plain(design, args):
    """The forward's staged or blocked design in plain PyTorch (see
    `_staged_fwd_design_plain`); ``args`` are `readout_chain`'s."""
    dec, klen, qz, k_all, v_all, tprec, gate_part, wo2, wq, bq, lng, lnb = args
    live, qzf, scale = _row_terms(klen, qz, k_all)
    n, _, tk, d = k_all.shape
    if chain_fwd_design(k_all.dtype, tk, d) != design:
        raise ValueError(f"_{design}_fwd_design_plain: the {design} design "
                         f"does not take L={tk}, d={d}")
    cols = _lane_columns(d, k_all.dtype)
    live_rows, reached_rows = _staged_masks(klen, tk, _padded_keys(design,
                                                                   tk))
    cur = dec[:, 0, :].float()
    curs = []
    for i in range(n):
        curs.append(cur)
        q = _staged_query(cur.to(k_all.dtype).float(), wq[i].float(),
                          bq[i].float())
        *_, xh, _ = _staged_hop(
            cur, q, _staged(k_all[i], live_rows),
            _staged(v_all[i], reached_rows), _staged(tprec[i], live_rows),
            gate_part[i], wo2[i], live, qzf, scale, cols)
        cur = xh * lng[i].float() + lnb[i].float()
    return cur.to(dec.dtype), torch.stack(curs)


def _staged_fwd_design_plain(dec, klen, qz, k_all, v_all, tprec, gate_part,
                             wo2, wq, bq, lng, lnb):
    """The forward's staged design in plain PyTorch, the same outputs as
    `readout_chain_plain` (its rounding points too): per hop, q =
    relu(cur_c Wq + bq) by the 16 k-slices (`_staged_query`); the row's K
    and tprec staged zero past the live keys and V past the reached ones,
    all zero-padded to STAGED_KEYS rows; the score dots by lane columns
    and a half-warp's butterfly, o by 16 key slices in order
    (`_staged_hop`); cur = normalize(o qz + cur) lng + lnb.  Takes d a
    multiple of 16 up to MAX_D and L up to STAGED_KEYS (the design's
    range; chain_fwd_design)."""
    return _design_fwd_plain("staged", (dec, klen, qz, k_all, v_all, tprec,
                                        gate_part, wo2, wq, bq, lng, lnb))


def _blocked_fwd_design_plain(dec, klen, qz, k_all, v_all, tprec,
                              gate_part, wo2, wq, bq, lng, lnb):
    """The forward's blocked design in plain PyTorch, the same outputs as
    `readout_chain_plain` (its rounding points too): the staged design's
    arithmetic (`_staged_fwd_design_plain`) over whole key blocks: each
    hop's K and tprec rows of the live keys and V rows of the reached
    ones zero-padded to a multiple of BLOCK_KEYS rows, the score dots a
    half-warp a key block by block into the f32 strip of all L keys, the
    softmax over the strip, and o by the 16 key slices h, h+16, ... taken
    in key order across the blocks.  Takes d a multiple of 16 up to MAX_D
    and STAGED_KEYS < L <= MAX_KEYS (the design's range;
    chain_fwd_design)."""
    return _design_fwd_plain("blocked", (dec, klen, qz, k_all, v_all, tprec,
                                         gate_part, wo2, wq, bq, lng, lnb))


def _design_bwd_plain(design, g, args, curs):
    """The backward's staged or blocked design in plain PyTorch (see
    `_staged_bwd_design_plain`); ``args`` are `readout_chain_bwd`'s after
    g and before curs."""
    klen, qz, k_all, v_all, tprec, gate_part, wo2, wq, bq, lng, lnb = args
    live, qzf, scale = _row_terms(klen, qz, k_all)
    n, b, tk, d = k_all.shape
    if chain_bwd_design(k_all.dtype, tk, d) != design:
        raise ValueError(f"_{design}_bwd_design_plain: the {design} design "
                         f"does not take L={tk}, d={d}")
    dt_ = k_all.dtype
    cols = _lane_columns(d, dt_)
    keys = _padded_keys(design, tk)
    live_rows, reached_rows = _staged_masks(klen, tk, keys)
    # the query pass: cur_c and q of every hop and row
    cur_cs = curs.to(dt_).float()
    qs = _staged_query(cur_cs, wq.float(), bq.float()[:, None, :])
    dk, dv, dt = (torch.empty_like(x) for x in (k_all, v_all, tprec))
    dgp = torch.empty_like(gate_part)
    f32 = dict(dtype=torch.float32, device=k_all.device)
    dwo2 = torch.zeros(wo2.shape, **f32)
    dwq = torch.zeros(wq.shape, **f32)
    dbq, dlng, dlnb = (torch.zeros(bq.shape, **f32) for _ in range(3))
    dcur = g.float()
    for i in range(n - 1, -1, -1):
        ks, vs, ts = (_staged(k_all[i], live_rows),
                      _staged(v_all[i], reached_rows),
                      _staged(tprec[i], live_rows))
        cur, cur_c, q = curs[i], cur_cs[i], qs[i]
        s0, tqk, sig, w, xh, inv = _staged_hop(
            cur, q, ks, vs, ts, gate_part[i], wo2[i], live, qzf, scale, cols)
        g_i = dcur
        dlng[i] = (g_i * xh).sum(0)
        dlnb[i] = g_i.sum(0)
        dxh = g_i * lng[i].float()
        dx = (dxh - dxh.mean(-1, keepdim=True)
              - xh * (dxh * xh).mean(-1, keepdim=True)) * inv
        do = dx * qzf
        dcur = dx                                   # the residual branch
        dw = _lanes_dot(do[:, None, :], vs, cols)[:, :tk]
        sdw = torch.where(live, dw * w, torch.zeros_like(dw)).sum(
            -1, keepdim=True)
        ds = torch.where(live, w * (dw - sdw), torch.zeros_like(dw))
        dgate = ds * s0 * scale * sig * (1.0 - sig)
        ds0 = ds * sig * scale
        dpre = dgate * wo2[i].float() * (1.0 - tqk * tqk)
        dgp[i] = dgate.to(dt_)
        dwo2[i] = (dgate * tqk).sum(0)
        # the [L, D] cotangents over all L keys
        dv[i] = ((w * reached_rows[:, :tk, 0])[:, :, None]
                 * do[:, None, :]).to(dt_)
        dt[i] = (dpre[:, :, None] * cur[:, None, :]).to(dt_)
        dk[i] = (ds0[:, :, None] * q[:, None, :]).to(dt_)
        dcur = dcur + _key_slices(_pad_keys(dpre, keys), ts)
        dq = _key_slices(_pad_keys(ds0, keys), ks)
        dq_pre = torch.where(q > 0, dq, torch.zeros_like(dq)).to(dt_).float()
        # dq_pre Wq^T: row e of Wq, lane c its k columns
        dcur = dcur + _lanes_dot(dq_pre[:, None, :], wq[i].float()[None],
                                 cols)
        dwq[i] = cur_c.T @ dq_pre
        dbq[i] = dq_pre.sum(0)
    return (dcur.to(g.dtype), dk, dv, dt, dgp, dwo2, dwq, dbq, dlng, dlnb)


def _staged_bwd_design_plain(g, klen, qz, k_all, v_all, tprec, gate_part,
                             wo2, wq, bq, lng, lnb, curs):
    """The staged design's steps in plain PyTorch, the same outputs as
    `readout_chain_bwd_plain` (its rounding points too): the query pass
    (q = relu(cur_c Wq + bq) for every hop and row, by the 16 k-slices k =
    h, h+16, ... combined by `_warps_in_order`); per hop, the row's K
    and tprec staged zero past the live keys and V past the reached
    ones, all zero-padded to STAGED_KEYS rows; the score dots q.K_l,
    cur.tprec_l and do.V_l by `_lanes_dot` over the lane columns of
    `_lane_columns`; the weighted sum o, sum dpre_l tprec_l and dq = sum
    ds0_l K_l over the padded keys by `_key_slices`; dk, dt zero past the
    live keys and dv past the reached ones; dq_pre Wq^T a row of Wq at a
    time by `_lanes_dot` over the lane columns of k.  Takes d a multiple
    of 16 up to MAX_D and L up to STAGED_KEYS (the design's range;
    chain_bwd_design)."""
    return _design_bwd_plain("staged", g, (klen, qz, k_all, v_all, tprec,
                                           gate_part, wo2, wq, bq, lng, lnb),
                             curs)


def _blocked_bwd_design_plain(g, klen, qz, k_all, v_all, tprec, gate_part,
                              wo2, wq, bq, lng, lnb, curs):
    """The blocked design's steps in plain PyTorch, the same outputs as
    `readout_chain_bwd_plain` (its rounding points too): the staged
    design's query pass and per-hop arithmetic
    (`_staged_bwd_design_plain`) over whole key blocks: per hop, the K and
    tprec rows of the live keys and V rows of the reached ones
    zero-padded to a multiple of BLOCK_KEYS rows; s0 and tqk block by
    block into the f32 strip of all L keys, the softmax over it; o from
    the V blocks and dw = do.V_l from a second pass of them; the softmax
    transpose on the strip; dk, dt zero past the live keys and dv past
    the reached ones over all L keys; sum dpre_l tprec_l and dq = sum
    ds0_l K_l from a second pass of the K and tprec blocks, by the 16 key
    slices in key order across the blocks.  Takes d a multiple of 16 up
    to MAX_D and STAGED_KEYS < L <= MAX_KEYS (the design's range;
    chain_bwd_design)."""
    return _design_bwd_plain("blocked", g, (klen, qz, k_all, v_all, tprec,
                                            gate_part, wo2, wq, bq, lng, lnb),
                             curs)


class ReadoutChainFunction(torch.autograd.Function):
    """`readout_chain` with `readout_chain_bwd` as its backward (the JAX
    package's custom_vjp: `_rc_fwd` saves the inputs and ``curs``,
    `_rc_bwd` returns ddec in dec's type, no cotangent for klen and qz,
    and the parameter sums cast to the parameters' types)."""

    @staticmethod
    def forward(ctx, dec, klen, qz, k_all, v_all, tprec, gate_part, wo2, wq,
                bq, lng, lnb):
        out, curs = readout_chain(dec, klen, qz, k_all, v_all, tprec,
                                  gate_part, wo2, wq, bq, lng, lnb)
        ctx.save_for_backward(klen, qz, k_all, v_all, tprec, gate_part, wo2,
                              wq, bq, lng, lnb, curs)
        ctx.dec_shape = dec.shape
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        args, curs = saved[:-1], saved[-1]
        grads = readout_chain_bwd(g.to(args[2].dtype).contiguous(), *args,
                                  curs)
        ddec, per_row, params = grads[0], grads[1:5], grads[5:]
        return (ddec.reshape(ctx.dec_shape), None, None, *per_row,
                *(d.to(p.dtype) for d, p in zip(params, args[6:])))


def readout_chain_vjp(dec, klen, qz, k_all, v_all, tprec, gate_part, wo2,
                      wq, bq, lng, lnb) -> torch.Tensor:
    """Differentiable `readout_chain`: the output [B,d] in dec's type."""
    return ReadoutChainFunction.apply(dec, klen, qz, k_all, v_all, tprec,
                                      gate_part, wo2, wq, bq, lng, lnb)
