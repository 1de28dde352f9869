"""The fused readout backward's designs: the names, the checks before a
build, and the "gemm" design's decomposition held in plain PyTorch.

The CUDA kernels run only on the card (chip_smoke.py holds both designs
against `fused_readout_bwd_plain` there).  Here `_gemm_design_plain`
runs the design's five steps as plain products on the CPU: (1) one
projection over all B*L keys for the 2n K and V planes; (2) the per-row
chain of vector work, which leaves dk_pre and dv_pre (zero past the live
and the reached keys), dpre_tqk and u; (3) dmem as one product over the
2n planes plus the dpre_tqk u epilogue; (4) dWk and dWv as mem^T times
each plane; (5) the batch sums.  It is held against the twin and against
JAX's Pallas backward `_readout_bwd` in interpret mode, on inputs made
with numpy from a seed: B=3, d=32, n=2, L=128 (one Pallas tile, so the
row with no live key is not padded), ragged keys, one `key_len == 0`
row and one masked query.

Tolerances, of each output's largest |value|: against the twin 1e-6 in
f32 (the same algebra, sums in another order) and 1e-2 in bf16 (a
product operand on a rounding boundary may round the other way after a
differently ordered f32 sum); against JAX those of
tests/test_torch_readout.py, 1e-4 / 1e-2 (reached: 1.6e-7 against the
twin in both dtypes, 1.2e-6 / 3.0e-4 against JAX).  The Pallas backward gives
the row with no live key a score gradient that the twin (as the jnp
reference) does not: its per-row cotangents are compared on the live
rows, and its batch sums with that row left out on both sides.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import readout_kernel as jrk
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as trk

torch.set_num_threads(2)

B, D, N_HOPS, L = 3, 32, 2, 128
KEY_LEN = (L, 0, 45)                 # full, no live key, ragged
QMASK = (1.0, 1.0, 0.0)              # the last row's query masked
TWIN_REL = {"float32": 1e-6, "bfloat16": 1e-2}
JAX_REL = {"float32": 1e-4, "bfloat16": 1e-2}
GRADS = ("dmem", "ddec", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwt",
         "dw1", "db1", "dwo1", "dwo2", "dbo", "dlng", "dlnb")
PER_ROW = ("dmem", "ddec")
_UNTYPED = set(trk._F32) | {"key_len"}


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    n = N_HOPS
    return {
        "mem": f(B, L, D), "dec": f(B, D),
        "logdt": np.log1p(np.abs(f(B, L, scale=40.0))),
        "key_len": np.array(KEY_LEN, np.int32),
        "qmask": np.array(QMASK, np.float32),
        "wq": f(n, D, D, scale=0.3), "bq": f(n, D, scale=0.1),
        "wk": f(n, D, D, scale=0.3), "bk": f(n, D, scale=0.1),
        "wv": f(n, D, D, scale=0.3), "bv": f(n, D, scale=0.1),
        "wt": f(n, D, D, scale=0.3), "w1": f(n, L, scale=0.3),
        "b1": f(n, L, scale=0.3), "wo1": f(n, L, scale=0.3),
        "wo2": f(n, L, scale=0.3), "bo": f(n, L, scale=0.3),
        "lng": 1.0 + f(n, D, scale=0.1), "lnb": f(n, D, scale=0.1)}


def _rows(ins, rows):
    """The inputs of the given batch rows only."""
    batched = {"mem", "dec", "logdt", "key_len", "qmask"}
    return {k: v[rows] if k in batched else v for k, v in ins.items()}


def _as_torch(ins, dtype):
    tdt = getattr(torch, dtype)
    return [torch.tensor(ins[k]) if k in _UNTYPED
            else torch.tensor(ins[k]).to(tdt) for k in trk._OPERANDS]


def _as_jax(ins, dtype):
    jdt = jnp.dtype(dtype)
    return [jnp.asarray(ins[k]) if k in _UNTYPED else jnp.asarray(ins[k], jdt)
            for k in trk._OPERANDS]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _gemm_design_plain(g, mem, dec, logdt, key_len, qmask, wq, bq, wk, bk,
                       wv, bv, wt, w1, b1, wo1, wo2, bo, lng, lnb):
    """The gemm design's steps with its operand rounding.  Returns the 16
    cotangents and the chain's workspace: the 2n planes [B, L, d] of
    dk_pre then dv_pre (rounded), dpre_tqk [n, B, L] and u [n, B, d]."""
    rnd = lambda x: x.to(mem.dtype).float()  # noqa: E731  (a product operand)
    b, tk, d = mem.shape
    n = wq.shape[0]
    m = b * tk
    scale = 1.0 / d ** 0.5
    memf = mem.float()
    # 1. proj: K and V of every hop, one product over all B*L keys
    w_all = torch.cat(list(wk) + list(wv), dim=1).float()          # [d, 2nd]
    b_all = torch.cat(list(bk) + list(bv)).float()
    kv = rnd(torch.relu(memf.reshape(m, d) @ w_all + b_all))
    kv = kv.reshape(b, tk, 2 * n, d)
    ks = [kv[:, :, i] for i in range(n)]
    vs = [kv[:, :, n + i] for i in range(n)]
    # 2. chain: the hops' query chain from K and V, then the reverse sweep
    # up to ddec_in, row by row (here batched), vector work only
    live_n = key_len.clamp(0, tk)
    span_n = torch.where(live_n > 0, live_n, torch.full_like(live_n, tk))
    pos = torch.arange(tk)[None, :]
    live, reach = pos < live_n[:, None], pos < span_n[:, None]
    qz = qmask.float()[:, None]
    cur = dec.float()
    hops = []
    for i in range(n):
        decr = rnd(cur)
        q = torch.relu(decr @ wq[i].float() + bq[i].float())
        u = decr @ wt[i].float()
        s0 = torch.einsum("bld,bd->bl", ks[i], q)
        tqk = torch.tanh(torch.einsum("bld,bd->bl", memf, u))
        decay = torch.tanh(logdt * w1[i] + b1[i])
        sig = torch.sigmoid(wo1[i] * decay + wo2[i] * tqk + bo[i])
        s = torch.where(live, s0 * sig * scale,
                        torch.full_like(s0, trk.NEG_FILL))
        w = torch.softmax(s, dim=-1)
        x = torch.einsum("bl,bld->bd", w, vs[i]) * qz + cur
        mu = x.mean(-1, keepdim=True)
        inv = 1.0 / torch.sqrt(torch.square(x - mu).mean(-1, keepdim=True)
                               + trk.LN_EPS)
        xh = (x - mu) * inv
        hops.append(dict(decr=decr, q=q, u=u, s0=s0, tqk=tqk, decay=decay,
                         sig=sig, w=w, xh=xh, inv=inv))
        cur = xh * lng[i].float() + lnb[i].float()
    zeros = lambda *s: torch.zeros(s)  # noqa: E731
    out = {k: zeros(n, d, d) for k in ("dwq", "dwt")}
    out.update({k: zeros(n, d) for k in ("dbq", "dbk", "dbv", "dlng",
                                         "dlnb")})
    out.update({k: zeros(n, tk) for k in ("dw1", "db1", "dwo1", "dwo2",
                                          "dbo")})
    planes = [None] * (2 * n)
    dpts, us = zeros(n, b, tk), zeros(n, b, d)
    gg = g.float()
    for i in range(n - 1, -1, -1):
        h = hops[i]
        out["dlng"][i] = (gg * h["xh"]).sum(0)
        out["dlnb"][i] = gg.sum(0)
        dxh = gg * lng[i].float()
        dx = (dxh - dxh.mean(-1, keepdim=True)
              - h["xh"] * (dxh * h["xh"]).mean(-1, keepdim=True)) * h["inv"]
        do, ddec = dx * qz, dx
        w = h["w"]
        dw = torch.einsum("bd,bld->bl", do, vs[i])
        ds = torch.where(live, w * (dw - (dw * w).sum(-1, keepdim=True)),
                         torch.zeros_like(w))
        sig, decay, tqk = h["sig"], h["decay"], h["tqk"]
        dgate = ds * h["s0"] * scale * sig * (1.0 - sig)
        ds0 = ds * sig * scale
        dpre_dec = dgate * wo1[i] * (1.0 - decay * decay)
        out["dw1"][i] = (dpre_dec * logdt).sum(0)
        out["db1"][i] = dpre_dec.sum(0)
        out["dwo1"][i] = (dgate * decay).sum(0)
        out["dwo2"][i] = (dgate * tqk).sum(0)
        out["dbo"][i] = dgate.sum(0)
        dpts[i] = dgate * wo2[i] * (1.0 - tqk * tqk)
        us[i] = h["u"]
        du = rnd(torch.einsum("bl,bld->bd", dpts[i], memf))
        dq = torch.einsum("bl,bld->bd", ds0, ks[i])
        dq_pre = torch.where(h["q"] > 0, dq, torch.zeros_like(dq))
        ddec = ddec + du @ wt[i].float().T + rnd(dq_pre) @ wq[i].float().T
        out["dwt"][i] = h["decr"].T @ du
        out["dwq"][i] = h["decr"].T @ rnd(dq_pre)
        out["dbq"][i] = dq_pre.sum(0)
        zero = torch.zeros_like(ks[i])
        dk = torch.where(live[..., None] & (ks[i] > 0),
                         ds0[..., None] * h["q"][:, None, :], zero)
        dv = torch.where(reach[..., None] & (vs[i] > 0),
                         w[..., None] * do[:, None, :], zero)
        out["dbk"][i] = dk.sum((0, 1))
        out["dbv"][i] = dv.sum((0, 1))
        planes[i], planes[n + i] = rnd(dk), rnd(dv)
        gg = ddec
    # 3. dmem: one product over all B*L keys and the 2n planes, plus the
    # dpre_tqk u epilogue
    a_all = torch.cat([pl.reshape(m, d) for pl in planes], dim=1)  # [m, 2nd]
    w_t = torch.cat([x.float().T for x in list(wk) + list(wv)], dim=0)
    dmem = (a_all @ w_t).reshape(b, tk, d) \
        + (dpts[:, :, :, None] * us[:, :, None, :]).sum(0)
    # 4. dWk, dWv: mem^T times each plane over all B*L keys
    dws = [memf.reshape(m, d).T @ pl.reshape(m, d) for pl in planes]
    # 5. the batch sums are above; the output order of the twin
    grads = (dmem, gg, out["dwq"], out["dbq"], torch.stack(dws[:n]),
             out["dbk"], torch.stack(dws[n:]), out["dbv"], out["dwt"],
             out["dw1"], out["db1"], out["dwo1"], out["dwo2"], out["dbo"],
             out["dlng"], out["dlnb"])
    return grads, (planes, dpts, us)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


def test_readout_bwd_design_is_checked_before_any_build(no_build):
    args = _as_torch(_inputs(), "float32")
    g = torch.zeros(B, D)
    with pytest.raises(ValueError, match="design"):
        trk._launch_bwd(g, args, _design="simt")


def test_readout_bwd_design_names_and_order():
    # the index is the C interface's `design`: "gemm" first, the default
    assert trk.BWD_DESIGNS == ("gemm", "rows")
    default = inspect.signature(trk._launch_bwd).parameters["_design"]
    assert default.default == "gemm"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_design_decomposition_matches_twin(dtype):
    ins = _inputs(seed=1)
    args = _as_torch(ins, dtype)
    g = torch.tensor(np.random.RandomState(2).randn(B, D).astype(np.float32))
    got, (planes, dpts, us) = _gemm_design_plain(g, *args)
    want = trk.fused_readout_bwd_plain(g, *args)
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape, name
        assert _rel(a.numpy(), w.numpy()) <= TWIN_REL[dtype], name
    # the chain leaves no key mask to the products: dk_pre zero past the
    # live keys, dv_pre past the reached ones (all L of the empty row),
    # dpre_tqk zero past the live keys
    for r, klen in enumerate(KEY_LEN):
        span = klen if klen else L
        for i in range(N_HOPS):
            assert not planes[i][r, klen:].any()
            assert not planes[N_HOPS + i][r, span:].any()
            assert not dpts[i, r, klen:].any()
    assert planes[N_HOPS][1].abs().max() > 0       # V reaches every key
    assert us.abs().max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_design_decomposition_matches_pallas(dtype):
    ins = _inputs(seed=3)
    g = np.random.RandomState(4).randn(B, D).astype(np.float32)
    got, _ = _gemm_design_plain(torch.tensor(g), *_as_torch(ins, dtype))
    want = jrk._readout_bwd(jnp.asarray(g), *_as_jax(ins, dtype))
    live = [r for r, klen in enumerate(KEY_LEN) if klen > 0]
    for name, a, w in zip(GRADS, got, want):
        if name in PER_ROW:
            assert _rel(a.numpy()[live], np.asarray(w)[live]) \
                <= JAX_REL[dtype], name
    # the batch sums, the row with no live key left out on both sides
    sub = _rows(ins, live)
    got, _ = _gemm_design_plain(torch.tensor(g[live]),
                                *_as_torch(sub, dtype))
    want = jrk._readout_bwd(jnp.asarray(g[live]), *_as_jax(sub, dtype))
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == tuple(np.asarray(w).shape), name
        assert _rel(a.numpy(), w) <= JAX_REL[dtype], name
