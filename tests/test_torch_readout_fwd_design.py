"""The fused readout forward's designs: the names, the checks before a
build, and the "gemm" design's decomposition held in plain PyTorch.

The CUDA kernels run only on the card (chip_smoke.py holds both designs
against `fused_readout_plain` there).  Here `_gemm_design_plain` runs
the design's two steps as plain products on the CPU: (1) one projection
over all B*L keys for the 2n K and V planes, rounded to mem's type; (2)
the per-row chain from those planes, which reads K only at the live keys
and V only at the reached ones (all L of a row with no live key).  It is
held against the twin and against JAX's Pallas forward `_readout_fwd` in
interpret mode, on inputs made with numpy from a seed: B=3, d=32, n=2,
L=128 (one Pallas tile, so the row with no live key is not padded), key
lengths 128, 0 and 45, the third row's query masked.

Tolerances, of the output's largest |value|: against the twin 1e-6 in
f32 (the same algebra, sums in another order) and 1e-2 in bf16 (a K or
V element on a rounding boundary may round the other way after a
differently ordered f32 sum); against JAX those of
tests/test_torch_readout.py, 1e-4 / 1e-2.
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


def _proj_plain(mem, wk, bk, wv, bv):
    """Step 1, proj: K and V of every hop as one product over all B*L
    keys, rounded to mem's type.  Returns the planes [2n, B, L, d]: K of
    hop i is plane i, V plane n + i."""
    b, tk, d = mem.shape
    n = wk.shape[0]
    w_all = torch.cat(list(wk) + list(wv), dim=1).float()          # [d, 2nd]
    b_all = torch.cat(list(bk) + list(bv)).float()
    kv = torch.relu(mem.float().reshape(b * tk, d) @ w_all + b_all)
    kv = kv.to(mem.dtype).reshape(b, tk, 2 * n, d)
    return kv.permute(2, 0, 1, 3).float()


def _chain_plain(planes, mem, dec, logdt, key_len, qmask, wq, bq, wk, bk,
                 wv, bv, wt, w1, b1, wo1, wo2, bo, lng, lnb):
    """Step 2, chain: the hops from the planes, a row's K read only at its
    live keys and V only at the keys its weights reach."""
    rnd = lambda x: x.to(mem.dtype).float()  # noqa: E731  (a product operand)
    b, tk, d = mem.shape
    n = wq.shape[0]
    scale = 1.0 / d ** 0.5
    memf = mem.float()
    live_n = key_len.clamp(0, tk)
    span_n = torch.where(live_n > 0, live_n, torch.full_like(live_n, tk))
    pos = torch.arange(tk)[None, :]
    live, reach = pos < live_n[:, None], pos < span_n[:, None]
    qz = qmask.float()[:, None]
    cur = dec.float()
    for i in range(n):
        k = torch.where(live[..., None], planes[i], torch.zeros(()))
        v = torch.where(reach[..., None], planes[n + i], torch.zeros(()))
        decr = rnd(cur)
        q = torch.relu(decr @ wq[i].float() + bq[i].float())
        u = decr @ wt[i].float()
        tqk = torch.tanh(torch.einsum("bld,bd->bl", memf, u))
        decay = torch.tanh(logdt * w1[i] + b1[i])
        sig = torch.sigmoid(wo1[i] * decay + wo2[i] * tqk + bo[i])
        s0 = torch.einsum("bld,bd->bl", k, q)
        s = torch.where(live, s0 * sig * scale,
                        torch.full_like(s0, trk.NEG_FILL))
        w = torch.softmax(s, dim=-1)
        x = torch.einsum("bl,bld->bd", w, v) * qz + cur
        mu = x.mean(-1, keepdim=True)
        inv = 1.0 / torch.sqrt(torch.square(x - mu).mean(-1, keepdim=True)
                               + trk.LN_EPS)
        cur = (x - mu) * inv * lng[i].float() + lnb[i].float()
    return cur


def _gemm_design_plain(mem, dec, logdt, key_len, qmask, wq, bq, wk, bk, wv,
                       bv, wt, w1, b1, wo1, wo2, bo, lng, lnb):
    """The gemm design's two steps with its operand rounding.  Returns
    the last hop's output f32 [B, d] and the planes."""
    args = (mem, dec, logdt, key_len, qmask, wq, bq, wk, bk, wv, bv, wt, w1,
            b1, wo1, wo2, bo, lng, lnb)
    planes = _proj_plain(mem, wk, bk, wv, bv)
    return _chain_plain(planes, *args), planes


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


def test_readout_fwd_design_is_checked_before_any_build(no_build):
    args = _as_torch(_inputs(), "float32")
    with pytest.raises(ValueError, match="design"):
        trk._launch(args, _design="simt")


def test_readout_fwd_design_names_and_order():
    # the index is the C interface's `design`: "gemm" first, the default
    assert trk.FWD_DESIGNS == ("gemm", "rows")
    default = inspect.signature(trk._launch).parameters["_design"]
    assert default.default == "gemm"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_design_decomposition_matches_twin(dtype):
    args = _as_torch(_inputs(seed=1), dtype)
    got, planes = _gemm_design_plain(*args)
    want = trk.fused_readout_plain(*args)
    assert got.dtype == torch.float32 and got.shape == (B, D)
    assert _rel(got.numpy(), want.numpy()) <= TWIN_REL[dtype]
    # the product computes every key; the chain reads K only at the live
    # keys and V only at the reached ones: what lies past them is unread
    poisoned = planes.clone()
    for r, klen in enumerate(KEY_LEN):
        span = klen if klen else L
        poisoned[:N_HOPS, r, klen:] = float("nan")
        poisoned[N_HOPS:, r, span:] = float("nan")
    assert torch.isnan(poisoned).any()
    assert torch.equal(_chain_plain(poisoned, *args), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_design_decomposition_matches_pallas(dtype):
    ins = _inputs(seed=3)
    got, _ = _gemm_design_plain(*_as_torch(ins, dtype))
    want = np.asarray(jrk._readout_fwd(*_as_jax(ins, dtype)), np.float32)
    assert want.shape == (B, D)
    assert _rel(got.numpy(), want) <= JAX_REL[dtype]
