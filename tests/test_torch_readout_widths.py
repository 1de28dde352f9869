"""The fused readout pair at a width its kernels are not built for: the
padding and live width the gemm designs take, held on the CPU.

On the card the readout kernels are built for d in `WIDTHS` (32, 64,
128).  For any other d up to 128 the gemm designs run at the next of
them, on operands `_pad_readout_operands` zero-pads (mem, dec, every
weight, bias and LN parameter), with the live d passed beside it: the
scale stays 1/sqrt(d), and each hop's layer norm averages over the d
live lanes and leaves the padded ones 0.  The twins take the same live
width (``live_d``), so here the kernel's composition pad -> twin at the
padded width with live d -> slice (`_slice_readout_grads` for the
backward) is held against the twins at the native width and against
JAX's Pallas `_readout_fwd` / `_readout_bwd` in interpret mode, on inputs
made with numpy from a seed: d = 16, 48 and 96, padded to the next width
and to 128, B=3, n=2 hops, L=256, key lengths 256, 0 (no live key) and
45, the third row's query masked.  The rows designs still take d in
WIDTHS only, and say so before any build.

Tolerances, of each output's largest |value|: against the native twin
1e-6 in f32 (the same algebra; the products add exact zeros, their sums
may run in another order) and 1e-2 in bf16 (a K or V element on a
rounding boundary may round the other way after a differently ordered
f32 sum), as tests/test_torch_readout_fwd_design.py holds its designs;
against JAX those of tests/test_torch_readout.py, 1e-4 / 1e-2.  The
Pallas backward gives the row with no live key a score gradient that
the twin (as the jnp reference) does not: the backward is compared with
JAX on the other two rows (the native twin holds all three).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mtamrecommender_tpu.ops.pallas import readout_kernel as jrk
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as trk

torch.set_num_threads(2)

B, N_HOPS, L = 3, 2, 256
KEY_LEN = (L, 0, 45)                 # full, no live key, ragged
QMASK = (1.0, 1.0, 0.0)              # the last row's query masked
TWIN_REL = {"float32": 1e-6, "bfloat16": 1e-2}
JAX_REL = {"float32": 1e-4, "bfloat16": 1e-2}
GRADS = ("dmem", "ddec", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwt",
         "dw1", "db1", "dwo1", "dwo2", "dbo", "dlng", "dlnb")
# (live d, the width the kernel runs it at): the next of WIDTHS, and 128
CASES = [(16, 32), (16, 128), (48, 64), (48, 128), (96, 128)]
_UNTYPED = set(trk._F32) | {"key_len"}


def _inputs(d, seed):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    n, w = N_HOPS, d ** -0.5
    return {
        "mem": f(B, L, d), "dec": f(B, d),
        "logdt": np.log1p(np.abs(f(B, L, scale=40.0))),
        "key_len": np.array(KEY_LEN, np.int32),
        "qmask": np.array(QMASK, np.float32),
        "wq": f(n, d, d, scale=w), "bq": f(n, d, scale=0.1),
        "wk": f(n, d, d, scale=w), "bk": f(n, d, scale=0.1),
        "wv": f(n, d, d, scale=w), "bv": f(n, d, scale=0.1),
        "wt": f(n, d, d, scale=0.3 * w), "w1": f(n, L, scale=0.3),
        "b1": f(n, L, scale=0.3), "wo1": f(n, L, scale=0.3),
        "wo2": f(n, L, scale=0.3), "bo": f(n, L, scale=0.3),
        "lng": 1.0 + f(n, d, scale=0.1), "lnb": f(n, d, scale=0.1)}


def _rows(ins, rows):
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


def _padded_forward(args, d, width):
    padded = trk._pad_readout_operands(args, width)
    out = trk.fused_readout_plain(*padded, live_d=d)
    assert out.shape == (B, width) and not out[:, d:].any()
    return out[:, :d]


def _padded_backward(g, args, d, width):
    padded = trk._pad_readout_operands(args, width)
    grads = trk.fused_readout_bwd_plain(F.pad(g, (0, width - d)), *padded,
                                        live_d=d)
    for name, t in zip(GRADS, grads):      # every padded lane is 0
        if t.shape[-1] == width:
            assert not t[..., d:].any(), name
        if t.dim() == 3 and name != "dmem":
            assert not t[:, d:].any(), name
    return trk._slice_readout_grads(d, grads)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


@pytest.mark.parametrize("d,width", [(16, 32), (32, 32), (48, 64),
                                     (96, 128), (128, 128)])
def test_gemm_design_runs_at_the_next_width(d, width):
    mem = torch.zeros(2, 5, d)
    assert trk._kernel_shape("fused_readout", mem, "gemm") == width
    if d == width:
        assert trk._kernel_shape("fused_readout", mem, "rows") == width


@pytest.mark.parametrize("launch", ["forward", "backward"])
def test_rows_design_refuses_other_widths_before_any_build(no_build, launch):
    args = _as_torch(_inputs(48, seed=0), "float32")
    with pytest.raises(ValueError, match="rows design takes d in"):
        if launch == "forward":
            trk._launch(args, _design="rows")
        else:
            trk._launch_bwd(torch.zeros(B, 48), args, _design="rows")
    with pytest.raises(ValueError, match="d <= 128"):
        trk._kernel_shape("fused_readout", torch.zeros(2, 5, 129), "gemm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,width", CASES)
def test_padded_forward_matches_the_native_twin(d, width, dtype):
    args = _as_torch(_inputs(d, seed=d), dtype)
    got = _padded_forward(args, d, width)
    want = trk.fused_readout_plain(*args)
    assert _rel(got.numpy(), want.numpy()) <= TWIN_REL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,width", CASES)
def test_padded_backward_matches_the_native_twin(d, width, dtype):
    args = _as_torch(_inputs(d, seed=d + 1), dtype)
    g = torch.tensor(np.random.RandomState(d).randn(B, d).astype(np.float32))
    got = _padded_backward(g, args, d, width)
    want = trk.fused_readout_bwd_plain(g, *args)
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape, name
        assert _rel(a.numpy(), w.numpy()) <= TWIN_REL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48, 96])
def test_padded_pair_matches_pallas(d, dtype):
    width = trk._kernel_shape("fused_readout", torch.zeros(1, 1, d), "gemm")
    ins = _inputs(d, seed=d + 2)
    got = _padded_forward(_as_torch(ins, dtype), d, width)
    want = np.asarray(jrk._readout_fwd(*_as_jax(ins, dtype)), np.float32)
    assert _rel(got.numpy(), want) <= JAX_REL[dtype]

    # the backward on the rows with a live key (the full row and the
    # masked query): per-row cotangents and batch sums alike
    g = np.random.RandomState(d + 3).randn(B, d).astype(np.float32)
    live = [r for r, klen in enumerate(KEY_LEN) if klen > 0]
    sub = _rows(ins, live)
    got = _padded_backward(torch.tensor(g[live]), _as_torch(sub, dtype), d,
                           width)
    want = jrk._readout_bwd(jnp.asarray(g[live]), *_as_jax(sub, dtype))
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == tuple(np.asarray(w).shape), name
        assert _rel(a.numpy(), w) <= JAX_REL[dtype], name
