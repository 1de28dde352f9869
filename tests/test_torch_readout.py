"""The port's fused multi-hop readout (ops/kernels/readout_kernel.py)
against the JAX package's Pallas readout kernel.

The plain twins `fused_readout_plain` and `fused_readout_bwd_plain` are
held against `readout_kernel.fused_readout` and its backward
`_readout_bwd` (the f32 cotangents before `_fr_bwd` casts them), run in
interpret mode on the CPU as tests/test_pallas.py runs them, on the same
inputs made with numpy from a seed: d=16, n = 2 and 3 hops, L = 256 and
300 (not a multiple of 128), scalar (constant) and positional gate rows,
ragged key lengths, one query-masked row, f32 and bf16.  The CUDA
kernels are held against the same twins on the card by chip_smoke.py.

Tolerances, of each output's largest |value|: the f32 forward 1e-5,
f32 cotangents 1e-4 (reached: 2e-7 and 3e-6); bf16 1e-2 (both sides
round the same operands to bf16, but a product operand on a rounding
boundary may round the other way after a differently ordered f32 sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import readout_kernel as jrk
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as trk

torch.set_num_threads(2)

B, D = 4, 16
REL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}   # fwd, bwd
GRADS = ("dmem", "ddec", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwt",
         "dw1", "db1", "dwo1", "dwo2", "dbo", "dlng", "dlnb")
CASES = [(2, 256, "positional", "float32"), (3, 300, "scalar", "float32"),
         (3, 300, "positional", "bfloat16"), (2, 256, "scalar", "bfloat16")]
_UNTYPED = set(trk._F32) | {"key_len"}


def _inputs(n, L, gate_mode, seed=0):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731

    def gate():
        if gate_mode == "scalar":
            return np.repeat(f(n, 1, scale=0.3), L, axis=1)
        return f(n, L, scale=0.3)

    return {
        "mem": f(B, L, D), "dec": f(B, D),
        "logdt": np.log1p(np.abs(f(B, L, scale=40.0))),
        # ragged, one row shorter than a 128 tile, every row live
        "key_len": np.array([L, 7, L - 50, 1], np.int32),
        "qmask": np.array([1, 1, 0, 1], np.float32),    # one masked query
        "wq": f(n, D, D, scale=0.4), "bq": f(n, D, scale=0.1),
        "wk": f(n, D, D, scale=0.4), "bk": f(n, D, scale=0.1),
        "wv": f(n, D, D, scale=0.4), "bv": f(n, D, scale=0.1),
        "wt": f(n, D, D, scale=0.4), "w1": gate(), "b1": gate(),
        "wo1": gate(), "wo2": gate(), "bo": gate(),
        "lng": 1.0 + f(n, D, scale=0.1), "lnb": f(n, D, scale=0.1)}


def _as_jax(ins, dtype):
    jdt = jnp.dtype(dtype)
    return [jnp.asarray(ins[k]) if k in _UNTYPED else jnp.asarray(ins[k], jdt)
            for k in trk._OPERANDS]


def _as_torch(ins, dtype):
    tdt = getattr(torch, dtype)
    return [torch.tensor(ins[k]) if k in _UNTYPED
            else torch.tensor(ins[k]).to(tdt) for k in trk._OPERANDS]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(map(str, c)) for c in CASES])
def case(request):
    """Inputs, the cotangent and the JAX kernel's forward and backward."""
    n, L, gate_mode, dtype = request.param
    ins = _inputs(n, L, gate_mode)
    g = np.random.RandomState(7).randn(B, D).astype(np.float32)
    jargs = _as_jax(ins, dtype)
    out = np.asarray(jrk.fused_readout(*jargs), np.float32)
    grads = [np.asarray(x) for x in jrk._readout_bwd(jnp.asarray(g), *jargs)]
    return dict(ins=ins, g=g, dtype=dtype, out=out, grads=grads)


def test_fused_readout_plain_matches_pallas(case):
    got = trk.fused_readout(*_as_torch(case["ins"], case["dtype"]))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    assert _rel(got.numpy(), case["out"]) <= REL[case["dtype"]][0]


def test_fused_readout_bwd_plain_matches_pallas(case):
    got = trk.fused_readout_bwd(torch.tensor(case["g"]),
                                *_as_torch(case["ins"], case["dtype"]))
    assert len(got) == len(GRADS) == len(case["grads"])
    for name, a, want in zip(GRADS, got, case["grads"]):
        assert a.dtype == torch.float32 and a.shape == want.shape, name
        assert _rel(a.numpy(), want) <= REL[case["dtype"]][1], name
    # the query mask zeroes o only: the masked row's memory gets no
    # gradient, its query still gets the residual's
    assert not got[0][2].any() and got[1][2].abs().max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_readout_vjp_is_the_backward(dtype):
    """Autograd through `fused_readout_vjp` gives the twin backward's
    cotangents, cast to each input's type, and none for logdt, key_len
    and qmask; in f32 it matches jax.vjp of the Pallas readout."""
    ins = _inputs(2, 256, "positional", seed=3)
    args = _as_torch(ins, dtype)
    leaves = [a.requires_grad_(True) if a.is_floating_point() else a
              for a in args]
    g = torch.tensor(np.random.RandomState(5).randn(B, D).astype(np.float32))
    trk.fused_readout_vjp(*leaves).backward(g)
    want = trk.fused_readout_bwd(g, *[a.detach() for a in args])
    for i, name in enumerate(trk._OPERANDS):
        if name in ("logdt", "key_len", "qmask"):
            assert getattr(leaves[i], "grad", None) is None, name
            continue
        grad = leaves[i].grad
        w = want[trk._DIFFERENTIABLE.index(i)]
        assert grad.dtype == leaves[i].dtype, name
        assert torch.equal(grad, w.to(leaves[i].dtype)), name
    if dtype == "float32":
        jargs = _as_jax(ins, dtype)
        _, vjp = jax.vjp(jrk.fused_readout, *jargs)
        jgrads = vjp(jnp.asarray(g.numpy()))
        for i in trk._DIFFERENTIABLE:
            assert _rel(leaves[i].grad.numpy(), jgrads[i]) <= 1e-4, \
                trk._OPERANDS[i]


def test_readout_wrappers_reject_bad_operands():
    args = _as_torch(_inputs(2, 256, "scalar"), "float32")
    bad = list(args)
    bad[1] = bad[1][:, :-1]                          # dec [B, d-1]
    with pytest.raises(ValueError, match="dec"):
        trk.fused_readout(*bad)
    bad = list(args)
    bad[3] = bad[3].long()                           # key_len int64
    with pytest.raises(TypeError, match="key_len"):
        trk.fused_readout(*bad)
    bad = list(args)
    bad[12] = bad[12].to(torch.bfloat16)             # a bf16 gate row
    with pytest.raises(TypeError, match="w1"):
        trk.fused_readout(*bad)
    bad = list(args)
    bad[5] = bad[5].to(torch.bfloat16)               # one bf16 weight
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        trk.fused_readout(*bad)
    with pytest.raises(ValueError, match="g must be f32"):
        trk.fused_readout_bwd(torch.zeros(B, D, dtype=torch.float64), *args)


def test_cpu_readout_never_builds_a_kernel(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached the CUDA build")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "library", refuse)
    before = (trk.launches, trk.bwd_launches)
    args = _as_torch(_inputs(2, 256, "scalar"), "float32")
    trk.fused_readout(*args)
    trk.fused_readout_bwd(torch.zeros(B, D), *args)
    assert (trk.launches, trk.bwd_launches) == before


def _meta_args(L, d=128, n=3):
    """Operands on the meta device: shapes and types, no data."""
    ins = {"mem": (B, L, d), "dec": (B, d), "logdt": (B, L), "key_len": (B,),
           "qmask": (B,), "wq": (n, d, d), "bq": (n, d), "wk": (n, d, d),
           "bk": (n, d), "wv": (n, d, d), "bv": (n, d), "wt": (n, d, d),
           **{k: (n, L) for k in trk._GATES}, "lng": (n, d), "lnb": (n, d)}
    return tuple(torch.empty(s, device="meta", dtype=torch.int32
                             if k == "key_len" else torch.float32)
                 for k, s in ins.items())


def test_readout_kernel_path_never_runs_the_twin(monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: never the
    twin, and outside 1 <= L <= 1024 keys (or d past 128) it raises
    before building anything; a d below 128 that is not 32, 64 or 128 is
    padded and reaches the build."""
    def refuse(*_a, **_k):
        raise AssertionError("the plain twin ran off the CPU")

    class Built(Exception):
        pass

    def library(*_a, **_k):
        raise Built

    monkeypatch.setattr(trk, "fused_readout_plain", refuse)
    monkeypatch.setattr(trk, "fused_readout_bwd_plain", refuse)
    monkeypatch.setattr(build, "library", library)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trk.fused_readout(*_meta_args(512))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trk.fused_readout_bwd(torch.empty(B, 128, device="meta"),
                              *_meta_args(512))
    for L, d in ((1025, 128), (0, 128), (512, 129)):
        with pytest.raises(ValueError, match="1 <= L <= 1024"):
            trk._launch(_meta_args(L, d))
        with pytest.raises(ValueError, match="1 <= L <= 1024"):
            trk._launch_bwd(torch.empty(B, d, device="meta"),
                            _meta_args(L, d))
    for L, d in ((1, 128), (256, 128), (1024, 128), (512, 48)):
        with pytest.raises(Built):
            trk._launch(_meta_args(L, d))
        with pytest.raises(Built):
            trk._launch_bwd(torch.empty(B, d, device="meta"),
                            _meta_args(L, d))
