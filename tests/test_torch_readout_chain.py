"""The port's sequential-chain readout (ops/kernels/readout_chain_kernel.py)
against the JAX package's Pallas chain kernel.

The plain twins `readout_chain_plain` and `readout_chain_bwd_plain` are
held against `readout_chain_kernel._chain_fwd` and `_chain_bwd_impl` (the
backward before `_rc_bwd` casts its parameter sums), run in interpret
mode on the CPU as tests/test_pallas.py runs them, on the same inputs
made with numpy from a seed: B=12, d=16, n = 2 and 3 hops, L = 12 and
50, positional and scalar (constant) wo2 rows, ragged key lengths and
one query-masked row, f32 and bf16.  The backward takes the JAX
forward's hop-input chain on both sides.  The CUDA kernels are held
against the same twins on the card by chip_smoke.py (phase 2f).

Tolerances: f32 within atol 1e-5; bf16 within 2e-2 of each output's
largest |value| (both sides round the same operands to bf16, but an
operand on a rounding boundary may round the other way after a
differently ordered f32 sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import readout_chain_kernel as jrc
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as trc

torch.set_num_threads(2)

B, D = 12, 16
ATOL_F32, REL_BF16 = 1e-5, 2e-2
CASES = [(3, 50, "positional", "float32"), (2, 12, "scalar", "float32"),
         (3, 50, "scalar", "bfloat16"), (2, 12, "positional", "bfloat16")]
_UNTYPED = ("klen", "qz")
# per-row cotangents, then the batch sums
PER_ROW = ("ddec", "dk", "dv", "dt", "dgp")


def _key_len(L):
    return np.array([L, 7, L - 3, 1, L, 2, L // 2, L, 5, L, 3, L], np.int32)


def _inputs(n, L, gate_mode, seed=0, key_len=None):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    wo2 = (np.repeat(f(n, 1, scale=0.5), L, axis=1) if gate_mode == "scalar"
           else f(n, L, scale=0.5))
    qz = np.ones((B,), np.float32)
    qz[4] = 0.0                                       # one masked query
    return {
        "dec": f(B, 1, D), "klen": _key_len(L) if key_len is None
        else np.asarray(key_len, np.int32), "qz": qz,
        "k_all": np.maximum(f(n, B, L, D), 0.0),
        "v_all": np.maximum(f(n, B, L, D), 0.0),
        "tprec": f(n, B, L, D, scale=0.5), "gate_part": f(n, B, L, scale=0.5),
        "wo2": wo2, "wq": f(n, D, D, scale=0.4), "bq": f(n, D, scale=0.1),
        "lng": 1.0 + f(n, D, scale=0.1), "lnb": f(n, D, scale=0.1)}


def _as_jax(ins, dtype):
    jdt = jnp.dtype(dtype)
    return [jnp.asarray(ins[k]) if k in _UNTYPED else jnp.asarray(ins[k], jdt)
            for k in trc._OPERANDS]


def _as_torch(ins, dtype):
    tdt = getattr(torch, dtype)
    return [torch.tensor(ins[k]) if k in _UNTYPED
            else torch.tensor(ins[k]).to(tdt) for k in trc._OPERANDS]


def _close(got, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    diff = np.abs(got - want).max() if want.size else 0.0
    if dtype == "float32":
        assert diff <= ATOL_F32, (what, diff)
    else:
        assert diff <= REL_BF16 * max(np.abs(want).max(), 1e-30), (what, diff)


def _g(seed=7):
    return np.random.RandomState(seed).randn(B, D).astype(np.float32)


@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(map(str, c)) for c in CASES])
def case(request):
    """Inputs, the cotangent and the JAX kernel's forward and backward."""
    n, L, gate_mode, dtype = request.param
    ins = _inputs(n, L, gate_mode)
    g = _g()
    jargs = _as_jax(ins, dtype)
    out, curs = jrc._chain_fwd(*jargs)
    grads = jrc._chain_bwd_impl(jnp.asarray(g, jnp.dtype(dtype)),
                                *jargs[1:], curs)
    return dict(ins=ins, g=g, dtype=dtype, out=np.asarray(out, np.float32),
                curs=np.asarray(curs),
                grads=[np.asarray(x, np.float32) for x in grads])


def test_readout_chain_plain_matches_pallas(case):
    dtype = case["dtype"]
    out, curs = trc.readout_chain(*_as_torch(case["ins"], dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, D)
    assert curs.dtype == torch.float32
    _close(out, case["out"], dtype, "out")
    _close(curs, case["curs"], dtype, "curs")


def test_readout_chain_bwd_plain_matches_pallas(case):
    dtype = case["dtype"]
    args = _as_torch(case["ins"], dtype)
    tdt = getattr(torch, dtype)
    got = trc.readout_chain_bwd(torch.tensor(case["g"]).to(tdt), *args[1:],
                                torch.tensor(case["curs"]))
    assert len(got) == len(trc._GRADS) == len(case["grads"])
    for name, a, want in zip(trc._GRADS, got, case["grads"]):
        assert a.dtype == (tdt if name in PER_ROW else torch.float32), name
        _close(a, want.reshape(a.shape), dtype, name)
    # the masked query's row: no score gradient reaches its keys
    assert not got[1][:, 4].float().any() and not got[4][:, 4].float().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_readout_chain_vjp_is_the_backward(dtype):
    """Autograd through `readout_chain_vjp` gives the twin backward's
    cotangents, the parameter sums cast to the parameters' types, ddec in
    dec's type and shape, and none for klen and qz; in f32 it matches
    jax.vjp of the Pallas `readout_chain`."""
    ins = _inputs(3, 50, "positional", seed=3)
    args = _as_torch(ins, dtype)
    leaves = [a.requires_grad_(True) if a.is_floating_point() else a
              for a in args]
    tdt = getattr(torch, dtype)
    g = torch.tensor(_g(seed=5)).to(tdt)
    out = trc.readout_chain_vjp(*leaves)
    assert out.dtype == tdt and out.shape == (B, D)
    out.backward(g)
    detached = [a.detach() for a in args]
    _, curs = trc.readout_chain(*detached)
    want = trc.readout_chain_bwd(g, *detached[1:], curs)
    assert leaves[1].grad is None and leaves[2].grad is None
    wants = dict(zip(trc._GRADS, want))
    for name, key in (("dec", "ddec"), ("k_all", "dk"), ("v_all", "dv"),
                      ("tprec", "dt"), ("gate_part", "dgp"), ("wo2", "dwo2"),
                      ("wq", "dwq"), ("bq", "dbq"), ("lng", "dlng"),
                      ("lnb", "dlnb")):
        leaf = leaves[trc._OPERANDS.index(name)]
        assert leaf.grad.dtype == tdt and leaf.grad.shape == leaf.shape, name
        assert torch.equal(leaf.grad, wants[key].to(tdt).reshape(leaf.shape)), \
            name
    if dtype == "float32":
        jargs = _as_jax(ins, dtype)
        _, vjp = jax.vjp(jrc.readout_chain, *jargs)
        jgrads = vjp(jnp.asarray(g.numpy()))
        for i, name in enumerate(trc._OPERANDS):
            if name not in _UNTYPED:
                _close(leaves[i].grad, jgrads[i], dtype, name)


def _jnp_chain(dec, klen, qz, k_all, v_all, tprec, gate_part, wo2, wq, bq,
               lng, lnb):
    """The chain as jnp code (the Pallas body's `_hop_fwd`, hop after
    hop), whose jax.vjp is the reference's: no score gradient at masked
    keys, through the key mask's ``where``."""
    n, _, tl, d = k_all.shape
    mask = jnp.arange(tl)[None, :] < klen[:, None]
    cur = dec[:, 0, :].astype(jnp.float32)
    for i in range(n):
        cur, _ = jrc._hop_fwd(cur, k_all[i], v_all[i], tprec[i],
                              gate_part[i], wo2[i], wq[i], bq[i], lng[i],
                              lnb[i], mask, qz[:, None], 1.0 / d ** 0.5,
                              k_all.dtype)
    return cur


def test_key_len_zero_row_both_ways():
    """A row with no live key.  Forward: a uniform softmax over its L
    keys in the twin and the Pallas kernel alike (neither pads L).
    Backward: the twin gives it no score gradient, as jax.vjp of the jnp
    chain does, on every row; the Pallas backward gives it one (dk, dgp,
    dt nonzero) and agrees with the twin on the live rows."""
    L = 50
    key_len = _key_len(L)
    key_len[2] = 0
    ins = _inputs(3, L, "positional", seed=11, key_len=key_len)
    jargs = _as_jax(ins, "float32")
    args = _as_torch(ins, "float32")
    g = _g(seed=13)
    out, curs = trc.readout_chain(*args)
    jout, jcurs = jrc._chain_fwd(*jargs)
    _close(out, jout, "float32", "out")
    ref_out, vjp = jax.vjp(_jnp_chain, *jargs)
    _close(out, ref_out, "float32", "out vs jnp")
    ref = vjp(jnp.asarray(g))
    got = trc.readout_chain_bwd(torch.tensor(g), *args[1:], curs)
    wants = dict(zip(trc._OPERANDS, ref))
    for key, name in zip(trc._GRADS, ("dec", "k_all", "v_all", "tprec",
                                      "gate_part", "wo2", "wq", "bq", "lng",
                                      "lnb")):
        a = dict(zip(trc._GRADS, got))[key]
        _close(a, np.asarray(wants[name]).reshape(a.shape), "float32", key)
    for i in (1, 3, 4):                              # dk, dt, dgp
        assert not got[i][:, 2].any()
    assert got[2][:, 2].abs().max() > 0              # V reaches every key
    pallas = jrc._chain_bwd_impl(jnp.asarray(g), *jargs[1:], jcurs)
    live = [r for r in range(B) if r != 2]
    for i, key in enumerate(PER_ROW):
        p = np.asarray(pallas[i]).reshape(got[i].shape)
        rows = (slice(None), live) if i else (live,)
        _close(got[i][rows], p[rows], "float32", key)
    assert np.abs(np.asarray(pallas[1])[:, 2]).max() > 1e-3
    assert np.abs(np.asarray(pallas[4])[:, 2]).max() > 1e-3


def test_readout_chain_wrappers_reject_bad_operands():
    args = _as_torch(_inputs(2, 12, "scalar"), "float32")
    bad = list(args)
    bad[0] = bad[0][:, :, :-1]                       # dec [B, 1, d-1]
    with pytest.raises(ValueError, match="dec"):
        trc.readout_chain(*bad)
    bad = list(args)
    bad[1] = bad[1].long()                           # klen int64
    with pytest.raises(TypeError, match="klen"):
        trc.readout_chain(*bad)
    bad = list(args)
    bad[7] = bad[7].to(torch.bfloat16)               # a bf16 wo2 row
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        trc.readout_chain(*bad)
    bad = list(args)
    bad[6] = bad[6][:, :, :-1]                       # gate_part [n, B, L-1]
    with pytest.raises(ValueError, match="gate_part"):
        trc.readout_chain(*bad)
    _, curs = trc.readout_chain(*args)
    with pytest.raises(ValueError, match="g must be"):
        trc.readout_chain_bwd(torch.zeros(B, D, dtype=torch.bfloat16),
                              *args[1:], curs)
    with pytest.raises(ValueError, match="curs must be"):
        trc.readout_chain_bwd(torch.zeros(B, D), *args[1:], curs[:1])


def test_cpu_readout_chain_never_builds_a_kernel(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached the CUDA build")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "library", refuse)
    before = (trc.launches, trc.bwd_launches)
    args = _as_torch(_inputs(2, 12, "scalar"), "float32")
    _, curs = trc.readout_chain(*args)
    trc.readout_chain_bwd(torch.zeros(B, D), *args[1:], curs)
    assert (trc.launches, trc.bwd_launches) == before


def _meta_args(L, d=128, n=3):
    """Operands on the meta device: shapes and types, no data."""
    shapes = {"dec": (B, 1, d), "klen": (B,), "qz": (B,),
              "k_all": (n, B, L, d), "v_all": (n, B, L, d),
              "tprec": (n, B, L, d), "gate_part": (n, B, L), "wo2": (n, L),
              "wq": (n, d, d), "bq": (n, d), "lng": (n, d), "lnb": (n, d)}
    return tuple(torch.empty(s, device="meta", dtype=torch.int32
                             if k == "klen" else torch.float32)
                 for k, s in shapes.items())


def test_readout_chain_kernel_path_never_runs_the_twin(monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: never the
    twin; past 256 keys (where JAX's `supported` refuses too), or d past
    128, it raises before building anything."""
    def refuse(*_a, **_k):
        raise AssertionError("the plain twin ran off the CPU")

    class Built(Exception):
        pass

    def library(*_a, **_k):
        raise Built

    monkeypatch.setattr(trc, "readout_chain_plain", refuse)
    monkeypatch.setattr(trc, "readout_chain_bwd_plain", refuse)
    monkeypatch.setattr(build, "library", library)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    curs = torch.empty(3, B, 128, device="meta")
    g = torch.empty(B, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trc.readout_chain(*_meta_args(50))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trc.readout_chain_bwd(g, *_meta_args(50)[1:], curs)
    for L, d in ((257, 128), (0, 128), (50, 129)):
        args = _meta_args(L, d)
        with pytest.raises(ValueError, match="1 <= L <= 256 keys, d <= 128"):
            trc._launch(args)
        with pytest.raises(ValueError, match="1 <= L <= 256 keys, d <= 128"):
            trc._launch_bwd(torch.empty(B, d, device="meta"), args[1:],
                            torch.empty(3, B, d, device="meta"))
    for L, d in ((1, 16), (50, 128), (256, 64)):
        args = _meta_args(L, d)
        with pytest.raises(Built):
            trc._launch(args)
        with pytest.raises(Built):
            trc._launch_bwd(torch.empty(B, d, device="meta"), args[1:],
                            torch.empty(3, B, d, device="meta"))


@pytest.mark.parametrize("tk", [1, 50, 255, 256, 257, 1024])
@pytest.mark.parametrize("heads", [1, 2])
def test_supported_follows_jax(tk, heads):
    """One head and at most 256 keys, as JAX's `supported`; every d up to
    128 (the CPU tests' d=16 included)."""
    assert trc.supported(tk, 16, heads) == jrc.supported(tk, heads)
    assert trc.supported(tk, 128, heads) == jrc.supported(tk, heads)
    assert not trc.supported(tk, 129, heads)
