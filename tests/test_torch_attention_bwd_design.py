"""The self-attention backward's tile design, held on the CPU through its
arithmetic composed in plain PyTorch.

On the card `fused_attention_bwd` with Tq, Tk <= 64 and d one of 16, 32,
64, 128 (the self-attention models' training steps: Tq = Tk = 50, d =
128) takes the "tile" design of csrc/fused_attention_bwd_tile.cu: one
block a batch row, its operands padded to 64 rows with zeros (k, v and
rawk also past the row's live keys), the score planes S0, TQK and DW as
products, the elementwise middle a warp a query row, the planes turned
into ds0, dpre_tqk and the dropped weights rounded to the input type and
zero past Tq and Tk, then the five gradient products; in time mode a
second launch sums each row's five gate terms over the batch, parts of
`GATE_ROWS` rows each in order, then the parts in order.  chip_smoke.py's
phase 2c holds the kernel against the plain twin there.  Here
`_tile_design_plain`, those steps in plain PyTorch, is held against the
twin `fused_attention_bwd_plain` and against JAX's `_fused_attention_bwd`
(the Pallas `_attn_bwd_kernel` in interpret mode, as
tests/test_torch_kernels.py runs it) on the same numpy inputs: the five
modes, f32 and bf16, Tq = Tk = 17, 50, 64 with d = 16, 128, 64, ragged key
lengths with a row of length 0 and a full row, a drop mask at rate 0.5.
The Pallas kernel pads Tk to 128 and gives a row with no live key its
padded keys too, so the row of length 0 is held against the twin and, in
f32, against jax.vjp of the jnp reference `_reference_middle`, and left
out of the inputs given to the Pallas kernel (whose gate cotangents sum
over every row).

Tolerances, of each output's largest |value|: f32 1e-5 (f32 products and
sums in different orders); bf16 1e-3, as tests/test_torch_kernels.py holds
the twin to the Pallas backward: both sides round the same product
operands to bf16 (g, the dropped weights, ds0, dpre_tqk), but one on a
rounding boundary may round the other way after a differently ordered f32
sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import attention_kernel as jak
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

MODES = ("plain", "time", "tisas", "plain_drop", "tisas_drop")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 1e-3}
# (Tq = Tk, d)
SHAPES = ((17, 16), (50, 128), (64, 64))
NAMES = ("dq", "dk", "dv", "dtqw", "drawk", "dw1", "db1", "dwo1", "dwo2",
         "dbo")
TIME_ONLY = NAMES[3:]
DIFF = (0, 1, 2, 5, 6, 7, 8, 9, 10, 11)   # the differentiable inputs


def _key_len(t, with_empty):
    # a row of length 0 (or 1), a full row, and ragged ones
    return np.array([0 if with_empty else 1, t, 3, t // 2, t - 3], np.int32)


def _inputs(seed, t, d, with_empty=True, b=None):
    """q, k, v, t_q, t_k, tqw, rawk, five [t, t] gate params, key_len (the
    forward's arguments, numpy), the f32 cotangent g and a drop mask."""
    r = np.random.RandomState(seed)
    key_len = _key_len(t, with_empty)
    if b is not None:
        key_len = np.resize(key_len, b)
    b = len(key_len)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    hours = np.sort(r.rand(b, t).astype(np.float32) * 500, axis=1)
    arrays = [np.maximum(f(b, t, d), 0), np.maximum(f(b, t, d), 0),
              np.maximum(f(b, t, d), 0), hours, hours, f(b, t, d, scale=0.3),
              f(b, t, d)]
    arrays += [f(t, t, scale=0.3) for _ in range(5)]
    arrays.append(key_len)
    g = f(b, t, d)
    dm = (r.rand(b, t, t) < 0.5).astype(np.float32) / 0.5
    return arrays, g, dm


def _torch(arrays, dtype):
    return [torch.tensor(a).to(dtype) for a in arrays[:-1]] \
        + [torch.tensor(arrays[-1])]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _model(mode, g, args, dm, **kw):
    tdm = torch.tensor(dm) if mode.endswith("_drop") else None
    return tak._tile_design_plain(mode, torch.tensor(g), *args, tdm, **kw)


def _hold(mode, got, want, rel, what):
    for name, x, w in zip(NAMES, got, want):
        if name in TIME_ONLY and mode != "time":
            assert x is None, (what, name)
            if w is not None:
                assert not np.asarray(w, np.float32).any(), (what, name)
            continue
        assert x.dtype == torch.float32, (what, name)
        assert bool(torch.isfinite(x).all()), (what, name)
        err = _rel(x.numpy(), w)
        assert err <= rel, (what, name, err)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,d,design", [
    (50, 50, 128, "tile"), (64, 64, 16, "tile"), (1, 50, 32, "tile"),
    (17, 17, 64, "tile"), (1, 1024, 128, "rows"), (50, 50, 96, "rows"),
    (50, 50, 256, "rows"), (65, 65, 128, "wide"), (50, 65, 128, "wide"),
    (50, 50, 8, "rows")])
def test_attention_bwd_design_routes(dtype, tq, tk, d, design):
    assert tak.attention_bwd_design(dtype, tq, tk, d) == design
    assert tak.BWD_DESIGNS == ("tile", "wide", "rows")


@pytest.mark.parametrize("tq,tk,d,design,chunk", [
    (1, 1024, 16, "tile", None), (50, 50, 96, "tile", None),
    (50, 50, 128, "mma", None), (50, 50, 128, "simt", None),
    (50, 50, 128, None, 48), (50, 50, 128, None, 0),
    (50, 50, 128, None, 8192)])
def test_forced_design_outside_its_range_refused_before_any_build(
        no_build, tq, tk, d, design, chunk):
    r = np.random.RandomState(0)
    arrays = [r.randn(2, tq, d), r.randn(2, tk, d), r.randn(2, tk, d),
              r.rand(2, tq), r.rand(2, tk), r.randn(2, tq, d),
              r.randn(2, tk, d)] + [r.randn(tq, tk) for _ in range(5)]
    args = [torch.tensor(a, dtype=torch.float32) for a in arrays]
    args.append(torch.tensor([1, tk], dtype=torch.int32))
    g = torch.zeros((2, tq, d))
    with pytest.raises(ValueError, match="does not take|a chunk takes"):
        tak._launch_bwd("time", g, *args, None, _design=design,
                        _chunk_rows=chunk)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_tile_design_matches_twin(t, d, dname, mode):
    """Every row, the one of length 0 included: the model against the
    twin in the same dtype."""
    dtype = DTYPES[dname][0]
    arrays, g, dm = _inputs(seed=t + d + len(mode), t=t, d=d)
    args = _torch(arrays, dtype)
    tdm = torch.tensor(dm) if mode.endswith("_drop") else None
    want = tak.fused_attention_bwd(mode, torch.tensor(g), *args, tdm)
    got = _model(mode, g, args, dm)
    _hold(mode, got, [None if w is None else w.numpy() for w in want],
          REL[dname], "twin")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_tile_design_matches_pallas(t, d, dname, mode):
    """Rows with a live key: the model against JAX's Pallas backward in
    interpret mode, in the same dtype; in f32 at Tq = Tk = 50 also the
    row of length 0, against jax.vjp of the jnp reference."""
    dtype, jdtype = DTYPES[dname]
    drop = mode.endswith("_drop")
    arrays, g, dm = _inputs(seed=2 * t + d + len(mode), t=t, d=d,
                            with_empty=False)
    jargs = [jnp.asarray(a) if i == 12 else jnp.asarray(a, jdtype)
             for i, a in enumerate(arrays)]
    want = jak._fused_attention_bwd(
        mode, jnp.asarray(g), *jargs,
        jnp.asarray(dm) if drop else jak.dm_dummy())
    got = _model(mode, g, _torch(arrays, dtype), dm)
    _hold(mode, got, want, REL[dname], "pallas")
    if dname != "float32" or t != 50:
        return
    arrays, g, dm = _inputs(seed=3 * t + d + len(mode), t=t, d=d)
    jargs = [jnp.asarray(a) for a in arrays]

    def ref(*x):
        full = list(jargs)
        for i, xi in zip(DIFF, x):
            full[i] = xi
        return jak._reference_middle(mode, *full,
                                     dm=jnp.asarray(dm) if drop else None)

    _, vjp = jax.vjp(ref, *[jargs[i] for i in DIFF])
    got = _model(mode, g, _torch(arrays, torch.float32), dm)
    _hold(mode, got, vjp(jnp.asarray(g)), REL[dname], "reference")


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,chunk", [(64, 32), (96, 32), (96, 64)])
def test_gate_sum_order_does_not_depend_on_chunking(dname, b, chunk):
    """The batch in one chunk and split (at B = 64 in two), as the launch
    splits a batch whose gate terms pass its workspace: the same bits;
    the per-row outputs too."""
    dtype = DTYPES[dname][0]
    arrays, g, dm = _inputs(seed=b + chunk, t=17, d=16, b=b)
    args = _torch(arrays, dtype)
    whole = _model("time", g, args, dm)
    split = _model("time", g, args, dm, chunk_rows=chunk)
    assert tak.gate_chunk_rows(b, 17, 17) == b
    for name, x, y in zip(NAMES, whole, split):
        assert torch.equal(x, y), name
    # and the order is the parts': one sequential sum over the batch
    # differs from it in some bits
    terms = torch.tensor(np.random.RandomState(b).randn(b, 17, 17),
                         dtype=torch.float32)
    seq = torch.zeros((17, 17))
    for row in terms:
        seq = seq + row
    parts = tak._gate_sum(terms, b)
    assert torch.equal(parts, tak._gate_sum(terms, chunk))
    assert not torch.equal(parts, seq)
    np.testing.assert_allclose(parts.numpy(), seq.numpy(), atol=1e-5)


def test_gate_chunk_rows_at_its_edges():
    # the default chunk: whole parts within the workspace cap, at most
    # GATE_MAX_ROWS rows, never more than the batch
    assert tak.gate_chunk_rows(256, 50, 50) == 256
    assert tak.gate_chunk_rows(10_000, 50, 50) == 2656
    assert tak.gate_chunk_rows(10_000, 64, 64) == 1632
    assert tak.gate_chunk_rows(10_000, 1, 1) == tak.GATE_MAX_ROWS
    assert tak.gate_chunk_rows(0, 50, 50) == 0
    assert tak.gate_chunk_rows(100, 50, 50, 32) == 32
    assert tak.gate_chunk_rows(10, 50, 50, 32) == 10
    for bad in (0, 16, 33, tak.GATE_MAX_ROWS + 32):
        with pytest.raises(ValueError, match="a chunk takes"):
            tak.gate_chunk_rows(100, 50, 50, bad)
