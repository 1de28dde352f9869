"""MTAM's serving hops' attention forward, the hop design, held on the CPU
through its arithmetic composed in plain PyTorch.

On the card `fused_attention` with one query row (Tq = 1), 1 <= Tk <= 64
keys and d a multiple of 16 up to 128 (MTAM's readout hops at L=50, d=128
and the narrow d=16) takes the "hop" design of
csrc/fused_attention_hop.cu: one block a batch row, the row's k and rawk
rows of the live keys and v rows of the reached keys staged in shared
memory, the score dots by a half-warp a key (8 columns a lane, the 16
lanes summed in a butterfly), the gate and the softmax in one warp, the
weights rounded to the input type, then out = sum_c w_c v_c by 16 key
slices in order.  chip_smoke.py's phase 2 holds the kernel against the
plain twin there and against the earlier "query" design forced, and its
phase 3 counts the hops of MTAM's scoring call.  Here
`_hop_fwd_design_plain`, those steps in plain PyTorch, is held against
the twin `fused_attention_plain` and against JAX's `_fused_attention_fwd`
(the Pallas `_attn_kernel` in interpret mode, as
tests/test_torch_attention_fwd_design.py runs it) on the same numpy
inputs: the five modes, f32 and bf16, Tk = 1, 17, 50, 64 with d = 16, 16,
128, 64, ragged key lengths with a row of length 0 and a full row, a drop
mask at rate 0.5.  The Pallas kernel pads Tk to 128 and gives a row with
no live key its padded keys too, so the row of length 0 is held against
the twin and, in f32, against the jnp reference `_reference_middle`, and
left out of the inputs given to the Pallas kernel.  The routes, the
forced and misaligned launches and the launch's choice of library are
held without any build.

Tolerances, of the largest |out|: f32 1e-5 (f32 products and sums in
different orders); bf16 1e-3: both sides round the same weights to bf16,
but a weight on a rounding boundary may round the other way after a
differently ordered f32 sum.
"""

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
# (Tk, d) at Tq = 1
SHAPES = ((1, 16), (17, 16), (50, 128), (64, 64))
ARGS = ("q", "k", "v", "t_q", "t_k", "tqw", "rawk")


def _key_len(t, with_empty):
    # a row of length 0 (or 1), a full row, and ragged ones, all within Tk
    lens = np.clip([1, t, 3, t // 2, t - 3], 1, t).astype(np.int32)
    if with_empty:
        lens[0] = 0
    return lens


def _inputs(seed, t, d, with_empty=True):
    """q, k, v, t_q, t_k, tqw, rawk, five [1, t] gate params, key_len (the
    forward's arguments at Tq = 1, numpy) and a [B, 1, t] drop mask."""
    r = np.random.RandomState(seed)
    key_len = _key_len(t, with_empty)
    b = len(key_len)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    hours = np.sort(r.rand(b, t).astype(np.float32) * 500, axis=1)
    # a readout query an hour after its last key
    t_q = hours.max(axis=1, keepdims=True) + 1.0
    arrays = [np.maximum(f(b, 1, d), 0), np.maximum(f(b, t, d), 0),
              np.maximum(f(b, t, d), 0), t_q, hours, f(b, 1, d, scale=0.3),
              f(b, t, d)]
    arrays += [f(1, t, scale=0.3) for _ in range(5)]
    arrays.append(key_len)
    dm = (r.rand(b, 1, t) < 0.5).astype(np.float32) / 0.5
    return arrays, dm


def _torch(arrays, dtype):
    return [torch.tensor(a).to(dtype) for a in arrays[:-1]] \
        + [torch.tensor(arrays[-1])]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _model(mode, args, dm):
    tdm = torch.tensor(dm) if mode.endswith("_drop") else None
    return tak._hop_fwd_design_plain(mode, *args, tdm)


def _hold(got, want, rel, what):
    assert got.dtype == torch.float32, what
    assert bool(torch.isfinite(got).all()), what
    err = _rel(got.numpy(), want)
    assert err <= rel, (what, err)


def _operands(tq, tk, d, dtype=torch.float32, b=2):
    """The forward's operands on the CPU (zeros: no kernel reads them)."""
    shapes = [(b, tq, d), (b, tk, d), (b, tk, d), (b, tq), (b, tk),
              (b, tq, d), (b, tk, d)] + [(tq, tk)] * 5
    return [torch.zeros(s, dtype=dtype) for s in shapes] \
        + [torch.tensor([1, tk] + [tk] * (b - 2), dtype=torch.int32)]


def _shifted(x):
    """x's shape and type, 4 bytes past a 16-byte boundary."""
    return torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tk", [1, 17, 50, 64])
@pytest.mark.parametrize("d", [16, 48, 64, 128])
def test_hop_takes_one_query_up_to_64_keys(no_build, dtype, tk, d):
    assert tak.attention_fwd_design(dtype, 1, tk, d) == "hop"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tk,d,design", [
    (65, 128, "blocked"), (1024, 128, "blocked"), (50, 8, "query"),
    (50, 40, "query"), (50, 144, "query"), (50, 256, "query")])
def test_query_design_keeps_the_other_single_queries(no_build, dtype, tk,
                                                     d, design):
    """Past 64 keys one query takes the blocked design at the hop
    design's widths; the query design keeps the other widths."""
    assert tak.attention_fwd_design(dtype, 1, tk, d) == design


@pytest.mark.parametrize("tq,tk,d", [(1, 65, 128), (1, 50, 8), (1, 50, 40),
                                     (2, 50, 128), (50, 50, 128)])
def test_forced_hop_outside_its_range_refused_before_any_build(
        no_build, tq, tk, d):
    with pytest.raises(ValueError, match="does not take"):
        tak._launch("time", *_operands(tq, tk, d), None, _design="hop")


@pytest.mark.parametrize("mode,operand", [
    ("time", "k"), ("time", "v"), ("time", "rawk"), ("plain", "k"),
    ("tisas", "v")])
def test_hop_misaligned_copy_operand_refused_before_any_build(
        no_build, mode, operand):
    args = _operands(1, 50, 128)
    i = ARGS.index(operand)
    args[i] = _shifted(args[i])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tak._launch(mode, *args, None)


class _FakeLib:
    """Stands in for the built libraries: records the launch function each
    launch calls and reports success."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)
        return lambda *_a: self.called.append(name) or 0


@pytest.mark.parametrize("mode,tq,tk,d,forced,misaligned,design", [
    ("time", 1, 50, 128, None, None, "hop"),
    ("time", 1, 50, 16, None, None, "hop"),
    ("tisas_drop", 1, 1, 64, None, None, "hop"),
    ("time", 1, 50, 128, "query", None, "query"),
    ("time", 1, 1024, 128, None, None, "blocked"),
    ("time", 1, 50, 40, None, None, "query"),
    ("plain", 1, 50, 128, None, "q", "hop"),
    ("plain", 1, 50, 128, None, "rawk", "hop"),
    ("time", 50, 50, 128, None, None, "tile")])
def test_launch_takes_the_design_it_should(monkeypatch, mode, tq, tk, d,
                                           forced, misaligned, design):
    """The launch calls the library of the design `attention_fwd_design`
    picks, or the query design forced; the hop design's copies read k and
    v (and rawk in time mode) only, so q and an unread rawk may sit
    anywhere; `launches` counts every launch, `fwd_hop_launches`,
    `fwd_blocked_launches` and `fwd_query_launches` their designs'."""
    lib = _FakeLib()
    for attr in ("_library", "_tile_library", "_hop_library",
                 "_blocked_library"):
        monkeypatch.setattr(tak, attr, lambda: lib)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    args = _operands(tq, tk, d)
    if misaligned:
        i = ARGS.index(misaligned)
        args[i] = _shifted(args[i])
    dm = torch.zeros(2, tq, tk) if mode.endswith("_drop") else None
    before = (tak.launches[mode], tak.fwd_hop_launches[mode],
              tak.fwd_query_launches[mode], tak.fwd_blocked_launches[mode])
    out = tak._launch(mode, *args, dm, _design=forced)
    suffix = {"tile": "_tile", "hop": "_hop", "blocked": "_blocked",
              "query": ""}[design]
    assert lib.called == [f"fused_attention{suffix}_launch"]
    assert tak.launches[mode] == before[0] + 1
    assert tak.fwd_hop_launches[mode] == before[1] + int(design == "hop")
    assert tak.fwd_query_launches[mode] == before[2] + int(design == "query")
    assert tak.fwd_blocked_launches[mode] == \
        before[3] + int(design == "blocked")
    assert tuple(out.shape) == (2, tq, d) and out.dtype == torch.float32


@pytest.mark.parametrize("tq,tk,d", [(2, 50, 128), (1, 65, 128),
                                     (1, 50, 40)])
def test_hop_model_refuses_other_shapes(tq, tk, d):
    with pytest.raises(ValueError, match="does not take"):
        tak._hop_fwd_design_plain("plain", *_operands(tq, tk, d))


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_hop_fwd_design_matches_twin(t, d, dname, mode):
    """Every row, the one of length 0 included: the model against the
    twin in the same dtype."""
    dtype = DTYPES[dname][0]
    arrays, dm = _inputs(seed=t + d + len(mode), t=t, d=d)
    args = _torch(arrays, dtype)
    tdm = torch.tensor(dm) if mode.endswith("_drop") else None
    want = tak.fused_attention(mode, *args, tdm)
    _hold(_model(mode, args, dm), want.numpy(), REL[dname], "twin")
    # the row of length 0 weighs its Tk keys alike, dropped or not
    want0 = args[2][0].float().mean(0)
    if tdm is not None:
        want0 = (tdm[0][:, :, None] * args[2][0].float()[None]).mean(1)[0]
    np.testing.assert_allclose(want[0, 0].numpy(), want0.numpy(), rtol=0,
                               atol=REL[dname] * 10)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_hop_fwd_design_matches_pallas(t, d, dname, mode):
    """Rows with a live key: the model against JAX's Pallas forward in
    interpret mode, in the same dtype; in f32 at Tk = 50 also a batch
    with the row of length 0, against the jnp reference."""
    dtype, jdtype = DTYPES[dname]
    drop = mode.endswith("_drop")
    arrays, dm = _inputs(seed=2 * t + d + len(mode), t=t, d=d,
                         with_empty=False)
    jargs = [jnp.asarray(a) if i == 12 else jnp.asarray(a, jdtype)
             for i, a in enumerate(arrays)]
    want = jak._fused_attention_fwd(
        mode, *jargs, jnp.asarray(dm) if drop else jak.dm_dummy())
    _hold(_model(mode, _torch(arrays, dtype), dm), want, REL[dname],
          "pallas")
    if dname != "float32" or t != 50:
        return
    arrays, dm = _inputs(seed=3 * t + d + len(mode), t=t, d=d)
    want = jak._reference_middle(mode, *[jnp.asarray(a) for a in arrays],
                                 dm=jnp.asarray(dm) if drop else None)
    _hold(_model(mode, _torch(arrays, torch.float32), dm), want,
          REL[dname], "reference")
