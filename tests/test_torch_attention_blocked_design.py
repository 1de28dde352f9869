"""The attention forward at one query row past 64 keys, the blocked
design, held on the CPU through its arithmetic composed in plain PyTorch.

On the card `fused_attention` with one query row (Tq = 1), 65 <= Tk <=
1024 keys and d a multiple of 16 up to 128 (MTAM's serving hops at the
reference's L=150, the plain-kind readout's hops up to 1024 keys) takes
the "blocked" design of csrc/fused_attention_blocked.cu: one block a
batch row, the live keys' k (and rawk) rows and the reached keys' v rows
streamed in 64-key blocks through a ring of shared-memory slots by bulk
copies, the score dots a half-warp a key into an f32 strip of all Tk
keys, the softmax over the strip (each warp its max and sum), the
weights rounded to the input type, then out = sum_c w_c v_c by 16 key
slices in key order across the blocks.  chip_smoke.py's phase 2 holds
the kernel against the plain twin there and against the earlier "query"
design forced, and its phase 14 counts the hops of MTAM's and
MTAM_no_time_aware_att's scoring calls at L=150.  Here
`_blocked_fwd_design_plain`, those steps in plain PyTorch, is held
against the twin `fused_attention_plain` and against JAX's
`_fused_attention_fwd` (the Pallas `_attn_kernel` in interpret mode, as
tests/test_torch_attention_hop_design.py runs it) on the same numpy
inputs: the five modes, f32 and bf16, Tk = 65, 150, 257, 1024 with d =
16 and 128, ragged key lengths with a row of length 0 and a full row, a
drop mask at rate 0.5.  The Pallas kernel pads Tk to a multiple of 128
and gives a row with no live key its padded keys too, so the row of
length 0 is held against the twin and, in f32, against the jnp reference
`_reference_middle`, and left out of the inputs given to the Pallas
kernel.  The routes, the forced and misaligned launches and the launch's
choice of library are held without any build; the two serving paths at
L=150 (MTAM's time hops, MTAM_no_time_aware_att's plain ones) run with
the model in the twin's place and against JAX's scores.

Tolerances, of the largest |out|: f32 1e-5 (f32 products and sums in
different orders); bf16 2e-3: both sides round the same weights to bf16,
but a weight on a rounding boundary may round the other way after a
differently ordered f32 sum.  Scores: 1e-5 of the largest |score|
(tests/torch_zoo_parity.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo_parity as zp
from helpers import make_batch
from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops.pallas import attention_kernel as jak
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

MODES = ("plain", "time", "tisas", "plain_drop", "tisas_drop")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 2e-3}
# (Tk, d) at Tq = 1: each length at both widths against the twin; against
# the Pallas kernel each length at one width (its interpret mode's time)
TWIN_SHAPES = tuple((t, d) for t in (65, 150, 257, 1024) for d in (16, 128))
PALLAS_SHAPES = ((65, 16), (150, 128), (257, 16), (1024, 128))
ARGS = ("q", "k", "v", "t_q", "t_k", "tqw", "rawk")


def _key_len(t, with_empty):
    # a row of length 0 (or 1), a full row, one ending one key into a
    # block, one at a block's end, and ragged ones, all within Tk
    lens = np.clip([1, t, 65, 64, t // 2, t - 3], 1, t).astype(np.int32)
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
    return tak._blocked_fwd_design_plain(mode, *args, tdm)


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
@pytest.mark.parametrize("tq,tk,d,design", [
    (1, 64, 128, "hop"), (1, 65, 128, "blocked"), (1, 65, 16, "blocked"),
    (1, 150, 128, "blocked"), (1, 150, 16, "blocked"),
    (1, 255, 48, "blocked"), (1, 256, 64, "blocked"),
    (1, 257, 112, "blocked"), (1, 1024, 128, "blocked"),
    (1, 1024, 16, "blocked"), (1, 1025, 128, "query"), (1, 150, 8, "query"),
    (1, 150, 40, "query"), (1, 150, 144, "query"), (1, 1024, 256, "query"),
    (2, 150, 128, "wide"), (65, 150, 128, "wide")])
def test_blocked_design_takes_one_query_past_64_keys(no_build, dtype, tq, tk,
                                                     d, design):
    """"blocked" at Tq = 1, 64 < Tk <= 1024, d a multiple of 16 up to
    128; the hop design below, the query design at other widths, the
    wide design at two queries or more; past 1024 keys the forward takes
    the blockwise route before any single-tile design."""
    assert tak.attention_fwd_design(dtype, tq, tk, d) == design
    assert tak.route(tk, False) == ("blockwise" if tk > 1024
                                    else "single_tile")
    assert tak.FWD_DESIGNS.index("blocked") == 2


@pytest.mark.parametrize("tq,tk,d,design", [
    (1, 64, 128, "blocked"), (1, 1025, 128, "blocked"),
    (1, 150, 40, "blocked"), (1, 150, 8, "blocked"), (1, 150, 144, "blocked"),
    (2, 150, 128, "blocked"), (1, 150, 128, "hop"), (1, 150, 128, "wide"),
    (1, 150, 128, "tile")])
def test_forced_design_outside_its_range_refused_before_any_build(
        no_build, tq, tk, d, design):
    with pytest.raises(ValueError, match="does not take"):
        tak._launch("time", *_operands(tq, tk, d), None, _design=design)


@pytest.mark.parametrize("mode,operand", [
    ("time", "k"), ("time", "v"), ("time", "rawk"), ("plain", "k"),
    ("tisas", "v"), ("plain_drop", "v"), ("tisas_drop", "k")])
def test_blocked_misaligned_copy_operand_refused_before_any_build(
        no_build, mode, operand):
    args = _operands(1, 150, 128)
    i = ARGS.index(operand)
    args[i] = _shifted(args[i])
    dm = torch.zeros(2, 1, 150) if mode.endswith("_drop") else None
    with pytest.raises(ValueError, match="16-byte aligned"):
        tak._launch(mode, *args, dm)


@pytest.mark.parametrize("mode", MODES)
def test_cpu_tensors_take_the_twin(no_build, mode):
    """On the CPU the wrapper runs the twin at the blocked design's
    shapes: no build."""
    arrays, dm = _inputs(seed=7, t=150, d=16)
    args = _torch(arrays, torch.float32)
    tdm = torch.tensor(dm) if mode.endswith("_drop") else None
    got = tak.fused_attention(mode, *args, tdm)
    torch.testing.assert_close(
        got, tak.fused_attention_plain(mode, *args, tdm), rtol=0, atol=0)


class _FakeLib:
    """Stands in for the built libraries: records the launch function each
    launch calls and reports success."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)
        return lambda *_a: self.called.append(name) or 0


@pytest.mark.parametrize("mode,tk,d,forced,misaligned,design", [
    ("time", 150, 128, None, None, "blocked"),
    ("plain", 150, 128, None, None, "blocked"),
    ("plain", 1024, 16, None, None, "blocked"),
    ("tisas_drop", 65, 64, None, None, "blocked"),
    ("plain_drop", 257, 32, None, None, "blocked"),
    ("time", 150, 128, "query", None, "query"),
    ("plain", 1024, 128, "query", None, "query"),
    ("plain", 150, 128, None, "q", "blocked"),
    ("plain", 150, 128, None, "rawk", "blocked"),
    ("time", 150, 128, None, "tqw", "blocked"),
    ("time", 64, 128, None, None, "hop"),
    ("time", 150, 40, None, None, "query")])
def test_launch_takes_the_design_it_should(monkeypatch, mode, tk, d, forced,
                                           misaligned, design):
    """The launch calls the library of the design `attention_fwd_design`
    picks, or the query design forced; the blocked design's copies read k
    and v (and rawk in time mode) only, so q, tqw and an unread rawk may
    sit anywhere; `launches` counts every launch, `fwd_blocked_launches`,
    `fwd_hop_launches` and `fwd_query_launches` their designs'."""
    lib = _FakeLib()
    for attr in ("_library", "_tile_library", "_hop_library",
                 "_blocked_library", "_wide_library"):
        monkeypatch.setattr(tak, attr, lambda: lib)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    args = _operands(1, tk, d)
    if misaligned:
        i = ARGS.index(misaligned)
        args[i] = _shifted(args[i])
    dm = torch.zeros(2, 1, tk) if mode.endswith("_drop") else None
    counters = (tak.launches, tak.fwd_blocked_launches, tak.fwd_hop_launches,
                tak.fwd_query_launches)
    before = [c[mode] for c in counters]
    out = tak._launch(mode, *args, dm, _design=forced)
    suffix = {"blocked": "_blocked", "hop": "_hop", "query": ""}[design]
    assert lib.called == [f"fused_attention{suffix}_launch"]
    assert [c[mode] - n for c, n in zip(counters, before)] == [
        1, int(design == "blocked"), int(design == "hop"),
        int(design == "query")]
    assert tuple(out.shape) == (2, 1, d) and out.dtype == torch.float32


@pytest.mark.parametrize("tq,tk,d", [(1, 64, 128), (2, 150, 128),
                                     (1, 150, 40), (1, 1025, 128)])
def test_blocked_model_refuses_other_shapes(tq, tk, d):
    with pytest.raises(ValueError, match="does not take"):
        tak._blocked_fwd_design_plain("plain", *_operands(tq, tk, d))


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", TWIN_SHAPES)
def test_blocked_fwd_design_matches_twin(t, d, dname, mode):
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
@pytest.mark.parametrize("t,d", PALLAS_SHAPES)
def test_blocked_fwd_design_matches_pallas(t, d, dname, mode):
    """Rows with a live key: the model against JAX's Pallas forward in
    interpret mode, in the same dtype; in f32 at Tk = 150 also a batch
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
    if dname != "float32" or t != 150:
        return
    arrays, dm = _inputs(seed=3 * t + d + len(mode), t=t, d=d)
    want = jak._reference_middle(mode, *[jnp.asarray(a) for a in arrays],
                                 dm=jnp.asarray(dm) if drop else None)
    _hold(_model(mode, _torch(arrays, torch.float32), dm), want,
          REL[dname], "reference")


# ------------------------------------------------- serving at L=150

L150, D_SERVE, HOPS_SERVE = 150, 16, 3
# an empty history (one event), a full row, rows ending inside, at and
# one past a 64-key block, ragged ones
SERVE_SEQ_LENS = [1, 2, L150, 65, 66, L150, 3, 129]


def _serve_cfg(name, use_pallas):
    return zp.ExperimentConfig().with_overrides(**{
        "model.experiment_type": name, "model.num_units": D_SERVE,
        "model.num_blocks": HOPS_SERVE, "model.dropout": 0.0,
        "data.max_seq_len": L150, "model.vocab_pad_multiple": 16,
        "model.use_pallas": use_pallas})


def _serve_meta():
    return (jtypes.DatasetMeta(20, 60, 5, L150),
            ttypes.DatasetMeta(20, 60, 5, L150))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("name,mode", [("MTAM", "time"),
                                       ("MTAM_no_time_aware_att", "plain")])
def test_serving_at_l150_matches_jax(monkeypatch, name, mode, use_pallas):
    """The scoring call at L=150, d=16, 3 hops on the CPU with the blocked
    model in the twin's place: every hop one Tq = 1, Tk = 150 forward in
    the model's mode, and the scores within 1e-5 of JAX's (its jnp route
    and its Pallas kernel in interpret mode) at the largest |score|."""
    calls = []

    def blocked(m, *args):
        calls.append((m, tuple(args[0].shape), tuple(args[1].shape)))
        return tak._blocked_fwd_design_plain(m, *args)
    monkeypatch.setattr(tak, "fused_attention_plain", blocked)
    jmeta, tmeta = _serve_meta()
    jb = make_batch(jmeta, batch_size=len(SERVE_SEQ_LENS), seed=150,
                    seq_lens=SERVE_SEQ_LENS)
    # hours since the epoch, as served requests carry them
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0)
    cfg = _serve_cfg(name, use_pallas)
    params = jax.device_get(jget_model(name).init(jax.random.PRNGKey(0),
                                                  cfg.model, jmeta))
    want = np.asarray(jbase.scores_for_eval(jget_model(name), params,
                                            cfg.model, jb, jmeta.item_vocab))
    model = load_jax_params(get_model(name).init(
        torch.Generator().manual_seed(0), cfg.model, tmeta), params)
    with torch.no_grad():
        got = tbase.scores_for_eval(get_model(name), model, cfg.model,
                                    zp.to_torch_batch(jb),
                                    tmeta.item_vocab).numpy()
    b = len(SERVE_SEQ_LENS)
    assert calls == [(mode, (b, 1, D_SERVE), (b, L150, D_SERVE))] \
        * HOPS_SERVE
    vocab = tmeta.item_vocab
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, vocab:], want[:, vocab:])
    scale = np.abs(want[:, :vocab]).max()
    assert np.abs(got[:, :vocab] - want[:, :vocab]).max() \
        <= zp.REL_SCORES_F32 * scale
