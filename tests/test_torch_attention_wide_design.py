"""The single-tile attention pair's "wide" design (64 < Tk <= 1024 keys,
or more than 64 queries), held on the CPU through its arithmetic composed
in plain PyTorch.

On the card `fused_attention` and `fused_attention_bwd` with 2 <= Tq <=
1024, Tk <= 1024, Tq or Tk past 64 and d one of 16, 32, 64, 128 (the
self-attention models' blocks at 64 < L <= 1024) take the wide design of
csrc/fused_attention_wide.cu and csrc/fused_attention_bwd_wide.cu: a
block 16 query rows of a batch row, their f32 score strip in shared
memory, the keys streamed through it in blocks; the backward's query pass
writes the rounded ds0, weights and dpre_tqk planes, and its key pass sums
dk, dv and drawk over them in query order.  chip_smoke.py's phase 2c holds
the kernels against their twins there.  Here the design-shaped twins,
`_wide_fwd_design_plain` and `_wide_design_plain`, are held against the
plain twins `fused_attention_plain` / `fused_attention_bwd_plain` and
against JAX's `_fused_attention_fwd` / `_fused_attention_bwd` (the Pallas
`_attn_kernel` and `_attn_bwd_kernel` in interpret mode, as
tests/test_torch_attention_bwd_design.py runs them) on the same numpy
inputs: the five modes, f32 and bf16, Tq = Tk = 65, 130, 200 at d = 16
and 32 (against the Pallas kernels each mode and dtype at one of the
three, in turn), ragged key lengths with a row of length 0 and a full
row, a drop mask at rate 0.5.  The Pallas kernels pad Tk to 128 and
give a row with no live key its padded keys too, so the row of length 0
is held against
the plain twins (and the forward's against the mean of its v rows), and
left out of the inputs given to the Pallas kernels.  Then one loss and
every gradient of Time_Aware_SA, SASrec (JAX's dropout masks injected)
and TiSAS at L=96, one block, d=32 against the JAX package.

Tolerances, of each output's largest |value|: f32 1e-5 (f32 products and
sums in different orders); bf16 1e-3, as the tile design's tests hold
its twins: both sides round the same product operands to bf16, but one
on a rounding boundary may round the other way after a differently
ordered f32 sum.  The models as tests/test_torch_attention_models.py
holds them: f32 loss terms to 1e-5 and every gradient leaf to 1e-5 of
its largest |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.config import ExperimentConfig
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu.ops.pallas import attention_kernel as jak
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import build

from helpers import make_batch

torch.set_num_threads(2)

MODES = ("plain", "time", "tisas", "plain_drop", "tisas_drop")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 1e-3}
SHAPES = ((65, 16), (130, 32), (200, 16))          # (Tq = Tk, d)
NAMES = ("dq", "dk", "dv", "dtqw", "drawk", "dw1", "db1", "dwo1", "dwo2",
         "dbo")
TIME_ONLY = NAMES[3:]
ARGS = ("q", "k", "v", "t_q", "t_k", "tqw", "rawk")


def _inputs(seed, t, d, with_empty=True, b=5):
    """q, k, v, t_q, t_k, tqw, rawk, five [t, t] gate params, key_len (the
    forward's arguments, numpy), the f32 cotangent g and a drop mask at
    rate 0.5, for ``b`` batch rows.  Key lengths: a row of length 0 (or
    1), a full row, and ragged ones, one inside the first 32-key block,
    in turn."""
    r = np.random.RandomState(seed)
    key_len = np.resize(np.array([0 if with_empty else 1, t, 3, t // 2,
                                  t - 3], np.int32), b)
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


def _jax(arrays, jdtype):
    return [jnp.asarray(a) if i == 12 else jnp.asarray(a, jdtype)
            for i, a in enumerate(arrays)]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _mask(mode, dm):
    return torch.tensor(dm) if mode.endswith("_drop") else None


def _hold_bwd(mode, got, want, rel, what):
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


def _operands(tq, tk, d, b=2):
    """The forward's operands on the CPU (zeros: no kernel reads them)."""
    shapes = [(b, tq, d), (b, tk, d), (b, tk, d), (b, tq), (b, tk),
              (b, tq, d), (b, tk, d)] + [(tq, tk)] * 5
    return [torch.zeros(s) for s in shapes] \
        + [torch.tensor([1, tk] + [tk] * (b - 2), dtype=torch.int32)]


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,d,fwd,bwd", [
    (64, 64, 128, "tile", "tile"), (65, 65, 128, "wide", "wide"),
    (64, 65, 128, "wide", "wide"), (65, 64, 128, "wide", "wide"),
    (2, 65, 16, "wide", "wide"), (65, 1, 32, "wide", "wide"),
    (256, 256, 64, "wide", "wide"), (1024, 1024, 128, "wide", "wide"),
    (1025, 1025, 128, "query", "rows"), (2, 1025, 128, "query", "rows"),
    (1025, 64, 128, "query", "rows"), (65, 65, 48, "query", "rows"),
    (65, 65, 256, "query", "rows"), (65, 65, 8, "query", "rows"),
    (1, 65, 128, "blocked", "rows"), (1, 1024, 128, "blocked", "rows"),
    (1, 64, 128, "hop", "tile")])
def test_wide_design_routes_by_shape(no_build, dtype, tq, tk, d, fwd, bwd):
    assert tak.attention_fwd_design(dtype, tq, tk, d) == fwd
    assert tak.attention_bwd_design(dtype, tq, tk, d) == bwd
    assert "wide" in tak.FWD_DESIGNS and "wide" in tak.BWD_DESIGNS


@pytest.mark.parametrize("tq,tk,d,design", [
    (50, 50, 128, "wide"), (1, 65, 128, "wide"), (65, 65, 48, "wide"),
    (1, 50, 128, "wide"), (65, 65, 128, "tile"), (65, 65, 128, "hop"),
    (65, 65, 128, "rows")])
def test_forced_fwd_design_outside_its_range_refused_before_any_build(
        no_build, tq, tk, d, design):
    with pytest.raises(ValueError, match="does not take"):
        tak._launch("time", *_operands(tq, tk, d), None, _design=design)


@pytest.mark.parametrize("mode,tq,tk,d,design,chunk", [
    ("time", 50, 50, 128, "wide", None), ("time", 1, 65, 128, "wide", None),
    ("plain", 65, 65, 48, "wide", None), ("time", 65, 65, 128, "tile", None),
    ("plain", 65, 65, 128, "query", None), ("time", 65, 65, 128, None, 48),
    ("time", 65, 65, 128, None, 0), ("plain", 65, 65, 128, None, 0),
    ("plain", 65, 65, 128, None, -3)])
def test_forced_bwd_design_outside_its_range_refused_before_any_build(
        no_build, mode, tq, tk, d, design, chunk):
    args = _operands(tq, tk, d)
    with pytest.raises(ValueError, match="does not take|a chunk takes"):
        tak._launch_bwd(mode, torch.zeros((2, tq, d)), *args, None,
                        _design=design, _chunk_rows=chunk)


@pytest.mark.parametrize("operand", ["q", "k", "v", "tqw", "rawk"])
def test_wide_misaligned_copy_operand_refused_before_any_build(
        no_build, operand):
    args = _operands(65, 65, 128)
    i = ARGS.index(operand)
    x = args[i]
    args[i] = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tak._launch("time", *args, None)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tak._launch_bwd("time", torch.zeros((2, 65, 128)), *args, None)


class _FakeLib:
    """Stands in for the built libraries: records each launch function
    called and the batch rows of the chunk it was given, and reports
    success."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launch(*a):
            self.called.append((name, a[-3] if "bwd_wide" in name else None))
            return 0
        return launch


@pytest.mark.parametrize("mode,forced,design", [
    ("time", None, "wide"), ("plain_drop", None, "wide"),
    ("tisas", "query", "query")])
def test_fwd_launch_takes_the_design_it_should(monkeypatch, mode, forced,
                                               design):
    """The launch calls the library of the design picked, or the query
    design forced; `launches` counts every launch, `fwd_wide_launches`
    and `fwd_query_launches` their designs'."""
    lib = _FakeLib()
    for attr in ("_library", "_tile_library", "_hop_library",
                 "_wide_library"):
        monkeypatch.setattr(tak, attr, lambda: lib)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    args = _operands(130, 130, 32)
    dm = torch.zeros(2, 130, 130) if mode.endswith("_drop") else None
    before = (tak.launches[mode], tak.fwd_wide_launches[mode],
              tak.fwd_query_launches[mode])
    out = tak._launch(mode, *args, dm, _design=forced)
    suffix = {"wide": "_wide", "query": ""}[design]
    assert lib.called == [(f"fused_attention{suffix}_launch", None)]
    assert tak.launches[mode] == before[0] + 1
    assert tak.fwd_wide_launches[mode] == before[1] + int(design == "wide")
    assert tak.fwd_query_launches[mode] == before[2] + int(design == "query")
    assert tuple(out.shape) == (2, 130, 32) and out.dtype == torch.float32


@pytest.mark.parametrize("mode,chunk,rows", [
    ("time", None, 2), ("plain", None, 2), ("tisas_drop", 1, 1),
    ("time", 32, 2)])
def test_bwd_launch_takes_the_wide_design(monkeypatch, mode, chunk, rows):
    """The backward launch calls the wide library with the chunk's rows
    (`wide_chunk_rows`) and counts `bwd_launches` and `bwd_wide_launches`;
    outside time mode dtqw, drawk and the gate gradients are None."""
    lib = _FakeLib()
    monkeypatch.setattr(tak, "_bwd_wide_library", lambda: lib)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    args = _operands(65, 200, 32)
    dm = torch.zeros(2, 65, 200) if mode.endswith("_drop") else None
    before = (tak.bwd_launches[mode], tak.bwd_wide_launches[mode])
    grads = tak._launch_bwd(mode, torch.zeros((2, 65, 32)), *args, dm,
                            _chunk_rows=chunk)
    assert lib.called == [("fused_attention_bwd_wide_launch", rows)]
    assert tak.bwd_launches[mode] == before[0] + 1
    assert tak.bwd_wide_launches[mode] == before[1] + 1
    shapes = [(2, 65, 32), (2, 200, 32), (2, 200, 32), (2, 65, 32),
              (2, 200, 32)] + [(65, 200)] * 5
    for name, x, shape in zip(NAMES, grads, shapes):
        if mode != "time" and name in TIME_ONLY:
            assert x is None, name
        else:
            assert tuple(x.shape) == shape and x.dtype == torch.float32, name


def test_wide_chunk_rows_at_its_edges():
    # time mode: whole GATE_ROWS-row parts within the cap (5 gate terms and
    # 3 planes a row), at least one part, never more than the batch
    assert tak.wide_chunk_rows(64, 256, 256, True) == 64
    assert tak.wide_chunk_rows(10_000, 256, 256, True) == 64
    assert tak.wide_chunk_rows(10_000, 1024, 1024, True) == tak.GATE_ROWS
    assert tak.wide_chunk_rows(10, 1024, 1024, True) == 10
    assert tak.wide_chunk_rows(100, 65, 65, True, 32) == 32
    # other modes: two planes a row, Tk padded to 32, at least one row
    assert tak.wide_chunk_rows(10_000, 1024, 1024, False) == 16
    assert tak.wide_chunk_rows(10_000, 65, 65, False) == (
        tak.GATE_WORKSPACE_CAP // (2 * 65 * 96))
    assert tak.wide_chunk_rows(100, 65, 65, False, 7) == 7
    assert tak.wide_chunk_rows(0, 65, 65, False) == 0
    for time_mode, bad in ((True, 48), (True, 0), (False, 0)):
        with pytest.raises(ValueError, match="a chunk takes"):
            tak.wide_chunk_rows(100, 65, 65, time_mode, bad)


@pytest.mark.parametrize("tq,tk,d", [(50, 50, 128), (1, 65, 128),
                                     (65, 65, 48)])
def test_wide_models_refuse_other_shapes(tq, tk, d):
    args = _operands(tq, tk, d)
    with pytest.raises(ValueError, match="does not take"):
        tak._wide_fwd_design_plain("plain", *args)
    with pytest.raises(ValueError, match="does not take"):
        tak._wide_design_plain("plain", torch.zeros((2, tq, d)), *args)


# ------------------------------------------------------------ the models

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_wide_fwd_design_matches_twin(t, d, dname, mode):
    """Every row, the one of length 0 included: the model against the
    twin in the same dtype; the row of length 0 weighs its Tk keys
    alike, dropped or not."""
    dtype = DTYPES[dname][0]
    arrays, _, dm = _inputs(seed=t + d + len(mode), t=t, d=d)
    args = _torch(arrays, dtype)
    tdm = _mask(mode, dm)
    want = tak.fused_attention(mode, *args, tdm)
    got = tak._wide_fwd_design_plain(mode, *args, tdm)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want.numpy()) <= REL[dname]
    v0 = args[2][0].float()
    want0 = (v0.mean(0) if tdm is None
             else (tdm[0][:, :, None] * v0[None]).mean(1))
    np.testing.assert_allclose(
        got[0].numpy(), np.broadcast_to(want0.numpy(), got[0].shape),
        rtol=0, atol=REL[dname] * 10)


def _pallas_shape(dname, mode):
    """The shape a (mode, dtype) is held at against the Pallas kernels
    (each call runs them in interpret mode, about a second): the three
    SHAPES in turn, so that every shape, mode and dtype is among them."""
    return SHAPES[(MODES.index(mode) + list(DTYPES).index(dname)) % 3]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_wide_fwd_design_matches_pallas(dname, mode):
    """Rows with a live key: the model against JAX's Pallas forward in
    interpret mode, in the same dtype."""
    t, d = _pallas_shape(dname, mode)
    dtype, jdtype = DTYPES[dname]
    drop = mode.endswith("_drop")
    arrays, _, dm = _inputs(seed=2 * t + d + len(mode), t=t, d=d,
                            with_empty=False)
    want = jak._fused_attention_fwd(
        mode, *_jax(arrays, jdtype),
        jnp.asarray(dm) if drop else jak.dm_dummy())
    got = tak._wide_fwd_design_plain(mode, *_torch(arrays, dtype),
                                     _mask(mode, dm))
    assert _rel(got.numpy(), want) <= REL[dname]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_wide_bwd_design_matches_twin(t, d, dname, mode):
    """Every row, the one of length 0 included: the model against the
    twin in the same dtype."""
    dtype = DTYPES[dname][0]
    arrays, g, dm = _inputs(seed=t + d + len(mode), t=t, d=d)
    args = _torch(arrays, dtype)
    tdm = _mask(mode, dm)
    want = tak.fused_attention_bwd(mode, torch.tensor(g), *args, tdm)
    got = tak._wide_design_plain(mode, torch.tensor(g), *args, tdm)
    _hold_bwd(mode, got, [None if w is None else w.numpy() for w in want],
              REL[dname], "twin")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_wide_bwd_design_matches_pallas(dname, mode):
    """Rows with a live key: the model against JAX's Pallas backward in
    interpret mode, in the same dtype."""
    t, d = _pallas_shape(dname, mode)
    dtype, jdtype = DTYPES[dname]
    drop = mode.endswith("_drop")
    arrays, g, dm = _inputs(seed=2 * t + d + len(mode), t=t, d=d,
                            with_empty=False)
    want = jak._fused_attention_bwd(
        mode, jnp.asarray(g), *_jax(arrays, jdtype),
        jnp.asarray(dm) if drop else jak.dm_dummy())
    got = tak._wide_design_plain(mode, torch.tensor(g),
                                 *_torch(arrays, dtype), _mask(mode, dm))
    _hold_bwd(mode, got, want, REL[dname], "pallas")


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_wide_gate_sums_do_not_depend_on_chunking(dname):
    """A batch of 70 rows in one chunk and in chunks of 32, as the launch
    splits a batch whose workspaces pass the cap: the same bits."""
    dtype = DTYPES[dname][0]
    arrays, g, _ = _inputs(seed=11, t=70, d=16, b=70)
    args = _torch(arrays, dtype)
    whole = tak._wide_design_plain("time", torch.tensor(g), *args)
    split = tak._wide_design_plain("time", torch.tensor(g), *args,
                                   chunk_rows=32)
    assert tak.wide_chunk_rows(70, 70, 70, True) == 70
    for name, x, y in zip(NAMES, whole, split):
        assert torch.equal(x, y), name


# ------------------------------------------------------- the models at L=96

ML, MD, MB = 96, 32, 8
SEQ_LENS = [1, 2, ML, 50, ML, 30, 70, 65]
MODELS = {"Time_Aware_Self_Attention_Model": 0.0, "SASrec": 0.5,
          "Ti_Self_Attention_Model": 0.0}


def _model_cfg(name):
    return ExperimentConfig().with_overrides(**{
        "model.experiment_type": name, "model.num_units": MD,
        "model.num_blocks": 1, "data.max_seq_len": ML,
        "model.vocab_pad_multiple": 16, "model.dropout": MODELS[name]})


@pytest.mark.parametrize("name", list(MODELS))
def test_self_attention_models_at_l96_match_jax(name):
    """One f32 step's loss terms and every gradient leaf at L=96 (the
    blocks take the wide design's shapes, Tq = Tk = 96) against JAX's jnp
    route; SASrec at dropout 0.5 with JAX's mask injected."""
    cfg = _model_cfg(name)
    jmeta = jtypes.DatasetMeta(20, 60, 5, ML)
    tmeta = ttypes.DatasetMeta(20, 60, 5, ML)
    assert tak.attention_bwd_design(torch.float32, ML, ML, MD) == "wide"
    params = jax.device_get(jget_model(name).init(jax.random.PRNGKey(0),
                                                  cfg.model, jmeta))
    model = load_jax_params(get_model(name).init(
        torch.Generator().manual_seed(0), cfg.model, tmeta), params)
    jb = make_batch(jmeta, batch_size=MB, seed=5, seq_lens=SEQ_LENS)
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0,
                     valid=jnp.asarray([1] * (MB - 1) + [0], jnp.float32))
    tb = ttypes.batch_from_numpy({f: np.asarray(getattr(jb, f))
                                  for f in jb._fields}, device="cpu")
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        m = jbase.compute_loss(jget_model(name), p, cfg.model, jb, True,
                               rng, jmeta.item_vocab)
        return m["loss"], m

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn,
                                                   has_aux=True))(params)
    jgrads = params_from_jax(jax.device_get(jgrads))
    masks = None
    if MODELS[name]:
        shape = jnp.zeros((MB, ML, 1))
        masks = iter([torch.tensor(np.asarray(jatt._draw_drop_mask(
            jax.random.fold_in(jax.random.split(rng)[0], 0), shape, shape,
            MODELS[name], True)))])
    got = tbase.compute_loss(get_model(name), model, cfg.model, tb,
                             tmeta.item_vocab, gen=masks)
    got["loss"].backward()
    for key in ("loss", "ce", "l2"):
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    tgrads = {n: p.grad for n, p in model.named_parameters()}
    assert set(tgrads) == set(jgrads)
    for leaf, g in tgrads.items():
        w = jgrads[leaf].numpy()
        assert g is not None and g.dtype == torch.float32, leaf
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                         1e-30), leaf
