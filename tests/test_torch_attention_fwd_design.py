"""The self-attention forward's tile design, held on the CPU through its
arithmetic composed in plain PyTorch.

On the card `fused_attention` with 2 <= Tq <= 64, Tk <= 64 and d one of
16, 32, 64, 128 (the self-attention models' blocks: Tq = Tk = 50, d =
128) takes the "tile" design of csrc/fused_attention_tile.cu: one block a
batch row, q and tqw padded to 64 rows with zeros, k and rawk zero past
the row's live keys and v past the keys its weights reach, the score
planes S0 and TQK as products, the elementwise middle a warp a query row
(gate, scale, mask, softmax, drop mask), the weights rounded to the input
type and zero past Tq and Tk, then out = W v.  chip_smoke.py's phase 2c
holds the kernel against the plain twin there, and against the earlier
"query" design forced.  (One query row with up to 64 keys takes the "hop"
design, tests/test_torch_attention_hop_design.py, one query row past 64
keys the "blocked" design, tests/test_torch_attention_blocked_design.py,
and more than 64 keys or queries the "wide" design,
tests/test_torch_attention_wide_design.py; the routes of all five are
held here.)  Here `_tile_fwd_design_plain`, those steps in
plain PyTorch, is held against the twin `fused_attention_plain` and
against JAX's `_fused_attention_fwd` (the Pallas `_attn_kernel` in
interpret mode, as tests/test_torch_kernels.py runs it) on the same numpy
inputs: the five modes, f32 and bf16, Tq = Tk = 17, 50, 64 with d = 16,
128, 64, ragged key lengths with a row of length 0 and a full row, a drop
mask at rate 0.5.  The Pallas kernel pads Tk to 128 and gives a row with
no live key its padded keys too, so the row of length 0 is held against
the twin and, in f32, against the jnp reference `_reference_middle`, and
left out of the inputs given to the Pallas kernel.

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
# (Tq = Tk, d)
SHAPES = ((17, 16), (50, 128), (64, 64))


def _key_len(t, with_empty):
    # a row of length 0 (or 1), a full row, and ragged ones
    return np.array([0 if with_empty else 1, t, 3, t // 2, t - 3], np.int32)


def _inputs(seed, t, d, with_empty=True):
    """q, k, v, t_q, t_k, tqw, rawk, five [t, t] gate params, key_len (the
    forward's arguments, numpy) and a drop mask."""
    r = np.random.RandomState(seed)
    key_len = _key_len(t, with_empty)
    b = len(key_len)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    hours = np.sort(r.rand(b, t).astype(np.float32) * 500, axis=1)
    arrays = [np.maximum(f(b, t, d), 0), np.maximum(f(b, t, d), 0),
              np.maximum(f(b, t, d), 0), hours, hours, f(b, t, d, scale=0.3),
              f(b, t, d)]
    arrays += [f(t, t, scale=0.3) for _ in range(5)]
    arrays.append(key_len)
    dm = (r.rand(b, t, t) < 0.5).astype(np.float32) / 0.5
    return arrays, dm


def _torch(arrays, dtype):
    return [torch.tensor(a).to(dtype) for a in arrays[:-1]] \
        + [torch.tensor(arrays[-1])]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _model(mode, args, dm):
    tdm = torch.tensor(dm) if mode.endswith("_drop") else None
    return tak._tile_fwd_design_plain(mode, *args, tdm)


def _hold(got, want, rel, what):
    assert got.dtype == torch.float32, what
    assert bool(torch.isfinite(got).all()), what
    err = _rel(got.numpy(), want)
    assert err <= rel, (what, err)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,d,design", [
    (50, 50, 128, "tile"), (64, 64, 16, "tile"), (2, 1, 32, "tile"),
    (17, 17, 64, "tile"), (64, 1, 128, "tile"), (1, 50, 128, "hop"),
    (1, 1, 16, "hop"), (1, 1024, 128, "blocked"), (65, 65, 128, "wide"),
    (50, 65, 128, "wide"), (65, 50, 128, "wide"), (50, 50, 48, "query"),
    (50, 50, 96, "query"), (50, 50, 256, "query"), (50, 50, 8, "query"),
    (1, 64, 128, "hop"), (1, 50, 48, "hop"), (1, 65, 128, "blocked"),
    (1, 50, 8, "query"), (1, 50, 256, "query")])
def test_attention_fwd_design_routes(dtype, tq, tk, d, design):
    assert tak.attention_fwd_design(dtype, tq, tk, d) == design
    assert tak.FWD_DESIGNS == ("tile", "hop", "blocked", "wide", "query")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_attention_fwd_design_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="no design"):
        tak.attention_fwd_design(dtype, 50, 50, 128)


@pytest.mark.parametrize("tq,tk,d,design", [
    (1, 50, 128, "tile"), (50, 50, 48, "tile"), (65, 65, 128, "tile"),
    (50, 65, 128, "tile"), (50, 50, 128, "mma"), (50, 50, 128, "rows")])
def test_forced_design_outside_its_range_refused_before_any_build(
        no_build, tq, tk, d, design):
    r = np.random.RandomState(0)
    arrays = [r.randn(2, tq, d), r.randn(2, tk, d), r.randn(2, tk, d),
              r.rand(2, tq), r.rand(2, tk), r.randn(2, tq, d),
              r.randn(2, tk, d)] + [r.randn(tq, tk) for _ in range(5)]
    args = [torch.tensor(a, dtype=torch.float32) for a in arrays]
    args.append(torch.tensor([1, tk], dtype=torch.int32))
    with pytest.raises(ValueError, match="does not take"):
        tak._launch("time", *args, None, _design=design)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_tile_fwd_design_matches_twin(t, d, dname, mode):
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
        want0 = (tdm[0][:, :, None] * args[2][0].float()[None]).mean(1)
    np.testing.assert_allclose(want[0].numpy(),
                               np.broadcast_to(want0.numpy(), want[0].shape),
                               rtol=0, atol=REL[dname] * 10)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_tile_fwd_design_matches_pallas(t, d, dname, mode):
    """Rows with a live key: the model against JAX's Pallas forward in
    interpret mode, in the same dtype; in f32 at Tq = Tk = 50 also a
    batch with the row of length 0, against the jnp reference."""
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
