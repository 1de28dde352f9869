"""The chain readout backward's staged design, held on the CPU through its
arithmetic composed in plain PyTorch.

On the card `readout_chain_bwd` with 1 <= L <= 64 keys and d a multiple
of 16 up to 128 (MTAM's training readout at L=50, d=128, and the narrow
d=16) takes the "staged" design of csrc/readout_chain_bwd.cu: a query
pass (q = relu(cur_c Wq + bq) for every hop and row), then a block a
batch row that stages each hop's K and tprec rows of the live keys and V
rows of the reached keys in shared memory, zero-padded to 64 rows in the
model; the score dots by lane columns and a half-warp's shuffle tree,
the key sums by 16 key slices combined in a fixed order, dk and dt zero
past the live keys and dv past the reached ones; then the batch sums and
a dwq product.  chip_smoke.py's phase 2f holds the kernel against the
plain twin there.  Here `_staged_bwd_design_plain`, those steps in plain
PyTorch, is held against the twin `readout_chain_bwd_plain` and against
JAX's `_chain_bwd_impl` (the Pallas `_chain_bwd_kernel` in interpret
mode, as tests/test_torch_readout_chain.py runs it) on the same numpy
inputs: f32 and bf16, (L, d) = (17, 16), (50, 128), (64, 64), positional
and scalar (constant) wo2 rows, ragged key lengths with a full row and a
query-masked row.  The backward takes the JAX forward's hop-input chain
on both sides.  The Pallas backward gives a row with no live key a score
gradient where the jnp reference gives none, so that row is held against
the twin and, in f32, against jax.vjp of the jnp chain, and the inputs
given to the Pallas kernel have none (as test_key_len_zero_row_both_ways
keeps it out of its Pallas comparison).

Tolerances, of each output's largest |value|: f32 1e-5 (f32 sums in
other orders); bf16 2e-2, as tests/test_torch_readout_chain.py holds the
twin to the Pallas backward (both round the same operands to bf16, but
one on a rounding boundary may round the other way after a differently
ordered f32 sum).
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

N_HOPS = 3
REL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = ((17, 16), (50, 128), (64, 64))
_UNTYPED = ("klen", "qz")


def _key_len(L, with_empty):
    # a full row, a row of length 0 (or 1), ragged rows, a masked query's
    return np.array([L, 0 if with_empty else 1, 3, L // 2, L, max(L - 5, 1)],
                    np.int32)


def _inputs(L, d, gate_mode, seed, with_empty=False):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    key_len = _key_len(L, with_empty)
    b = len(key_len)
    wo2 = (np.repeat(f(N_HOPS, 1, scale=0.5), L, axis=1)
           if gate_mode == "scalar" else f(N_HOPS, L, scale=0.5))
    qz = np.ones((b,), np.float32)
    qz[3] = 0.0                                     # a masked query
    return {
        "dec": f(b, 1, d), "klen": key_len, "qz": qz,
        "k_all": np.maximum(f(N_HOPS, b, L, d), 0.0),
        "v_all": np.maximum(f(N_HOPS, b, L, d), 0.0),
        "tprec": f(N_HOPS, b, L, d, scale=0.5),
        "gate_part": f(N_HOPS, b, L, scale=0.5), "wo2": wo2,
        "wq": f(N_HOPS, d, d, scale=d ** -0.5), "bq": f(N_HOPS, d, scale=0.1),
        "lng": 1.0 + f(N_HOPS, d, scale=0.1), "lnb": f(N_HOPS, d, scale=0.1)}


def _as_jax(ins, dtype):
    jdt = jnp.dtype(dtype)
    return [jnp.asarray(ins[k]) if k in _UNTYPED else jnp.asarray(ins[k], jdt)
            for k in trc._OPERANDS]


def _as_torch(ins, dtype):
    tdt = getattr(torch, dtype)
    return [torch.tensor(ins[k]) if k in _UNTYPED
            else torch.tensor(ins[k]).to(tdt) for k in trc._OPERANDS]


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _hold(got, want, dname, what):
    for name, x, w in zip(trc._GRADS, got, want):
        x = x.float().numpy() if isinstance(x, torch.Tensor) else x
        w = (w.float().numpy() if isinstance(w, torch.Tensor)
             else np.asarray(w, np.float32))
        assert np.isfinite(x).all(), (what, name)
        err = _rel(x, w.reshape(x.shape))
        assert err <= REL[dname], (what, name, err)


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tk", [1, 50, 64, 65, 255])
@pytest.mark.parametrize("d", [16, 48, 96, 128, 8, 40, 100])
def test_chain_bwd_design_routes(dtype, tk, d):
    want = ("rows" if d % 16 else "staged" if tk <= trc.STAGED_KEYS
            else "blocked")
    assert trc.chain_bwd_design(dtype, tk, d) == want
    assert trc.BWD_DESIGNS == ("staged", "blocked", "rows")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_chain_bwd_design_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="no design"):
        trc.chain_bwd_design(dtype, 50, 128)


def _meta_like(L, d, dtype=torch.float32, b=4):
    """The backward's operands on the CPU, uninitialised (no kernel reads
    them here)."""
    shapes = {"klen": (b,), "qz": (b,), "k_all": (N_HOPS, b, L, d),
              "v_all": (N_HOPS, b, L, d), "tprec": (N_HOPS, b, L, d),
              "gate_part": (N_HOPS, b, L), "wo2": (N_HOPS, L),
              "wq": (N_HOPS, d, d), "bq": (N_HOPS, d), "lng": (N_HOPS, d),
              "lnb": (N_HOPS, d)}
    args = tuple(torch.zeros(s, dtype=torch.int32 if k == "klen" else
                             torch.float32 if k == "qz" else dtype)
                 for k, s in shapes.items())
    return (torch.zeros((b, d), dtype=dtype), args,
            torch.zeros((N_HOPS, b, d)))


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


@pytest.mark.parametrize("tk,d,design", [
    (65, 128, "staged"), (255, 128, "staged"), (50, 56, "staged"),
    (50, 128, "tile"), (50, 128, "gemm"), (50, 128, "")])
def test_forced_design_outside_its_range_refused_before_any_build(
        no_build, tk, d, design):
    g, args, curs = _meta_like(tk, d)
    with pytest.raises(ValueError, match="does not take"):
        trc._launch_bwd(g, args, curs, _design=design)


def test_forced_staged_misaligned_refused_before_any_build(no_build):
    g, args, curs = _meta_like(50, 128)
    k = args[2]
    shifted = torch.zeros(k.numel() + 1)[1:].view(k.shape)   # 4 bytes off
    args = args[:2] + (shifted,) + args[3:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        trc._launch_bwd(g, args, curs, _design="staged")


class _FakeLib:
    """Stands in for the built library: records the design each launch
    asks for and reports success."""

    def __init__(self):
        self.designs = []

    def readout_chain_bwd_workspace_bytes(self, design, *_):
        return 0

    def readout_chain_bwd_launch(self, design, *_):
        self.designs.append(design)
        return 0


@pytest.mark.parametrize("tk,d,forced,misaligned,design", [
    (50, 128, None, False, "staged"), (50, 16, None, False, "staged"),
    (64, 64, None, False, "staged"), (50, 128, "rows", False, "rows"),
    (50, 128, None, True, "rows"), (255, 128, None, False, "blocked"),
    (50, 40, None, False, "rows")])
def test_launch_takes_the_design_it_should(monkeypatch, tk, d, forced,
                                           misaligned, design):
    """The launch asks the library for the design `chain_bwd_design`
    picks, the rows design where the staged one is picked but k_all is
    not 16-byte aligned (before the launch, never after a failure), or
    the design forced; `bwd_launches` counts every launch and
    `bwd_rows_launches` the rows design's."""
    lib = _FakeLib()
    monkeypatch.setattr(trc, "_bwd_library", lambda: lib)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    g, args, curs = _meta_like(tk, d)
    if misaligned:
        k = args[2]
        args = (args[:2] + (torch.zeros(k.numel() + 1)[1:].view(k.shape),)
                + args[3:])
    before = (trc.bwd_launches, trc.bwd_rows_launches)
    grads = trc._launch_bwd(g, args, curs, _design=forced)
    assert lib.designs == [trc.BWD_DESIGNS.index(design)]
    assert trc.bwd_launches == before[0] + 1
    assert trc.bwd_rows_launches == before[1] + int(design == "rows")
    assert [tuple(x.shape) for x in grads[:5]] == [
        (4, d), (N_HOPS, 4, tk, d), (N_HOPS, 4, tk, d), (N_HOPS, 4, tk, d),
        (N_HOPS, 4, tk)]


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("gate_mode", ["positional", "scalar"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("tk,d", SHAPES)
def test_staged_design_matches_twin_and_pallas(tk, d, dname, gate_mode):
    """Every row: the model against the twin in the same dtype, and
    against JAX's Pallas backward in interpret mode on the same inputs
    and hop-input chain."""
    ins = _inputs(tk, d, gate_mode, seed=tk + d + len(gate_mode))
    jargs = _as_jax(ins, dname)
    _, jcurs = jrc._chain_fwd(*jargs)
    b = len(ins["klen"])
    g = np.random.RandomState(tk * d).randn(b, d).astype(np.float32)
    tdt = getattr(torch, dname)
    args = _as_torch(ins, dname)
    curs = torch.tensor(np.asarray(jcurs))
    tg = torch.tensor(g).to(tdt)
    got = trc._staged_bwd_design_plain(tg, *args[1:], curs)
    per_row = dict(zip(trc._GRADS, got))
    assert per_row["dk"].dtype == tdt and per_row["dwq"].dtype == torch.float32
    twin = trc.readout_chain_bwd_plain(tg, *args[1:], curs)
    _hold(got, twin, dname, "twin")
    pallas = jrc._chain_bwd_impl(jnp.asarray(g, jnp.dtype(dname)),
                                 *jargs[1:], jcurs)
    _hold(got, [np.asarray(x, np.float32) for x in pallas], dname, "pallas")
    # the masked query's row: no score gradient reaches its keys
    assert not per_row["dk"][:, 3].float().any()
    assert not per_row["dgp"][:, 3].float().any()


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


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_staged_design_key_len_zero_row(dname):
    """A row with no live key (row 1) at MTAM's L=50, d=128: its softmax
    is uniform over all L keys, so V is staged to L and dv = w do there,
    while dk, dt and dgp are exactly 0.  The model against the twin on
    every row; in f32 against jax.vjp of the jnp chain too (the rows
    with a live key are held against the Pallas backward above)."""
    tk, d = 50, 128
    ins = _inputs(tk, d, "positional", seed=7 * tk + d, with_empty=True)
    b = len(ins["klen"])
    assert ins["klen"][1] == 0
    g = np.random.RandomState(d).randn(b, d).astype(np.float32)
    tdt = getattr(torch, dname)
    args = _as_torch(ins, dname)
    tg = torch.tensor(g).to(tdt)
    _, curs = trc.readout_chain(*args)
    got = trc._staged_bwd_design_plain(tg, *args[1:], curs)
    _hold(got, trc.readout_chain_bwd_plain(tg, *args[1:], curs), dname,
          "twin")
    for i in (1, 3, 4):                              # dk, dt, dgp
        assert not got[i][:, 1].float().any()
    assert got[2][:, 1].float().abs().max() > 0      # V reaches every key
    if dname == "float32":
        jargs = _as_jax(ins, dname)
        _, vjp = jax.vjp(_jnp_chain, *jargs)
        ref = dict(zip(trc._OPERANDS, vjp(jnp.asarray(g))))
        want = [ref[k] for k in ("dec", "k_all", "v_all", "tprec",
                                 "gate_part", "wo2", "wq", "bq", "lng",
                                 "lnb")]
        _hold(got, [np.asarray(w, np.float32) for w in want], dname, "jnp")


def test_staged_model_refuses_shapes_outside_the_design():
    ins = _inputs(65, 16, "scalar", seed=1)
    args = _as_torch(ins, "float32")
    _, curs = trc.readout_chain(*args)
    with pytest.raises(ValueError, match="does not take"):
        trc._staged_bwd_design_plain(torch.zeros(len(ins["klen"]), 16),
                                     *args[1:], curs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_columns_cover_every_column_once(dtype):
    """Each lane owns 8 columns and the lanes cover 0 .. d-1 once; in
    f32 a lane's two 16-byte pieces sit d/2 apart, so 8 lanes' first
    pieces are 128 contiguous bytes."""
    for d in (16, 48, 96, 128):
        cols = trc._lane_columns(d, dtype)
        assert cols.shape == (d // 8, 8)
        assert sorted(cols.flatten().tolist()) == list(range(d))
        if dtype == torch.float32:
            assert (cols[:, 4] - cols[:, 0] == d // 2).all()
            assert (cols[1:, 0] - cols[:-1, 0] == 4).all()
