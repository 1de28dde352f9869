"""The chain readout forward's staged design, held on the CPU through its
arithmetic composed in plain PyTorch.

On the card `readout_chain` with 1 <= L <= 64 keys and d a multiple of
16 up to 128 (MTAM's training readout at L=50, d=128, and the narrow
d=16) takes the "staged" design of csrc/readout_chain.cu: a block a
batch row that stages each hop's K and tprec rows of the live keys and V
rows of the reached keys in shared memory, zero-padded to 64 rows in the
model; q = relu(cur_c Wq + bq) by 16 k-slices combined in a fixed order,
the score dots by lane columns and a half-warp's shuffle tree, o by 16
key slices combined in the same order, the residual and normalize().
The backward picks its design by the same predicate, so the pair always
runs one design.  chip_smoke.py's phase 2f holds the kernel against the
plain twin there.  Here `_staged_fwd_design_plain`, those steps in plain
PyTorch, is held against the twin `readout_chain_plain` and against JAX's
`_chain_fwd` (the Pallas `_chain_fwd_kernel` in interpret mode, as
tests/test_torch_readout_chain.py runs it) on the same numpy inputs: f32
and bf16, (L, d) = (17, 16), (50, 128), (64, 64), positional and scalar
(constant) wo2 rows, ragged key lengths with a full row and a
query-masked row.  A row with no live key (a uniform softmax over its L
keys, V staged to L) is held against the twin, the Pallas kernel and the
jnp chain.

Tolerances, of each output's (out, curs) largest |value|: f32 1e-5 (f32
sums in other orders); bf16 2e-2, as tests/test_torch_readout_chain.py
holds the twin to the Pallas kernel (both round the same operands to
bf16, but one on a rounding boundary may round the other way after a
differently ordered f32 sum).
"""

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


def _inputs(L, d, gate_mode, seed, with_empty=False, n=N_HOPS):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    key_len = _key_len(L, with_empty)
    b = len(key_len)
    wo2 = (np.repeat(f(n, 1, scale=0.5), L, axis=1)
           if gate_mode == "scalar" else f(n, L, scale=0.5))
    qz = np.ones((b,), np.float32)
    qz[3] = 0.0                                     # a masked query
    return {
        "dec": f(b, 1, d), "klen": key_len, "qz": qz,
        "k_all": np.maximum(f(n, b, L, d), 0.0),
        "v_all": np.maximum(f(n, b, L, d), 0.0),
        "tprec": f(n, b, L, d, scale=0.5),
        "gate_part": f(n, b, L, scale=0.5), "wo2": wo2,
        "wq": f(n, d, d, scale=d ** -0.5), "bq": f(n, d, scale=0.1),
        "lng": 1.0 + f(n, d, scale=0.1), "lnb": f(n, d, scale=0.1)}


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
    """out [B,d] and curs [n,B,d] within REL of the largest |value|."""
    for name, x, w in zip(("out", "curs"), got, want):
        x = x.float().numpy()
        w = (w.float().numpy() if isinstance(w, torch.Tensor)
             else np.asarray(w, np.float32))
        assert np.isfinite(x).all(), (what, name)
        err = _rel(x, w.reshape(x.shape))
        assert err <= REL[dname], (what, name, err)


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tk", [1, 50, 64, 65, 255])
@pytest.mark.parametrize("d", [16, 48, 96, 128, 8, 40, 100])
def test_chain_fwd_design_routes_as_the_backward(dtype, tk, d):
    want = ("rows" if d % 16 else "staged" if tk <= trc.STAGED_KEYS
            else "blocked")
    assert trc.chain_fwd_design(dtype, tk, d) == want
    assert trc.chain_fwd_design(dtype, tk, d) == trc.chain_bwd_design(
        dtype, tk, d)
    assert trc.FWD_DESIGNS == ("staged", "blocked", "rows") == \
        trc.BWD_DESIGNS


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_chain_fwd_design_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="no design"):
        trc.chain_fwd_design(dtype, 50, 128)


def _meta_like(L, d, dtype=torch.float32, b=4):
    """The forward's operands on the CPU, uninitialised (no kernel reads
    them here)."""
    shapes = {"dec": (b, 1, d), "klen": (b,), "qz": (b,),
              "k_all": (N_HOPS, b, L, d), "v_all": (N_HOPS, b, L, d),
              "tprec": (N_HOPS, b, L, d), "gate_part": (N_HOPS, b, L),
              "wo2": (N_HOPS, L), "wq": (N_HOPS, d, d), "bq": (N_HOPS, d),
              "lng": (N_HOPS, d), "lnb": (N_HOPS, d)}
    return tuple(torch.zeros(s, dtype=torch.int32 if k == "klen" else
                             torch.float32 if k == "qz" else dtype)
                 for k, s in shapes.items())


def _shifted(x):
    """x's shape and type, 4 bytes past a 16-byte boundary."""
    return torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)


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
    with pytest.raises(ValueError, match="does not take"):
        trc._launch(_meta_like(tk, d), _design=design)


@pytest.mark.parametrize("operand", ["k_all", "v_all", "tprec", "wq"])
def test_forced_staged_misaligned_refused_before_any_build(no_build,
                                                           operand):
    args = list(_meta_like(50, 128))
    i = trc._OPERANDS.index(operand)
    args[i] = _shifted(args[i])
    with pytest.raises(ValueError, match="16-byte aligned"):
        trc._launch(tuple(args), _design="staged")


class _FakeLib:
    """Stands in for the built library: records the design each launch
    asks for and reports success."""

    def __init__(self):
        self.designs = []

    def readout_chain_launch(self, design, *_):
        self.designs.append(design)
        return 0


@pytest.mark.parametrize("tk,d,forced,misaligned,design", [
    (50, 128, None, None, "staged"), (50, 16, None, None, "staged"),
    (64, 64, None, None, "staged"), (1, 32, None, None, "staged"),
    (50, 128, "rows", None, "rows"), (50, 128, None, "k_all", "rows"),
    (50, 128, None, "wq", "rows"), (50, 128, None, "bq", "staged"),
    (255, 128, None, None, "blocked"), (50, 40, None, None, "rows")])
def test_launch_takes_the_design_it_should(monkeypatch, tk, d, forced,
                                           misaligned, design):
    """The launch asks the library for the design `chain_fwd_design`
    picks, the rows design where the staged one is picked but k_all,
    v_all, tprec or wq is not 16-byte aligned (before the launch, never
    after a failure; the other operands may sit anywhere), or the design
    forced; `launches` counts every launch and `rows_launches` the rows
    design's."""
    lib = _FakeLib()
    monkeypatch.setattr(trc, "_library", lambda: lib)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    args = list(_meta_like(tk, d))
    if misaligned:
        i = trc._OPERANDS.index(misaligned)
        args[i] = _shifted(args[i])
    before = (trc.launches, trc.rows_launches)
    out, curs = trc._launch(tuple(args), _design=forced)
    assert lib.designs == [trc.FWD_DESIGNS.index(design)]
    assert trc.launches == before[0] + 1
    assert trc.rows_launches == before[1] + int(design == "rows")
    assert tuple(out.shape) == (4, d) and out.dtype == torch.float32
    assert tuple(curs.shape) == (N_HOPS, 4, d)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("gate_mode", ["positional", "scalar"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("tk,d", SHAPES)
def test_staged_design_matches_twin_and_pallas(tk, d, dname, gate_mode):
    """Every row: the model against the twin in the same dtype, and
    against JAX's Pallas forward in interpret mode on the same inputs."""
    ins = _inputs(tk, d, gate_mode, seed=tk + d + len(gate_mode))
    args = _as_torch(ins, dname)
    got = trc._staged_fwd_design_plain(*args)
    assert got[0].dtype == getattr(torch, dname)
    assert got[1].dtype == torch.float32
    _hold(got, trc.readout_chain_plain(*args), dname, "twin")
    pallas = jrc._chain_fwd(*_as_jax(ins, dname))
    _hold(got, [np.asarray(x, np.float32) for x in pallas], dname, "pallas")
    # the masked query's row keeps its residual and normalize only: its
    # hops do not depend on K, V or tprec
    ins2 = dict(ins, v_all=ins["v_all"] + 1.0, k_all=ins["k_all"] * 2.0)
    again = trc._staged_fwd_design_plain(*_as_torch(ins2, dname))
    assert torch.equal(again[0][3], got[0][3])


def _jnp_chain(dec, klen, qz, k_all, v_all, tprec, gate_part, wo2, wq, bq,
               lng, lnb):
    """The chain as jnp code (the Pallas body's `_hop_fwd`, hop after
    hop): the reference's uniform softmax over all L keys in a row with
    none live."""
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
    is uniform over all L keys, so V is staged to L.  The model against
    the twin, the Pallas kernel and the jnp chain on every row, and the
    row's output unmoved by its K and tprec rows (never read) but moved
    by its V rows past the first key."""
    tk, d = 50, 128
    ins = _inputs(tk, d, "positional", seed=7 * tk + d, with_empty=True)
    assert ins["klen"][1] == 0
    args = _as_torch(ins, dname)
    got = trc._staged_fwd_design_plain(*args)
    _hold(got, trc.readout_chain_plain(*args), dname, "twin")
    jargs = _as_jax(ins, dname)
    _hold(got, [np.asarray(x, np.float32) for x in jrc._chain_fwd(*jargs)],
          dname, "pallas")
    ref = np.asarray(_jnp_chain(*jargs), np.float32)
    assert _rel(got[0].float().numpy(), ref) <= REL[dname]
    k2 = ins["k_all"].copy()
    t2 = ins["tprec"].copy()
    k2[:, 1] += 3.0
    t2[:, 1] -= 2.0
    same = trc._staged_fwd_design_plain(
        *_as_torch(dict(ins, k_all=k2, tprec=t2), dname))
    assert torch.equal(same[0][1], got[0][1])
    v2 = ins["v_all"].copy()
    v2[:, 1, tk - 1] += 5.0
    moved = trc._staged_fwd_design_plain(*_as_torch(dict(ins, v_all=v2),
                                                    dname))
    assert not torch.equal(moved[0][1], got[0][1])


def test_staged_model_refuses_shapes_outside_the_design():
    for tk, d in ((65, 16), (50, 40)):
        args = _as_torch(_inputs(tk, d, "scalar", seed=1), "float32")
        with pytest.raises(ValueError, match="does not take"):
            trc._staged_fwd_design_plain(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 48, 96, 128])
def test_lane_mapping_covers_every_column_once(dtype, d):
    """Each lane owns 8 columns and the 16 lanes of a half-warp cover 0 ..
    d-1 once (lanes past d / 8 own none); the 16 k-slices of q's sum and
    the 16 key slices of o's cover every k < d and every key < 64 once."""
    cols = trc._lane_columns(d, dtype)
    assert cols.shape == (d // trc.GROUP, trc.GROUP)
    assert sorted(cols.flatten().tolist()) == list(range(d))
    assert cols.shape[0] <= trc.HALVES
    for n in (d, trc.STAGED_KEYS):
        taken = sorted(k for h in range(trc.HALVES)
                       for k in range(h, n, trc.HALVES))
        assert taken == list(range(n))
