"""The scatter-add kernel's "columns" design, held on the CPU through its
plan and its work split composed in plain PyTorch.

On the card `scatter_add` (csrc/embedding_gather.cu) takes the route
`scatter_plan` picks: up to SMALL_N ids one pass that finds each row's
ids in order; past it the ids sorted into each row's list (a sort a
1,024-id chunk, the counts turned into where each chunk's run lies in
its row's list, each position placed), then each row with more than
SCATTER_HOT ids as one chain a SCATTER_SLICE-column slice and every
other row as one chain over its columns.  chip_smoke.py holds the
kernel against `scatter_add_plain` and the earlier design there, bit for
bit.  Here `_columns_design_plain`, the same split in plain PyTorch,
and `_row_lists`, its ordering passes, are held against the sequential
definition, `scatter_add_plain` and JAX's `_scatter_add_impl` (Pallas in
interpret mode, one grid step an id: n <= 300 only).

Tolerances: equal to the definition and the twin (every chain adds its
rows one at a time in position order and rounds after every add, as
they do).  Against JAX: equal in f32; in bf16 within one bf16 ulp of
JAX's value, as tests/test_torch_gather.py holds the twin (JAX's
interpret mode adds two bf16 rows in its own way).  The kernel adds two
bf16 values with one fma.rn.bf16 (the exact sum rounded once), held here
equal to the f32 sum rounded to bf16 on pairs of every exponent spread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import embedding_kernel as jek
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as tek

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _sequential(grad, ids, vocab):
    """The definition: for i in order, out[ids[i]] += grad[i], rounded."""
    out = torch.zeros((vocab, grad.shape[1]), dtype=grad.dtype)
    for i, v in enumerate(ids.tolist()):
        out[v] = (out[v].float() + grad[i].float()).to(grad.dtype)
    return out


def _hot_ids(n, vocab, seed):
    """Three hot rows (0, 1, 2: most of the ids, runs across several
    1,024-id chunks), a few cold rows (at most SCATTER_HOT ids each) and
    rows no id names."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, 3, n)
    cold = r.rand(n) < 0.05
    ids[cold] = r.randint(3, vocab - 5, cold.sum())
    return torch.tensor(ids.astype(np.int32))


def _grad(n, d, dtype, seed):
    r = np.random.RandomState(seed)
    return torch.tensor(r.randn(n, d).astype(np.float32)).to(dtype)


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.where(x > 0, x, 1)))
                                   - 7), 0.0)


def test_scatter_plan_at_its_edges():
    """The route and its workspace at n = 0, 1, 256, 257, 131,072 and
    vocab 0; the columns route's bytes counted here from its arrays."""
    def columns_bytes(n, vocab):
        chunks = -(-n // 1024)
        r4 = lambda x: -(-x // 4) * 4  # noqa: E731
        return 4 * (4 + 2 * 1024 * chunks + r4(chunks * vocab)
                    + 3 * r4(vocab) + r4(n))

    for n in (0, 1, 256):
        assert tek.scatter_plan(n, 128, 2048) == ("small", 128, 0)
    assert tek.scatter_plan(257, 128, 2048) == ("columns", 32,
                                                columns_bytes(257, 2048))
    assert columns_bytes(257, 2048) == 4 * (4 + 2048 + 2048 + 6144 + 260)
    assert tek.scatter_plan(131072, 128, 2176) == (
        "columns", 32, columns_bytes(131072, 2176))
    assert tek.scatter_plan(131072, 64, 3) == ("columns", 32,
                                               columns_bytes(131072, 3))
    assert tek.scatter_plan(131072, 128, 0) == ("small", 128, 0)
    assert tek.scatter_plan(0, 32, 0) == ("small", 32, 0)
    # the sort key holds the id in 22 bits past SMALL_N ids only
    assert tek.scatter_plan(256, 128, tek.MAX_VOCAB + 1)[0] == "small"
    assert tek.scatter_plan(257, 128, tek.MAX_VOCAB)[0] == "columns"
    with pytest.raises(ValueError, match="vocab <= 4194303"):
        tek.scatter_plan(257, 128, tek.MAX_VOCAB + 1)
    # the segments design: a count a (segment, row), the starts, the lists
    assert tek._segments_bytes(131072, 128) == 4 * (128 * 128 + 129
                                                    + 131072)
    assert tek._segments_bytes(0, 40) == 4 * 41
    assert tek._segments_bytes(5, 0) == 0


@pytest.mark.parametrize("n", [300, 3000])
def test_row_lists_hold_each_rows_positions_in_order(n):
    """The sort, rows and place passes: row v's list is the positions
    of id v, ascending; ids outside the table are in no list."""
    r = np.random.RandomState(n)
    vocab = 50
    ids = r.randint(-3, vocab + 3, n).astype(np.int32)
    ids[::7] = 4
    start, length, lists = tek._row_lists(torch.tensor(ids), vocab)
    for v in range(vocab):
        got = lists[start[v]:start[v] + length[v]].numpy()
        np.testing.assert_array_equal(got, np.flatnonzero(ids == v))
    assert lists.numel() == ((ids >= 0) & (ids < vocab)).sum()


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48, 96])
def test_columns_split_is_the_sequential_loop(dname, d):
    """Thousands of ids over 3 hot rows (each past SCATTER_HOT, over
    three 1,024-id chunks) and a few cold rows, d padded to 32, 64 or
    128 (one to four 32-column chains a hot row): equal to the
    definition and to the twin."""
    dtype = DTYPES[dname][0]
    n, vocab = 2500, 40
    ids = _hot_ids(n, vocab, seed=d)
    grad = _grad(n, d, dtype, seed=d + 1)
    assert tek.scatter_plan(n, tek.kernel_width("x", d), vocab)[0] \
        == "columns"
    counts = torch.bincount(ids.long(), minlength=vocab)
    assert (counts[:3] > tek.SCATTER_HOT).all()
    assert ((counts[3:] > 0) & (counts[3:] <= tek.SCATTER_HOT)).any()
    got = tek._columns_design_plain(grad, ids, vocab)
    assert got.dtype == dtype and got.shape == (vocab, d)
    assert torch.equal(got, _sequential(grad, ids, vocab))
    assert torch.equal(got, tek.scatter_add_plain(grad, ids, vocab))
    assert not got[counts == 0].any()


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_small_pass_is_the_sequential_loop(dname):
    """Up to SMALL_N ids: each row's ids found in position order, a row a
    chain over its columns (d = 48, padded to 64)."""
    dtype = DTYPES[dname][0]
    for n in (1, 200, 256):
        ids = torch.tensor(np.random.RandomState(n).randint(0, 30, n)
                           .astype(np.int32))
        grad = _grad(n, 48, dtype, seed=n)
        assert tek.scatter_plan(n, 64, 40)[0] == "small"
        got = tek._columns_design_plain(grad, ids, 40)
        assert torch.equal(got, _sequential(grad, ids, 40))
        assert torch.equal(got, tek.scatter_add_plain(grad, ids, 40))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [200, 300])
def test_columns_split_matches_jax(dname, n):
    """Against JAX's sequential Pallas kernel in interpret mode: the
    small pass (n = 200) and the columns route (n = 300, row 3 hot with
    150 ids), d = 16 padded to 32."""
    tdtype, jdtype = DTYPES[dname]
    vocab, d = 40, 16
    r = np.random.RandomState(n)
    ids = r.randint(0, 30, n).astype(np.int32)
    ids[::2] = 3
    grad = r.randn(n, d).astype(np.float32)
    want = np.asarray(jek._scatter_add_impl(
        jnp.asarray(grad, jdtype), jnp.asarray(ids), vocab=vocab),
        np.float32)
    got = tek._columns_design_plain(torch.tensor(grad).to(tdtype),
                                    torch.tensor(ids), vocab)
    assert tek.scatter_plan(n, 32, vocab)[0] == ("small" if n <= 256
                                                 else "columns")
    got = got.float().numpy()
    if dname == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert not got[30:].any()


def test_bf16_add_rounded_once_is_the_f32_sum_rounded():
    """The kernel adds two bf16 values with one fma.rn.bf16 (x * 1 +
    acc: their exact sum rounded once to bf16); the definition rounds
    their f32 sum to bf16.  Equal on pairs of every exponent spread from
    0 to 40, both signs, ties and near-ties."""
    r = np.random.RandomState(0)
    m = 200000
    a = r.randn(m) * 2.0 ** r.randint(-20, 20, m)
    b = r.randn(m) * 2.0 ** r.randint(-20, 20, m) * 2.0 ** -r.randint(0, 41,
                                                                        m)
    # pairs one bf16 half-ulp apart (an exact tie) and just off it
    half = np.ldexp(1.0, np.frexp(a)[1] - 9)
    b[: m // 4] = half[: m // 4] * r.choice([1, -1, 3, 1 + 2.0 ** -7],
                                            m // 4)
    ta = torch.tensor(a).to(torch.bfloat16)
    tb = torch.tensor(b).to(torch.bfloat16)
    exact = ta.double() + tb.double()      # exact: spreads below 44 bits
    mant, expo = np.frexp(exact.numpy())
    once = np.ldexp(np.rint(mant * 256.0) / 256.0, expo)   # half to even
    twice = (ta.float() + tb.float()).to(torch.bfloat16).double().numpy()
    np.testing.assert_array_equal(once, twice)


def test_scatter_kernel_path_never_runs_the_twin(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: never the
    twin or the plain composition, in either design, at a kernel width
    or a padded one; an unknown design, and a vocab past the sort key's
    22 bits, raise before anything is built."""
    def refuse(*_a, **_k):
        raise AssertionError("the plain twin ran off the CPU")

    class Built(Exception):
        pass

    def library(*_a, **_k):
        raise Built

    monkeypatch.setattr(tek, "scatter_add_plain", refuse)
    monkeypatch.setattr(tek, "_columns_design_plain", refuse)
    monkeypatch.setattr(build, "library", library)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    ids = torch.empty(3000, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tek.scatter_add(torch.empty(3000, 128, device="meta"), ids, 2048)
    for design in tek.SCATTER_DESIGNS:
        for d in (128, 48):
            for n in (3000, 100):
                with pytest.raises(Built):
                    tek._launch_scatter(torch.empty(n, d, device="meta"),
                                        ids[:n], 2048, design)
    with pytest.raises(ValueError, match="unknown design"):
        tek.scatter_add(torch.zeros(4, 16),
                        torch.zeros(4, dtype=torch.int32), 8,
                        _design="rows")
    with pytest.raises(ValueError, match="vocab <= "):
        tek._launch_scatter(torch.empty(3000, 128, device="meta"), ids,
                            tek.MAX_VOCAB + 1, "columns")
    assert tek.SCATTER_DESIGNS[0] == "columns"
