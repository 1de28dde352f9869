"""The embedding table gradient `dtable` against the JAX package.

On CPU tensors `dtable` runs its plain twin `dtable_plain` (an f32
index_add_, rounded once to the cotangent's type); chip_smoke.py holds
the CUDA kernel (csrc/embedding_dtable.cu) against the same twin on the
card.  Here, at step-like ragged ids (half of them the padding id 0, a
repeated position pattern, item-like ids, a table of 300 rows: a ragged
128-row tile), the twin is held against JAX's Pallas `_dtable_impl` (in
interpret mode, as tests/test_torch_kernels.py runs it) and against
`jax.vjp` of `jnp.take`; past one Pallas chunk in bf16 against JAX's
one-hot route; and the kernel's launch plan (`dtable_plan`), which the
CPU can reach, at its edges.

Tolerances: f32 within 1e-5 of the largest |value| (the same f32 numbers
summed in other orders).  In bf16 two routes that sum in f32 and round
once may differ by one bf16 ulp of an element (2**-7 of its value) where
their f32 sums straddle a rounding boundary, plus 1e-5 of the largest
|value| where a sum cancels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops import embedding as jemb
from mtamrecommender_tpu.ops.pallas import embedding_kernel as jek
from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as tek

torch.set_num_threads(2)

ATOL_F32 = 1e-5
BF16_ULP = 2.0 ** -7


def _step_ids(n, vocab, seed):
    """A position pattern (1..100, repeated), 30 % of the entries item-like
    ids above it, then half of all entries the padding id 0."""
    r = np.random.RandomState(seed)
    ids = np.resize(np.arange(1, 101), n).astype(np.int32)
    item = r.rand(n) < 0.3
    ids[item] = r.randint(101, vocab, item.sum())
    ids[r.rand(n) < 0.5] = 0
    return ids


def _inputs(n, d, vocab, dtype, seed=0):
    ids = _step_ids(n, vocab, seed)
    ct = torch.tensor(np.random.RandomState(seed + 1).randn(n, d)
                      .astype(np.float32)).to(dtype)
    jct = jnp.asarray(ct.float().numpy(), jnp.bfloat16
                      if dtype == torch.bfloat16 else jnp.float32)
    return ids, ct, jct


def _assert_one_rounding_apart(got, want):
    """bf16: at most one ulp of each element apart (see the module note)."""
    scale = np.abs(want).max()
    assert np.all(np.abs(got - want)
                  <= BF16_ULP * np.abs(want) + ATOL_F32 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtable_twin_matches_jax_at_step_like_shapes(dtype):
    n, d, vocab = 5000, 32, 300
    ids, ct, jct = _inputs(n, d, vocab, dtype)
    before = dict(tek.launches)
    got = tek.dtable(ct, torch.tensor(ids), vocab)
    assert tek.launches == before            # the CPU runs the twin
    assert got.dtype == dtype and got.shape == (vocab, d)
    got = got.float().numpy()
    # one Pallas chunk at this size: the kernel rounds once, as the twin
    assert jek._chunk_for(n, d, ct.element_size()) >= n
    pallas = np.asarray(jek._dtable_impl(jct, jnp.asarray(ids), vocab),
                        np.float32)
    unnamed = np.setdiff1d(np.arange(vocab), ids)
    assert unnamed.size and not got[unnamed].any()
    if dtype == torch.bfloat16:
        _assert_one_rounding_apart(got, pallas)
        return
    scale = np.abs(pallas).max()
    np.testing.assert_allclose(got, pallas, atol=ATOL_F32 * scale, rtol=0)
    # jnp.take's own backward (XLA's scatter-add): in f32 only, since in
    # bf16 it rounds after every add (the scatter_add kernel's semantics)
    table = jnp.zeros((vocab, d), jnp.float32)
    take = jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids), axis=0),
                   table)[1](jct)[0]
    np.testing.assert_allclose(got, np.asarray(take), atol=ATOL_F32 * scale,
                               rtol=0)


def test_dtable_bf16_past_one_chunk_follows_the_onehot_route():
    """At d = 128 and n = 20,480 the Pallas kernel takes 2,048-id chunks
    and rounds its bf16 running sum after each of the 10; JAX's default
    route at the main paths' sizes, the one-hot matmul
    (`_take_onehot_bwd`), sums in f32 and rounds once, as the port does.
    The port is held to the one-hot route; its gap to the Pallas route is
    reported and bounded by one bf16 ulp of the largest |value| a chunk
    (10 * 2**-7), and some elements lie more than one rounding apart."""
    n, d, vocab = 20480, 128, 300
    ids, ct, jct = _inputs(n, d, vocab, torch.bfloat16, seed=3)
    chunks = -(-n // jek._chunk_for(n, d, 2))
    assert chunks == 10
    got = tek.dtable(ct, torch.tensor(ids), vocab).float().numpy()
    table = jnp.zeros((vocab, d), jnp.bfloat16)
    onehot = np.asarray(jax.vjp(
        lambda t: jemb._take_onehot_bwd(t, jnp.asarray(ids)), table)[1](
            jct)[0], np.float32)
    _assert_one_rounding_apart(got, onehot)
    pallas = np.asarray(jek._dtable_impl(jct, jnp.asarray(ids), vocab),
                        np.float32)
    scale = np.abs(onehot).max()
    gap = np.abs(got - pallas).max() / scale
    print(f"bf16 dtable, {chunks} Pallas chunks: port vs Pallas route "
          f"{gap:.3e} of the largest |value| (bound {chunks * BF16_ULP:.3e})")
    assert gap <= chunks * BF16_ULP
    assert np.any(np.abs(got - pallas)
                  > BF16_ULP * np.abs(pallas) + ATOL_F32 * scale)


D = 128


@pytest.mark.parametrize("n,chunk", [
    (0, 0), (1, 0), (tek.SMALL_N, 0),       # one pass, no workspace
    (tek.SMALL_N + 1, 256),                 # past it, the small chunk
    (128 * 256, 256),                       # one wave of 128 blocks
    (128 * 256 + 1, 1024), (128 * 1024, 1024),  # past it, the large one
    (128 * 1024 + 1, 1024), (524288, 1024)])
def test_dtable_plan_picks_the_chunk_and_sizes_the_workspace(n, chunk):
    got_chunk, ws_bytes = tek.dtable_plan(n, D, 3712)
    assert got_chunk == chunk
    if chunk == 0:
        assert ws_bytes == 0
        return
    chunks = -(-n // chunk)
    assert chunks <= tek.WAVE_BLOCKS or chunk == tek.CHUNKS[-1]
    # f32 partial rows for up to n distinct (chunk, id) pairs, their ids,
    # one count a chunk
    assert ws_bytes == 4 * (n * D + n + chunks)


@pytest.mark.parametrize("vocab", [0, 1, tek.MAX_VOCAB])
def test_dtable_plan_takes_any_vocab_up_to_the_key_bound(vocab):
    assert tek.dtable_plan(5000, D, vocab)[0] == 256


def test_dtable_plan_refuses_a_vocab_above_the_key_bound():
    # the sort key is id << log2(1024) | position in 32 bits
    assert tek.MAX_VOCAB == (1 << (32 - 10)) - 1
    with pytest.raises(ValueError, match="vocab <= 4194303"):
        tek.dtable_plan(5000, D, tek.MAX_VOCAB + 1)


@pytest.mark.parametrize("n,vocab", [(0, 7), (0, 0), (3, 0)])
def test_dtable_empty_edges(n, vocab):
    ids = torch.zeros(n, dtype=torch.int32)
    if n and not vocab:
        with pytest.raises(ValueError, match=r"\[0, 0\)"):
            tek.dtable(torch.ones((n, 32)), ids, vocab)
        return
    out = tek.dtable(torch.ones((n, 32)), ids, vocab)
    assert out.shape == (vocab, 32) and not out.any()
