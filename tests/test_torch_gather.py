"""The port's embedding gather / scatter-add pair against the JAX package.

`gather_plain` and `scatter_add_plain`, the plain twins of the port's
CUDA kernels (csrc/embedding_gather.cu), against the JAX `gather` and its
gradient, the sequential `_scatter_kernel` (Pallas in interpret mode), on
the same numpy inputs with duplicate ids and rows no id names; and
`behavior_embedding(gather=embedding_kernel.gather)` against its default
lookup, `take_dtable`.

Tolerances: f32 equal (both add each row's cotangents one at a time in
position order); bf16 within one bf16 ulp of JAX's value, per element
(JAX's interpret mode adds two bf16 rows in its own way; the port adds
in f32 and rounds after every add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import embedding_kernel as jek
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.ops import embedding as temb
from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as tek

torch.set_num_threads(2)

V, D = 40, 16


def _ids(seed, shape=(6, 9)):
    """Ids in [0, 30) (rows 30-39 untouched), id 3 in every fourth slot."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, 30, shape).astype(np.int32)
    ids.reshape(-1)[::4] = 3
    return ids


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.where(x > 0, x, 1)))
                                   - 7), 0.0)


def test_gather_and_its_gradient_match_jax_f32():
    r = np.random.RandomState(0)
    table = r.randn(V, D).astype(np.float32)
    ids = _ids(1)
    w = r.randn(*ids.shape, D).astype(np.float32)
    want = np.asarray(jek.gather(jnp.asarray(table), jnp.asarray(ids)))
    jgrad = np.asarray(jax.grad(lambda t: jnp.sum(
        jek.gather(t, jnp.asarray(ids)) * w))(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    got = tek.gather(t, torch.tensor(ids))
    assert got.shape == (*ids.shape, D)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), jgrad)
    assert not t.grad[30:].any() and t.grad[3].abs().sum() > 0


@pytest.mark.parametrize("n", [1, 17, 200])
def test_scatter_add_plain_matches_jax_f32(n):
    r = np.random.RandomState(n)
    grad = r.randn(n, D).astype(np.float32)
    ids = _ids(n, (n,))
    want = np.asarray(jek._scatter_add_impl(jnp.asarray(grad),
                                            jnp.asarray(ids), vocab=V))
    got = tek.scatter_add_plain(torch.tensor(grad), torch.tensor(ids), V)
    assert got.dtype == torch.float32 and got.shape == (V, D)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_add_plain_matches_jax_bf16_within_one_ulp():
    r = np.random.RandomState(5)
    n = 240
    grad = r.randn(n, D).astype(np.float32)
    ids = _ids(6, (n,))
    want = np.asarray(jek._scatter_add_impl(
        jnp.asarray(grad, jnp.bfloat16), jnp.asarray(ids), vocab=V),
        np.float32)
    got = tek.scatter_add_plain(torch.tensor(grad).to(torch.bfloat16),
                                torch.tensor(ids), V)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    # rounding after every add is not dtable's "sum in f32, round once"
    once = tek.dtable_plain(torch.tensor(grad).to(torch.bfloat16),
                            torch.tensor(ids), V).float().numpy()
    assert not np.array_equal(got, once)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_plain_is_the_sequential_loop(dtype):
    """The rank-by-rank twin against the definition, one id at a time."""
    r = np.random.RandomState(7)
    n = 300
    grad = torch.tensor(r.randn(n, D).astype(np.float32)).to(dtype)
    ids = torch.tensor(r.randint(0, 12, n).astype(np.int32))
    want = torch.zeros((V, D), dtype=dtype)
    for i in range(n):
        want[ids[i]] = (want[ids[i]].float() + grad[i].float()).to(dtype)
    assert torch.equal(tek.scatter_add_plain(grad, ids, V), want)


def test_wrappers_check_ids_and_shapes():
    table = torch.zeros((V, D))
    with pytest.raises(ValueError, match="ids must lie"):
        tek.gather_rows(table, torch.tensor([0, V], dtype=torch.int32))
    with pytest.raises(ValueError, match="ids must lie"):
        tek.scatter_add(torch.zeros((2, D)),
                        torch.tensor([-1, 0], dtype=torch.int32), V)
    with pytest.raises(TypeError, match="int32"):
        tek.gather_rows(table, torch.tensor([0, 1]))
    empty = tek.scatter_add(torch.zeros((0, D)),
                            torch.zeros((0,), dtype=torch.int32), V)
    assert empty.shape == (V, D) and not empty.any()


def _batch(seed=3, b=4, L=7):
    r = np.random.RandomState(seed)
    arrays = {"user_id": r.randint(1, 20, b), "items": r.randint(0, 60, (b, L)),
              "cats": r.randint(0, 8, (b, L)),
              "positions": np.tile(np.arange(L), (b, 1)),
              "times": r.rand(b, L) * 100, "time_last": r.rand(b, L),
              "time_now": r.rand(b, L), "target_id": r.randint(1, 60, b),
              "target_cat": r.randint(1, 8, b), "target_time": r.rand(b),
              "seq_len": np.full(b, L), "valid": np.ones(b)}
    ints = ("user_id", "items", "cats", "positions", "target_id",
            "target_cat", "seq_len")
    return ttypes.batch_from_numpy(
        {k: v.astype(np.int32 if k in ints else np.float32)
         for k, v in arrays.items()}, device="cpu")


def test_behavior_embedding_gather_seam_matches_the_default():
    meta = ttypes.DatasetMeta(20, 60, 5, 7)
    params = temb.init_behavior_embedding(torch.Generator().manual_seed(0),
                                          meta, D)
    batch = _batch()
    outs, grads = [], []
    for gather in (None, tek.gather):
        p = temb.BehaviorEmbedding({k: v.clone() for k, v in params.items()})
        e = temb.behavior_embedding(p, batch, gather=gather)
        w = torch.linspace(-1, 1, e.behavior_emb.numel()).reshape(
            e.behavior_emb.shape)
        ((e.behavior_emb * w).sum() + e.user_emb.square().sum()
         + e.cat_emb.sum()).backward()
        outs.append(e)
        grads.append({n: q.grad for n, q in p.named_parameters()})
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
