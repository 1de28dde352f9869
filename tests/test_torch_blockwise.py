"""The port's blockwise attention (past 1024 keys) against the JAX package.

`fused_attention_blockwise_plain`, the plain twin of the port's blockwise
CUDA kernel, against the JAX `fused_attention` (its
`_attn_kernel_blockwise`, Pallas in interpret mode, as
tests/test_pallas.py runs it) on the same numpy inputs, in the three
modes; the port's `reference_middle` and its autograd (the backward
above 1024 keys) against `jax.vjp` of JAX's `_reference_middle`.

Rows: one full, one whose live keys end inside the first 512-key block,
one with no live key.  That last row is pinned both ways: the port gives
it the unpadded reference's uniform weights over its Tk keys; the Pallas
kernel pads Tk to a multiple of 512 first and spreads the weight over the
padded (zero) keys too, so its output is sum(v) / padded Tk.

Tolerances: outputs within 1e-5 (f32) or 5e-3 (bf16: both packages
round each block's exp(s - m) to bf16 before @ v) of their largest
|value|; f32 gradients within 1e-4 of each leaf's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import attention_kernel as pk
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak

torch.set_num_threads(2)

D = 16
REL_F32, REL_BF16, REL_GRAD = 1e-5, 5e-3, 1e-4
MODES = ("plain", "time", "tisas")


def _inputs(tq, tk, seed=0):
    """q, k, v, t_q, t_k, tqw, rawk, five [Tq, Tk] gate params, key_len:
    numpy f32 (key_len int32) for three rows: full, 300 live keys, none."""
    r = np.random.RandomState(seed)
    b = 3
    hours = np.sort(r.rand(b, tk).astype(np.float32) * 3000, axis=1)
    t_q = (hours[:, :tq] if tq == tk
           else np.sort(r.rand(b, tq).astype(np.float32) * 3000, axis=1))
    arrays = [r.randn(b, tq, D), r.randn(b, tk, D), r.randn(b, tk, D),
              t_q, hours, r.randn(b, tq, D) * 0.3, r.randn(b, tk, D)]
    arrays += [r.randn(tq, tk) * 0.3 for _ in range(5)]
    return ([np.asarray(a, np.float32) for a in arrays]
            + [np.array([tk, 300, 0], np.int32)])


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax(mode, arrays, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in arrays[:-1]]
    return np.asarray(pk.fused_attention(mode, *args,
                                         jnp.asarray(arrays[-1]),
                                         pk.dm_dummy(dtype)))


def _port(mode, arrays, dtype=torch.float32):
    args = [torch.tensor(a).to(dtype) for a in arrays[:-1]]
    return tak.fused_attention_blockwise_plain(
        mode, *args, torch.tensor(arrays[-1])).numpy()


@pytest.mark.parametrize("tk", [1100, 1500])
@pytest.mark.parametrize("tq", [1, 8])
@pytest.mark.parametrize("mode", MODES)
def test_blockwise_twin_matches_pallas_f32(mode, tq, tk):
    arrays = _inputs(tq, tk)
    got, want = _port(mode, arrays), _jax(mode, arrays)
    assert got.shape == (3, tq, D)
    live = [0, 1]                        # the rows with a live key
    assert _rel(got[live], want[live]) <= REL_F32


@pytest.mark.parametrize("tq", [1, 8])
@pytest.mark.parametrize("mode", MODES)
def test_blockwise_twin_matches_pallas_bf16(mode, tq):
    arrays = _inputs(tq, 1500, seed=1)
    got = _port(mode, arrays, torch.bfloat16)
    want = _jax(mode, arrays, jnp.bfloat16)
    live = [0, 1]
    assert _rel(got[live], want[live]) <= REL_BF16
    # the blockwise rounding is the kernel's own: it is not the single
    # tile's "normalise, then round the weights"
    single = tak.fused_attention_plain(
        mode, *[torch.tensor(a).to(torch.bfloat16) for a in arrays[:-1]],
        torch.tensor(arrays[-1])).numpy()
    assert not np.array_equal(got[live], single[live])


@pytest.mark.parametrize("mode", MODES)
def test_key_len_zero_row_both_ways(mode):
    tk = 1100
    arrays = _inputs(8, tk, seed=2)
    got = _port(mode, arrays)
    ref = np.asarray(pk._reference_middle(
        mode, *[jnp.asarray(a) for a in arrays[:-1]], jnp.asarray(arrays[-1])))
    # the port: the unpadded reference's uniform weights, on every row
    assert _rel(got, ref) <= REL_F32
    np.testing.assert_allclose(got[2], np.broadcast_to(
        arrays[2][2].mean(0), got[2].shape), rtol=0, atol=1e-5)
    # Pallas: Tk padded to 1536, the row's weight spread over 1536 keys
    pallas = _jax(mode, arrays)
    np.testing.assert_allclose(pallas[2], np.broadcast_to(
        arrays[2][2].sum(0) / 1536, pallas[2].shape), rtol=0, atol=1e-5)
    assert _rel(got[2], pallas[2]) > 0.2


@pytest.mark.parametrize("mode", MODES)
def test_reference_middle_and_its_backward_match_jax_vjp(mode):
    """`reference_middle` under autograd against jax.vjp of JAX's
    `_reference_middle`; and `fused_attention_vjp` at Tk = 1100, whose
    forward is the blockwise twin and whose backward is that recompute
    (counted in dense_bwd), gives the same gradients."""
    arrays = _inputs(8, 1100, seed=3)
    g = np.random.RandomState(4).randn(3, 8, D).astype(np.float32)
    diff = (0, 1, 2, 5, 6, 7, 8, 9, 10, 11)       # q k v tqw rawk gates
    jargs = [jnp.asarray(a) for a in arrays]

    def jfn(*xs):
        full = list(jargs)
        for i, x in zip(diff, xs):
            full[i] = x
        return pk._reference_middle(mode, *full)

    want, vjp = jax.vjp(jfn, *[jargs[i] for i in diff])
    jgrads = vjp(jnp.asarray(g))
    for route in ("reference", "vjp"):
        leaves = [torch.tensor(a) for a in arrays]
        for i in diff:
            leaves[i].requires_grad_(True)
        before = tak.dense_bwd[mode]
        if route == "reference":
            out = tak.reference_middle(mode, *leaves)
        else:
            out = tak.fused_attention_vjp(mode, *leaves)
        assert _rel(out.detach().numpy(), want) <= REL_F32
        out.backward(torch.tensor(g))
        assert tak.dense_bwd[mode] == before + (route == "vjp")
        for i, jg in zip(diff, jgrads):
            got = leaves[i].grad
            if mode != "time" and i > 2:     # no dependence outside time
                assert got is None or not got.any(), (route, i)
                continue
            assert _rel(got.numpy(), jg) <= REL_GRAD, (route, i)
