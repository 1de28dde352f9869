"""The five layer helpers no model calls (`sequential_average_pooling`,
`sequential_max_pooling`, `prelu`, `dice`, `gelu`) against the JAX
package's, outputs and input gradients, in f32 within 1e-6 of each
array's largest |value|, but for `gelu`'s input gradient, held within
1e-5: torch's gelu backward evaluates the tanh approximation's
derivative in closed form, JAX differentiates the forward's ops, and the
two differ by a few f32 ulps of the largest gradient.  A one-element
gradient (a scalar alpha's) is one sum over every element, whose last
digits the summation order sets: where it misses, it must be no farther
from JAX's float64 value than JAX's f32 value is, plus 1e-6 of it (as
tests/test_torch_multihead.py holds scalar gates).  Inputs are made
with numpy from a seed, with ragged lengths, a row of length 0 and one
of the full length.

Kept quirks: average pooling divides by the padded length L, max pooling
fills padding with -2^32+1 (a row of length 0 gives that fill), and
`gelu` is the tanh approximation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops import layers as jl
from mtamrecommender_tpu_torch.ops import layers as tl

torch.set_num_threads(2)

REL = 1e-6
REL_GELU_GRAD = 1e-5
B, L, D = 5, 7, 6
LENGTHS = np.array([3, 0, 7, 1, 5], np.int32)


def _hold(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _jax_grads(jfn, arrays, grad_of, w, dtype):
    jargs = [jnp.asarray(a).astype(dtype) if a.dtype == np.float32
             else jnp.asarray(a) for a in arrays]

    def jloss(*diff):
        args = list(jargs)
        for i, a in zip(grad_of, diff):
            args[i] = a
        out = jfn(*args)
        return jnp.sum(out * w.astype(dtype)), out

    (_, out), grads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(grad_of))), has_aux=True)(
        *[jargs[i] for i in grad_of])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _both(jfn, tfn, *arrays, grad_of=(0,), grad_rel=REL):
    """Outputs of ``jfn`` and ``tfn`` on ``arrays`` and the gradients of
    sum(out * w) with respect to the arrays at ``grad_of``."""
    w = np.random.RandomState(9).randn(
        *np.shape(jfn(*[jnp.asarray(a) for a in arrays]))).astype(np.float32)
    want, jgrads = _jax_grads(jfn, arrays, grad_of, w, jnp.float32)
    targs = [torch.tensor(a) for a in arrays]
    for i in grad_of:
        targs[i].requires_grad_(True)
    got = tfn(*targs)
    (got * torch.tensor(w)).sum().backward()
    _hold(got, want)
    for k, (i, g) in enumerate(zip(grad_of, jgrads)):
        mine = targs[i].grad.numpy()
        scale = max(np.abs(g).max(), 1e-30)
        if g.size == 1 and np.abs(mine - g).max() > grad_rel * scale:
            with jax.enable_x64(True):
                exact = _jax_grads(jfn, arrays, grad_of, w, jnp.float64)[1][k]
            assert np.abs(mine - exact).max() <= (
                np.abs(g - exact).max() + grad_rel * scale)
            continue
        _hold(targs[i].grad, g, grad_rel)
    return got


def test_sequential_average_pooling_divides_by_the_padded_length():
    seq = np.random.RandomState(1).randn(B, L, D).astype(np.float32)
    got = _both(jl.sequential_average_pooling, tl.sequential_average_pooling,
                seq, LENGTHS)
    want = seq[0, :3].sum(0) / L
    np.testing.assert_allclose(got[0].detach().numpy(), want, rtol=1e-6)
    assert not got[1].any()                 # a row of length 0


def test_sequential_max_pooling_fills_padding():
    seq = np.random.RandomState(2).randn(B, L, D).astype(np.float32) - 3.0
    got = _both(jl.sequential_max_pooling, tl.sequential_max_pooling,
                seq, LENGTHS)
    np.testing.assert_array_equal(got[0].detach().numpy(),
                                  seq[0, :3].max(0))
    # a row of length 0 gives the fill, -2^32+1
    assert (got[1] == -(2.0 ** 32) + 1.0).all()


@pytest.mark.parametrize("alpha_shape", [(), (D,)])
def test_prelu(alpha_shape):
    r = np.random.RandomState(3)
    x = r.randn(B, L, D).astype(np.float32)
    x[0, 0, 0] = 0.0                          # the kink
    alpha = np.asarray(r.rand(*alpha_shape), np.float32)
    _both(jl.prelu, tl.prelu, x, alpha, grad_of=(0, 1))


@pytest.mark.parametrize("axis", [-1, 1])
def test_dice(axis):
    r = np.random.RandomState(4)
    x = (r.randn(B, L, D) * 2 + 0.5).astype(np.float32)
    alpha = r.rand(D).astype(np.float32)
    if axis == 1:
        alpha = alpha[:1].reshape(1)
    _both(lambda a, b: jl.dice(a, b, axis=axis),
          lambda a, b: tl.dice(a, b, axis=axis), x, alpha, grad_of=(0, 1))


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, B * L * D, dtype=np.float32).reshape(B, L, D)
    got = _both(jl.gelu, tl.gelu, x, grad_rel=REL_GELU_GRAD)
    exact = torch.nn.functional.gelu(torch.tensor(x))
    assert not torch.allclose(got, exact, atol=1e-6, rtol=0)
