"""Multi-head attention in the port: the three variants at h = 2 and 4
against the JAX package's jnp path.

The Pallas kernels take one head (`attention_kernel.supported`), so at
h > 1 JAX computes attention on its jnp path, in training and serving,
and the port takes its dense route (`dense_attention`: heads on an
einsum axis of their own), counted in ``dense_fwd``.  Each case runs one
block with distinct queries and keys, Tq = Tk = 7, d = 8h, ragged key
lengths (one row with a single live key) and one row with
``query_len = 0``; the outputs and the gradients of sum(out * w_out)
with respect to the queries, the keys and every block parameter are
held.  Plain and TiSAS attention drop weights at rate 0.5: JAX's mask is
the bernoulli draw `layers.dropout` makes on the [B, h, Tq, Tk] weights
from the call's rng, rebuilt here and handed to the port as its mask
source.  The time kind runs with positional and scalar gates.

Tolerances (tests/test_torch_train.py's): f32 within 1e-5 of each
array's largest |value|; under bf16 (parameters and inputs cast, as the
models' compute cast does) each array no farther from JAX's bf16 array
than JAX's bf16 array is from its f32 one, plus 5e-2 of the f32 array's
largest |value| (`torch_zoo_parity.check_bf16`'s rule).  A scalar
gate's gradient is one sum over B * Tq * Tk terms that nearly cancel
(ROADMAP.md, Queue 3, settled items 3 and 4), so JAX's own rounding
sets its last digits: where such a leaf misses the rule above, the port
must be no farther from exact math (JAX's jnp path in float64) than
JAX's f32 leaf is, plus 1e-5 of it; under bf16, no farther from JAX's
f32 leaf than JAX's bf16 leaf is, plus 5e-2 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu_torch.bridge import params_from_jax
from mtamrecommender_tpu_torch.ops import attention as tatt
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak

from test_torch_attention_models import _port_block

torch.set_num_threads(2)

B, T = 6, 7
REL_F32 = 1e-5
REL_BF16 = 5e-2
KEY_LEN = np.array([T, 1, 3, T, 5, 6], np.int32)
QUERY_LEN = np.array([T, 4, 0, 7, 2, 5], np.int32)   # row 2: no live query
RATE = 0.5
CASES = [(kind, h, gate) for h in (2, 4)
         for kind, gate in (("plain", None), ("tisas", None),
                            ("time", "positional"), ("time", "scalar"))]


def _jax_block(kind, d, gate, seed=4):
    return jax.device_get(jatt.init_attention_stack(
        jax.random.PRNGKey(seed), 1, d, kind=kind, t_q_len=T, t_k_len=T,
        gate_mode=gate or "positional")[0])


def _inputs(d, seed):
    r = np.random.RandomState(seed)
    t_q = np.sort(r.rand(B, T).astype(np.float32) * 300, axis=1)
    t_k = np.sort(r.rand(B, T).astype(np.float32) * 300, axis=1)
    return dict(q=r.randn(B, T, d).astype(np.float32),
                k=r.randn(B, T, d).astype(np.float32), t_q=t_q, t_k=t_k,
                w_out=r.randn(B, T, d).astype(np.float32))


def jax_heads_mask(rng, shape, rate=RATE):
    """The mask JAX's jnp path applies to its [B, h, Tq, Tk] weights
    (`layers.dropout`): bernoulli(rng, 1 - rate, shape), as f32 0 or
    1/(1 - rate)."""
    keep = 1.0 - rate
    kept = jax.random.bernoulli(rng, keep, shape)
    return torch.tensor(np.asarray(kept, np.float32) / keep)


def _jax(kind, jblock, x, h, dtype, rng):
    """JAX's output and the gradients of sum(out * w_out) with respect to
    the block, the queries and the keys, on the jnp path (the Pallas
    route refuses h > 1); in ``dtype`` with f32 cotangents."""
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731

    def loss(p, q, k):
        kw = dict(num_heads=h, dropout_rate=RATE, train=True, rng=rng)
        lens = (jnp.asarray(KEY_LEN), jnp.asarray(QUERY_LEN))
        if kind == "plain":
            out, _ = jatt.multihead_attention(p, q, k, *lens, **kw)
        else:
            fn = (jatt.time_aware_multihead_attention if kind == "time"
                  else jatt.tisas_multihead_attention)
            out, _ = fn(p, q, k, *lens, cast(x["t_q"]), cast(x["t_k"]),
                        **kw)
        return jnp.sum(out.astype(jnp.float32) * x["w_out"]), out

    p = jax.tree.map(cast, jblock)
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        p, cast(x["q"]), cast(x["k"]))
    jgp, jgq, jgk = jax.device_get(grads)
    want = {"out": out, "queries": jgq, "keys": jgk,
            **params_from_jax(jgp)}
    return {n: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for n, v in want.items()}


def _port(kind, jblock, x, h, dtype, masks):
    """The port's output and gradients, as `_jax` returns them."""
    block = _port_block(jblock, kind).to(dtype)
    q = torch.tensor(x["q"]).to(dtype).requires_grad_(True)
    k = torch.tensor(x["k"]).to(dtype).requires_grad_(True)
    lens = (torch.tensor(KEY_LEN), torch.tensor(QUERY_LEN))
    if kind == "time":
        out = tatt.time_aware_multihead_attention(
            block, q, k, *lens, torch.tensor(x["t_q"]).to(dtype),
            torch.tensor(x["t_k"]).to(dtype), num_heads=h)
    else:
        kw = dict(num_heads=h, dropout_rate=RATE, train=True,
                  gen=iter(masks))
        if kind == "plain":
            out = tatt.multihead_attention(block, q, k, *lens, **kw)
        else:
            out = tatt.tisas_multihead_attention(
                block, q, k, *lens, torch.tensor(x["t_q"]).to(dtype),
                torch.tensor(x["t_k"]).to(dtype), **kw)
    assert out.dtype == dtype and out.shape == q.shape
    (out.float() * torch.tensor(x["w_out"])).sum().backward()
    got = {"out": out, "queries": q.grad, "keys": k.grad,
           **{n: p.grad for n, p in block.named_parameters()}}
    return {n: v.detach().float().numpy() for n, v in got.items()}


def _case(kind, h, gate, dtype_pair, seed=0):
    d = 8 * h
    jblock = _jax_block(kind, d, gate)
    x = _inputs(d, seed)
    rng = jax.random.PRNGKey(21 + seed)
    masks = [jax_heads_mask(rng, (B, h, T, T))]
    jdt, tdt = dtype_pair
    return (_jax(kind, jblock, x, h, jdt, rng),
            _port(kind, jblock, x, h, tdt, masks))


def _jax_f64(kind, h, gate, seed=0):
    """JAX's jnp path in float64 on `_case`'s inputs: exact math to f32's
    eyes.  Time kind only (the others' masks are drawn in f32)."""
    assert kind == "time"
    x = _inputs(8 * h, seed)
    with jax.enable_x64(True):
        jblock = jax.tree.map(lambda a: np.asarray(a, np.float64),
                              _jax_block(kind, 8 * h, gate))
        return _jax(kind, jblock, {k: v.astype(np.float64)
                                   for k, v in x.items()},
                    h, jnp.float64, None)


def _hold_f32(got, want, exact=None):
    """Every array within REL_F32 of its largest |value|; a scalar leaf
    that misses, against ``exact()`` (`_jax_f64`) as the docstring says.
    Returns the scalar leaves held that way."""
    assert set(got) == set(want)
    by_exact = []
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        scale = max(np.abs(w).max(), 1e-30)
        if np.abs(got[name] - w).max() <= REL_F32 * scale:
            continue
        assert w.ndim == 0 and exact is not None, name
        x = exact()[name]
        assert abs(got[name] - x) <= abs(w - x) + REL_F32 * scale, name
        by_exact.append(name)
    return by_exact


@pytest.mark.parametrize("kind,h,gate", CASES)
def test_variants_match_jax_f32(kind, h, gate):
    counts = dict(tak.dense_fwd)
    want, got = _case(kind, h, gate, (jnp.float32, torch.float32))
    by_exact = _hold_f32(got, want, lambda: _jax_f64(kind, h, gate))
    assert gate == "scalar" or not by_exact
    # one dense-route call, in the variant's mode, and no kernel route
    mode = kind if kind == "time" else f"{kind}_drop"
    assert tak.dense_fwd[mode] == counts[mode] + 1
    # the row without a live query keeps its residual and normalize only
    assert np.abs(got["out"][2]).sum() > 0


@pytest.mark.parametrize("kind,h,gate", [c for c in CASES if c[1] == 2])
def test_variants_match_jax_bf16(kind, h, gate):
    want, got = _case(kind, h, gate, (jnp.bfloat16, torch.bfloat16), seed=1)
    want32, _ = _case(kind, h, gate, (jnp.float32, torch.float32), seed=1)
    assert set(got) == set(want)
    for name, w in want.items():
        w32 = want32[name]
        assert np.isfinite(got[name]).all(), name
        slack = REL_BF16 * np.abs(w32).max()
        if np.abs(got[name] - w).max() <= slack + np.abs(w - w32).max():
            continue
        assert gate == "scalar" and w.ndim == 0, name
        assert abs(got[name] - w32) <= abs(w - w32) + slack, name


@pytest.mark.parametrize("kind", ["plain", "tisas"])
def test_the_heads_mask_matters(kind):
    """Each head drops its own weights: the port given JAX's [B, h, Tq,
    Tk] mask matches JAX (above), and with every head given head 0's
    mask it does not."""
    h, d = 2, 16
    jblock = _jax_block(kind, d, None)
    x = _inputs(d, 0)
    rng = jax.random.PRNGKey(21)
    mask = jax_heads_mask(rng, (B, h, T, T))
    assert not torch.equal(mask[:, 0], mask[:, 1])
    same = mask[:, :1].expand(B, h, T, T).contiguous()
    want = _jax(kind, jblock, x, h, jnp.float32, rng)
    got = _port(kind, jblock, x, h, torch.float32, [same])
    assert np.abs(got["out"] - want["out"]).max() > 1e-3


@pytest.mark.parametrize("kind", ["plain", "tisas"])
def test_drop_mask_drawn_with_a_head_axis(kind):
    """With a generator the call draws one f32 [B, h, Tq, Tk] mask; an
    injected mask of the one-head shape is refused."""
    h, d = 2, 16
    block = _port_block(_jax_block(kind, d, None), kind)
    x = torch.tensor(_inputs(d, 0)["q"])
    lens = torch.tensor(KEY_LEN)
    fn = (tatt.multihead_attention if kind == "plain"
          else lambda *a, **k: tatt.tisas_multihead_attention(
              *a, torch.zeros(B, T), torch.zeros(B, T), **k))
    kw = dict(num_heads=h, dropout_rate=RATE, train=True)
    a = fn(block, x, x, lens, lens, gen=torch.Generator().manual_seed(5),
           **kw)
    from mtamrecommender_tpu_torch.ops import layers as tlayers
    mask = tlayers.draw_drop_mask(torch.Generator().manual_seed(5), B, T, T,
                                  RATE, "cpu", num_heads=h)
    assert mask.shape == (B, h, T, T)
    b = fn(block, x, x, lens, lens, gen=iter([mask]), **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="drop mask"):
        fn(block, x, x, lens, lens, gen=iter([mask[:, 0]]), **kw)


@pytest.mark.parametrize("kind", ["plain", "time", "tisas"])
def test_heads_that_do_not_divide_d_raise(kind):
    d = 16
    block = _port_block(_jax_block(kind, d, "positional"), kind)
    x = torch.zeros((B, T, d))
    lens = torch.tensor(KEY_LEN)
    t = torch.zeros((B, T))
    with pytest.raises(ValueError, match="num_heads=3"):
        if kind == "plain":
            tatt.multihead_attention(block, x, x, lens, lens, num_heads=3)
        elif kind == "tisas":
            tatt.tisas_multihead_attention(block, x, x, lens, lens, t, t,
                                           num_heads=3)
        else:
            tatt.time_aware_multihead_attention(block, x, x, lens, lens, t,
                                                t, num_heads=3)


def test_route_takes_the_dense_route_past_one_head():
    assert tak.route(50, False, 1) == "single_tile"
    assert tak.route(2048, False, 1) == "blockwise"
    for tk in (1, 50, 1024, 2048):
        for drop in (False, True):
            assert tak.route(tk, drop, 2) == "dense"
    assert not tak.supported(50, 2)
