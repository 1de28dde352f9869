"""The Tq = 1 readout (`vanilla_attention_stack`) at two heads, in the
time and plain kinds, against the JAX package.

The readout kernels take one head (JAX's `readout_kernel.supported`,
`readout_chain_kernel.supported`, `attention_kernel.supported`), so at
h = 2 JAX trains through its hop-batched jnp readout
(`_fused_single_query_readout`) at every length and serves hop by hop on
its jnp path.  The port does the same: training through
`single_query_readout` (time kind) or `plain_single_query_readout`
(plain kind), serving through the attention variants on the dense
route, one `dense_fwd` call a hop.  At L = 300, where one head's time
readout takes the fused readout kernel, the readout stacks and every
kernel wrapper are replaced by stand-ins that raise, as in
tests/test_torch_plain_readout.py.  In serving JAX runs both of its
routes (use_pallas False: its hop-batched readout; True: hop by hop);
in training both take the same hop-batched readout at h > 1, held once.
The plain kind drops at rate 0.5 in
training with JAX's per-hop masks rebuilt from its rng: hop i's
bernoulli on the [B, h, 1, Tk] weights from fold_in(rng, i).

Inputs are made with numpy from a seed: B=8, d=16, 2 hops, ragged key
lengths, one masked query.  Tolerances: f32 within 1e-5 of each array's
largest |value|; a scalar gate's gradient, a sum of B * Tk terms a hop
that nearly cancel, as tests/test_torch_multihead.py holds it (against
JAX in float64 where it misses).
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

from test_torch_multihead import _hold_f32, _port_block, jax_heads_mask

torch.set_num_threads(2)

B, D, HOPS, H = 8, 16, 2, 2
REL_F32 = 1e-5
RATE = 0.5
# (L, kind, gate): the positional gate at L = 12, the scalar gate (the
# long-history runs') at L = 300
CASES = [(12, "plain", None), (12, "time", "positional"),
         (300, "plain", None), (300, "time", "scalar")]


def _inputs(L, seed=0):
    r = np.random.RandomState(seed)
    key_len = np.array([L, 1, 3, L - 2, L, 7, L // 2, 2], np.int32)
    qlen = np.ones((B,), np.int32)
    qlen[3] = 0                                        # a masked query
    t_keys = np.sort(r.rand(B, L).astype(np.float32) * 500, axis=1)
    return dict(enc=r.randn(B, L, D).astype(np.float32),
                dec=r.randn(B, 1, D).astype(np.float32),
                key_len=key_len, qlen=qlen, t_keys=t_keys,
                t_q=t_keys.max(1, keepdims=True) + 3.0,
                w_out=r.randn(B, D).astype(np.float32))


def _blocks(kind, gate, L, seed=4):
    jp = jax.device_get(jatt.init_attention_stack(
        jax.random.PRNGKey(seed), HOPS, D, kind=kind, t_q_len=1, t_k_len=L,
        gate_mode=gate or "positional"))
    return jp, torch.nn.ModuleList(_port_block(b, kind) for b in jp)


def _jax(kind, jp, x, train, use_pallas, rate=0.0, rng=None):
    """JAX's readout and the gradients of sum(out * w_out) with respect to
    the hop params, the memory and the query, in the inputs' type."""
    def loss(p, enc, dec):
        out = jatt.vanilla_attention_stack(
            p, enc, dec, jnp.asarray(x["key_len"]), jnp.asarray(x["qlen"]),
            kind=kind, num_heads=H, dropout_rate=rate, train=train, rng=rng,
            t_queries=jnp.asarray(x["t_q"]), t_keys=jnp.asarray(x["t_keys"]),
            use_pallas=use_pallas)
        return jnp.sum(out * x["w_out"]), out

    (_, out), (jgp, jge, jgd) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jp, jnp.asarray(x["enc"]), jnp.asarray(x["dec"]))
    grads = params_from_jax(jax.device_get(jgp))
    return {"out": np.asarray(out), "enc": np.asarray(jge),
            "dec": np.asarray(jgd), **{n: g.numpy() for n, g in grads.items()}}


def _port(kind, blocks, x, train, rate=0.0, gen=None):
    enc = torch.tensor(x["enc"], requires_grad=True)
    dec = torch.tensor(x["dec"], requires_grad=True)
    blocks.zero_grad()
    out = tatt.vanilla_attention_stack(
        blocks, enc, dec, torch.tensor(x["key_len"]), torch.tensor(x["qlen"]),
        kind=kind, num_heads=H, t_queries=torch.tensor(x["t_q"]),
        t_keys=torch.tensor(x["t_keys"]), dropout_rate=rate, train=train,
        gen=gen)
    assert out.shape == (B, D)
    (out * torch.tensor(x["w_out"])).sum().backward()
    got = {"out": out, "enc": enc.grad, "dec": dec.grad,
           **{n: p.grad for n, p in blocks.named_parameters()}}
    return {n: v.detach().numpy() for n, v in got.items()}


def _jax_f64(kind, jp, x, train):
    """`_jax` in float64 (no dropout): exact math to f32's eyes."""
    with jax.enable_x64(True):
        got = _jax(kind, jax.tree.map(lambda a: np.asarray(a, np.float64), jp),
                   {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
                    for k, v in x.items()}, train, False)
    return {n: v.astype(np.float32) for n, v in got.items()}


def _hold(got, want, kind, jp, x, train):
    by_exact = _hold_f32(got, want, lambda: _jax_f64(kind, jp, x, train))
    assert all(w in tatt.GATE_PARAMS for n in by_exact
               for w in [n.split(".", 1)[1]]), by_exact


@pytest.fixture
def no_kernels(monkeypatch):
    """Stand-ins for the readout stacks and every attention and readout
    kernel wrapper: a call fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a multi-head readout reached a one-head "
                             "kernel route")
    for name in ("fused_readout_stack", "readout_chain_stack"):
        monkeypatch.setattr(tatt, name, refuse)
    monkeypatch.setattr(tatt.readout_kernel, "fused_readout_vjp", refuse)
    monkeypatch.setattr(tatt.readout_chain_kernel, "readout_chain_vjp",
                        refuse)
    monkeypatch.setattr(tatt.attention_kernel, "fused_attention_vjp", refuse)


def _dense_calls(fn):
    before = dict(tak.dense_fwd)
    out = fn()
    return out, {m: tak.dense_fwd[m] - before[m] for m in tak.MODES
                 if tak.dense_fwd[m] != before[m]}


@pytest.mark.parametrize("L,kind,gate", CASES)
def test_training_matches_jax(L, kind, gate, no_kernels):
    """Training: the hop-batched readout at every length, no dense-route
    call (the readouts run their own plain PyTorch)."""
    jp, blocks = _blocks(kind, gate, L)
    x = _inputs(L)
    got, calls = _dense_calls(lambda: _port(kind, blocks, x, True))
    assert calls == {}
    _hold(got, _jax(kind, jp, x, True, False), kind, jp, x, True)
    # the masked query keeps only its residual and normalize each hop
    assert np.abs(got["out"][3]).sum() > 0


@pytest.mark.parametrize("L,kind,gate", CASES)
def test_serving_matches_jax_hop_by_hop(L, kind, gate, no_kernels):
    """Serving: one dense-route call a hop in the kind's mode."""
    jp, blocks = _blocks(kind, gate, L)
    x = _inputs(L, seed=1)
    got, calls = _dense_calls(lambda: _port(kind, blocks, x, False, RATE))
    assert calls == {kind: HOPS}
    for use_pallas in (False, True):
        _hold(got, _jax(kind, jp, x, False, use_pallas, RATE), kind, jp, x,
              False)


def _readout_masks(rng, L):
    """JAX's plain readout masks at two heads: hop i's bernoulli on the
    [B, h, 1, Tk] weights from fold_in(rng, i)."""
    return [jax_heads_mask(jax.random.fold_in(rng, i), (B, H, 1, L), RATE)
            for i in range(HOPS)]


@pytest.mark.parametrize("L", [12, 300])
def test_plain_training_dropout_matches_jax_with_its_masks(L, no_kernels):
    jp, blocks = _blocks("plain", None, L)
    x = _inputs(L, seed=2)
    rng = jax.random.PRNGKey(13)
    masks = _readout_masks(rng, L)
    got = _port("plain", blocks, x, True, RATE, iter(masks))
    _hold_f32(got, _jax("plain", jp, x, True, False, RATE, rng))
    # a head's own mask matters: swapping the heads' masks changes it
    swapped = [m.flip(1).contiguous() for m in masks]
    other = _port("plain", blocks, x, True, RATE, iter(swapped))
    assert np.abs(other["out"] - got["out"]).max() > 1e-3


def test_plain_readout_draws_head_masks_in_hop_order():
    """With a generator the plain readout draws one [B, h, 1, Tk] mask a
    hop, in hop order."""
    from mtamrecommender_tpu_torch.ops import layers as tlayers
    _, blocks = _blocks("plain", None, 12)
    x = _inputs(12, seed=3)
    a = _port("plain", blocks, x, True, RATE,
              torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    masks = [tlayers.draw_drop_mask(g, B, 1, 12, RATE, "cpu", num_heads=H)
             for _ in range(HOPS)]
    assert masks[0].shape == (B, H, 1, 12)
    b = _port("plain", blocks, x, True, RATE, iter(masks))
    for name in a:
        assert np.array_equal(a[name], b[name]), name


@pytest.mark.parametrize("kind", ["plain", "time"])
def test_heads_that_do_not_divide_d_raise(kind):
    _, blocks = _blocks(kind, "positional", 12)
    x = {k: torch.tensor(v) for k, v in _inputs(12).items()}
    for train in (True, False):
        with pytest.raises(ValueError, match="num_heads=3"):
            tatt.vanilla_attention_stack(
                blocks, x["enc"], x["dec"], x["key_len"], x["qlen"],
                kind=kind, num_heads=3, t_queries=x["t_q"],
                t_keys=x["t_keys"], train=train)
