"""The plain kind of the port's Tq = 1 readout (NARM's and
MTAM_no_time_aware_att's) against the JAX package's
`vanilla_attention_stack`.

Training: the port's `plain_single_query_readout` (plain PyTorch; both
readout kernels are time-only) against JAX's hop-batched jnp readout,
which both JAX routes take for the plain kind (use_pallas False and
True), forward and the gradients of the memory, the query and every hop
parameter; at dropout 0.5 with JAX's per-hop masks injected (hop i
draws from fold_in(rng, i)); at L = 300, where a time readout would take
the fused readout kernel, with the readout kernels' stacks replaced by
stand-ins that raise.  Serving: hop by hop on the attention kernel in
plain mode (here its twin) against JAX's per-hop Pallas kernels in
interpret mode and its jnp readout.  Inputs are made with numpy from a
seed: B=8, d=16, 2 hops, ragged key lengths, one masked query.

Tolerances: f32 atol 1e-5 (L = 12); 1e-5 of each output's largest
|value| at L = 300 (softmax sums over 300 keys in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu_torch.bridge import params_from_jax
from mtamrecommender_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

B, D, HOPS = 8, 16, 2
ATOL_F32 = 1e-5
REL_F32 = 1e-5


def _inputs(L, seed=0):
    r = np.random.RandomState(seed)
    key_len = np.array([L, 1, 3, L - 2, L, 7, L // 2, 2], np.int32)
    qlen = np.ones((B,), np.int32)
    qlen[3] = 0                                        # a masked query
    return dict(enc=r.randn(B, L, D).astype(np.float32),
                dec=r.randn(B, 1, D).astype(np.float32),
                key_len=key_len, qlen=qlen,
                w_out=r.randn(B, D).astype(np.float32))


def _blocks(seed=4):
    jp = jatt.init_attention_stack(jax.random.PRNGKey(seed), HOPS, D,
                                   kind="plain")
    jp = jax.device_get(jp)
    flat = params_from_jax(jp)
    blocks = []
    for i in range(HOPS):
        sub = {k.split(".", 1)[1]: v for k, v in flat.items()
               if k.startswith(f"{i}.")}
        nested = {}
        for k, v in sub.items():
            a, b = k.split(".")
            nested.setdefault(a, {})[b] = v
        blocks.append(tatt.attention_block(nested))
    return jp, torch.nn.ModuleList(blocks)


def _jax(jp, x, rate, train, use_pallas, rng=None):
    """JAX's readout, its output and the gradients of sum(out * w_out)
    with respect to the hop params, the memory and the query."""
    def loss(p, enc, dec):
        out = jatt.vanilla_attention_stack(
            p, enc, dec, jnp.asarray(x["key_len"]), jnp.asarray(x["qlen"]),
            kind="plain", num_heads=1, dropout_rate=rate, train=train,
            rng=rng, use_pallas=use_pallas)
        return jnp.sum(out * x["w_out"]), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jp, jnp.asarray(x["enc"]), jnp.asarray(x["dec"]))
    return np.asarray(out), grads


def _jax_masks(rng, L, rate=0.5, hops=HOPS):
    dec = jnp.zeros((B, 1, D), jnp.float32)
    enc = jnp.zeros((B, L, D), jnp.float32)
    return [torch.tensor(np.asarray(jatt._draw_drop_mask(
        jax.random.fold_in(rng, i), dec, enc, rate, True)))
        for i in range(hops)]


def _port(blocks, x, rate, train, gen=None):
    enc = torch.tensor(x["enc"], requires_grad=True)
    dec = torch.tensor(x["dec"], requires_grad=True)
    out = tatt.vanilla_attention_stack(
        blocks, enc, dec, torch.tensor(x["key_len"]), torch.tensor(x["qlen"]),
        kind="plain", num_heads=1, dropout_rate=rate, train=train, gen=gen)
    (out * torch.tensor(x["w_out"])).sum().backward()
    return out, enc.grad, dec.grad


def _hold(got, want, rel=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = ATOL_F32 if rel is None else rel * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol


def _hold_all(blocks, out, genc, gdec, want, jgrads, rel=None):
    _hold(out, want, rel)
    jgp, jgenc, jgdec = jgrads
    _hold(genc, jgenc, rel)
    _hold(gdec, jgdec, rel)
    jg = params_from_jax(jax.device_get(jgp))
    for name, p in blocks.named_parameters():
        _hold(p.grad, jg[name], rel)


@pytest.fixture
def no_readout_kernels(monkeypatch):
    """Stand-ins for the time-only readout stacks and their kernels'
    wrappers: any call fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain readout reached a time-only "
                             "readout kernel")
    for name in ("fused_readout_stack", "readout_chain_stack",
                 "single_query_readout"):
        monkeypatch.setattr(tatt, name, refuse)
    monkeypatch.setattr(tatt.readout_kernel, "fused_readout_vjp", refuse)
    monkeypatch.setattr(tatt.readout_chain_kernel, "readout_chain_vjp",
                        refuse)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_training_readout_matches_jax(use_pallas, no_readout_kernels):
    jp, blocks = _blocks()
    x = _inputs(12)
    want, jgrads = _jax(jp, x, 0.0, True, use_pallas)
    out, genc, gdec = _port(blocks, x, 0.0, True)
    assert out.shape == (B, D)
    _hold_all(blocks, out, genc, gdec, want, jgrads)
    # the masked query keeps only its residual and normalize each hop
    assert out[3].abs().sum() > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_training_dropout_matches_jax_with_its_masks(use_pallas,
                                                     no_readout_kernels):
    """Rate 0.5: one [B, 1, L] mask a hop, in hop order, from the mask
    source; the masks JAX draws (hop i from fold_in(rng, i)) give JAX's
    output and gradients, and without them the output differs."""
    jp, blocks = _blocks()
    x = _inputs(12, seed=1)
    rng = jax.random.PRNGKey(9)
    want, jgrads = _jax(jp, x, 0.5, True, use_pallas, rng)
    out, genc, gdec = _port(blocks, x, 0.5, True, iter(_jax_masks(rng, 12)))
    _hold_all(blocks, out, genc, gdec, want, jgrads)
    blocks.zero_grad()
    undropped = _port(blocks, x, 0.0, True)[0]
    assert not torch.allclose(out, undropped)


def test_dropout_masks_come_from_the_generator_in_hop_order():
    """With a generator the readout draws one [B, 1, L] mask a hop, in
    hop order: the same seed gives the same output, and masks drawn from
    that seed beforehand, injected, give it too."""
    _, blocks = _blocks()
    x = _inputs(12, seed=2)
    a = _port(blocks, x, 0.5, True, torch.Generator().manual_seed(3))[0]
    b = _port(blocks, x, 0.5, True, torch.Generator().manual_seed(3))[0]
    assert torch.equal(a, b)
    from mtamrecommender_tpu_torch.ops import layers as tlayers
    g = torch.Generator().manual_seed(3)
    masks = [tlayers.draw_drop_mask(g, B, 1, 12, 0.5, "cpu")
             for _ in range(HOPS)]
    c = _port(blocks, x, 0.5, True, iter(masks))[0]
    assert torch.equal(a, c)
    with pytest.raises(StopIteration):
        _port(blocks, x, 0.5, True, iter(masks[:1]))


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_training_at_300_keys_stays_off_the_readout_kernels(
        dropout, no_readout_kernels):
    """At L = 300 a time readout takes the fused readout kernel; the
    plain one trains in plain PyTorch, matching JAX's route there (its
    jnp readout: the fused readout kernel is time-only)."""
    jp, blocks = _blocks(seed=6)
    x = _inputs(300, seed=3)
    rng = jax.random.PRNGKey(11) if dropout else None
    want, jgrads = _jax(jp, x, dropout, True, True, rng)
    gen = iter(_jax_masks(rng, 300)) if dropout else None
    out, genc, gdec = _port(blocks, x, dropout, True, gen)
    _hold_all(blocks, out, genc, gdec, want, jgrads, rel=REL_F32)


@pytest.mark.parametrize("L", [12, 300])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_serving_runs_hop_by_hop_like_jax(L, use_pallas, no_readout_kernels,
                                          monkeypatch):
    """Serving: HOPS plain-mode calls of the attention kernel (its twin
    on the CPU) against JAX's per-hop Pallas kernels in interpret mode
    (use_pallas=True) and its jnp readout."""
    jp, blocks = _blocks()
    x = _inputs(L, seed=4)
    want = np.asarray(jatt.vanilla_attention_stack(
        jp, jnp.asarray(x["enc"]), jnp.asarray(x["dec"]),
        jnp.asarray(x["key_len"]), jnp.asarray(x["qlen"]), kind="plain",
        num_heads=1, dropout_rate=0.5, train=False, use_pallas=use_pallas))
    modes = []
    fused = tatt.attention_kernel.fused_attention_vjp
    monkeypatch.setattr(tatt.attention_kernel, "fused_attention_vjp",
                        lambda mode, *a: modes.append(mode) or fused(mode, *a))
    with torch.no_grad():
        got = tatt.vanilla_attention_stack(
            blocks, torch.tensor(x["enc"]), torch.tensor(x["dec"]),
            torch.tensor(x["key_len"]), torch.tensor(x["qlen"]),
            kind="plain", num_heads=1, dropout_rate=0.5, train=False)
    assert modes == ["plain"] * HOPS
    _hold(got, want, rel=REL_F32)


def test_unknown_kind_and_heads_refused():
    """An unknown kind raises; two heads train (in plain PyTorch, as
    JAX's hop-batched jnp readout) and match JAX."""
    jp, blocks = _blocks()
    xn = _inputs(12)
    x = {k: torch.tensor(v) for k, v in xn.items()}
    args = (blocks, x["enc"], x["dec"], x["key_len"], x["qlen"])
    with pytest.raises(ValueError, match="kind"):
        tatt.vanilla_attention_stack(*args, kind="tisas", num_heads=1)
    want = jatt.vanilla_attention_stack(
        jp, jnp.asarray(xn["enc"]), jnp.asarray(xn["dec"]),
        jnp.asarray(xn["key_len"]), jnp.asarray(xn["qlen"]), kind="plain",
        num_heads=2, dropout_rate=0.0, train=True)
    got = tatt.vanilla_attention_stack(*args, kind="plain", num_heads=2,
                                       train=True)
    _hold(got, want)
