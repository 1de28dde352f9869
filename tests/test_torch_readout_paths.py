"""MTAM's readout route over long histories in the port against JAX.

From 256 keys (`READOUT_KERNEL_MIN_KEYS`) to 1024 (`MAX_KEYS`) MTAM's
Tq=1 readout takes the fused readout kernel in both packages, in
training and serving.  Here, on the same parameters (the JAX init,
converted by `bridge.load_jax_params`) and the same numpy inputs: the
route by length; the readout stack and its gradients against the JAX
`_fused_readout_pallas` (Pallas in interpret mode) in both gate modes
(the scalar gates broadcast to [n, L] rows outside the autograd
function, their cotangents summed back); and a row with ``key_len ==
0`` against the jnp reference.  tests/test_torch_readout_slice.py runs
the whole slice.

Tolerances: f32 outputs within 1e-5 of their largest |value|, f32
gradients within 1e-4 of each leaf's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.config import ExperimentConfig
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

D, HOPS, B = 16, 2, 4
REL_OUT_F32, REL_GRAD_F32 = 1e-5, 1e-4


def _cfg(L, **kw):
    over = {"model.num_units": D, "model.num_blocks": HOPS,
            "model.dropout": 0.0, "data.max_seq_len": L,
            "model.vocab_pad_multiple": 16, "model.use_pallas": True,
            "model.time_gate_mode": "scalar"}
    over.update(kw)
    return ExperimentConfig().with_overrides(**over)


def _models(cfg, L):
    jmeta = jtypes.DatasetMeta(20, 60, 5, L)
    tmeta = ttypes.DatasetMeta(20, 60, 5, L)
    params = jax.device_get(jget_model("MTAM").init(jax.random.PRNGKey(0),
                                                    cfg.model, jmeta))
    model = get_model("MTAM").init(torch.Generator().manual_seed(0),
                                   cfg.model, tmeta)
    return jmeta, tmeta, params, load_jax_params(model, params)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() \
        / max(np.abs(want).max(), 1e-30)


def _readout_inputs(L, key_len, seed=12):
    r = np.random.RandomState(seed)
    enc = r.randn(B, L, D).astype(np.float32)
    dec = r.randn(B, 1, D).astype(np.float32)
    t_keys = np.sort(r.rand(B, L).astype(np.float32) * 3000, axis=1)
    t_q = t_keys[:, -1:] + 2.0
    return (enc, dec, np.asarray(key_len, np.int32),
            np.array([1, 0, 1, 1], np.int32), t_q, t_keys,
            r.randn(B, D).astype(np.float32))


def _port_readout(att, enc, dec, key_len, qlen, t_q, t_keys, train=True):
    tenc = torch.tensor(enc, requires_grad=True)
    tdec = torch.tensor(dec, requires_grad=True)
    out = tatt.vanilla_attention_stack(
        att, tenc, tdec, torch.tensor(key_len), torch.tensor(qlen),
        kind="time", num_heads=1, t_queries=torch.tensor(t_q),
        t_keys=torch.tensor(t_keys), train=train)
    return out, tenc, tdec


@pytest.mark.parametrize("gate_mode", ["scalar", "positional"])
def test_readout_stack_matches_jax_pallas(gate_mode):
    """The stack at Tk=256 takes `fused_readout_stack`: its output and the
    gradients of the memory, the query and every hop parameter against
    JAX's `_fused_readout_pallas` (one query-masked row)."""
    L = 256
    cfg = _cfg(L, **{"model.time_gate_mode": gate_mode})
    _, _, params, model = _models(cfg, L)
    enc, dec, key_len, qlen, t_q, t_keys, w_out = _readout_inputs(
        L, [L, 100, 7, 2])

    def jloss(att, enc_, dec_):
        out = jatt._fused_readout_pallas(att, enc_, dec_, jnp.asarray(key_len),
                                         jnp.asarray(t_q), jnp.asarray(t_keys),
                                         jnp.asarray(qlen))
        return jnp.sum(out * w_out), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        params["att"], jnp.asarray(enc), jnp.asarray(dec))
    got, tenc, tdec = _port_readout(model.att, enc, dec, key_len, qlen, t_q,
                                    t_keys)
    assert got.shape == (B, D)
    assert _rel(got.detach().numpy(), want) <= REL_OUT_F32
    (got * torch.tensor(w_out)).sum().backward()
    assert _rel(tenc.grad.numpy(), jg[1]) <= REL_GRAD_F32
    assert _rel(tdec.grad.numpy(), jg[2]) <= REL_GRAD_F32
    jatt_grads = params_from_jax(jax.device_get(jg[0]))
    for name, p in model.att.named_parameters():
        assert p.grad.shape == p.shape, name
        assert _rel(p.grad.numpy(), jatt_grads[name].numpy()) \
            <= REL_GRAD_F32, name


def test_key_len_zero_row_follows_the_jnp_reference():
    """A row with no live key: its softmax is uniform over its L keys and
    its score gradient is zero, as JAX's jnp readout gives; the Pallas
    kernel (L padded to 384 before the mask) differs on that row only."""
    L = 300
    cfg = _cfg(L, **{"model.time_gate_mode": "positional"})
    _, _, params, model = _models(cfg, L)
    enc, dec, key_len, qlen, t_q, t_keys, w_out = _readout_inputs(
        L, [L, 0, 40, 3], seed=4)
    qlen = np.ones((B,), np.int32)
    args = (jnp.asarray(key_len), jnp.asarray(qlen))

    def jloss(enc_, dec_):
        out = jatt._fused_single_query_readout(
            params["att"], enc_, dec_, *args, kind="time", num_heads=1,
            dropout_rate=0.0, train=True, rng=None,
            t_queries=jnp.asarray(t_q), t_keys=jnp.asarray(t_keys))
        return jnp.sum(out * w_out), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                       has_aux=True)(jnp.asarray(enc),
                                                     jnp.asarray(dec))
    got, tenc, tdec = _port_readout(model.att, enc, dec, key_len, qlen, t_q,
                                    t_keys)
    assert _rel(got.detach().numpy(), want) <= REL_OUT_F32
    (got * torch.tensor(w_out)).sum().backward()
    assert _rel(tenc.grad.numpy(), jg[0]) <= REL_GRAD_F32
    assert _rel(tdec.grad.numpy(), jg[1]) <= REL_GRAD_F32
    assert tenc.grad[1].abs().sum() > 0          # V reaches every key
    pallas = np.asarray(jatt._fused_readout_pallas(
        params["att"], jnp.asarray(enc), jnp.asarray(dec), args[0],
        jnp.asarray(t_q), jnp.asarray(t_keys), args[1]))
    rows = [0, 2, 3]
    assert _rel(got.detach().numpy()[rows], pallas[rows]) <= REL_OUT_F32
    assert _rel(got.detach().numpy()[1], pallas[1]) > 1e-3


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("tk", [255, 256, 1024, 1025])
def test_readout_route_by_length(monkeypatch, tk, train):
    """256 <= Tk <= 1024 takes the fused readout in training and serving;
    outside, serving takes the per-hop attention kernel, and training
    the chain kernel's route below 256 keys and the plain hop-batched
    readout past 1024 (tests/test_torch_readout_chain_paths.py holds the
    chain's route against JAX)."""
    gen = torch.Generator().manual_seed(1)
    att = [tatt.TimeAttentionBlock(p) for p in tatt.init_attention_stack(
        gen, HOPS, D, kind="time", t_q_len=1, t_k_len=tk, gate_mode="scalar")]
    taken = []

    def spy(name, fn):
        def wrapped(*a, **k):
            taken.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(tatt, name, wrapped)

    for name in ("fused_readout_stack", "readout_chain_stack",
                 "single_query_readout", "time_aware_multihead_attention"):
        spy(name, getattr(tatt, name))
    enc, dec, key_len, qlen, t_q, t_keys, _ = _readout_inputs(
        tk, [tk, 9, 1, tk - 3], seed=tk)
    with torch.no_grad():
        out, _, _ = _port_readout(att, enc, dec, key_len, qlen, t_q, t_keys,
                                  train=train)
    assert out.shape == (B, D) and torch.isfinite(out).all()
    if 256 <= tk <= 1024:
        want = ["fused_readout_stack"]
    elif train:
        want = ["readout_chain_stack" if tk < 256 else "single_query_readout"]
    else:
        want = ["time_aware_multihead_attention"] * HOPS
    assert taken == want
