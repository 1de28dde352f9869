"""The port's GRU cells as modules against the JAX package: `gru_net`,
`bidirectional_gru_net` and `tseqrec_net` (and `time_aware_gru_net`'s
T-SeqRec branch) against JAX's jnp route and its Pallas route in
interpret mode.

Parameters come from JAX's init through `bridge.load_jax_params`;
inputs, time features, an initial state and an output cotangent are
made with numpy from a seed; lengths are ragged with a row of length 0
and a full row.  Held: the outputs and every gradient (inputs, time
features, initial state, each parameter).  f32: outputs within 1e-5,
each gradient within 1e-5 of its largest |value|.  bf16 (parameters
and inputs rounded to bf16, as `_compute_cast` does; the gradients flow
back through the casts): each leaf no farther from JAX's bf16 leaf than
JAX's bf16 leaf is from its f32 leaf, plus 5e-2 of the f32 leaf's
largest |value| (tests/test_torch_train.py's rule).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops import time_gru as jtg
from mtamrecommender_tpu.ops.pallas import flags as jflags
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.ops import time_gru as ttg

torch.set_num_threads(2)

D, L, B = 16, 12, 8
ATOL_F32 = 1e-5
REL_F32 = 1e-5
REL_BF16 = 5e-2
LENGTHS = [0, 1, L, 4, L - 1, 2, 6, 8]

# cell -> (JAX init, JAX function, port init, port module, float inputs
# the function takes besides its parameters)
CELLS = {
    "gru": (jtg.init_gru, jtg.gru_net, ttg.init_gru, ttg.GRU,
            ("inputs", "h0")),
    "bidirectional": (jtg.init_bidirectional_gru, jtg.bidirectional_gru_net,
                      ttg.init_bidirectional_gru, ttg.BidirectionalGRU,
                      ("inputs",)),
    "tseqrec": (jtg.init_tseqrec, jtg.tseqrec_net, ttg.init_tseqrec,
                ttg.TimeGRU, ("inputs", "time_last", "time_now", "h0")),
}


def _inputs(seed=11):
    r = np.random.RandomState(seed)
    return {"inputs": r.randn(B, L, D).astype(np.float32),
            "time_last": np.abs(r.randn(B, L)).astype(np.float32) * 5,
            "time_now": np.abs(r.randn(B, L)).astype(np.float32) * 50,
            "h0": (0.5 * r.randn(B, D)).astype(np.float32)}


def _cotangent(cell, seed=12):
    width = 2 * D if cell == "bidirectional" else D
    return np.random.RandomState(seed).randn(B, L, width).astype(np.float32)


def _jax_call(cell, p, x, lengths, use_pallas):
    fn = CELLS[cell][1]
    if cell == "gru":
        return fn(p, x["inputs"], lengths, initial_state=x["h0"],
                  use_pallas=use_pallas)
    if cell == "bidirectional":
        return fn(p, x["inputs"], lengths, use_pallas=use_pallas)
    return fn(p, x["inputs"], x["time_last"], x["time_now"], lengths,
              initial_state=x["h0"], use_pallas=use_pallas)


def _port_call(cell, p, x, lengths):
    if cell == "gru":
        return ttg.gru_net(p, x["inputs"], lengths, initial_state=x["h0"])
    if cell == "bidirectional":
        return ttg.bidirectional_gru_net(p, x["inputs"], lengths)
    return ttg.tseqrec_net(p, x["inputs"], x["time_last"], x["time_now"],
                           lengths, initial_state=x["h0"])


def _params(cell):
    return jax.device_get(CELLS[cell][0](jax.random.PRNGKey(3), D, D))


@functools.lru_cache(maxsize=None)
def _jax(cell, use_pallas, dtype):
    """JAX's outputs (f32) and gradients of sum(out * cotangent), by leaf
    name: ``params.*`` and the float inputs."""
    jflags.set_scope("all")
    jdt = jnp.dtype(dtype)
    names = CELLS[cell][4]
    x = {k: jnp.asarray(v) for k, v in _inputs().items() if k in names}
    cot = jnp.asarray(_cotangent(cell))
    lengths = jnp.asarray(LENGTHS, jnp.int32)

    def loss(p, xs):
        pc = jax.tree.map(lambda a: a.astype(jdt), p)
        xc = {k: v.astype(jdt) for k, v in xs.items()}
        out = _jax_call(cell, pc, xc, lengths, use_pallas).astype(jnp.float32)
        return jnp.sum(out * cot), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(_params(cell), x)
    grads = {f"params.{k}": v for k, v in params_from_jax(
        jax.device_get(gp)).items()}
    grads.update({k: torch.from_numpy(np.array(v, np.float32))
                  for k, v in gx.items()})
    return np.asarray(out), grads


def _port(cell, dtype):
    _, _, tinit, tmodule, names = CELLS[cell]
    gen = torch.Generator().manual_seed(0)
    raw = tinit(gen, D, D)
    module = tmodule(raw)
    load_jax_params(module, _params(cell))
    tdt = getattr(torch, dtype)
    module_c = copy.deepcopy(module).to(tdt)
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in _inputs().items() if k in names}
    x = {k: v.to(tdt) for k, v in leaves.items()}
    out = _port_call(cell, module_c, x, torch.tensor(LENGTHS)).float()
    (out * torch.tensor(_cotangent(cell))).sum().backward()
    grads = {f"params.{n}": p.grad.float()
             for n, p in module_c.named_parameters()}
    grads.update({k: v.grad for k, v in leaves.items()})
    return out.detach().numpy(), grads


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_matches_jax_f32(cell, use_pallas):
    want_out, want = _jax(cell, use_pallas, "float32")
    got_out, got = _port(cell, "float32")
    np.testing.assert_allclose(got_out, want_out, atol=ATOL_F32, rtol=0)
    # past each row's length: 0 (both directions of the bidirectional)
    for b, n in enumerate(LENGTHS):
        assert not got_out[b, n:].any(), b
    assert set(got) == set(want)
    for leaf, g in got.items():
        w = want[leaf].numpy()
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= REL_F32 * scale, leaf
        assert scale > 1e-30, leaf          # every leaf is reached


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_matches_jax_bf16(cell, use_pallas):
    want_out, want = _jax(cell, use_pallas, "bfloat16")
    want_out32, want32 = _jax(cell, use_pallas, "float32")
    got_out, got = _port(cell, "bfloat16")
    assert np.abs(got_out - want_out).max() <= (
        REL_BF16 * np.abs(want_out32).max()
        + np.abs(want_out - want_out32).max())
    for leaf, g in got.items():
        w, w32 = want[leaf].numpy(), want32[leaf].numpy()
        assert torch.isfinite(g).all(), leaf
        assert np.abs(g.numpy() - w).max() <= (
            REL_BF16 * np.abs(w32).max() + np.abs(w - w32).max()), leaf


def test_time_aware_gru_net_dispatches_tseqrec():
    """time_aware_gru_net("T-SeqRec") is tseqrec_net; init_time_aware_gru
    gives JAX's leaves; an unknown cell raises."""
    module = ttg.TimeGRU(ttg.init_time_aware_gru(
        torch.Generator().manual_seed(0), "T-SeqRec", D, D))
    load_jax_params(module, jax.device_get(jtg.init_time_aware_gru(
        jax.random.PRNGKey(1), "T-SeqRec", D, D)))
    x = {k: torch.tensor(v) for k, v in _inputs().items()}
    lengths = torch.tensor(LENGTHS)
    got = ttg.time_aware_gru_net(module, "T-SeqRec", x["inputs"],
                                 x["time_last"], x["time_now"], lengths)
    want = ttg.tseqrec_net(module, x["inputs"], x["time_last"],
                           x["time_now"], lengths)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="cell type"):
        ttg.time_aware_gru_net(module, "lstm", x["inputs"], x["time_last"],
                               x["time_now"], lengths)
    with pytest.raises(ValueError, match="cell type"):
        ttg.init_time_aware_gru(torch.Generator(), "lstm", D, D)
