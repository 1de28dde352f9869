"""PISTRec (its "soft" mode, the default) at two heads against the JAX
package: one step's loss and every gradient leaf in f32 and bf16, the
scores, and the step's route.

PISTRec reads ``num_heads`` in its self-attention blocks and in its
readout.  At h = 2 neither package runs an attention or readout kernel:
the self-attention takes JAX's jnp path and the port's dense route, the
readout their hop-batched readouts; the T-SeqRec GRU keeps its kernel
route.  Inputs and f32 tolerances: tests/torch_zoo_parity.py.

bf16: `check_bf16`'s rule against one of JAX's two routes on every
leaf (the ROADMAP.md parity rule: where JAX's bf16 routes differ a leaf
may match either), on `torch_zoo_parity.batches`' default batch.  A
leaf that misses both there is one whose gradient cancels (the switch's
bias sums a softmax gradient over the batch, and a bf16 error of 1 % in
a branch moves it by tens of percent): it is held over four batches
(seeds 5 to 8) instead, its bf16 error (the largest |difference| from
JAX's f32 leaf over that leaf's largest |value|) averaged over them no
more than JAX's jnp route's averaged error plus 5e-2.  At most one leaf
may take that rule.
"""

import functools

import jax
import numpy as np
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from test_torch_multihead_models import HEADS, check_step_calls

torch.set_num_threads(2)

NAME = "pistrec"
OVER = HEADS + (("model.pistrec_type", "soft"),)
BATCH_SEEDS = (5, 6, 7, 8)


def test_loss_and_grads_match_jax_f32():
    grads = zp.check_f32(NAME, False, OVER)
    for leaf in ("switch.w", "self_att.1.time_input_w", "cross_att.0.q.w",
                 "cross_att.1.v.w", "rnn.time_kernel_w2"):
        assert grads[leaf].abs().sum() > 0, leaf


def test_scores_match_jax_f32():
    zp.check_scores_f32(NAME, False, OVER)


def test_training_step_route(monkeypatch):
    """The T-SeqRec GRU pair, the dense route once a self-attention
    block, no attention or readout kernel."""
    check_step_calls(NAME, {("gru_scan", "tseqrec"): 1,
                            ("gru_scan_bwd", "tseqrec"): 1,
                            ("dense_attention", "time"): zp.HOPS},
                     monkeypatch)


@functools.lru_cache(maxsize=None)
def _jax_step(use_pallas, dtype):
    """JAX's jitted (loss, gradients) of (params, batch) in one route and
    compute type, and its params."""
    c = zp.cfg(NAME, **{"model.use_pallas": use_pallas,
                        "model.compute_dtype": dtype, **dict(OVER)})
    jmeta, _ = zp.meta()

    def loss_fn(p, jb):
        return jbase.compute_loss(jget_model(NAME), p, c.model, jb, True,
                                  None, jmeta.item_vocab)["loss"]

    return jax.jit(jax.value_and_grad(loss_fn)), zp.jax_params(NAME, c)


def _jax(seed, use_pallas, dtype):
    """JAX's loss and gradients on batch ``seed``."""
    step, params = _jax_step(use_pallas, dtype)
    loss, grads = step(params, zp.batches(seed=seed)[0])
    return float(loss), {n: g.numpy() for n, g in
                         zp.params_from_jax(jax.device_get(grads)).items()}


def _port(seed):
    c = zp.cfg(NAME, **{"model.compute_dtype": "bfloat16", **dict(OVER)})
    _, model = zp.models(NAME, c)
    _, tb = zp.batches(seed=seed)
    metrics, grads = zp.port_loss_and_grads(NAME, c, model, tb)
    return metrics["loss"].item(), {n: g.numpy() for n, g in grads.items()}


def _rel_err(a, ref):
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_loss_and_grads_match_jax_bf16():
    loss, got = _port(BATCH_SEEDS[0])
    _, w32 = _jax(BATCH_SEEDS[0], False, "float32")
    routes = [_jax(BATCH_SEEDS[0], up, "bfloat16") for up in (False, True)]
    np.testing.assert_allclose(loss, routes[1][0], rtol=zp.REL_LOSS_BF16)
    assert set(got) == set(w32)
    missed = []
    for leaf, g in got.items():
        assert np.isfinite(g).all(), leaf
        if not any(np.abs(g - w[leaf]).max()
                   <= zp._bf16_allowance(w[leaf], w32[leaf])
                   for _, w in routes):
            missed.append(leaf)
    assert len(missed) <= 1, missed
    if not missed:
        return
    errs = []
    for seed in BATCH_SEEDS:
        _, g = _port(seed)
        _, f32 = _jax(seed, False, "float32")
        _, bf16 = _jax(seed, False, "bfloat16")
        errs.append([_rel_err(g[leaf], f32[leaf]) for leaf in missed]
                    + [_rel_err(bf16[leaf], f32[leaf]) for leaf in missed])
    port, jnp_route = np.mean(errs, axis=0)
    assert port <= jnp_route + zp.REL_GRAD_BF16, (missed, errs)
