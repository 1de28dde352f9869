"""The port's FPMC (models/fpmc.py) against the JAX package's: from the
JAX init's tables (bridged), the full-catalog scores, K SBPR steps on the
same batches (each step's loss and the four tables after it) and the
evaluation's accuracy and MRR; the training loop's order and negatives
from numpy's RandomState(seed) in JAX's sequence; and the learning test
of tests/test_fpmc.py on the port.  FPMC runs no kernel.

Tolerances: f32 tables and scores within 1e-7 (values ~1e-2: the same
products in other orders), losses within 1e-6 relative; accuracy and MRR
equal (the ranks of the same scores)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.models import fpmc as jfpmc
from mtamrecommender_tpu_torch.bridge import load_jax_params
from mtamrecommender_tpu_torch.models import fpmc as tfpmc

torch.set_num_threads(2)

CFG = dict(n_user=20, n_item=15, n_factor=8, learn_rate=0.05, regular=0.001)
K_STEPS, CAP = 5, 3
ATOL = 1e-7


def _models(seed=0):
    cfg_j, cfg_t = jfpmc.FPMCConfig(**CFG), tfpmc.FPMCConfig(**CFG)
    params = jax.device_get(jfpmc.init_fpmc(jax.random.PRNGKey(seed), cfg_j))
    model = tfpmc.init_fpmc(torch.Generator().manual_seed(seed), cfg_t)
    return params, load_jax_params(model, params)


def _tuples(n=40, seed=1):
    r = np.random.RandomState(seed)
    return [(int(r.randint(CFG["n_user"])), int(r.randint(CFG["n_item"])),
             [int(x) for x in r.randint(0, CFG["n_item"], r.randint(1, 5))])
            for _ in range(n)]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_init_keys_and_scores_match_jax():
    params, model = _models()
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in params.items()}
    u, i, basket, mask = tfpmc.pack_batch(_tuples(), np.arange(12), CAP)
    want = jfpmc.score_all(params, jnp.asarray(u), jnp.asarray(basket),
                           jnp.asarray(mask))
    with torch.no_grad():
        scores = tfpmc.score_all(model, torch.tensor(u), torch.tensor(basket),
                                 torch.tensor(mask))
    assert scores.shape == (12, CFG["n_item"])
    _close(scores, want)


def test_sbpr_steps_match_jax():
    params, model = _models()
    data = _tuples()
    r = np.random.RandomState(4)
    for k in range(K_STEPS):
        sel = r.randint(0, len(data), 16)
        u, i, basket, mask = tfpmc.pack_batch(data, sel, CAP)
        j = r.randint(0, CFG["n_item"], 16).astype(np.int32)
        params, jloss = jfpmc.sbpr_step(
            params, u, i, j, basket, mask, learn_rate=CFG["learn_rate"],
            regular=CFG["regular"])
        loss = tfpmc.sbpr_step(model, *(torch.tensor(a) for a in
                                        (u, i, j, basket, mask)),
                               learn_rate=CFG["learn_rate"],
                               regular=CFG["regular"])
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
        for name, p in model.named_parameters():
            _close(p, params[name])
    # the steps moved every table
    fresh = _models()[1]
    for name, p in model.named_parameters():
        assert not torch.equal(p, getattr(fresh, name)), name


def test_evaluate_matches_jax():
    params, model = _models(seed=2)
    te = _tuples(n=30, seed=5)
    want = jfpmc.evaluate(params, te)
    got = tfpmc.evaluate(model, te)
    assert got == want
    assert tfpmc.evaluate(model, []) == (0.0, 0.0)


def test_train_loop_draws_jax_order_and_negatives(monkeypatch):
    """train_fpmc's batches: the same (u, i, j, basket, mask) in the same
    sequence as the JAX loop's, from RandomState(seed)."""
    data = _tuples(n=20, seed=6)
    seen = {"jax": [], "port": []}
    jstep, tstep = jfpmc.sbpr_step, tfpmc.sbpr_step

    def jspy(params, *a, **kw):
        seen["jax"].append([np.asarray(x) for x in a])
        return jstep(params, *a, **kw)

    def tspy(model, *a, **kw):
        seen["port"].append([x.numpy() for x in a])
        return tstep(model, *a, **kw)

    monkeypatch.setattr(jfpmc, "sbpr_step", jspy)
    monkeypatch.setattr(tfpmc, "sbpr_step", tspy)
    kw = dict(n_epoch=2, neg_batch_size=3, batch_size=8, basket_cap=CAP,
              seed=9)
    jfpmc.train_fpmc(jfpmc.FPMCConfig(**CFG), data, **kw)
    tfpmc.train_fpmc(tfpmc.FPMCConfig(**CFG), data, device="cpu", **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 2 * 3 * 3
    for a, b in zip(seen["port"], seen["jax"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _toy_data(n_user=20, n_item=15, seed=0):
    """Users deterministically transition i -> (i+1) % n_item (the JAX
    package's tests/test_fpmc.py)."""
    rng = np.random.RandomState(seed)
    tr, te = [], []
    for u in range(n_user):
        start = rng.randint(0, n_item)
        chain = [(start + k) % n_item for k in range(6)]
        for k in range(1, 5):
            tr.append((u, chain[k], [chain[k - 1]]))
        te.append((u, chain[5], [chain[4]]))
    return tr, te


def test_fpmc_learns_markov_transitions():
    tr, te = _toy_data()
    cfg = tfpmc.FPMCConfig(n_user=20, n_item=15, n_factor=16,
                           learn_rate=0.05, regular=0.001)
    _, (acc, mrr) = tfpmc.train_fpmc(cfg, tr, te, n_epoch=30,
                                     neg_batch_size=5, batch_size=64,
                                     device="cpu")
    # successor structure is fully deterministic: must beat chance by far
    assert acc > 0.5, acc
    assert mrr > 0.6, mrr


def test_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfpmc.train_fpmc(tfpmc.FPMCConfig(**CFG), _tuples(n=4), n_epoch=1)
