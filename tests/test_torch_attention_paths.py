"""The training and serving paths of the port's self-attention models
(SASrec, Time_Aware_SA, TiSAS) against the JAX package.

Helpers, inputs and tolerances are those of
tests/test_torch_attention_models.py (the modules and the loss on both
JAX routes): f32 loss and gradient leaves to 1e-5 of each leaf's
largest |value|, the trajectory's losses to atol 1e-5 and its
parameters as stated there, serving scores to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.data import device_data as jdd
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu.train import trainer as jtrainer
from mtamrecommender_tpu_torch import serve as tserve
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.data import device_data as tdd
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train import trainer as ttrainer

from helpers import make_batch
from test_torch_attention_models import (ATOL_F32, ATOL_SCORES_F32, B,
                                         BLOCKS, KINDS, L, MODELS,
                                         TRAJ_PARAM_ATOL, _assert_f32_match,
                                         _batches, _cfg, _jax_loss_and_grads,
                                         _meta, _models, _port_loss_and_grads)

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["SASrec", "Ti_Self_Attention_Model"])
def test_dropout_training_matches_jax_with_its_masks(name):
    """At dropout 0.5: JAX draws each block's mask from its rng
    (compute_loss splits it, the stack folds in the block index); the
    port gets the same masks injected, and loss and gradients agree."""
    cfg = _cfg(name, **{"model.dropout": 0.5})
    params, model = _models(name, cfg)
    jb, tb = _batches()
    rng = jax.random.PRNGKey(7)
    want, jgrads = _jax_loss_and_grads(name, cfg, params, jb, rng)
    apply_rng = jax.random.split(rng)[0]
    shape = jnp.zeros((B, L, 1))
    masks = [torch.tensor(np.asarray(jatt._draw_drop_mask(
        jax.random.fold_in(apply_rng, i), shape, shape, 0.5, True)))
        for i in range(BLOCKS)]
    got, tgrads = _port_loss_and_grads(name, cfg, model, tb, iter(masks))
    _assert_f32_match(got, want, tgrads, jgrads)
    # with the port's own generator the masks, hence the loss, differ
    _, other = _models(name, cfg)
    _, tmeta = _meta()
    drawn = tbase.compute_loss(get_model(name), other, cfg.model, tb,
                               tmeta.item_vocab,
                               gen=torch.Generator().manual_seed(0))
    assert abs(drawn["loss"].item() - got["loss"].item()) > 1e-6


def test_scalar_gate_mode_matches_jax():
    """JAX keeps scalar gates on its jnp path; the port broadcasts them to
    the kernel's [Tq, Tk] tiles and autograd sums their gradients back."""
    name = "Time_Aware_Self_Attention_Model"
    cfg = _cfg(name, **{"model.use_pallas": True,
                        "model.time_gate_mode": "scalar"})
    params, model = _models(name, cfg)
    assert model.att[0].time_input_w1.dim() == 0
    jb, tb = _batches()
    want, jgrads = _jax_loss_and_grads(name, cfg, params, jb)
    got, tgrads = _port_loss_and_grads(name, cfg, model, tb)
    _assert_f32_match(got, want, tgrads, jgrads)


def _dataset(n=3 * B, seed=2):
    jmeta, _ = _meta()
    big = make_batch(jmeta, batch_size=n, seed=seed)
    arrays = {f: np.asarray(getattr(big, f)) for f in jdd.DeviceDataset._fields}
    return arrays, jdd.DeviceDataset(**{k: jnp.asarray(v)
                                        for k, v in arrays.items()})


def test_time_aware_sa_trajectory_matches_jax():
    """Three make_train_step steps in f32 from the same parameters and
    batches: per-step losses and the final parameters."""
    name = "Time_Aware_Self_Attention_Model"
    cfg = _cfg(name, **{"model.use_pallas": True})
    jmeta, tmeta = _meta()
    params, model = _models(name, cfg)
    arrays, jdata = _dataset()
    order, _ = tdd.epoch_order(3 * B, B, np.random.RandomState(1))
    jopt = jtrainer.make_optimizer(cfg.train)
    jstep = jtrainer.make_train_step(jget_model(name), cfg, jopt,
                                     jmeta.item_vocab)
    jopt_state = jopt.init(params)
    topt = ttrainer.make_optimizer(cfg.train)
    tstep = ttrainer.make_train_step(get_model(name), cfg, topt,
                                     tmeta.item_vocab, device="cpu")
    tstate = topt.init(model)
    tdata = tdd.to_device(arrays, device="cpu")
    jlosses, tlosses = [], []
    for step in range(3):
        jb = jdd.gather_batch(jdata, jnp.asarray(order), step, B)
        params, jopt_state, m = jstep(params, jopt_state, jb,
                                      jax.random.PRNGKey(step))
        jlosses.append(float(m["loss"]))
        tstate, tm = tstep(model, tstate,
                           tdd.gather_batch(tdata, torch.tensor(order), step,
                                            B))
        tlosses.append(tm["loss"].item())
    np.testing.assert_allclose(tlosses, jlosses, atol=ATOL_F32, rtol=0)
    want = params_from_jax(jax.device_get(params))
    for leaf, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[leaf].numpy())
        assert diff.max() <= TRAJ_PARAM_ATOL, (leaf, diff.max())
        assert (diff <= ATOL_F32).mean() >= 0.99, leaf


def test_dropout_steps_are_reproducible_from_the_seed():
    """SASrec at dropout 0.5: the step's generator is seeded from
    cfg.train.seed, so two runs give the same losses and another seed
    other masks."""
    name = "SASrec"
    _, tmeta = _meta()
    arrays, _ = _dataset()
    tdata = tdd.to_device(arrays, device="cpu")
    order = torch.tensor(tdd.epoch_order(3 * B, B,
                                         np.random.RandomState(1))[0])
    runs = []
    for seed in (5, 5, 6):
        cfg = _cfg(name, **{"model.dropout": 0.5, "train.seed": seed})
        _, model = _models(name, cfg)
        opt = ttrainer.make_optimizer(cfg.train)
        run = ttrainer.make_superstep(get_model(name), cfg, opt,
                                      tmeta.item_vocab, B, device="cpu")
        _, stacked = run(model, opt.init(model), tdata, order, 0, 3)
        runs.append(stacked["loss"])
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


# ------------------------------------------------------------ serving

def _histories():
    rng = np.random.RandomState(21)
    base = 1_700_000_000.0
    lengths = [0, 1, 3, L - 1, 2 * L, 5]   # empty, and longer than L-1
    hists = [[(int(rng.randint(1, 61)), int(rng.randint(1, 6)),
               base + 3600.0 * 7 * i + rng.randint(0, 3000))
              for i in range(n)] for n in lengths]
    return hists, [base + 3600.0 * 400] * len(hists)


@pytest.mark.parametrize("name", MODELS)
def test_recommender_scores_match_jax(name):
    """serve.Recommender takes the three models from the registry alone:
    its scores on collated histories against JAX `scores_for_eval` on the
    same batch, f32, and k finite recommendations per request."""
    cfg = _cfg(name, **{"model.use_pallas": True, "model.dropout": 0.5})
    jmeta, tmeta = _meta()
    params = jax.device_get(jget_model(name).init(jax.random.PRNGKey(0),
                                                  cfg.model, jmeta))
    rec = tserve.Recommender(cfg, tmeta, params, device="cpu")
    hists, req = _histories()
    tb = rec.batch_from_histories(hists, req)
    jb = jtypes.Batch(**{f: jnp.asarray(getattr(tb, f).numpy())
                         for f in tb._fields})
    want = np.asarray(jbase.scores_for_eval(jget_model(name), params,
                                            cfg.model, jb, jmeta.item_vocab))
    with torch.no_grad():
        got = tbase.scores_for_eval(rec.model_def, rec._model_c, cfg.model,
                                    tb, tmeta.item_vocab).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_SCORES_F32, rtol=0)
    recs = rec.recommend(hists, req, k=10)
    assert [len(r) for r in recs] == [10] * len(hists)
    assert all(np.isfinite(s) for r in recs for _, s in r)


@pytest.mark.parametrize("name", MODELS)
def test_bridge_loads_the_models_strictly(name):
    cfg = _cfg(name)
    params, model = _models(name, cfg)
    names = set(params_from_jax(params))
    assert names == set(dict(model.named_parameters()))
    assert {"embedding.item_table", "att.0.q.w", "att.1.v.b",
            "att.1.ln.gamma", "ln_out.beta"} <= names
    if KINDS[name] == "time":
        assert tuple(model.att[1].time_output_w2.shape) == (L, L)
    else:
        assert not any(n.startswith("att.0.time") for n in names)
    missing = jax.tree.map(lambda x: x, params)
    del missing["att"][1]["k"]["b"]
    with pytest.raises(KeyError, match="att.1.k.b"):
        load_jax_params(model, missing)
