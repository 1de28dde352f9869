"""The port's NARM family (NARM, NARM+, NARM++: one attention block over
the GRU's states, read by the layer-normed intent, and the concat head)
against the JAX package: init key paths and shapes, one step's loss and
every gradient leaf in f32 and bf16 against both JAX routes and the
scores (NARM's dropout: tests/test_torch_plain_readout_models.py).
Inputs, routes and tolerances: tests/torch_zoo_parity.py.

NARM in bf16 against JAX's jnp route: JAX's two routes themselves
disagree there by more than the helper's allowance on a leaf
(`zp.check_bf16_where_routes_agree`), so that leaf is held against the
Pallas route, which the port follows."""

import numpy as np
import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model

torch.set_num_threads(2)

MODELS = ("NARM", "NARM+", "NARM++")
# leaves each model's f32 gradient must reach
EXTRA_LEAVES = {"NARM": ("att.0.q.w", "output_w", "ln_intent.gamma"),
                "NARM+": ("att.0.time_input_w", "att.0.time_output_w2"),
                "NARM++": ("rnn.time_kernel_w1", "att.0.time_input_b1")}
DROP = (("model.dropout", 0.5),)


@pytest.mark.parametrize("name", MODELS)
def test_init_matches_jax_key_paths(name):
    zp.check_init_keys(name)
    _, tmeta = zp.meta()
    model = get_model(name).init(torch.Generator().manual_seed(0),
                                 zp.cfg(name).model, tmeta)
    assert len(model.att) == 1 and model.ln_out.gamma.shape == (2 * zp.D,)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_f32(name, use_pallas):
    grads = zp.check_f32(name, use_pallas)
    assert grads["rnn.w_gate_h"].abs().sum() > 0
    for leaf in EXTRA_LEAVES[name]:
        assert grads[leaf].abs().sum() > 0, leaf


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_bf16(name, use_pallas):
    if name == "NARM" and not use_pallas:
        zp.check_bf16_where_routes_agree(name, False)
    else:
        zp.check_bf16(name, use_pallas)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax_f32(name, use_pallas):
    zp.check_scores_f32(name, use_pallas)


def test_time_kind_draws_no_mask():
    """NARM+ at dropout 0.5 trains as at 0: the time kind never drops, so
    it takes nothing from its mask source."""
    name = "NARM+"
    c = zp.cfg(name, **dict(DROP))
    _, model = zp.models(name, c)
    _, tb = zp.batches()
    _, tmeta = zp.meta()
    got = tbase.compute_loss(get_model(name), model, c.model, tb,
                             tmeta.item_vocab, gen=iter(()))
    want = tbase.compute_loss(get_model(name), model, zp.cfg(name).model, tb,
                              tmeta.item_vocab)
    assert torch.equal(got["loss"], want["loss"])


def test_concat_head_predicts_2d():
    name = "NARM"
    c = zp.cfg(name)
    _, model = zp.models(name, c)
    _, tb = zp.batches()
    with torch.no_grad():
        pred = get_model(name).apply(model, c.model, tb,
                                     train=False).predict_emb
    assert pred.shape == (zp.B, 2 * zp.D)
    assert get_model(name).output_mode == "concat"
    assert np.isfinite(pred.numpy()).all()
