"""The port's LSTUR, LSTUR_time_rnn (a GRU started from the user's
embedding: the plain cell, and the T-SeqRec cell reading dims 0..d-3 of
the behavior embedding with dims d-2 and d-1 as its time signals) and
STAMP against the JAX package: init key paths and shapes, one step's
loss and every gradient leaf in f32 and bf16 against both JAX routes,
the scores; and, at regulation rate 0, the user table's gradient, which
then comes only through the GRU's initial state.  Inputs, routes and
tolerances: tests/torch_zoo_parity.py."""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models.registry import get_model

torch.set_num_threads(2)

MODELS = ("LSTUR", "LSTUR_time_rnn", "STAMP")
# leaves each model's f32 gradient must reach
EXTRA_LEAVES = {"LSTUR": ("rnn.w_gate_h", "embedding.user_table"),
                "LSTUR_time_rnn": ("rnn.time_input_w1", "rnn.time_kernel_t2",
                                   "embedding.dense_w"),
                "STAMP": ("att_w0", "att_w2", "mlp_a.w", "ln_mem.gamma")}
NO_L2 = (("model.regulation_rate", 0.0),)


@pytest.mark.parametrize("name", MODELS)
def test_init_matches_jax_key_paths(name):
    zp.check_init_keys(name)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_f32(name, use_pallas):
    grads = zp.check_f32(name, use_pallas)
    for leaf in EXTRA_LEAVES[name]:
        assert grads[leaf].abs().sum() > 0, leaf


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_bf16(name, use_pallas):
    zp.check_bf16(name, use_pallas)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax_f32(name, use_pallas):
    zp.check_scores_f32(name, use_pallas)


@pytest.mark.parametrize("name", ["LSTUR", "LSTUR_time_rnn"])
def test_user_table_learns_through_the_initial_state(name):
    """Without the L2 term the user rows' gradient is the GRU's dh0
    alone: nonzero at the batch's users, and JAX's."""
    grads = zp.check_f32(name, True, over=NO_L2)
    _, tb = zp.batches()
    table = grads["embedding.user_table"]
    users = tb.user_id.long().unique()
    assert table[users].abs().sum(dim=1).gt(0).all()
    others = torch.ones(table.shape[0], dtype=torch.bool)
    others[users] = False
    assert not table[others].any()


@pytest.mark.parametrize("name,moves", [("STAMP", True), ("LSTUR", False)])
def test_stamp_memory_sums_the_padding(name, moves):
    """STAMP's external memory sums all L positions, padding included
    (as the JAX package does): an item id written into a padding slot
    moves the row's prediction; it moves no GRU model's."""
    c = zp.cfg(name)
    _, model = zp.models(name, c)
    _, tb = zp.batches()
    row, slot = 3, zp.SEQ_LENS[3] + 2           # a slot past the history
    items = tb.items.clone()
    items[row, slot] = 7
    with torch.no_grad():
        a = get_model(name).apply(model, c.model, tb, train=False)
        b = get_model(name).apply(model, c.model, tb._replace(items=items),
                                  train=False)
    assert torch.equal(a.predict_emb[:row], b.predict_emb[:row])
    assert (not torch.equal(a.predict_emb[row], b.predict_emb[row])) == moves
