"""The port's `via` ablations (MTAM_via_T_GRU, MTAM_via_rnn: the
readout over the GRU's states, the intent layer-normed) against the JAX
package: init key paths and shapes, one step's loss and every gradient
leaf in f32 and bf16 against both JAX routes, the scores, and the via
memory.  Inputs, routes and tolerances: tests/torch_zoo_parity.py."""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.ops import attention, time_gru

torch.set_num_threads(2)

MODELS = ("MTAM_via_T_GRU", "MTAM_via_rnn")
# leaves each model's f32 gradient must reach, besides the GRU's
EXTRA_LEAVES = {"MTAM_via_T_GRU": ("ln_intent.gamma",),
                "MTAM_via_rnn": ("ln_intent.gamma",)}


@pytest.mark.parametrize("name", MODELS)
def test_init_matches_jax_key_paths(name):
    zp.check_init_keys(name)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_f32(name, use_pallas):
    grads = zp.check_f32(name, use_pallas)
    assert grads["rnn.w_gate_h"].abs().sum() > 0
    for leaf in EXTRA_LEAVES.get(name, ()):
        assert grads[leaf].abs().sum() > 0, leaf


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_bf16(name, use_pallas):
    zp.check_bf16(name, use_pallas)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax_f32(name, use_pallas):
    zp.check_scores_f32(name, use_pallas)


def test_via_memory_is_the_gru_states():
    """The via models attend over the GRU's states with key_len =
    seq_len: the states are 0 from the mask slot (seq_len - 1) on, and
    the readout's gradient reaches every live step of the GRU."""
    c = zp.cfg("MTAM_via_rnn")
    _, model = zp.models("MTAM_via_rnn", c)
    _, tb = zp.batches()
    e = tbase.embed(model, tb)
    emb = e.behavior_emb.detach().requires_grad_(True)
    states = time_gru.gru_net(model.rnn, emb, tb.seq_len - 1)
    for b, n in enumerate(tb.seq_len.tolist()):
        assert not states[b, n - 1:].any()
    ones = torch.ones_like(tb.seq_len)
    readout = attention.vanilla_attention_stack(
        model.att, states, states[:, :1].detach() * 0 + 1.0,
        key_len=tb.seq_len, query_len=ones, kind="time", num_heads=1,
        t_queries=tb.target_time[:, None], t_keys=tb.times, train=True)
    (g,) = torch.autograd.grad(readout.sum(), emb)
    for b, n in enumerate(tb.seq_len.tolist()):
        live = n - 1
        if live > 0:
            assert g[b, :live].abs().sum(-1).min() > 0, b
        assert not g[b, live:].any(), b
