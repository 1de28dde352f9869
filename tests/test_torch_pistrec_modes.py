"""PISTRec's "long" (the self-attended history at the mask slot alone)
and "hybird" (the time readout alone) modes against the JAX package: one
step's loss and every gradient leaf in f32 and bf16 against both JAX
routes, and the scores.  Inputs, routes and tolerances:
tests/torch_zoo_parity.py; in bf16 `zp.check_bf16_where_routes_agree`."""

import pytest
import torch

import torch_zoo_parity as zp

torch.set_num_threads(2)

NAME = "pistrec"
MODES = ("long", "hybird")


def _over(mode):
    return (("model.pistrec_type", mode),)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_jax_f32(mode, use_pallas):
    grads = zp.check_f32(NAME, use_pallas, _over(mode))
    assert not grads["switch.w"].any() and not grads["switch.b"].any()
    assert grads["self_att.0.v.w"].abs().sum() > 0
    # the long mode reads no GRU and no readout
    assert (grads["rnn.w_gate_h"].abs().sum() > 0) == (mode == "hybird")
    assert (grads["cross_att.0.q.w"].abs().sum() > 0) == (mode == "hybird")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_jax_bf16(mode, use_pallas):
    zp.check_bf16_where_routes_agree(NAME, use_pallas, _over(mode))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_scores_match_jax_f32(mode, use_pallas):
    zp.check_scores_f32(NAME, use_pallas, _over(mode))
