"""MTAM_no_time_aware_att (the T-GRU's intent, a plain multi-hop readout
over the behavior embeddings, no layer norm after it) against the JAX
package: init key paths and shapes, one step's loss and every gradient
leaf in f32 and bf16 against both JAX routes, the scores.  Its dropout,
and NARM's: tests/test_torch_plain_readout_dropout.py.  Inputs, routes
and tolerances: tests/torch_zoo_parity.py."""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models.registry import get_model

torch.set_num_threads(2)

NAME = "MTAM_no_time_aware_att"


def test_init_matches_jax_key_paths():
    zp.check_init_keys(NAME)
    _, tmeta = zp.meta()
    model = get_model(NAME).init(torch.Generator().manual_seed(0),
                                 zp.cfg(NAME).model, tmeta)
    # plain blocks: no time parameters
    assert not hasattr(model.att[0], "time_input_w")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_grads_match_jax_f32(use_pallas):
    grads = zp.check_f32(NAME, use_pallas)
    for leaf in ("rnn.time_kernel_w1", "att.1.q.w", "att.0.v.b"):
        assert grads[leaf].abs().sum() > 0, leaf
    # the readout is not layer-normed: ln_out gets no gradient
    assert not grads["ln_out.gamma"].any() and not grads["ln_out.beta"].any()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_grads_match_jax_bf16(use_pallas):
    zp.check_bf16(NAME, use_pallas)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_scores_match_jax_f32(use_pallas):
    zp.check_scores_f32(NAME, use_pallas)
