"""The port's RNN baselines (Gru4Rec, Vallina_Gru4Rec, T_SeqRec) against
the JAX package: init key paths and shapes, one step's loss and every
gradient leaf in f32 and bf16 against both JAX routes, and the scores.
Inputs, routes and tolerances: tests/torch_zoo_parity.py."""

import pytest
import torch

import torch_zoo_parity as zp

torch.set_num_threads(2)

MODELS = ("Gru4Rec", "Vallina_Gru4Rec", "T_SeqRec")


@pytest.mark.parametrize("name", MODELS)
def test_init_matches_jax_key_paths(name):
    zp.check_init_keys(name)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_f32(name, use_pallas):
    grads = zp.check_f32(name, use_pallas)
    # the GRU's weights are reached, through gru_scan_bwd
    assert grads["rnn.w_gate_h"].abs().sum() > 0
    if name == "T_SeqRec":
        # the time gates only through the backward's de1 / de2
        for leaf in ("rnn.time_input_w1", "rnn.time_kernel_t2",
                     "rnn.time_bias1"):
            assert grads[leaf].abs().sum() > 0, leaf
    if name == "Vallina_Gru4Rec":
        # the GRU reads the raw item rows: the behavior projection idles
        assert not grads["embedding.dense_w"].any()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_bf16(name, use_pallas):
    zp.check_bf16(name, use_pallas)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax_f32(name, use_pallas):
    zp.check_scores_f32(name, use_pallas)
