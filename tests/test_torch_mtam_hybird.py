"""The port's MTAM_hybird (the concat output head: [intent,
ln_out(readout)] @ output_w [2d, d] before the item table) against the
JAX package: init key paths and shapes, one step's loss and every
gradient leaf in f32 and bf16 against both JAX routes, the scores, and
the head in scoring and in the loss.  Inputs, routes and tolerances:
tests/torch_zoo_parity.py."""

import numpy as np
import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model

torch.set_num_threads(2)

MODELS = ("MTAM_hybird",)
# leaves each model's f32 gradient must reach, besides the GRU's
EXTRA_LEAVES = {"MTAM_hybird": ("output_w",)}


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


def test_hybird_concat_head():
    """MTAM_hybird predicts [B, 2d]; its scores are (pred @ output_w) @
    table^T in f32, and in bf16 use the bf16-rounded output_w and table
    upcast to f32, as JAX does; the loss takes the same head."""
    name = "MTAM_hybird"
    assert get_model(name).output_mode == "concat"
    _, tmeta = zp.meta()
    for dtype in ("float32", "bfloat16"):
        c = zp.cfg(name, **{"model.compute_dtype": dtype})
        _, model = zp.models(name, c)
        _, tb = zp.batches()
        tdt = tbase.compute_dtype(c.model)
        model_c = tbase.cast_floats(model, tdt)
        with torch.no_grad():
            pred = get_model(name).apply(
                model_c, c.model, tbase.cast_floats(tb, tdt),
                train=False).predict_emb
            assert pred.shape == (zp.B, 2 * zp.D)
            want = (pred.float() @ model_c.output_w.float()) \
                @ model_c.embedding.item_table.float().T
            got = tbase.scores_for_eval(get_model(name), model, c.model, tb,
                                        tmeta.item_vocab)
        v = tmeta.item_vocab
        torch.testing.assert_close(got[:, :v], want[:, :v], rtol=0,
                                   atol=1e-6)
    got, want, v = zp.scores(name, dtype="bfloat16")
    scale = np.abs(want[:, :v]).max()
    assert np.abs(got[:, :v] - want[:, :v]).max() <= zp.REL_LOSS_BF16 * scale
