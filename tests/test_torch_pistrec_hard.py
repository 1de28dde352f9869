"""PISTRec's "hard" mode (each row takes its switch's argmax branch, the
first on ties, so the switch gets no gradient) and its "short" mode (the
T-SeqRec intent alone) against the JAX package: one step's loss and
every gradient leaf in f32 and bf16 against both JAX routes, and the
scores.  Inputs, routes and tolerances: tests/torch_zoo_parity.py; in
bf16 `zp.check_bf16_where_routes_agree`."""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models import pistrec
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops import layers

torch.set_num_threads(2)

NAME = "pistrec"
MODES = ("hard", "short")


def _over(mode):
    return (("model.pistrec_type", mode),)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_jax_f32(mode, use_pallas):
    grads = zp.check_f32(NAME, use_pallas, _over(mode))
    # the switch and, in the short mode, both attention stacks get none
    assert not grads["switch.w"].any() and not grads["switch.b"].any()
    assert grads["rnn.w_gate_h"].abs().sum() > 0
    if mode == "short":
        assert not grads["cross_att.0.q.w"].any()
        assert not grads["self_att.0.v.w"].any()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_jax_bf16(mode, use_pallas):
    zp.check_bf16_where_routes_agree(NAME, use_pallas, _over(mode))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_scores_match_jax_f32(mode, use_pallas):
    zp.check_scores_f32(NAME, use_pallas, _over(mode))


def test_hard_takes_each_rows_argmax_branch():
    """Each row's hard prediction is its switch's argmax branch, the
    first on a tie (long before short before hybrid), as jnp.argmax
    takes it."""
    c = zp.cfg(NAME, **dict(_over("hard")))
    _, model = zp.models(NAME, c)
    _, tb = zp.batches()
    with torch.no_grad():
        parts, z, _ = pistrec.branches(model, c.model, tb, train=False)
        got = pistrec.combine("hard", parts, z)
        pred = get_model(NAME).apply(model, c.model, tb,
                                     train=False).predict_emb
    for r, k in enumerate(z.argmax(dim=1).tolist()):
        assert torch.equal(got[r], parts[k][r])
    assert torch.equal(pred, layers.layer_norm(model.ln_out, got))
    tie = torch.tensor([[0.25, 0.25, 0.5], [0.4, 0.4, 0.2]])
    one = torch.ones(2, 1)
    assert torch.equal(pistrec.combine("hard", (one * 0, one, one * 2), tie),
                       torch.tensor([[2.0], [0.0]]))
