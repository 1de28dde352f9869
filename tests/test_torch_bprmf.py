"""The port's BPRMF and its "bpr" output mode against the JAX package, and
the registry.

BPRMF's forward is the user embedding; its loss (`models.base.bpr_loss`)
draws ONE negative item a step, which JAX draws from compute_loss's rng
(``randint(split(rng)[1], (1,), 0, item_count)``) and the port from the
step's generator: here JAX's draw is injected (``neg_id=``).  Init key
paths and shapes, one step's loss and every gradient leaf in f32 and
bf16 against both JAX routes, the scores (plain: no bias); the
generator's draw in range and repeatable; the registry's 22 names and
output modes against JAX's.  Inputs, routes and tolerances:
tests/torch_zoo_parity.py."""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import MODEL_REGISTRY, get_model

torch.set_num_threads(2)

NAME = "bpr"
SEED = 3          # compute_loss's rng: PRNGKey(SEED)


def test_init_matches_jax_key_paths():
    zp.check_init_keys(NAME)
    _, tmeta = zp.meta()
    model = get_model(NAME).init(torch.Generator().manual_seed(0),
                                 zp.cfg(NAME).model, tmeta)
    assert model.item_bias.shape == (model.embedding.item_table.shape[0], 1)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_grads_match_jax_f32(use_pallas):
    grads = zp.check_f32(NAME, use_pallas, rng_seed=SEED)
    for leaf in ("embedding.user_table", "embedding.item_table",
                 "item_bias"):
        assert grads[leaf].abs().sum() > 0, leaf
    # the loss reads the user rows and the item rows it names only
    for leaf in ("embedding.cat_table", "embedding.pos_table",
                 "embedding.dense_w"):
        assert not grads[leaf].any(), leaf


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_grads_match_jax_bf16(use_pallas):
    zp.check_bf16(NAME, use_pallas, rng_seed=SEED)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_scores_match_jax_f32(use_pallas):
    zp.check_scores_f32(NAME, use_pallas)


def test_scores_are_the_user_rows_against_the_table():
    c = zp.cfg(NAME)
    _, model = zp.models(NAME, c)
    _, tb = zp.batches()
    _, tmeta = zp.meta()
    with torch.no_grad():
        got = tbase.scores_for_eval(get_model(NAME), model, c.model, tb,
                                    tmeta.item_vocab)
        want = model.embedding.user_table[tb.user_id.long()] \
            @ model.embedding.item_table.T
    v = tmeta.item_vocab
    torch.testing.assert_close(got[:, :v], want[:, :v], rtol=0, atol=0)


def test_the_negative_comes_from_the_generator():
    """Without ``neg_id`` the loss draws its negative from the generator
    after the forward: in [0, item_count), the same from the same seed,
    and the loss it gives is the loss with that id injected."""
    c = zp.cfg(NAME)
    _, model = zp.models(NAME, c)
    _, tb = zp.batches()
    _, tmeta = zp.meta()

    def loss(**kw):
        return tbase.compute_loss(get_model(NAME), model, c.model, tb,
                                  tmeta.item_vocab, **kw)["loss"]

    draws = [tbase.draw_negative(torch.Generator().manual_seed(s),
                                 tmeta.item_count, "cpu") for s in range(64)]
    ids = torch.cat(draws)
    assert ids.dtype == torch.int32 and ids.min() >= 0
    assert ids.max() < tmeta.item_count and len(ids.unique()) > 20
    neg = tbase.draw_negative(torch.Generator().manual_seed(5),
                              tmeta.item_count, "cpu")
    a = loss(gen=torch.Generator().manual_seed(5))
    assert torch.equal(a, loss(gen=torch.Generator().manual_seed(5)))
    assert torch.equal(a, loss(neg_id=neg))
    with pytest.raises(ValueError, match="Generator"):
        loss()


def test_registry_matches_jax():
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY) and \
        len(MODEL_REGISTRY) == 22
    for name, model_def in MODEL_REGISTRY.items():
        assert model_def.name == name
        assert model_def.output_mode == JAX_REGISTRY[name].output_mode, name
    with pytest.raises(KeyError, match="known"):
        get_model("TopPop")


def test_unknown_output_mode_refused():
    c = zp.cfg(NAME)
    _, model = zp.models(NAME, c)
    _, tb = zp.batches()
    odd = get_model(NAME)._replace(output_mode="pairwise")
    with pytest.raises(ValueError, match="output mode"):
        tbase.compute_loss(odd, model, c.model, tb)
    with pytest.raises(ValueError, match="output mode"):
        tbase.scores_for_eval(odd, model, c.model, tb)
    assert tbase.OUTPUT_MODES == ("plain", "concat", "bpr")
