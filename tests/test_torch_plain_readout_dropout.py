"""The models with the plain-kind readout at dropout 0.5 against the JAX
package: MTAM_no_time_aware_att and NARM, each hop's attention-weight
mask drawn by JAX from compute_loss's rng (fold_in(split(rng)[0], hop))
and injected as the port's mask source; one step's loss and every
gradient leaf in f32 and bf16 against both JAX routes; and the masks
taken one a hop, in hop order.  Inputs, routes and tolerances:
tests/torch_zoo_parity.py.

NARM in bf16 against JAX's jnp route: JAX's two routes themselves
disagree by more than the helper's allowance on a leaf
(`zp.check_bf16_where_routes_agree`), which is held against the Pallas
route, the one the port follows."""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model

torch.set_num_threads(2)

NAME = "MTAM_no_time_aware_att"
DROP = (("model.dropout", 0.5),)
# the plain readout's hops: one mask each
HOPS = {"NARM": 1, NAME: zp.HOPS}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["NARM", NAME])
def test_dropout_matches_jax_with_its_masks_f32(name, use_pallas):
    grads = zp.check_f32(name, use_pallas, over=DROP, rng_seed=7,
                         n_masks=HOPS[name])
    assert grads["att.0.v.w"].abs().sum() > 0


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["NARM", NAME])
def test_dropout_matches_jax_with_its_masks_bf16(name, use_pallas):
    kw = dict(over=DROP, rng_seed=7, n_masks=HOPS[name])
    if name == "NARM" and not use_pallas:
        zp.check_bf16_where_routes_agree(name, False, **kw)
    else:
        zp.check_bf16(name, use_pallas, **kw)


@pytest.mark.parametrize("name", ["NARM", NAME])
def test_dropout_draws_a_mask_a_hop_from_the_generator(name):
    """In training at 0.5 the model takes exactly one mask a hop from its
    source (a short source raises), and a generator's draws repeat from
    its seed."""
    c = zp.cfg(name, **dict(DROP))
    _, model = zp.models(name, c)
    _, tb = zp.batches()
    _, tmeta = zp.meta()

    def loss(gen):
        return tbase.compute_loss(get_model(name), model, c.model, tb,
                                  tmeta.item_vocab, gen=gen)["loss"]

    masks = zp.jax_readout_masks(7, HOPS[name])
    loss(iter(masks))
    with pytest.raises(StopIteration):
        loss(iter(masks[:-1]))
    a = loss(torch.Generator().manual_seed(2))
    assert torch.equal(a, loss(torch.Generator().manual_seed(2)))
    assert not torch.equal(a, loss(None))
