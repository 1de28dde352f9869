"""The self-attention models (Time_Aware_SA, SASrec, TiSAS) at two heads
against the JAX package.

At h = 2 the attention kernels refuse the call (`supported`), in JAX
and in the port: JAX takes its jnp attention, the port its dense route,
once a block.  SASrec and TiSAS train at dropout 0.5 with JAX's masks
rebuilt from its rng (`torch_zoo_parity.jax_block_masks`: block i's
bernoulli on the [B, h, L, L] weights), injected as the port's mask
source.  Inputs and tolerances: tests/torch_zoo_parity.py; bf16 against
JAX's jnp route (with no GRU and no attention kernel at h = 2, JAX's two
routes are one here).
"""

import pytest
import torch

import torch_zoo_parity as zp
from test_torch_multihead_models import HEADS, check_step_calls

torch.set_num_threads(2)

DROP_SEED = 7
# the models and their self-attention kind ("time" draws nothing)
MODELS = {"Time_Aware_Self_Attention_Model": "time", "SASrec": "plain",
          "Ti_Self_Attention_Model": "tisas"}


def _args(name):
    """(over, extra check kwargs): SASrec and TiSAS at dropout 0.5 with
    JAX's two-head masks injected."""
    if MODELS[name] == "time":
        return HEADS, {}
    return HEADS + (("model.dropout", 0.5),), dict(
        rng_seed=DROP_SEED,
        masks=zp.jax_block_masks(DROP_SEED, zp.HOPS, 2, 0.5))


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_f32(name):
    over, kw = _args(name)
    zp.check_f32(name, False, over, **kw)


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_bf16(name):
    over, kw = _args(name)
    zp.check_bf16(name, False, over, **kw)


@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax_f32(name):
    zp.check_scores_f32(name, False, HEADS)


@pytest.mark.parametrize("name", MODELS)
def test_training_step_takes_the_dense_route(name, monkeypatch):
    """One f32 step (no dropout here): the dense route once a block in
    the model's mode, and no attention kernel."""
    check_step_calls(name, {("dense_attention", MODELS[name]): zp.HOPS},
                     monkeypatch)
