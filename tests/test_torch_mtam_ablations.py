"""The port's MTAM ablations over the behavior embeddings (T_GRU,
MTAM_no_time_aware_rnn, MTAM_with_T_SeqRec) against the JAX package:
init key paths and shapes, one step's loss and every gradient leaf in
f32 and bf16 against both JAX routes, the scores, and a 3-step f32
trajectory of MTAM_with_T_SeqRec.  The `via` models and MTAM_hybird:
tests/test_torch_mtam_ablations_via.py.  Inputs, routes and
tolerances: tests/torch_zoo_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu.data import device_data as jdd
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.train import trainer as jtrainer
from mtamrecommender_tpu_torch.bridge import params_from_jax
from mtamrecommender_tpu_torch.data import device_data as tdd
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train import trainer as ttrainer

from helpers import make_batch

torch.set_num_threads(2)

MODELS = ("T_GRU", "MTAM_no_time_aware_rnn", "MTAM_with_T_SeqRec")
# leaves each model's f32 gradient must reach, besides the GRU's
EXTRA_LEAVES = {"MTAM_with_T_SeqRec": ("rnn.time_input_w1",
                                       "rnn.time_kernel_t2", "att.1.q.w"),
                "T_GRU": ("rnn.time_input_w2", "rnn.time_bias2")}


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


def _dataset(n=3 * zp.B, seed=2):
    jmeta, _ = zp.meta()
    big = make_batch(jmeta, batch_size=n, seed=seed)
    arrays = {f: np.asarray(getattr(big, f))
              for f in jdd.DeviceDataset._fields}
    return arrays, jdd.DeviceDataset(**{k: jnp.asarray(v)
                                        for k, v in arrays.items()})


def test_train_trajectory_matches_jax():
    """Three make_train_step steps of MTAM_with_T_SeqRec in f32 from the
    same parameters and batches: per-step losses and the final
    parameters within 1e-5."""
    name = "MTAM_with_T_SeqRec"
    c = zp.cfg(name)
    jmeta, tmeta = zp.meta()
    params, model = zp.models(name, c)
    arrays, jdata = _dataset()
    order, _ = tdd.epoch_order(3 * zp.B, zp.B, np.random.RandomState(1))
    jstep = jtrainer.make_train_step(jget_model(name), c,
                                     jtrainer.make_optimizer(c.train),
                                     jmeta.item_vocab)
    jopt_state = jtrainer.make_optimizer(c.train).init(params)
    topt = ttrainer.make_optimizer(c.train)
    tstep = ttrainer.make_train_step(get_model(name), c, topt,
                                     tmeta.item_vocab, device="cpu")
    tstate = topt.init(model)
    tdata = tdd.to_device(arrays, device="cpu")
    jlosses, tlosses = [], []
    for step in range(3):
        jb = jdd.gather_batch(jdata, jnp.asarray(order), step, zp.B)
        params, jopt_state, m = jstep(params, jopt_state, jb, None)
        jlosses.append(float(m["loss"]))
        tstate, tm = tstep(model, tstate, tdd.gather_batch(
            tdata, torch.tensor(order), step, zp.B))
        tlosses.append(tm["loss"].item())
    np.testing.assert_allclose(tlosses, jlosses, atol=zp.ATOL_F32, rtol=0)
    want = params_from_jax(jax.device_get(params))
    for leaf, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[leaf].numpy(),
                                   atol=zp.ATOL_F32, rtol=0, err_msg=leaf)
