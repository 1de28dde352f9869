"""Shared parity checks of the port's zoo models against the JAX package
(used by tests/test_torch_rnn_models.py, tests/test_torch_mtam_ablations.py,
tests/test_torch_mtam_ablations_via.py,
tests/test_torch_mtam_hybird.py and
tests/test_torch_zoo_checkpoint.py).

Parameters come from the JAX package's init through
`bridge.load_jax_params`; batches are made with numpy from a seed, with
one filler row and a row of ``seq_len`` 1 (an empty history: GRU length
0, gathered at -1).  JAX runs both of its routes: the jnp path
(use_pallas=False) and the Pallas kernels in interpret mode
(use_pallas=True).

Tolerances (tests/test_torch_train.py's): the f32 loss terms within
1e-5; every f32 gradient leaf within 1e-5 of its largest |value|; f32
scores within 1e-5 of the largest |score| (the logits sum D products
after the readout's hops); under bf16 compute the loss within 2e-2 of
its value, and each gradient leaf no farther from JAX's bf16 leaf than
JAX's bf16 leaf is from its f32 leaf, plus 5e-2 of the f32 leaf's
largest |value| (the two packages round at different places, and JAX's
jnp route carries the GRU state in bf16).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.config import ExperimentConfig
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model

from helpers import make_batch

D, L, HOPS, B = 16, 12, 2, 8
ATOL_F32 = 1e-5
REL_GRAD_F32 = 1e-5
REL_SCORES_F32 = 1e-5
REL_LOSS_BF16 = 2e-2
REL_GRAD_BF16 = 5e-2
SEQ_LENS = [1, 2, L, 5, L, 3, 7, 9]
VALID = [1, 1, 1, 1, 1, 1, 1, 0]          # one filler row


def cfg(name, **kw):
    over = {"model.experiment_type": name, "model.num_units": D,
            "model.num_blocks": HOPS, "model.dropout": 0.0,
            "data.max_seq_len": L, "model.vocab_pad_multiple": 16}
    over.update(kw)
    return ExperimentConfig().with_overrides(**over)


def meta():
    return (jtypes.DatasetMeta(20, 60, 5, L), ttypes.DatasetMeta(20, 60, 5, L))


def jax_params(name, c, seed=0):
    jmeta, _ = meta()
    return jax.device_get(jget_model(name).init(jax.random.PRNGKey(seed),
                                                c.model, jmeta))


def models(name, c, seed=0):
    """(JAX's parameters, the port's model loaded with them)."""
    _, tmeta = meta()
    params = jax_params(name, c, seed)
    model = get_model(name).init(torch.Generator().manual_seed(0), c.model,
                                 tmeta)
    return params, load_jax_params(model, params)


def to_torch_batch(jb):
    return ttypes.batch_from_numpy({f: np.asarray(getattr(jb, f))
                                    for f in jb._fields}, device="cpu")


def batches(seed=5, valid=VALID):
    jmeta, _ = meta()
    jb = make_batch(jmeta, batch_size=B, seed=seed, seq_lens=SEQ_LENS)
    # hours since the epoch, as served requests carry them
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0,
                     valid=jnp.asarray(valid, jnp.float32))
    return jb, to_torch_batch(jb)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(name, use_pallas, dtype):
    """JAX's loss terms and gradients by port name, memoized per module."""
    c = cfg(name, **{"model.use_pallas": use_pallas,
                     "model.compute_dtype": dtype})
    jmeta, _ = meta()
    params = jax_params(name, c)
    jb, _ = batches()

    def loss_fn(p):
        m = jbase.compute_loss(jget_model(name), p, c.model, jb, True, None,
                               jmeta.item_vocab)
        return m["loss"], m

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                     has_aux=True))(params)
    return ({k: float(v) for k, v in metrics.items()},
            params_from_jax(jax.device_get(grads)))


def port_loss_and_grads(name, c, model, tb):
    _, tmeta = meta()
    metrics = tbase.compute_loss(get_model(name), model, c.model, tb,
                                 tmeta.item_vocab)
    metrics["loss"].backward()
    # a parameter the loss does not reach (Vallina_Gru4Rec's behavior
    # projection) has no grad; JAX's is zeros, as the train step takes it
    return metrics, {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p))
                     for n, p in model.named_parameters()}


def check_init_keys(name):
    """The port's init gives exactly JAX's key paths and shapes."""
    c = cfg(name)
    _, tmeta = meta()
    want = {n: tuple(t.shape)
            for n, t in params_from_jax(jax_params(name, c)).items()}
    model = get_model(name).init(torch.Generator().manual_seed(0), c.model,
                                 tmeta)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert get_model(name).output_mode == jget_model(name).output_mode


def check_f32(name, use_pallas):
    """Loss terms and every gradient leaf of one f32 step."""
    c = cfg(name)
    _, model = models(name, c)
    _, tb = batches()
    want, jgrads = jax_loss_and_grads(name, use_pallas, "float32")
    got, tgrads = port_loss_and_grads(name, c, model, tb)
    for key in ("loss", "ce", "l2"):
        np.testing.assert_allclose(got[key].item(), want[key],
                                   atol=ATOL_F32, rtol=ATOL_F32, err_msg=key)
    assert set(tgrads) == set(jgrads)
    for leaf, g in tgrads.items():
        w = jgrads[leaf].numpy()
        assert g is not None and g.dtype == torch.float32, leaf
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= REL_GRAD_F32 * scale, leaf
    return tgrads


def check_bf16(name, use_pallas):
    """Loss and every gradient leaf of one step under bf16 compute."""
    c = cfg(name, **{"model.compute_dtype": "bfloat16"})
    _, model = models(name, c)
    _, tb = batches()
    want, jgrads = jax_loss_and_grads(name, use_pallas, "bfloat16")
    _, jgrads32 = jax_loss_and_grads(name, use_pallas, "float32")
    got, tgrads = port_loss_and_grads(name, c, model, tb)
    assert got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), want["loss"],
                               rtol=REL_LOSS_BF16)
    assert set(tgrads) == set(jgrads)
    for leaf, g in tgrads.items():
        w, w32 = jgrads[leaf].numpy(), jgrads32[leaf].numpy()
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), leaf
        assert np.abs(g.numpy() - w).max() <= (
            REL_GRAD_BF16 * np.abs(w32).max() + np.abs(w - w32).max()), leaf


def scores(name, dtype="float32", use_pallas=False):
    """(the port's scores, JAX's, the logical vocab) on one batch."""
    c = cfg(name, **{"model.compute_dtype": dtype,
                     "model.use_pallas": use_pallas})
    params, model = models(name, c)
    jb, tb = batches()
    jmeta, tmeta = meta()
    want = np.asarray(jbase.scores_for_eval(jget_model(name), params,
                                            c.model, jb, jmeta.item_vocab))
    with torch.no_grad():
        got = tbase.scores_for_eval(get_model(name), model, c.model, tb,
                                    tmeta.item_vocab).numpy()
    return got, want, tmeta.item_vocab


def check_scores_f32(name, use_pallas):
    got, want, vocab = scores(name, use_pallas=use_pallas)
    assert got.shape == want.shape and got.dtype == np.float32
    # the padded table's columns hold the mask fill on both sides
    np.testing.assert_array_equal(got[:, vocab:], want[:, vocab:])
    scale = np.abs(want[:, :vocab]).max()
    assert np.abs(got[:, :vocab] - want[:, :vocab]).max() \
        <= REL_SCORES_F32 * scale
