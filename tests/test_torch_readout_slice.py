"""MTAM over long histories, the whole slice, in the port against JAX.

At L=256 MTAM's readout takes the fused readout kernel in both packages
(tests/test_torch_readout_paths.py holds the route).  On the same
parameters and numpy batch: `compute_loss` with every gradient leaf
against JAX's with use_pallas=True (GRU scan and readout kernels in
interpret mode), and the Recommender's scores against JAX
`scores_for_eval`.

Tolerances: f32 losses and scores within 1e-5, gradients within 1e-4 of
each leaf's largest |value| (reached: 4e-6 but one leaf).  In the whole
step a scalar gate's gradient is a sum over L*B terms that nearly
cancel: there a leaf may sit as much farther from JAX's Pallas route as
JAX's own two routes (use_pallas True and False) sit apart
(att.1.time_output_w1: 1.2e-4 from the Pallas route, which is 5.0e-5
from JAX's jnp route).  bf16 scores within 1e-2 of the largest |score|
(both packages round the same operands, XLA and torch the intermediate
ops at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import params_from_jax
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as trk
from mtamrecommender_tpu_torch.serve import Recommender

from helpers import make_batch
from test_torch_readout_paths import B, REL_GRAD_F32, REL_OUT_F32, _cfg, \
    _models, _rel

torch.set_num_threads(2)

REL_BF16 = 1e-2


L_SLICE = 256
SEQ_LENS = [L_SLICE, 130, 9, 2]


def _slice_batches():
    jmeta = jtypes.DatasetMeta(20, 60, 5, L_SLICE)
    jb = make_batch(jmeta, batch_size=B, seed=3, seq_lens=SEQ_LENS)
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0)
    tb = ttypes.batch_from_numpy({f: np.asarray(getattr(jb, f))
                                  for f in jb._fields}, device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def slice_f32():
    """JAX's f32 loss and gradients at L=256 through both Pallas kernels
    (GRU scan and readout, interpret mode)."""
    cfg = _cfg(L_SLICE)
    jmeta, tmeta, params, model = _models(cfg, L_SLICE)
    jb, tb = _slice_batches()

    def loss_fn(p):
        m = jbase.compute_loss(jget_model("MTAM"), p, cfg.model, jb, True,
                               None, jmeta.item_vocab)
        return m["loss"], m

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                     has_aux=True))(params)
    jnp_cfg = _cfg(L_SLICE, **{"model.use_pallas": False})
    jnp_grads = jax.jit(jax.grad(lambda p: jbase.compute_loss(
        jget_model("MTAM"), p, jnp_cfg.model, jb, True, None,
        jmeta.item_vocab)["loss"]))(params)
    return dict(cfg=cfg, tmeta=tmeta, model=model, tb=tb, metrics=metrics,
                grads=params_from_jax(jax.device_get(grads)),
                jnp_grads=params_from_jax(jax.device_get(jnp_grads)))


def test_long_history_loss_and_grads_match_jax_f32(slice_f32, monkeypatch):
    s = slice_f32
    calls = []
    real = trk.fused_readout_bwd

    def spy(*a):
        calls.append("bwd")
        return real(*a)
    monkeypatch.setattr(trk, "fused_readout_bwd", spy)
    got = tbase.compute_loss(get_model("MTAM"), s["model"], s["cfg"].model,
                             s["tb"], s["tmeta"].item_vocab)
    got["loss"].backward()
    assert calls == ["bwd"]                   # one backward for all hops
    for key in ("loss", "ce", "l2"):
        np.testing.assert_allclose(got[key].item(), float(s["metrics"][key]),
                                   rtol=REL_OUT_F32, err_msg=key)
    grads = {n: p.grad for n, p in s["model"].named_parameters()}
    assert set(grads) == set(s["grads"])
    for name, g in grads.items():
        want = s["grads"][name].numpy()
        routes = np.abs(want - s["jnp_grads"][name].numpy()).max()
        assert g.dtype == torch.float32, name
        assert np.abs(g.numpy() - want).max() <= (
            REL_GRAD_F32 * max(np.abs(want).max(), 1e-30) + routes), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_history_scores_match_jax(dtype):
    """Recommender at L=256 (its scoring batch through the readout kernel's
    twin) against JAX `scores_for_eval` with use_pallas=True."""
    cfg = _cfg(L_SLICE, **{"model.compute_dtype": dtype})
    jmeta, tmeta, params, _ = _models(cfg, L_SLICE)
    rec = Recommender(cfg, tmeta, params, device="cpu")
    _, tb = _slice_batches()
    jb = jtypes.Batch(**{f: jnp.asarray(getattr(tb, f).numpy())
                         for f in tb._fields})
    want = np.asarray(jbase.scores_for_eval(jget_model("MTAM"), params,
                                            cfg.model, jb, jmeta.item_vocab))
    with torch.no_grad():
        got = tbase.scores_for_eval(rec.model_def, rec._model_c, cfg.model,
                                    tb, tmeta.item_vocab).numpy()
    vocab = jmeta.item_vocab            # the padded columns hold -2^32+1
    tol = REL_OUT_F32 if dtype == "float32" else REL_BF16
    assert _rel(got[:, :vocab], want[:, :vocab]) <= tol
