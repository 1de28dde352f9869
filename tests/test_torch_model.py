"""The port's MTAM modules against the JAX package, layer by layer.

Parameters come from the JAX package's own init and reach the port
through `bridge.load_jax_params`; inputs are made with numpy from a
seed.  JAX runs both of its routes: the jnp path (use_pallas=False) and
the Pallas kernels in interpret mode (use_pallas=True), as
tests/test_pallas.py runs them.  The port has one route (its kernels,
here their plain twins on the CPU).

Tolerances: f32 modules agree to atol 1e-5 and the f32 MTAM scores to
atol 1e-4 (the logits sum 16 products of O(1) values after three hops).
Under bf16 compute both packages round every activation to bf16 but at
different places (XLA may keep fused intermediates in f32; torch rounds
after every op), and the JAX jnp route also carries the GRU state in
bf16, so bf16 scores are held to 2e-2 of the largest |score| (measured:
7e-3 on these inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.config import ExperimentConfig
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu.ops import layers as jlayers
from mtamrecommender_tpu.ops import time_gru as jtg
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops import attention as tatt
from mtamrecommender_tpu_torch.ops import layers as tlayers
from mtamrecommender_tpu_torch.ops import time_gru as ttg

from helpers import make_batch

torch.set_num_threads(2)

D, L, HOPS, B = 16, 12, 2, 8
ATOL_F32 = 1e-5
ATOL_SCORES_F32 = 1e-4
REL_SCORES_BF16 = 2e-2
# one empty history (seq_len 1: only the mask slot), one full row
SEQ_LENS = [1, 2, L, 5, L, 3, 7, 9]


def _cfg(**kw):
    over = {"model.num_units": D, "model.num_blocks": HOPS,
            "model.dropout": 0.0, "data.max_seq_len": L,
            "model.vocab_pad_multiple": 16}
    over.update({f"model.{k}": v for k, v in kw.items()})
    return ExperimentConfig().with_overrides(**over)


def _meta():
    return (jtypes.DatasetMeta(20, 60, 5, L), ttypes.DatasetMeta(20, 60, 5, L))


def _models(cfg):
    jmeta, tmeta = _meta()
    params = jax.device_get(jget_model("MTAM").init(jax.random.PRNGKey(0),
                                                    cfg.model, jmeta))
    model = get_model("MTAM").init(torch.Generator().manual_seed(0),
                                   cfg.model, tmeta)
    return params, load_jax_params(model, params)


def _batches():
    jmeta, _ = _meta()
    jb = make_batch(jmeta, batch_size=B, seed=5, seq_lens=SEQ_LENS)
    # hours since the epoch, as served requests carry them
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0)
    return jb, ttypes.batch_from_numpy(
        {f: np.asarray(getattr(jb, f)) for f in jb._fields}, device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tgru_net_matches_jax(use_pallas):
    params, model = _models(_cfg())
    r = np.random.RandomState(11)
    x = r.randn(B, L, D).astype(np.float32)
    t_last = np.abs(r.randn(B, L)).astype(np.float32) * 5
    t_now = np.abs(r.randn(B, L)).astype(np.float32) * 5
    lengths = np.array(SEQ_LENS, np.int32) - 1
    want = jtg.tgru_net(params["rnn"], jnp.asarray(x), jnp.asarray(t_last),
                        jnp.asarray(t_now), jnp.asarray(lengths),
                        use_pallas=use_pallas)
    got = ttg.tgru_net(model.rnn, torch.tensor(x), torch.tensor(t_last),
                       torch.tensor(t_now), torch.tensor(lengths))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_readout_matches_jax(use_pallas):
    """Two Tq=1 time-attention hops: JAX's hop-batched jnp readout
    (use_pallas=False) or its per-hop interpret kernels (use_pallas=True,
    train=False), against the port's per-hop kernel loop."""
    params, model = _models(_cfg())
    r = np.random.RandomState(12)
    enc = r.randn(B, L, D).astype(np.float32)
    dec = r.randn(B, 1, D).astype(np.float32)
    t_keys = np.sort(r.rand(B, L).astype(np.float32) * 300, axis=1)
    t_q = t_keys[:, -1:] + 2.0
    key_len = np.array(SEQ_LENS, np.int32)
    ones = np.ones((B,), np.int32)
    want = jatt.vanilla_attention_stack(
        params["att"], jnp.asarray(enc), jnp.asarray(dec),
        jnp.asarray(key_len), jnp.asarray(ones), kind="time", num_heads=1,
        dropout_rate=0.0, train=False, t_queries=jnp.asarray(t_q),
        t_keys=jnp.asarray(t_keys), use_pallas=use_pallas)
    with torch.no_grad():
        got = tatt.vanilla_attention_stack(
            model.att, torch.tensor(enc), torch.tensor(dec),
            torch.tensor(key_len), torch.tensor(ones), kind="time",
            num_heads=1, t_queries=torch.tensor(t_q),
            t_keys=torch.tensor(t_keys))
    assert got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32,
                               rtol=0)


def _scores(cfg):
    params, model = _models(cfg)
    jb, tb = _batches()
    jmeta, tmeta = _meta()
    want = np.asarray(jbase.scores_for_eval(jget_model("MTAM"), params,
                                            cfg.model, jb, jmeta.item_vocab))
    with torch.no_grad():
        got = tbase.scores_for_eval(get_model("MTAM"), model, cfg.model, tb,
                                    tmeta.item_vocab).numpy()
    return got, want, tmeta.item_vocab


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mtam_scores_match_jax_f32(use_pallas):
    got, want, vocab = _scores(_cfg(use_pallas=use_pallas))
    assert got.shape == want.shape == (B, 64)       # 63 rows padded to 64
    np.testing.assert_allclose(got, want, atol=ATOL_SCORES_F32, rtol=0)
    assert (got[:, vocab:] == tbase.NEG_FILL).all()   # padding masked


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mtam_scores_match_jax_bf16(use_pallas):
    got, want, vocab = _scores(_cfg(use_pallas=use_pallas,
                                    compute_dtype="bfloat16"))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = np.abs(want[:, :vocab]).max()
    assert np.abs(got[:, :vocab] - want[:, :vocab]).max() \
        <= REL_SCORES_BF16 * scale


def test_scalar_gate_mode_matches_jax():
    """JAX keeps scalar gates on its jnp path; the port broadcasts them to
    the kernel's [Tq, Tk] tiles.  Same math."""
    got, want, _ = _scores(_cfg(use_pallas=True, time_gate_mode="scalar"))
    np.testing.assert_allclose(got, want, atol=ATOL_SCORES_F32, rtol=0)


def test_bf16_compute_rounds_the_hour_stamps():
    """Hours since the epoch lose their low bits in bf16; the port keeps
    that behaviour of the JAX package instead of fixing it."""
    jb, tb = _batches()
    cfg = _cfg(compute_dtype="bfloat16")
    _, model = _models(cfg)
    _, cast = tbase._compute_cast(cfg.model, model, tb)
    want = np.asarray(jnp.asarray(jb.times, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(cast.times.float().numpy(), want)
    assert cast.seq_len.dtype == torch.int32
    assert not np.array_equal(want, np.asarray(jb.times))


def test_layers_match_jax():
    r = np.random.RandomState(13)
    # a row of tiny variance separates the two epsilons (1e-12 vs 1e-8)
    x = np.stack([r.randn(D), 1.0 + 1e-5 * r.randn(D)]).astype(np.float32)
    p = {"gamma": r.randn(D).astype(np.float32),
         "beta": r.randn(D).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = tlayers.LayerNorm({k: torch.tensor(v) for k, v in p.items()})
    with torch.no_grad():
        for jf, tf in ((jlayers.layer_norm, tlayers.layer_norm),
                       (jlayers.normalize, tlayers.normalize)):
            np.testing.assert_allclose(tf(tp, torch.tensor(x)).numpy(),
                                       np.asarray(jf(jp, jnp.asarray(x))),
                                       atol=1e-4, rtol=1e-4)
    seq = r.randn(3, 5, 4).astype(np.float32)
    pos = np.array([-1, 0, 4], np.int32)     # -1: an empty history's slot
    np.testing.assert_array_equal(
        tlayers.gather_positions(torch.tensor(seq), torch.tensor(pos)).numpy(),
        np.asarray(jlayers.gather_positions(jnp.asarray(seq),
                                            jnp.asarray(pos))))
