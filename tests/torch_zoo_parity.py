"""Shared parity checks of the port's zoo models against the JAX package
(used by tests/test_torch_rnn_models.py, tests/test_torch_mtam_ablations.py,
tests/test_torch_mtam_ablations_via.py,
tests/test_torch_mtam_hybird.py, tests/test_torch_zoo_checkpoint.py,
tests/test_torch_narm.py, tests/test_torch_lstur_stamp.py,
tests/test_torch_mtam_no_time_att.py, tests/test_torch_pistrec*.py,
tests/test_torch_bprmf.py and tests/test_torch_multihead_*.py).

Parameters come from the JAX package's init through
`bridge.load_jax_params`; batches are made with numpy from a seed, with
one filler row and a row of ``seq_len`` 1 (an empty history: GRU length
0, gathered at -1), at ``data.max_seq_len`` L or, where ``over`` sets it,
that length (`seq_lens`).  JAX runs both of its routes: the jnp path
(use_pallas=False) and the Pallas kernels in interpret mode
(use_pallas=True).  ``over`` is a tuple of extra (config key, value)
pairs; ``rng_seed`` gives JAX's loss an rng (PRNGKey(rng_seed)) and the
port what JAX draws from it: the bpr loss's negative item
(`jax_negative`) and, for ``n_masks`` plain readout hops, each hop's
attention-weight dropout mask (`jax_readout_masks`); ``masks``, where
given, are the port's masks instead (multi-head self-attention's:
`jax_block_masks`).

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
from mtamrecommender_tpu.ops import attention as jatt
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


def meta(length=L):
    return (jtypes.DatasetMeta(20, 60, 5, length),
            ttypes.DatasetMeta(20, 60, 5, length))


def seq_lens(length=L):
    """SEQ_LENS at ``data.max_seq_len`` = length: past L, two full rows,
    two ragged ones near half and near all of it, and short rows."""
    if length == L:
        return SEQ_LENS
    return [1, 2, length, 5, length, 3, length // 2 + 1, length - 5]


def jax_params(name, c, seed=0):
    jmeta, _ = meta(c.data.max_seq_len)
    return jax.device_get(jget_model(name).init(jax.random.PRNGKey(seed),
                                                c.model, jmeta))


def models(name, c, seed=0):
    """(JAX's parameters, the port's model loaded with them)."""
    _, tmeta = meta(c.data.max_seq_len)
    params = jax_params(name, c, seed)
    model = get_model(name).init(torch.Generator().manual_seed(0), c.model,
                                 tmeta)
    return params, load_jax_params(model, params)


def to_torch_batch(jb):
    return ttypes.batch_from_numpy({f: np.asarray(getattr(jb, f))
                                    for f in jb._fields}, device="cpu")


def batches(seed=5, valid=VALID, length=L):
    jmeta, _ = meta(length)
    jb = make_batch(jmeta, batch_size=B, seed=seed, seq_lens=seq_lens(length))
    # hours since the epoch, as served requests carry them
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0,
                     valid=jnp.asarray(valid, jnp.float32))
    return jb, to_torch_batch(jb)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(name, use_pallas, dtype, over=(), rng_seed=None):
    """JAX's loss terms and gradients by port name, memoized per module."""
    c = cfg(name, **{"model.use_pallas": use_pallas,
                     "model.compute_dtype": dtype, **dict(over)})
    jmeta, _ = meta(c.data.max_seq_len)
    params = jax_params(name, c)
    jb, _ = batches(length=c.data.max_seq_len)
    rng = None if rng_seed is None else jax.random.PRNGKey(rng_seed)

    def loss_fn(p):
        m = jbase.compute_loss(jget_model(name), p, c.model, jb, True, rng,
                               jmeta.item_vocab)
        return m["loss"], m

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                     has_aux=True))(params)
    return ({k: float(v) for k, v in metrics.items()},
            params_from_jax(jax.device_get(grads)))


def jax_negative(rng_seed):
    """The negative item JAX's bpr loss draws from compute_loss's rng:
    ``randint(split(rng)[1], (1,), 0, item_count)``, as an int32 tensor."""
    jmeta, _ = meta()
    loss_rng = jax.random.split(jax.random.PRNGKey(rng_seed))[1]
    neg = jax.random.randint(loss_rng, (1,), 0, jmeta.item_count)
    return torch.tensor(np.asarray(neg), dtype=torch.int32)


def jax_readout_masks(rng_seed, n_masks, rate=0.5):
    """The dropout masks of JAX's plain Tq=1 readout under compute_loss's
    rng: hop i draws bernoulli(fold_in(split(rng)[0], i), 1 - rate,
    [B, 1, 1, L]), here f32 [B, 1, L] of 0 or 1/(1 - rate)."""
    apply_rng = jax.random.split(jax.random.PRNGKey(rng_seed))[0]
    dec = jnp.zeros((B, 1, D), jnp.float32)
    enc = jnp.zeros((B, L, D), jnp.float32)
    return [torch.tensor(np.asarray(jatt._draw_drop_mask(
        jax.random.fold_in(apply_rng, i), dec, enc, rate, True)))
        for i in range(n_masks)]


def jax_block_masks(rng_seed, n_blocks, heads, rate=0.5):
    """The dropout masks of JAX's jnp self-attention blocks at ``heads``
    heads under compute_loss's rng: block i's `layers.dropout` draws
    bernoulli(fold_in(split(rng)[0], i), 1 - rate, [B, h, L, L]) on its
    weights, here f32 of 0 or 1/(1 - rate)."""
    apply_rng = jax.random.split(jax.random.PRNGKey(rng_seed))[0]
    keep = 1.0 - rate
    return [torch.tensor(np.asarray(jax.random.bernoulli(
        jax.random.fold_in(apply_rng, i), keep, (B, heads, L, L)),
        np.float32) / keep) for i in range(n_blocks)]


def _port_sources(name, rng_seed, n_masks, rate, masks=None):
    """(gen, neg_id) for the port's compute_loss: JAX's masks (``masks``
    where given) and, in the bpr mode, JAX's negative."""
    if rng_seed is None:
        return None, None
    gen = iter(jax_readout_masks(rng_seed, n_masks, rate)
               if masks is None else masks)
    neg = (jax_negative(rng_seed) if get_model(name).output_mode == "bpr"
           else None)
    return gen, neg


def port_loss_and_grads(name, c, model, tb, gen=None, neg_id=None):
    _, tmeta = meta(c.data.max_seq_len)
    metrics = tbase.compute_loss(get_model(name), model, c.model, tb,
                                 tmeta.item_vocab, gen=gen, neg_id=neg_id)
    metrics["loss"].backward()
    # a parameter the loss does not reach (Vallina_Gru4Rec's behavior
    # projection) has no grad; JAX's is zeros, as the train step takes it
    return metrics, {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p))
                     for n, p in model.named_parameters()}


def check_init_keys(name, over=()):
    """The port's init gives exactly JAX's key paths and shapes."""
    c = cfg(name, **dict(over))
    _, tmeta = meta(c.data.max_seq_len)
    want = {n: tuple(t.shape)
            for n, t in params_from_jax(jax_params(name, c)).items()}
    model = get_model(name).init(torch.Generator().manual_seed(0), c.model,
                                 tmeta)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert get_model(name).output_mode == jget_model(name).output_mode


def check_f32(name, use_pallas, over=(), rng_seed=None, n_masks=0,
              masks=None, pad_row_rel=None):
    """Loss terms and every gradient leaf of one f32 step.  With
    ``pad_row_rel`` row 0 of the position table, the padding position's,
    is held to that instead: it sums the cotangents of every padded slot
    of the batch (hundreds past 64 keys) in another order than JAX's
    scatter (tests/test_torch_chain_blocked_design.py)."""
    c = cfg(name, **dict(over))
    _, model = models(name, c)
    _, tb = batches(length=c.data.max_seq_len)
    want, jgrads = jax_loss_and_grads(name, use_pallas, "float32", over,
                                      rng_seed)
    gen, neg = _port_sources(name, rng_seed, n_masks, c.model.dropout, masks)
    got, tgrads = port_loss_and_grads(name, c, model, tb, gen, neg)
    for key in ("loss", "ce", "l2"):
        np.testing.assert_allclose(got[key].item(), want[key],
                                   atol=ATOL_F32, rtol=ATOL_F32, err_msg=key)
    assert set(tgrads) == set(jgrads)
    for leaf, g in tgrads.items():
        w = jgrads[leaf].numpy()
        assert g is not None and g.dtype == torch.float32, leaf
        scale = max(np.abs(w).max(), 1e-30)
        diff = np.abs(g.numpy() - w)
        if pad_row_rel is not None and leaf == "embedding.pos_table":
            assert diff[0].max() <= pad_row_rel * scale, leaf
            diff = diff[1:]
        assert diff.max() <= REL_GRAD_F32 * scale, leaf
    return tgrads


def check_bf16(name, use_pallas, over=(), rng_seed=None, n_masks=0,
               masks=None):
    """Loss and every gradient leaf of one step under bf16 compute."""
    c = cfg(name, **{"model.compute_dtype": "bfloat16", **dict(over)})
    _, model = models(name, c)
    _, tb = batches(length=c.data.max_seq_len)
    want, jgrads = jax_loss_and_grads(name, use_pallas, "bfloat16", over,
                                      rng_seed)
    _, jgrads32 = jax_loss_and_grads(name, use_pallas, "float32", over,
                                     rng_seed)
    gen, neg = _port_sources(name, rng_seed, n_masks, c.model.dropout, masks)
    got, tgrads = port_loss_and_grads(name, c, model, tb, gen, neg)
    assert got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), want["loss"],
                               rtol=REL_LOSS_BF16)
    assert set(tgrads) == set(jgrads)
    for leaf, g in tgrads.items():
        w, w32 = jgrads[leaf].numpy(), jgrads32[leaf].numpy()
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), leaf
        assert np.abs(g.numpy() - w).max() <= (
            REL_GRAD_BF16 * np.abs(w32).max() + np.abs(w - w32).max()), leaf


def _bf16_allowance(w, w32):
    return REL_GRAD_BF16 * np.abs(w32).max() + np.abs(w - w32).max()


def check_bf16_where_routes_agree(name, use_pallas, over=(), rng_seed=None,
                                  n_masks=0):
    """`check_bf16` against the JAX route ``use_pallas`` on every leaf
    where JAX's other route itself passes that check against it.  On a
    leaf where the other route does not, JAX's two bf16 routes differ by
    more than the allowance (the jnp route carries the GRU state in
    bf16, the Pallas route and the port in f32; in PISTRec the bf16
    hour stamps and the hard switch add more), so JAX gives two
    references: the port's leaf must pass `check_bf16`'s rule against
    one of them.  Where the routes agree on every leaf this is
    `check_bf16`.  Returns the leaves that passed against the other
    route only."""
    c = cfg(name, **{"model.compute_dtype": "bfloat16", **dict(over)})
    _, model = models(name, c)
    _, tb = batches(length=c.data.max_seq_len)
    route = {}
    for up in (use_pallas, not use_pallas):
        want, jgrads = jax_loss_and_grads(name, up, "bfloat16", over,
                                          rng_seed)
        _, jgrads32 = jax_loss_and_grads(name, up, "float32", over,
                                         rng_seed)
        route[up] = (want, jgrads, jgrads32)
    gen, neg = _port_sources(name, rng_seed, n_masks, c.model.dropout)
    got, tgrads = port_loss_and_grads(name, c, model, tb, gen, neg)
    assert got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), route[use_pallas][0]["loss"],
                               rtol=REL_LOSS_BF16)
    assert set(tgrads) == set(route[use_pallas][1])
    apart = []
    for leaf, g in tgrads.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), leaf
        w, w32 = (route[use_pallas][k][leaf].numpy() for k in (1, 2))
        if np.abs(g.numpy() - w).max() <= _bf16_allowance(w, w32):
            continue
        wo, wo32 = (route[not use_pallas][k][leaf].numpy() for k in (1, 2))
        assert np.abs(wo - w).max() > _bf16_allowance(w, w32), leaf
        assert np.abs(g.numpy() - wo).max() <= _bf16_allowance(wo, wo32), \
            leaf
        apart.append(leaf)
    return apart


def scores(name, dtype="float32", use_pallas=False, over=()):
    """(the port's scores, JAX's, the logical vocab) on one batch."""
    c = cfg(name, **{"model.compute_dtype": dtype,
                     "model.use_pallas": use_pallas, **dict(over)})
    params, model = models(name, c)
    jb, tb = batches(length=c.data.max_seq_len)
    jmeta, tmeta = meta(c.data.max_seq_len)
    want = np.asarray(jbase.scores_for_eval(jget_model(name), params,
                                            c.model, jb, jmeta.item_vocab))
    with torch.no_grad():
        got = tbase.scores_for_eval(get_model(name), model, c.model, tb,
                                    tmeta.item_vocab).numpy()
    return got, want, tmeta.item_vocab


def check_scores_f32(name, use_pallas, over=()):
    got, want, vocab = scores(name, use_pallas=use_pallas, over=over)
    assert got.shape == want.shape and got.dtype == np.float32
    # the padded table's columns hold the mask fill on both sides
    np.testing.assert_array_equal(got[:, vocab:], want[:, vocab:])
    scale = np.abs(want[:, :vocab]).max()
    assert np.abs(got[:, :vocab] - want[:, :vocab]).max() \
        <= REL_SCORES_F32 * scale
