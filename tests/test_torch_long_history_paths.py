"""Serving and training past 1024 keys in the port against JAX.

Above 1024 keys the JAX package's attention takes `_attn_kernel_blockwise`
(no dropout; its backward recomputes through `jax.vjp` of the jnp
reference) and keeps attention-weight dropout on its jnp path; the port
takes its blockwise kernel (here its plain twin), the autograd of
`reference_middle` for the backward, and the dense route for dropout.
Here, at L = 1100 (d = 16, 2 blocks), on the same parameters (the JAX
init, converted by `bridge.load_jax_params`) and numpy batches: the route
at 1024 and 1025 keys, read from the wrappers' counters; every model's
serving scores against JAX with use_pallas=True (Pallas in interpret
mode); Time_Aware_SA's loss and gradients; SASrec's and TiSAS's at
dropout 0.5 with JAX's masks rebuilt as tests/test_torch_attention_paths.py
does; MTAM's loss and gradients (its readout in plain PyTorch, as JAX's).

Tolerances: f32 scores and losses within 1e-5 of the largest |value|,
gradient leaves within 1e-4 of each leaf's largest |value| (MTAM's 1e-5,
as tests/test_torch_train.py holds it).  In bf16 compute (Time_Aware_SA,
and SASrec / TiSAS at dropout 0.5) the loss and each gradient leaf are
held as chip_smoke.py holds the card's bf16 step against the CPU: within
TRAIN_TOL_BF16 (5e-2) of the leaf's largest f32 |value| plus JAX's own
bf16-vs-f32 gap on that leaf.  Past 1024 keys the port's dense backward
and dropout route compute in f32 where JAX computes in bf16; these cases
measure that gap.
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
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops import attention as tatt
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak

from helpers import make_batch

torch.set_num_threads(2)

L, D, BLOCKS, B = 1100, 16, 2, 2
SEQ_LENS = [L, 300]
REL_F32, REL_GRAD = 1e-5, 1e-4
TRAIN_TOL_BF16 = 5e-2     # chip_smoke.py's TRAIN_TOL["bfloat16"]


def _cfg(name, gate="positional", **kw):
    over = {"model.experiment_type": name, "model.num_units": D,
            "model.num_blocks": BLOCKS, "data.max_seq_len": L,
            "model.vocab_pad_multiple": 16, "model.use_pallas": True,
            "model.dropout": 0.0, "model.time_gate_mode": gate}
    over.update(kw)
    return ExperimentConfig().with_overrides(**over)


def _meta():
    return (jtypes.DatasetMeta(20, 60, 5, L), ttypes.DatasetMeta(20, 60, 5, L))


def _models(name, cfg):
    jmeta, tmeta = _meta()
    params = jax.device_get(jget_model(name).init(jax.random.PRNGKey(0),
                                                  cfg.model, jmeta))
    model = get_model(name).init(torch.Generator().manual_seed(0),
                                 cfg.model, tmeta)
    return params, load_jax_params(model, params)


def _batches(seed=5):
    jmeta, _ = _meta()
    jb = make_batch(jmeta, batch_size=B, seed=seed, seq_lens=SEQ_LENS)
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0)
    tb = ttypes.batch_from_numpy({f: np.asarray(getattr(jb, f))
                                  for f in jb._fields}, device="cpu")
    return jb, tb


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _counts():
    return {"single": dict(tak.launches), "bwd": dict(tak.bwd_launches),
            "blockwise": dict(tak.blockwise_launches),
            "dense_fwd": dict(tak.dense_fwd), "dense_bwd": dict(tak.dense_bwd)}


def _delta(before, after):
    return {k: {m: after[k][m] - before[k][m] for m in after[k]
                if after[k][m] != before[k][m]} for k in after}


# ------------------------------------------------------------ routes

def test_route_helper():
    assert tak.route(1024, False) == tak.route(1024, True) == "single_tile"
    assert tak.route(1025, False) == "blockwise"
    assert tak.route(1025, True) == "dense"
    assert tak.route(tak.MAX_KEYS, False) == "blockwise"
    assert tak.route(tak.MAX_KEYS + 1, False) == "dense"
    assert tak.supported(tak.MAX_KEYS, 1) and not tak.supported(1025, 2)
    assert tak.dropout_supported(1024) and not tak.dropout_supported(1025)


@pytest.fixture
def twins_count(monkeypatch):
    """The plain twins count their calls here as their kernels count
    launches on the card."""
    def counting(counter, plain):
        def run(mode, *args):
            counter[mode] += 1
            return plain(mode, *args)
        return run

    for name, counter in (("fused_attention_plain", tak.launches),
                          ("fused_attention_blockwise_plain",
                           tak.blockwise_launches),
                          ("fused_attention_bwd_plain", tak.bwd_launches)):
        monkeypatch.setattr(tak, name, counting(counter, getattr(tak, name)))


@pytest.mark.parametrize("kind", ["plain", "time", "tisas"])
@pytest.mark.parametrize("tk", [1024, 1025])
def test_route_by_key_count(twins_count, kind, tk):
    """One block at Tq = Tk: forward and backward through the wrappers;
    then a rate-0.5 training call, which takes the kernel's drop mode at
    1024 keys and the dense route at 1025."""
    gen = torch.Generator().manual_seed(tk)
    block = tatt.init_attention_stack(gen, 1, D, kind=kind, t_q_len=tk,
                                      t_k_len=tk)[0]
    block = (tatt.TimeAttentionBlock if kind == "time"
             else tatt.MHABlock)(block)
    x = torch.randn((1, tk, D), generator=gen, requires_grad=True)
    times = torch.sort(torch.rand((1, tk), generator=gen) * 500).values
    lens = torch.tensor([tk - 7], dtype=torch.int32)
    mode = kind

    def call(**kw):
        if kind == "plain":
            return tatt.multihead_attention(block, x, x, lens, lens, **kw)
        if kind == "tisas":
            return tatt.tisas_multihead_attention(block, x, x, lens, lens,
                                                  times, times, **kw)
        return tatt.time_aware_multihead_attention(block, x, x, lens, lens,
                                                   times, times)

    before = _counts()
    call(train=False).sum().backward()
    got = _delta(before, _counts())
    if tk <= 1024:
        assert got == {"single": {mode: 1}, "bwd": {mode: 1},
                       "blockwise": {}, "dense_fwd": {}, "dense_bwd": {}}
    else:
        assert got == {"single": {}, "bwd": {}, "blockwise": {mode: 1},
                       "dense_fwd": {}, "dense_bwd": {mode: 1}}
    if kind == "time":
        return
    before = _counts()
    call(dropout_rate=0.5, train=True,
         gen=torch.Generator().manual_seed(1)).sum().backward()
    got = _delta(before, _counts())
    drop = f"{kind}_drop"
    if tk <= 1024:
        assert got == {"single": {drop: 1}, "bwd": {drop: 1},
                       "blockwise": {}, "dense_fwd": {}, "dense_bwd": {}}
    else:
        assert got == {"single": {}, "bwd": {}, "blockwise": {},
                       "dense_fwd": {drop: 1}, "dense_bwd": {}}


def test_kernel_wrapper_refuses_what_jax_refuses():
    """A drop mask above 1024 keys has no kernel in either package."""
    tk = 1025
    z = torch.zeros
    args = (z(1, 1, D), z(1, tk, D), z(1, tk, D), z(1, 1), z(1, tk),
            z(1, 1, D), z(1, tk, D), *(z(1, tk) for _ in range(5)),
            torch.tensor([tk], dtype=torch.int32))
    with pytest.raises(ValueError, match="dense_attention"):
        tak.fused_attention("plain_drop", *args, z(1, 1, tk))
    out = tak.dense_attention("plain_drop", *args, torch.ones(1, 1, tk))
    assert torch.allclose(out, tak.fused_attention("plain", *args),
                          atol=1e-6)


# ------------------------------------------------------------ serving

SERVING = [("SASrec", "positional"), ("Ti_Self_Attention_Model", "positional"),
           ("Time_Aware_Self_Attention_Model", "positional"),
           ("Time_Aware_Self_Attention_Model", "scalar"),
           ("MTAM", "positional"), ("MTAM", "scalar")]


@pytest.mark.parametrize("name,gate", SERVING)
def test_scores_for_eval_match_jax(twins_count, name, gate):
    cfg = _cfg(name, gate)
    params, model = _models(name, cfg)
    jmeta, tmeta = _meta()
    jb, tb = _batches()
    want = np.asarray(jax.jit(lambda p, b: jbase.scores_for_eval(
        jget_model(name), p, cfg.model, b, jmeta.item_vocab))(params, jb))
    before = _counts()
    with torch.no_grad():
        got = tbase.scores_for_eval(get_model(name), model, cfg.model, tb,
                                    tmeta.item_vocab).numpy()
    counts = _delta(before, _counts())
    assert _rel(got, want) <= REL_F32
    mode = {"SASrec": "plain", "Ti_Self_Attention_Model": "tisas"}.get(
        name, "time")
    assert counts["blockwise"] == {mode: BLOCKS} and not counts["single"]


# ------------------------------------------------------------ training

def _loss_and_grads(name, cfg, params, model, rng=None, masks=None,
                    rel_grad=REL_GRAD):
    jmeta, tmeta = _meta()
    jb, tb = _batches()

    def loss_fn(p):
        m = jbase.compute_loss(jget_model(name), p, cfg.model, jb, True,
                               rng, jmeta.item_vocab)
        return m["loss"], m

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    jgrads = params_from_jax(jax.device_get(jgrads))
    got = tbase.compute_loss(get_model(name), model, cfg.model, tb,
                             tmeta.item_vocab,
                             gen=None if masks is None else iter(masks))
    got["loss"].backward()
    for key in ("loss", "ce", "l2"):
        assert abs(got[key].item() - float(want[key])) \
            <= REL_F32 * max(abs(float(want[key])), 1.0), key
    for leaf, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, leaf
        assert _rel(p.grad.numpy(), jgrads[leaf].numpy()) <= rel_grad, leaf


def _bf16_loss_and_grads(name, cfg, rng=None, masks=None):
    """One bf16 step of the port against JAX's bf16 step on the same
    parameters and batch: the loss and every gradient leaf within
    TRAIN_TOL_BF16 of JAX's f32 value's largest |value| plus JAX's own
    bf16-vs-f32 gap.  Returns {leaf: (port gap, JAX's own gap), "loss":
    ...}, each over the largest f32 |value|."""
    jmeta, tmeta = _meta()
    jb, tb = _batches()
    cfg16 = cfg.with_overrides(**{"model.compute_dtype": "bfloat16"})
    params, model = _models(name, cfg16)
    want = {}
    for key, c in (("f32", cfg), ("bf16", cfg16)):
        def loss_fn(p, c=c):
            m = jbase.compute_loss(jget_model(name), p, c.model, jb, True,
                                   rng, jmeta.item_vocab)
            return m["loss"], m
        (_, m), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        want[key] = (float(m["loss"]),
                     params_from_jax(jax.device_get(g)))
    got = tbase.compute_loss(get_model(name), model, cfg16.model, tb,
                             tmeta.item_vocab,
                             gen=None if masks is None else iter(masks))
    got["loss"].backward()
    (l32, g32), (l16, g16) = want["f32"], want["bf16"]
    gaps = {"loss": (abs(got["loss"].item() - l16) / abs(l32),
                     abs(l16 - l32) / abs(l32))}
    for leaf, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), leaf
        scale = max(np.abs(g32[leaf].numpy()).max(), 1e-30)
        gaps[leaf] = (np.abs(p.grad.numpy() - g16[leaf].numpy()).max() / scale,
                      np.abs(g16[leaf].numpy() - g32[leaf].numpy()).max()
                      / scale)
    for leaf, (gap, own) in gaps.items():
        assert gap <= TRAIN_TOL_BF16 + own, (leaf, gap, own)
    return gaps


def test_time_aware_sa_loss_and_grads_match_jax(twins_count):
    name = "Time_Aware_Self_Attention_Model"
    cfg = _cfg(name)
    params, model = _models(name, cfg)
    before = _counts()
    _loss_and_grads(name, cfg, params, model, rng=jax.random.PRNGKey(1))
    assert _delta(before, _counts()) == {
        "single": {}, "bwd": {}, "blockwise": {"time": BLOCKS},
        "dense_fwd": {}, "dense_bwd": {"time": BLOCKS}}


def test_time_aware_sa_bf16_loss_and_grads_match_jax(twins_count):
    """bf16 compute at 1100 keys: the blockwise forward (JAX: Pallas in
    bf16) and the dense backward (JAX: jax.vjp of the jnp reference on
    bf16 operands; the port's autograd of `reference_middle`)."""
    name = "Time_Aware_Self_Attention_Model"
    before = _counts()
    _bf16_loss_and_grads(name, _cfg(name), rng=jax.random.PRNGKey(1))
    assert _delta(before, _counts()) == {
        "single": {}, "bwd": {}, "blockwise": {"time": BLOCKS},
        "dense_fwd": {}, "dense_bwd": {"time": BLOCKS}}


@pytest.mark.parametrize("gate", ["positional", "scalar"])
def test_mtam_loss_and_grads_match_jax(twins_count, gate):
    """MTAM trains past 1024 keys on the hop-batched readout in plain
    PyTorch (`single_query_readout`: no attention, readout or chain
    kernel) and the GRU scan's backward.  JAX runs its jnp route
    (use_pallas False: the GRU kernel in interpret mode over 1100 steps
    would take minutes); its readout is the same in both routes.
    Gradients within 1e-5 of each leaf's largest |value|, as
    tests/test_torch_train.py holds MTAM at L=12."""
    name = "MTAM"
    cfg = _cfg(name, gate, **{"model.use_pallas": False})
    params, model = _models(name, cfg)
    before = _counts()
    _loss_and_grads(name, cfg, params, model, rel_grad=REL_F32)
    assert _delta(before, _counts()) == {
        "single": {}, "bwd": {}, "blockwise": {}, "dense_fwd": {},
        "dense_bwd": {}}


@pytest.mark.parametrize("name", ["SASrec", "Ti_Self_Attention_Model"])
def test_dropout_training_matches_jax_with_its_masks(twins_count, name):
    """At dropout 0.5 and 1100 keys JAX drops on its jnp path; the port
    takes the dense route with JAX's masks injected."""
    cfg = _cfg(name, **{"model.dropout": 0.5})
    params, model = _models(name, cfg)
    rng = jax.random.PRNGKey(7)
    apply_rng = jax.random.split(rng)[0]
    shape = jnp.zeros((B, L, 1))
    masks = [torch.tensor(np.asarray(jatt._draw_drop_mask(
        jax.random.fold_in(apply_rng, i), shape, shape, 0.5, True)))
        for i in range(BLOCKS)]
    before = _counts()
    _loss_and_grads(name, cfg, params, model, rng=rng, masks=masks)
    drop = "plain_drop" if name == "SASrec" else "tisas_drop"
    assert _delta(before, _counts()) == {
        "single": {}, "bwd": {}, "blockwise": {},
        "dense_fwd": {drop: BLOCKS}, "dense_bwd": {}}


def _jax_masks(rng):
    apply_rng = jax.random.split(rng)[0]
    shape = jnp.zeros((B, L, 1))
    return [torch.tensor(np.asarray(jatt._draw_drop_mask(
        jax.random.fold_in(apply_rng, i), shape, shape, 0.5, True)))
        for i in range(BLOCKS)]


@pytest.mark.parametrize("name", ["SASrec", "Ti_Self_Attention_Model"])
def test_dropout_training_bf16_matches_jax_with_its_masks(twins_count, name):
    """bf16 compute at dropout 0.5 and 1100 keys: JAX's jnp dropout path
    in bf16, the port's dense route with JAX's masks."""
    rng = jax.random.PRNGKey(7)
    before = _counts()
    _bf16_loss_and_grads(name, _cfg(name, **{"model.dropout": 0.5}),
                         rng=rng, masks=_jax_masks(rng))
    drop = "plain_drop" if name == "SASrec" else "tisas_drop"
    assert _delta(before, _counts()) == {
        "single": {}, "bwd": {}, "blockwise": {},
        "dense_fwd": {drop: BLOCKS}, "dense_bwd": {}}
