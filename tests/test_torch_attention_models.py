"""The port's self-attention models (SASrec, Time_Aware_SA, TiSAS)
against the JAX package.

Parameters come from the JAX package's init through
`bridge.load_jax_params`; batches are made with numpy from a seed.  JAX
runs both of its routes: the jnp path (use_pallas=False) and the Pallas
kernels in interpret mode (use_pallas=True), as tests/test_pallas.py runs
them.  The port has one route: the fused attention kernel and its
backward, here their plain twins on the CPU.

Dropout: torch's generators cannot give JAX's threefry bits, so where a
test drops attention weights it draws JAX's masks (`_draw_drop_mask` with
the rng JAX's forward folds for each block) and hands them to the port
as its mask source, an iterator in place of a generator.

The training and serving paths (dropout with JAX's masks, the scalar
gate, a 3-step trajectory, the step's generator, `Recommender`, the
weight bridge) are in tests/test_torch_attention_paths.py.

Tolerances (as tests/test_torch_train.py):
  * f32 modules: atol 1e-5; f32 loss terms: 1e-5; f32 gradient leaves:
    1e-5 of each leaf's largest |value|; the 3-step f32 trajectory:
    losses to atol 1e-5, and 99 % of each leaf's final parameters to
    1e-5, all to 2e-4: Adam divides by sqrt(nu) + 1e-8, so where a
    gradient element is ~1e-8 (about 50 of the 256 in a block's q.w
    here, behind dead relus) f32 noise of ~1e-9 in it moves the step by
    up to ~lr/10 = 1e-4;
  * bf16 compute: the loss to 2e-2 of its value; each gradient leaf no
    farther from JAX's bf16 leaf than JAX's bf16 leaf is from its f32
    leaf, plus 5e-2 of the f32 leaf's largest |value| (the packages
    round activations to bf16 at different places, and the hour stamps
    lose their low bits in bf16);
  * serving scores: atol 1e-4 (three blocks of 16-wide products).
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
from mtamrecommender_tpu_torch.ops import layers as tlayers

from helpers import make_batch

torch.set_num_threads(2)

D, L, BLOCKS, B = 16, 8, 2, 8
ATOL_F32 = 1e-5
REL_GRAD_F32 = 1e-5
REL_LOSS_BF16 = 2e-2
REL_GRAD_BF16 = 5e-2
ATOL_SCORES_F32 = 1e-4
TRAJ_PARAM_ATOL = 2e-4
SEQ_LENS = [1, 2, L, 5, L, 3, 7, 6]
MODELS = ("SASrec", "Time_Aware_Self_Attention_Model",
          "Ti_Self_Attention_Model")
KINDS = {"SASrec": "plain", "Time_Aware_Self_Attention_Model": "time",
         "Ti_Self_Attention_Model": "tisas"}


def _cfg(name, **kw):
    over = {"model.experiment_type": name, "model.num_units": D,
            "model.num_blocks": BLOCKS, "data.max_seq_len": L,
            "model.vocab_pad_multiple": 16,
            # the time kind never drops, so it keeps the default rate
            "model.dropout": 0.5 if KINDS[name] == "time" else 0.0}
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


def _to_torch_batch(jb):
    return ttypes.batch_from_numpy({f: np.asarray(getattr(jb, f))
                                    for f in jb._fields}, device="cpu")


def _batches(seed=5, valid=None):
    jmeta, _ = _meta()
    jb = make_batch(jmeta, batch_size=B, seed=seed, seq_lens=SEQ_LENS)
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0)
    if valid is not None:
        jb = jb._replace(valid=jnp.asarray(valid, jnp.float32))
    return jb, _to_torch_batch(jb)


def _jax_loss_and_grads(name, cfg, params, jb, rng=None):
    jmeta, _ = _meta()

    def loss_fn(p):
        m = jbase.compute_loss(jget_model(name), p, cfg.model, jb, True,
                               rng, jmeta.item_vocab)
        return m["loss"], m

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                     has_aux=True))(params)
    return metrics, params_from_jax(jax.device_get(grads))


def _port_loss_and_grads(name, cfg, model, tb, gen=None):
    _, tmeta = _meta()
    metrics = tbase.compute_loss(get_model(name), model, cfg.model, tb,
                                 tmeta.item_vocab, gen=gen)
    metrics["loss"].backward()
    return metrics, {n: p.grad for n, p in model.named_parameters()}


def _assert_f32_match(got, want, tgrads, jgrads):
    for key in ("loss", "ce", "l2"):
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   atol=ATOL_F32, rtol=ATOL_F32, err_msg=key)
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        w = jgrads[name].numpy()
        assert g is not None and g.dtype == torch.float32, name
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= REL_GRAD_F32 * scale, name


# ------------------------------------------------------------ dropout

def test_dropout_and_drop_mask():
    y = tlayers.draw_drop_mask(torch.Generator().manual_seed(3), 4, 64, 64,
                               0.25, "cpu")
    assert set(torch.unique(y).tolist()) == {0.0,
                                             float(torch.tensor(1 / 0.75))}
    assert abs((y > 0).float().mean().item() - 0.75) < 0.03
    m = tlayers.draw_drop_mask(torch.Generator().manual_seed(3), 4, 8, 8,
                               0.5, "cpu")
    assert m.dtype == torch.float32 and m.shape == (4, 8, 8)
    assert set(torch.unique(m).tolist()) == {0.0, 2.0}
    again = tlayers.draw_drop_mask(torch.Generator().manual_seed(3), 4, 8,
                                   8, 0.5, "cpu")
    assert torch.equal(m, again)
    # masks drawn elsewhere are handed out in order, and checked
    source = iter([m, again * 0])
    assert tlayers.draw_drop_mask(source, 4, 8, 8, 0.5, "cpu") is m
    assert not tlayers.draw_drop_mask(source, 4, 8, 8, 0.5, "cpu").any()
    with pytest.raises(ValueError, match="drop mask"):
        tlayers.draw_drop_mask(iter([m]), 4, 8, 9, 0.5, "cpu")


# ------------------------------------------------ attention modules

def _port_block(jblock, kind):
    as_t = lambda t: {k: (as_t(v) if isinstance(v, dict)  # noqa: E731
                          else torch.tensor(np.asarray(v)))
                      for k, v in t.items()}
    cls = tatt.TimeAttentionBlock if kind == "time" else tatt.MHABlock
    return cls(as_t(jax.device_get(jblock)))


@pytest.mark.parametrize("kind", ["plain", "time", "tisas"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_modules_match_jax_at_tq_gt_1(kind, use_pallas):
    """One self-attention block, forward and gradients of the input and
    every parameter, f32, with JAX's rate-0.5 masks injected (the time
    kind does not drop)."""
    r = np.random.RandomState(12)
    jp = jatt.init_attention_stack(jax.random.PRNGKey(4), 1, D, kind=kind,
                                   t_q_len=L, t_k_len=L)[0]
    enc = r.randn(B, L, D).astype(np.float32)
    times = np.sort(r.rand(B, L).astype(np.float32) * 300, axis=1)
    lens = np.array(SEQ_LENS, np.int32)
    w_out = r.randn(B, L, D).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    kw = dict(num_heads=1, dropout_rate=0.5, train=True, rng=rng,
              use_pallas=use_pallas)

    def jloss(p, x):
        if kind == "plain":
            out, _ = jatt.multihead_attention(p, x, x, jnp.asarray(lens),
                                              jnp.asarray(lens), **kw)
        else:
            fn = (jatt.time_aware_multihead_attention if kind == "time"
                  else jatt.tisas_multihead_attention)
            out, _ = fn(p, x, x, jnp.asarray(lens), jnp.asarray(lens),
                        jnp.asarray(times), jnp.asarray(times), **kw)
        return jnp.sum(out * w_out), out

    (_, want), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(enc))
    block = _port_block(jp, kind)
    x = torch.tensor(enc, requires_grad=True)
    lt, tt = torch.tensor(lens), torch.tensor(times)
    if kind == "time":
        got = tatt.time_aware_multihead_attention(block, x, x, lt, lt, tt, tt)
    else:
        dm = torch.tensor(np.asarray(jatt._draw_drop_mask(
            rng, jnp.asarray(enc), jnp.asarray(enc), 0.5, True)))
        fn = (tatt.multihead_attention if kind == "plain"
              else lambda *a, **k: tatt.tisas_multihead_attention(
                  *a[:5], tt, tt, **k))
        got = fn(block, x, x, lt, lt, dropout_rate=0.5, train=True,
                 gen=iter([dm]))
        # the mask matters: without it the output differs
        assert not torch.allclose(got, fn(block, x, x, lt, lt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_F32, rtol=0)
    (got * torch.tensor(w_out)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx),
                               atol=ATOL_F32, rtol=0)
    jg = params_from_jax(jax.device_get(jgp))
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(),
                                   atol=ATOL_F32, rtol=0, err_msg=name)


def test_unported_attention_options_raise():
    """Two heads run (on the dense route) and match JAX's jnp path; a
    head count that does not divide d, and an unknown kind, raise."""
    jp = jatt.init_attention_stack(jax.random.PRNGKey(4), 1, D, kind="plain")
    block = _port_block(jp[0], "plain")
    enc = np.random.RandomState(3).randn(B, L, D).astype(np.float32)
    want, _ = jatt.multihead_attention(
        jp[0], jnp.asarray(enc), jnp.asarray(enc),
        jnp.asarray(SEQ_LENS, jnp.int32), jnp.asarray(SEQ_LENS, jnp.int32),
        num_heads=2, train=False)
    x = torch.tensor(enc)
    lens = torch.tensor(SEQ_LENS, dtype=torch.int32)
    got = tatt.multihead_attention(block, x, x, lens, lens, num_heads=2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_F32, rtol=0)
    with pytest.raises(ValueError, match="num_heads=3"):
        tatt.multihead_attention(block, x, x, lens, lens, num_heads=3)
    with pytest.raises(ValueError, match="kind"):
        tatt.self_attention_stack([block], x, lens, lens, kind="cross",
                                  num_heads=1, dropout_rate=0.0, train=False)


# ------------------------------------------------------------ models

@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_compute_loss_and_grads_match_jax_f32(name, use_pallas):
    cfg = _cfg(name, **{"model.use_pallas": use_pallas})
    params, model = _models(name, cfg)
    # one filler row (valid 0), as an epoch's last batch has
    jb, tb = _batches(valid=[1, 1, 1, 1, 1, 1, 1, 0])
    rng = jax.random.PRNGKey(1) if KINDS[name] == "time" else None
    want, jgrads = _jax_loss_and_grads(name, cfg, params, jb, rng)
    got, tgrads = _port_loss_and_grads(name, cfg, model, tb)
    _assert_f32_match(got, want, tgrads, jgrads)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_compute_loss_and_grads_match_jax_bf16(name, use_pallas):
    cfg = _cfg(name, **{"model.use_pallas": use_pallas,
                        "model.compute_dtype": "bfloat16"})
    params, model = _models(name, cfg)
    jb, tb = _batches()
    want, jgrads = _jax_loss_and_grads(name, cfg, params, jb)
    _, jgrads32 = _jax_loss_and_grads(
        name, _cfg(name, **{"model.use_pallas": use_pallas}), params, jb)
    got, tgrads = _port_loss_and_grads(name, cfg, model, tb)
    assert got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=REL_LOSS_BF16)
    for leaf, g in tgrads.items():
        w, w32 = jgrads[leaf].numpy(), jgrads32[leaf].numpy()
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), leaf
        assert np.abs(g.numpy() - w).max() <= (
            REL_GRAD_BF16 * np.abs(w32).max() + np.abs(w - w32).max()), leaf
