"""The port's MTAM training step against the JAX package.

Parameters come from the JAX package's init through
`bridge.load_jax_params`; batches are made with numpy from a seed.  JAX
runs both of its routes: the jnp path (use_pallas=False) and the Pallas
kernels in interpret mode (use_pallas=True), as tests/test_pallas.py runs
them.  JAX gradient trees reach the port's parameter names through
`bridge.params_from_jax`.

Tolerances:
  * modules in f32 (the hop-batched readout, the batch gather, one
    optimizer update): atol 1e-5; the LR schedule to rtol 1e-6 (numpy's
    and XLA's float32 powers may differ in the last bit);
  * the f32 loss and every gradient leaf of the whole step: atol 1e-5
    on the loss terms, and 1e-5 of each leaf's largest |value| on the
    gradients (the L2 sum runs over ~400 rows and the logits' gradient
    over 64 columns, summed in other orders);
  * the 3-step f32 trajectory: losses to atol 1e-5, final parameters to
    atol 1e-5 (each Adam step moves a parameter by at most ~lr = 1e-3);
  * bf16 compute: the loss to 2e-2 of its value; each gradient leaf no
    farther from JAX's bf16 leaf than JAX's bf16 leaf is from its f32
    leaf, plus 5e-2 of the f32 leaf's largest |value|.  The two packages
    round activations to bf16 at different places (XLA keeps some fused
    intermediates in f32, torch rounds after every op), JAX's jnp route
    carries the GRU state in bf16, and the hour stamps lose their low
    bits in bf16, so some leaves (the decay-gate params) are mostly
    rounding noise in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.config import ExperimentConfig
from mtamrecommender_tpu.data import device_data as jdd
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu.train import trainer as jtrainer
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.data import device_data as tdd
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops import attention as tatt
from mtamrecommender_tpu_torch.train import trainer as ttrainer

from helpers import make_batch

torch.set_num_threads(2)

D, L, HOPS, B = 16, 12, 2, 8
ATOL_F32 = 1e-5
REL_GRAD_F32 = 1e-5
REL_LOSS_BF16 = 2e-2
REL_GRAD_BF16 = 5e-2
SEQ_LENS = [1, 2, L, 5, L, 3, 7, 9]


def _cfg(**kw):
    over = {"model.num_units": D, "model.num_blocks": HOPS,
            "model.dropout": 0.0, "data.max_seq_len": L,
            "model.vocab_pad_multiple": 16}
    over.update(kw)
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


def _to_torch_batch(jb):
    return ttypes.batch_from_numpy({f: np.asarray(getattr(jb, f))
                                    for f in jb._fields})


def _batches(seed=5, valid=None):
    jmeta, _ = _meta()
    jb = make_batch(jmeta, batch_size=B, seed=seed, seq_lens=SEQ_LENS)
    jb = jb._replace(times=jb.times + 470_000.0,
                     target_time=jb.target_time + 470_000.0)
    if valid is not None:
        jb = jb._replace(valid=jnp.asarray(valid, jnp.float32))
    return jb, _to_torch_batch(jb)


def _jax_loss_and_grads(cfg, params, jb):
    jmeta, _ = _meta()

    def loss_fn(p):
        m = jbase.compute_loss(jget_model("MTAM"), p, cfg.model, jb, True,
                               None, jmeta.item_vocab)
        return m["loss"], m

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                     has_aux=True))(params)
    return metrics, params_from_jax(jax.device_get(grads))


def _port_loss_and_grads(cfg, model, tb):
    _, tmeta = _meta()
    metrics = tbase.compute_loss(get_model("MTAM"), model, cfg.model, tb,
                                 tmeta.item_vocab)
    metrics["loss"].backward()
    return metrics, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_compute_loss_and_grads_match_jax_f32(use_pallas):
    cfg = _cfg(**{"model.use_pallas": use_pallas})
    params, model = _models(cfg)
    # one filler row (valid 0), as an epoch's last batch has
    jb, tb = _batches(valid=[1, 1, 1, 1, 1, 1, 1, 0])
    want, jgrads = _jax_loss_and_grads(cfg, params, jb)
    got, tgrads = _port_loss_and_grads(cfg, model, tb)
    for key in ("loss", "ce", "l2"):
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   atol=ATOL_F32, rtol=ATOL_F32, err_msg=key)
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        w = jgrads[name].numpy()
        assert g is not None and g.dtype == torch.float32, name
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= REL_GRAD_F32 * scale, name
    # the pad id's table rows take the L2 of every padded position
    assert tgrads["embedding.item_table"][0].abs().sum() > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_compute_loss_and_grads_match_jax_bf16(use_pallas):
    cfg = _cfg(**{"model.use_pallas": use_pallas,
                  "model.compute_dtype": "bfloat16"})
    params, model = _models(cfg)
    jb, tb = _batches()
    want, jgrads = _jax_loss_and_grads(cfg, params, jb)
    _, jgrads32 = _jax_loss_and_grads(
        _cfg(**{"model.use_pallas": use_pallas}), params, jb)
    got, tgrads = _port_loss_and_grads(cfg, model, tb)
    assert got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=REL_LOSS_BF16)
    for name, g in tgrads.items():
        w, w32 = jgrads[name].numpy(), jgrads32[name].numpy()
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert np.abs(g.numpy() - w).max() <= (
            REL_GRAD_BF16 * np.abs(w32).max() + np.abs(w - w32).max()), name


def test_training_readout_matches_jax():
    """The hop-batched readout (train=True), forward and gradients of
    the memory, the query and every hop parameter, f32."""
    cfg = _cfg()
    params, model = _models(cfg)
    r = np.random.RandomState(12)
    enc = r.randn(B, L, D).astype(np.float32)
    dec = r.randn(B, 1, D).astype(np.float32)
    t_keys = np.sort(r.rand(B, L).astype(np.float32) * 300, axis=1)
    t_q = t_keys[:, -1:] + 2.0
    key_len = np.array(SEQ_LENS, np.int32)
    ones = np.ones((B,), np.int32)
    w_out = r.randn(B, D).astype(np.float32)

    def jloss(att, enc_, dec_):
        out = jatt.vanilla_attention_stack(
            att, enc_, dec_, jnp.asarray(key_len), jnp.asarray(ones),
            kind="time", num_heads=1, dropout_rate=0.0, train=True,
            t_queries=jnp.asarray(t_q), t_keys=jnp.asarray(t_keys))
        return jnp.sum(out * w_out), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        params["att"], jnp.asarray(enc), jnp.asarray(dec))
    tenc = torch.tensor(enc, requires_grad=True)
    tdec = torch.tensor(dec, requires_grad=True)
    got = tatt.vanilla_attention_stack(
        model.att, tenc, tdec, torch.tensor(key_len), torch.tensor(ones),
        kind="time", num_heads=1, t_queries=torch.tensor(t_q),
        t_keys=torch.tensor(t_keys), train=True)
    assert got.shape == (B, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_F32, rtol=0)
    (got * torch.tensor(w_out)).sum().backward()
    np.testing.assert_allclose(tenc.grad.numpy(), np.asarray(jg[1]),
                               atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(tdec.grad.numpy(), np.asarray(jg[2]),
                               atol=ATOL_F32, rtol=0)
    jatt_grads = params_from_jax(jax.device_get(jg[0]))
    for name, p in model.att.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jatt_grads[name].numpy(),
                                   atol=ATOL_F32, rtol=0, err_msg=name)


@pytest.mark.parametrize("base_lr", [1e-3, 5e-3])
def test_lr_schedule_matches_jax(base_lr):
    cfg = _cfg(**{"train.learning_rate": base_lr}).train
    jsched = jtrainer.make_lr_schedule(cfg)
    tsched = ttrainer.make_lr_schedule(cfg)
    for step in (0, 1, 99, 100, 101, 250, 16_100):
        # float32 powers may differ in the last bit between numpy and XLA
        np.testing.assert_allclose(tsched(step),
                                   float(jsched(jnp.asarray(step))),
                                   rtol=1e-6, err_msg=str(step))
    # base 5e-3 keeps lr1 while lr1(step-1) > 1e-3; base 1e-3 uses lr2
    assert tsched(100) == pytest.approx(
        base_lr * 0.99 if base_lr > 1e-3 else 1e-3 * 0.995, rel=1e-6)


def _dotted(path) -> str:
    """A pytree key path as the bridge's dotted parameter name."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_optimizer_update_matches_optax(grad_scale):
    """Two updates from the same gradients, the clip untriggered (norm
    < 1) and triggered (norm > 1)."""
    cfg = _cfg()
    params, model = _models(cfg)
    r = np.random.RandomState(3)
    names = list(params_from_jax(params))
    grads_np = [{n: (r.randn(*params_from_jax(params)[n].shape)
                     * grad_scale).astype(np.float32) for n in names}
                for _ in range(2)]
    jopt = jtrainer.make_optimizer(cfg.train)
    state = jopt.init(params)
    jparams = params
    for g in grads_np:
        gtree = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(g[_dotted(path)]), params)
        updates, state = jopt.update(gtree, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    topt = ttrainer.make_optimizer(cfg.train)
    tstate = topt.init(model)
    for g in grads_np:
        tstate = topt.update(model, {n: torch.tensor(v) for n, v in g.items()},
                             tstate)
    assert tstate.count == 2
    want = params_from_jax(jax.device_get(jparams))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=ATOL_F32, rtol=0, err_msg=name)


def test_clip_is_optax_not_torch():
    g = {"a": torch.tensor([3.0, 4.0])}                 # norm 5
    np.testing.assert_allclose(
        ttrainer.clip_by_global_norm(g, 1.0)["a"].numpy(), [0.6, 0.8])
    assert torch.equal(ttrainer.clip_by_global_norm(g, 5.0 + 1e-3)["a"],
                       g["a"])


def _dataset(n=3 * B, seed=2):
    jmeta, _ = _meta()
    big = make_batch(jmeta, batch_size=n, seed=seed)
    arrays = {f: np.asarray(getattr(big, f)) for f in jdd.DeviceDataset._fields}
    return arrays, jdd.DeviceDataset(**{k: jnp.asarray(v)
                                        for k, v in arrays.items()})


def test_gather_batch_matches_jax():
    arrays, jdata = _dataset(n=B + 3)
    order, n_steps = tdd.epoch_order(B + 3, B, np.random.RandomState(0))
    jorder, jn = jdd.epoch_order(B + 3, B, np.random.RandomState(0))
    np.testing.assert_array_equal(order, jorder)
    assert n_steps == jn == 2 and (order == -1).sum() == B - 3
    tdata = tdd.to_device(arrays, device="cpu")
    for step in range(n_steps):
        want = jdd.gather_batch(jdata, jnp.asarray(jorder), step, B)
        got = tdd.gather_batch(tdata, torch.tensor(order), step, B)
        for f in want._fields:
            g = getattr(got, f)
            assert g.dtype == getattr(_to_torch_batch(want), f).dtype, f
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    pad = tdd.gather_batch(tdata, torch.tensor(order), 1, B)
    assert (pad.seq_len[3:] == 2).all() and not pad.valid[3:].any()
    assert not pad.items[3:].any()


def test_train_trajectory_matches_jax():
    """Three make_train_step steps in f32 from the same parameters and
    batches: per-step losses and the final parameters."""
    cfg = _cfg()
    jmeta, tmeta = _meta()
    params, model = _models(cfg)
    arrays, jdata = _dataset()
    order, _ = tdd.epoch_order(3 * B, B, np.random.RandomState(1))
    jstep = jtrainer.make_train_step(jget_model("MTAM"), cfg,
                                     jtrainer.make_optimizer(cfg.train),
                                     jmeta.item_vocab)
    jopt_state = jtrainer.make_optimizer(cfg.train).init(params)
    topt = ttrainer.make_optimizer(cfg.train)
    tstep = ttrainer.make_train_step(get_model("MTAM"), cfg, topt,
                                     tmeta.item_vocab, device="cpu")
    tstate = topt.init(model)
    tdata = tdd.to_device(arrays, device="cpu")
    jlosses, tlosses = [], []
    for step in range(3):
        jb = jdd.gather_batch(jdata, jnp.asarray(order), step, B)
        params, jopt_state, m = jstep(params, jopt_state, jb, None)
        jlosses.append(float(m["loss"]))
        tstate, tm = tstep(model, tstate,
                           tdd.gather_batch(tdata, torch.tensor(order), step,
                                            B))
        tlosses.append(tm["loss"].item())
    np.testing.assert_allclose(tlosses, jlosses, atol=ATOL_F32, rtol=0)
    assert tlosses[2] < tlosses[0]
    want = params_from_jax(jax.device_get(params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=ATOL_F32, rtol=0, err_msg=name)


def test_superstep_is_the_step_loop():
    cfg = _cfg()
    _, tmeta = _meta()
    arrays, _ = _dataset()
    order = torch.tensor(tdd.epoch_order(3 * B, B,
                                         np.random.RandomState(1))[0])
    tdata = tdd.to_device(arrays, device="cpu")
    runs = []
    for use_superstep in (False, True):
        _, model = _models(cfg)
        opt = ttrainer.make_optimizer(cfg.train)
        state = opt.init(model)
        if use_superstep:
            run = ttrainer.make_superstep(get_model("MTAM"), cfg, opt,
                                          tmeta.item_vocab, B, device="cpu")
            state, stacked = run(model, state, tdata, order, 0, 3)
            losses = stacked["loss"]
            assert set(stacked) == {"loss", "ce", "l2"}
        else:
            step = ttrainer.make_train_step(get_model("MTAM"), cfg, opt,
                                            tmeta.item_vocab, device="cpu")
            losses = []
            for k in range(3):
                state, m = step(model, state,
                                tdd.gather_batch(tdata, order, k, B))
                losses.append(m["loss"])
            losses = torch.stack(losses)
        runs.append((losses, model.rnn.w_gate_h.detach().clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_training_entry_points_run_on_cuda_by_default(monkeypatch):
    cfg = _cfg()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays, _ = _dataset()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdd.to_device(arrays)
    opt = ttrainer.make_optimizer(cfg.train)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.make_train_step(get_model("MTAM"), cfg, opt, 63)
    step = ttrainer.make_train_step(get_model("MTAM"), cfg, opt, 63,
                                    device="cpu")
    assert callable(step)


def test_unported_training_options_raise():
    cfg = _cfg()
    for key, value in (("train.optimizer", "sgd"),
                       ("train.pack_small_leaves", True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrainer.make_optimizer(_cfg(**{key: value}).train)
    _, model = _models(cfg)
    _, tb = _batches()
    bpr = get_model("MTAM")._replace(output_mode="bpr")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbase.compute_loss(bpr, model, cfg.model, tb)
