"""The port's checkpoints (`train.checkpoint`) and the optimizer-state
bridge (`bridge.opt_state_from_jax`).

Save and restore are held bit for bit: parameters, Adam moments, step
and cursor come back `torch.equal`, and 3 MTAM steps, a save, a restore
and 3 more steps equal 6 unbroken steps.  The load modes mirror the JAX
package's tests (tests/test_train.py, checkpoint section).  JAX parity:
a JAX Orbax checkpoint written after 2 JAX steps, restored by JAX and
converted, goes through the port's save and restore; one more step on
each side then agrees with the tolerance of ROADMAP.md Queue 3 item 2
(Adam's epsilon on near-zero gradients): 99 % of each parameter leaf
within 1e-5 and all of it within 2e-4, the Adam moments within 1e-5 of
each leaf's largest |value|.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.config import ExperimentConfig
from mtamrecommender_tpu.data import device_data as jdd
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.train import checkpoint as jckpt
from mtamrecommender_tpu.train import trainer as jtrainer
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import (load_jax_params,
                                              opt_state_from_jax,
                                              params_from_jax)
from mtamrecommender_tpu_torch.data import device_data as tdd
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train import checkpoint as tckpt
from mtamrecommender_tpu_torch.train import trainer as ttrainer
from mtamrecommender_tpu_torch.train.trainer import AdamState, TrainState

from helpers import make_batch

torch.set_num_threads(2)

D, L, HOPS, B = 16, 12, 2, 8
ATOL = 1e-5          # Queue 3 item 2: 99 % of each leaf
ATOL_ALL = 2e-4      # and all of it


def _cfg(**kw):
    over = {"model.num_units": D, "model.num_blocks": HOPS,
            "model.dropout": 0.0, "data.max_seq_len": L,
            "model.vocab_pad_multiple": 16}
    over.update(kw)
    return ExperimentConfig().with_overrides(**over)


def _meta():
    return (jtypes.DatasetMeta(20, 60, 5, L), ttypes.DatasetMeta(20, 60, 5, L))


def _skeleton(cfg, seed=0):
    _, tmeta = _meta()
    return get_model("MTAM").init(torch.Generator().manual_seed(seed),
                                  cfg.model, tmeta)


def _dataset(n=6 * B, seed=2):
    jmeta, _ = _meta()
    big = make_batch(jmeta, batch_size=n, seed=seed)
    arrays = {f: np.asarray(getattr(big, f)) for f in jdd.DeviceDataset._fields}
    order = tdd.epoch_order(n, B, np.random.RandomState(1))[0]
    return arrays, order


def _trained_state(cfg, steps=2):
    """A port TrainState after ``steps`` MTAM steps on the CPU."""
    _, tmeta = _meta()
    arrays, order = _dataset()
    data = tdd.to_device(arrays, device="cpu")
    model = _skeleton(cfg)
    opt = ttrainer.make_optimizer(cfg.train)
    step = ttrainer.make_train_step(get_model("MTAM"), cfg, opt,
                                    tmeta.item_vocab, device="cpu")
    state = opt.init(model)
    for k in range(steps):
        state, _ = step(model, state,
                        tdd.gather_batch(data, torch.tensor(order), k, B))
    return TrainState(model=model, opt_state=state, step=steps), opt


def _assert_state_equal(got: TrainState, want: TrainState, step=None):
    assert got.step == (want.step if step is None else step)
    gp, wp = dict(got.model.named_parameters()), \
        dict(want.model.named_parameters())
    assert set(gp) == set(wp)
    for name in wp:
        assert torch.equal(gp[name], wp[name]), name
    if want.opt_state is None:
        assert got.opt_state is None
        return
    assert got.opt_state.count == want.opt_state.count
    for key in ("mu", "nu"):
        g, w = getattr(got.opt_state, key), getattr(want.opt_state, key)
        assert set(g) == set(w)
        for name in w:
            assert torch.equal(g[name], w[name]), (key, name)


def _fresh(cfg, opt, step=0):
    model = _skeleton(cfg, seed=7)
    return TrainState(model=model, opt_state=opt.init(model), step=step)


def test_round_trip_is_bit_equal(tmp_path):
    cfg = _cfg()
    state, opt = _trained_state(cfg)
    state = TrainState(state.model, state.opt_state, step=7)
    cursor = {"epoch": 2, "step_at_epoch_start": 5, "rng": [0, 1],
              "np_keys": [3] * 624, "np_pos": 4, "np_has_gauss": 0,
              "np_cached": 0.0}
    ckpt = tckpt.Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() is None
    assert ckpt.save(state, cursor=cursor, wait=True)
    assert ckpt.latest_step() == 7
    template = _fresh(cfg, opt)
    before = {n: p.clone() for n, p in template.model.named_parameters()}
    restored, got_cursor = ckpt.restore(template, with_cursor=True)
    ckpt.close()
    _assert_state_equal(restored, state)
    assert got_cursor == cursor
    assert restored.model is not template.model
    for name, p in template.model.named_parameters():    # left as it was
        assert torch.equal(p, before[name]), name
    # without a cursor: None
    other = tckpt.Checkpointer(str(tmp_path / "bare"))
    other.save(state)
    assert other.restore(template, with_cursor=True)[1] is None


def test_files_load_with_weights_only(tmp_path):
    cfg = _cfg()
    state, _ = _trained_state(cfg, steps=1)
    ckpt = tckpt.Checkpointer(str(tmp_path))
    ckpt.save(TrainState(state.model, state.opt_state, step=3),
              cursor={"epoch": 1})
    step_dir = tmp_path / "3"
    assert sorted(os.listdir(step_dir)) == [tckpt.CURSOR_FILE,
                                            tckpt.STATE_FILE]
    payload = torch.load(step_dir / tckpt.STATE_FILE, weights_only=True)
    assert set(payload) == {"params", "opt_state", "step"}
    assert payload["step"] == 3 and payload["opt_state"]["count"] == 1
    for name, p in state.model.named_parameters():
        t = payload["params"][name]
        assert t.device.type == "cpu" and torch.equal(t, p.detach()), name
        assert torch.equal(payload["opt_state"]["mu"][name],
                           state.opt_state.mu[name]), name
    assert json.loads((step_dir / tckpt.CURSOR_FILE).read_text()) == \
        {"epoch": 1}


def test_adam_state_dict_round_trip():
    mu = {"a": torch.arange(3.0)}
    nu = {"a": torch.ones(3)}
    d = AdamState(4, mu, nu).to_dict()
    assert d == {"count": 4, "mu": mu, "nu": nu} and type(d["count"]) is int
    back = AdamState.from_dict(d)
    assert isinstance(back, AdamState) and back.count == 4
    assert back.mu["a"] is mu["a"] and back.nu["a"] is nu["a"]


def test_max_to_keep_keeps_the_newest_three(tmp_path):
    cfg = _cfg()
    state, _ = _trained_state(cfg, steps=0)
    ckpt = tckpt.Checkpointer(str(tmp_path))
    for step in (1, 2, 3, 4, 5):
        assert ckpt.save(TrainState(state.model, state.opt_state, step))
    assert ckpt.all_steps() == [3, 4, 5] and ckpt.latest_step() == 5
    # a step no newer than the latest is skipped, as Orbax's manager does
    assert not ckpt.save(TrainState(state.model, state.opt_state, 4))
    assert ckpt.all_steps() == [3, 4, 5]
    # a save cut short leaves a temporary directory latest_step ignores
    os.makedirs(tmp_path / ".tmp-9-1")
    os.makedirs(tmp_path / "11")                 # no state file: incomplete
    assert ckpt.latest_step() == 5
    keep_all = tckpt.Checkpointer(str(tmp_path / "all"), max_to_keep=None)
    for step in (1, 2, 3, 4):
        keep_all.save(TrainState(state.model, state.opt_state, step))
    assert keep_all.all_steps() == [1, 2, 3, 4]


def test_missing_checkpoint_raises(tmp_path):
    ckpt = tckpt.Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(None)
    state, _ = _trained_state(_cfg(), steps=0)
    ckpt.save(TrainState(state.model, state.opt_state, 2))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state, step=5)


def test_restore_is_strict(tmp_path):
    cfg = _cfg()
    state, opt = _trained_state(cfg, steps=1)
    ckpt = tckpt.Checkpointer(str(tmp_path))
    ckpt.save(TrainState(state.model, None, 1))       # parameters only
    # parameters only, restored for serving
    got = ckpt.restore(TrainState(_skeleton(cfg, 3), None))
    _assert_state_equal(got, TrainState(state.model, None, 1))
    # a template asking for the Adam state the step does not hold
    with pytest.raises(KeyError, match="optimizer"):
        ckpt.restore(_fresh(cfg, opt))
    # another width: shapes differ
    with pytest.raises(ValueError, match="parameter"):
        ckpt.restore(TrainState(_skeleton(_cfg(**{"model.num_units": 32})),
                                None))
    # another depth: names differ
    with pytest.raises(KeyError, match="att.1"):
        ckpt.restore(TrainState(_skeleton(_cfg(**{"model.num_blocks": 1})),
                                None))


def test_load_type_modes(tmp_path):
    cfg = _cfg()
    state, opt = _trained_state(cfg)
    state = TrainState(state.model, state.opt_state, step=11)
    ckpt_dir = str(tmp_path / "modes")
    tckpt.Checkpointer(ckpt_dir).save(state, wait=True)

    fresh = _fresh(cfg, opt)
    # from_scratch: untouched
    out = tckpt.apply_load_type(cfg.train, fresh, ckpt_dir)
    assert out is fresh and out.step == 0
    # full: params, Adam state and step restored
    cfg_full = cfg.with_overrides(**{"train.load_type": "full"})
    out = tckpt.apply_load_type(cfg_full.train, fresh, ckpt_dir)
    _assert_state_equal(out, state)
    # fine_tune: params restored, step reset, fresh opt state
    cfg_ft = cfg.with_overrides(**{"train.load_type": "fine_tune",
                                   "train.fine_tune_load_path": ckpt_dir})
    out = tckpt.apply_load_type(cfg_ft.train, fresh, str(tmp_path / "none"),
                                optimizer_init=opt.init)
    _assert_state_equal(out, TrainState(state.model, opt.init(state.model),
                                        0))
    assert all(not t.any() for t in out.opt_state.mu.values())
    # without optimizer_init the template's optimizer state is kept
    out = tckpt.apply_load_type(cfg_ft.train, fresh, ckpt_dir)
    assert out.step == 0 and out.opt_state is fresh.opt_state
    # the ValueErrors
    no_path = cfg.with_overrides(**{"train.load_type": "fine_tune"})
    with pytest.raises(ValueError, match="fine_tune_load_path"):
        tckpt.apply_load_type(no_path.train, fresh, ckpt_dir)
    bad = cfg.with_overrides(**{"train.load_type": "partial"})
    with pytest.raises(ValueError, match="partial"):
        tckpt.apply_load_type(bad.train, fresh, ckpt_dir)
    # full from an empty run directory
    with pytest.raises(FileNotFoundError):
        tckpt.apply_load_type(cfg_full.train, fresh, str(tmp_path / "empty"))


def test_load_type_with_cursor(tmp_path):
    """apply_load_type(with_cursor=True) returns (state, cursor): the
    saved cursor for 'full', None for from_scratch / fine_tune and for
    checkpoints written without one."""
    cfg = _cfg()
    state, opt = _trained_state(cfg, steps=1)
    state = TrainState(state.model, state.opt_state, step=7)
    cur = {"epoch": 2, "step_at_epoch_start": 5, "rng": [0, 1]}
    with_dir, without_dir = str(tmp_path / "with"), str(tmp_path / "without")
    tckpt.Checkpointer(with_dir).save(state, cursor=cur, wait=True)
    tckpt.Checkpointer(without_dir).save(state, wait=True)

    cfg_full = cfg.with_overrides(**{"train.load_type": "full"}).train
    out, got = tckpt.apply_load_type(cfg_full, state, with_dir,
                                     with_cursor=True)
    assert out.step == 7 and got == cur
    out, got = tckpt.apply_load_type(cfg_full, state, without_dir,
                                     with_cursor=True)
    assert out.step == 7 and got is None
    out, got = tckpt.apply_load_type(cfg.train, state, with_dir,
                                     with_cursor=True)
    assert out is state and got is None     # from_scratch never resumes
    cfg_ft = cfg.with_overrides(**{"train.load_type": "fine_tune",
                                   "train.fine_tune_load_path": with_dir})
    out, got = tckpt.apply_load_type(cfg_ft.train, state, without_dir,
                                     optimizer_init=opt.init,
                                     with_cursor=True)
    assert out.step == 0 and got is None


def _run_steps(cfg, model, opt_state, data, order, start, n):
    _, tmeta = _meta()
    opt = ttrainer.make_optimizer(cfg.train)
    step = ttrainer.make_train_step(get_model("MTAM"), cfg, opt,
                                    tmeta.item_vocab, device="cpu")
    losses = []
    for k in range(start, start + n):
        opt_state, m = step(model, opt_state,
                            tdd.gather_batch(data, order, k, B))
        losses.append(m["loss"])
    return opt_state, torch.stack(losses)


def test_resume_is_bit_equal_to_the_unbroken_run(tmp_path):
    """3 steps, save, restore into a fresh model (`full`), 3 steps ==
    6 unbroken steps: parameters, Adam moments and losses torch.equal."""
    cfg = _cfg()
    arrays, order_np = _dataset()
    data = tdd.to_device(arrays, device="cpu")
    order = torch.tensor(order_np)
    opt = ttrainer.make_optimizer(cfg.train)

    model = _skeleton(cfg)
    unbroken, losses = _run_steps(cfg, model, opt.init(model), data, order,
                                  0, 6)

    first = _skeleton(cfg)
    st, losses_a = _run_steps(cfg, first, opt.init(first), data, order, 0, 3)
    ckpt_dir = str(tmp_path / "run")
    tckpt.Checkpointer(ckpt_dir).save(TrainState(first, st, 3))
    cfg_full = cfg.with_overrides(**{"train.load_type": "full"})
    resumed = tckpt.apply_load_type(cfg_full.train, _fresh(cfg, opt),
                                    ckpt_dir)
    assert resumed.step == 3 and resumed.opt_state.count == 3
    st, losses_b = _run_steps(cfg, resumed.model, resumed.opt_state, data,
                              order, 3, 3)
    assert torch.equal(torch.cat([losses_a, losses_b]), losses)
    _assert_state_equal(TrainState(resumed.model, st, 6),
                        TrainState(model, unbroken, 6))


# ------------------------------------------------------------ JAX parity

def _close(got: torch.Tensor, want: np.ndarray, name: str):
    diff = np.abs(got.detach().numpy() - want)
    assert diff.max() <= ATOL_ALL, (name, diff.max())
    assert np.mean(diff <= ATOL) >= 0.99, (name, np.mean(diff <= ATOL))


def test_jax_checkpoint_converted_resumes_like_jax(tmp_path):
    cfg = _cfg()
    jmeta, tmeta = _meta()
    arrays, order_np = _dataset(n=3 * B)
    jdata = jdd.DeviceDataset(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jorder = jnp.asarray(order_np)
    jmodel = jget_model("MTAM")
    jopt = jtrainer.make_optimizer(cfg.train)
    jstep = jtrainer.make_train_step(jmodel, cfg, jopt, jmeta.item_vocab)
    params = jmodel.init(jax.random.PRNGKey(0), cfg.model, jmeta)
    opt_state = jopt.init(params)
    for k in range(2):
        params, opt_state, _ = jstep(params, opt_state,
                                     jdd.gather_batch(jdata, jorder, k, B),
                                     None)
    jdir = str(tmp_path / "jax")
    ck = jckpt.Checkpointer(jdir)
    ck.save(jtrainer.TrainState(params, opt_state, step=2), wait=True)
    ck.close()
    # JAX restores its own checkpoint; the arrays cross through the bridge
    template = jmodel.init(jax.random.PRNGKey(1), cfg.model, jmeta)
    ck = jckpt.Checkpointer(jdir)
    jstate = ck.restore(jtrainer.TrainState(template, jopt.init(template)))
    ck.close()
    jstate = jtrainer.TrainState(*jax.device_get((jstate.params,
                                                  jstate.opt_state)),
                                 step=jstate.step)
    adam = opt_state_from_jax(jstate.opt_state)
    assert adam.count == 2
    model = load_jax_params(_skeleton(cfg), jstate.params)
    # the port saves and restores it
    pdir = str(tmp_path / "port")
    tckpt.Checkpointer(pdir).save(TrainState(model, adam, jstate.step))
    opt = ttrainer.make_optimizer(cfg.train)
    restored = tckpt.Checkpointer(pdir).restore(_fresh(cfg, opt))
    assert restored.step == 2
    _assert_state_equal(restored, TrainState(model, adam, 2))
    # one more step on each side
    jparams, jopt_state, jm = jstep(jstate.params, jstate.opt_state,
                                    jdd.gather_batch(jdata, jorder, 2, B),
                                    None)
    tstep = ttrainer.make_train_step(get_model("MTAM"), cfg, opt,
                                     tmeta.item_vocab, device="cpu")
    tdata = tdd.to_device(arrays, device="cpu")
    t_opt, tm = tstep(restored.model, restored.opt_state,
                      tdd.gather_batch(tdata, torch.tensor(order_np), 2, B))
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               atol=ATOL, rtol=0)
    want = params_from_jax(jax.device_get(jparams))
    for name, p in restored.model.named_parameters():
        _close(p, want[name].numpy(), name)
    jadam = opt_state_from_jax(jax.device_get(jopt_state))
    assert t_opt.count == jadam.count == 3
    for key in ("mu", "nu"):
        for name, t in getattr(t_opt, key).items():
            w = getattr(jadam, key)[name].numpy()
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(t.numpy() - w).max() <= ATOL * scale, (key, name)


def test_opt_state_from_jax_refuses_other_structures():
    cfg = _cfg()
    jmeta, _ = _meta()
    params = jax.device_get(jget_model("MTAM").init(jax.random.PRNGKey(0),
                                                    cfg.model, jmeta))
    good = jax.device_get(jtrainer.make_optimizer(cfg.train).init(params))
    adam = opt_state_from_jax(good)
    assert adam.count == 0 and set(adam.mu) == set(params_from_jax(params))
    assert all(t.dtype == torch.float32 for t in adam.nu.values())
    # the other optimizers and layouts convert (tests/test_torch_optim.py
    # holds their values); a packed state needs the model to name entries
    flat = jax.device_get(jtrainer.make_optimizer(cfg.with_overrides(**{
        "train.flatten_optimizer": True}).train).init(params))
    assert list(opt_state_from_jax(flat).mu) == ["flat"]
    packed = jax.device_get(jtrainer.make_optimizer(cfg.with_overrides(**{
        "train.pack_small_leaves": True}).train).init(params))
    with pytest.raises(ValueError, match=r"opt_state\[1\]\.mu is packed"):
        opt_state_from_jax(packed)
    rms = jax.device_get(jtrainer.make_optimizer(cfg.with_overrides(**{
        "train.optimizer": "rmsprop"}).train).init(params))
    assert type(opt_state_from_jax(rms)).kind == "rmsprop"
    # what no optimizer of the JAX package makes is refused
    lion = jax.device_get(optax.scale_by_lion().init(params))
    with pytest.raises(TypeError, match=r"opt_state\[1\] is a ScaleByLion"):
        opt_state_from_jax((good[0], lion, good[2]))
    mangled = (good[0], good[1]._replace(mu=[1, 2]), good[2])
    with pytest.raises(ValueError, match="pass model="):
        opt_state_from_jax(mangled)
    skewed = (good[0], good[1], good[2]._replace(count=np.int32(5)))
    with pytest.raises(ValueError, match="count"):
        opt_state_from_jax(skewed)
    with pytest.raises(TypeError, match="chain's 3-tuple"):
        opt_state_from_jax(good[1])
