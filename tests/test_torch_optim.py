"""The port's optimizers and optimizer-state layouts against optax.

The JAX package's `make_optimizer` (clip_by_global_norm, then
scale_by_adam / scale_by_adadelta / scale_by_rms / identity, then
scale_by_schedule) and the port's run five steps from the same MTAM
parameters (converted with `bridge.load_jax_params`) on the same
gradients, drawn with numpy from a seed: small ones (no clip) and large
ones (clipped).  The item table has 66,003 x 16 > 2^20 elements, so
``pack_small_leaves`` keeps it standalone and packs the rest.

Tolerances (f32): after each step every parameter leaf within 1e-6 of
its largest |value|, and after the fifth every moment within 1e-6 of
its largest |value|; the counts equal.  The packed and flat layouts
apply the per-leaf layout's update bit for bit (``torch.equal``): the
clip's norm is summed leaf by leaf in every layout.  JAX's state after
two steps, converted with `bridge.opt_state_from_jax`, continues in the
port for three more steps to JAX's fifth; each state round-trips
through `train.checkpoint` unchanged.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.config import ExperimentConfig
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.train import trainer as jtrainer
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import (load_jax_params,
                                              opt_state_from_jax,
                                              params_from_jax)
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train import checkpoint as tckpt
from mtamrecommender_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

OPTIMIZERS = ("adam", "adadelta", "rmsprop", "sgd")
LAYOUTS = {"leaf": {}, "flat": {"train.flatten_optimizer": True},
           "packed": {"train.pack_small_leaves": True},
           "flat_packed": {"train.flatten_optimizer": True,
                           "train.pack_small_leaves": True}}
REL = 1e-6
STEPS = 5
ITEMS = 66_000          # item table 66,003 x 16 > 2^20: packed standalone


def _cfg(optimizer, layout):
    return ExperimentConfig().with_overrides(**{
        "model.num_units": 16, "model.num_blocks": 2,
        "data.max_seq_len": 12, "train.optimizer": optimizer,
        "train.learning_rate": 1e-3, **LAYOUTS[layout]})


@pytest.fixture(scope="module")
def start():
    """JAX's MTAM parameters, their names in tree order, and the five
    steps' gradients by name (steps 0 and 3 below the clip norm)."""
    cfg = _cfg("adam", "leaf")
    meta = jtypes.DatasetMeta(20, ITEMS, 5, 12)
    params = jax.device_get(jget_model("MTAM").init(
        jax.random.PRNGKey(0), cfg.model, meta))
    names = list(params_from_jax(params))
    rng = np.random.RandomState(3)
    grads = []
    for k in range(STEPS):
        scale = 1e-5 if k in (0, 3) else 1e-2
        grads.append({n: (rng.standard_normal(p.shape) * scale).astype(
            np.float32) for n, p in params_from_jax(params).items()})
    return params, names, grads


def _jax_tree(params, by_name):
    paths, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, _ in paths:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        leaves.append(by_name[name])
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _port_model(cfg, params):
    meta = ttypes.DatasetMeta(20, ITEMS, 5, 12)
    model = get_model("MTAM").init(torch.Generator().manual_seed(0),
                                   cfg.model, meta)
    return load_jax_params(model, params)


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= REL * scale, (what, err, scale)


def _run_jax(cfg, params, grads, steps):
    opt = jtrainer.make_optimizer(cfg.train)
    state = opt.init(params)
    trail = []
    for g in grads[:steps]:
        updates, state = opt.update(_jax_tree(params, g), state, params)
        params = optax.apply_updates(params, updates)
        trail.append((jax.device_get(params), jax.device_get(state)))
    return trail


def _assert_state_close(got, want):
    assert type(got) is type(want) and got.count == want.count
    for key, m in ttrainer.moments(want).items():
        assert set(getattr(got, key)) == set(m), key
        for n, t in m.items():
            _close(getattr(got, key)[n].numpy(), t.numpy(), (key, n))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_optimizer_against_optax(start, optimizer, layout, tmp_path):
    params, _, grads = start
    cfg = _cfg(optimizer, layout)
    trail = _run_jax(cfg, params, grads, STEPS)
    model = _port_model(cfg, params)
    opt = ttrainer.make_optimizer(cfg.train)
    state = opt.init(model)
    assert type(state).kind == optimizer
    for m in ttrainer.moments(state).values():
        assert list(m) == ttrainer.make_layout(cfg.train, model).keys
    for k in range(STEPS):
        state = opt.update(model, {n: torch.from_numpy(g)
                                   for n, g in grads[k].items()}, state)
        want = params_from_jax(trail[k][0])
        for n, p in model.named_parameters():
            _close(p.detach().numpy(), want[n].numpy(), (k, n))
    _assert_state_close(state, opt_state_from_jax(trail[-1][1], model))

    # JAX's state after two steps, converted, continues in the port
    resumed = _port_model(cfg, trail[1][0])
    st = opt_state_from_jax(trail[1][1], resumed)
    assert st.count == 2
    for k in range(2, STEPS):
        st = opt.update(resumed, {n: torch.from_numpy(g)
                                  for n, g in grads[k].items()}, st)
    want = params_from_jax(trail[-1][0])
    for n, p in resumed.named_parameters():
        _close(p.detach().numpy(), want[n].numpy(), ("resumed", n))

    # and the state round-trips through a checkpoint unchanged
    ck = tckpt.Checkpointer(str(tmp_path / "ck"))
    ck.save(ttrainer.TrainState(model, state, STEPS))
    back = ck.restore(ttrainer.TrainState(_port_model(cfg, params),
                                          opt.init(model), 0))
    assert back.step == STEPS and back.opt_state.count == state.count
    for key, m in ttrainer.moments(state).items():
        for n, t in m.items():
            assert torch.equal(getattr(back.opt_state, key)[n], t)
    for (n, p), (_, q) in zip(back.model.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_layouts_equal_the_per_leaf_update(start, optimizer):
    params, _, grads = start
    runs = {}
    for layout in LAYOUTS:
        cfg = _cfg(optimizer, layout)
        model = _port_model(cfg, params)
        opt = ttrainer.make_optimizer(cfg.train)
        state = opt.init(model)
        for k in range(STEPS):
            state = opt.update(model, {n: torch.from_numpy(g)
                                       for n, g in grads[k].items()}, state)
        runs[layout] = (model, state, ttrainer.make_layout(cfg.train, model))
    base_model, base_state, _ = runs["leaf"]
    for layout, (model, state, lay) in runs.items():
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  base_model.named_parameters()):
            assert torch.equal(p, q), (layout, n)
        for key, m in ttrainer.moments(state).items():
            per_leaf = lay.unpack(m)
            for n, t in getattr(base_state, key).items():
                assert torch.equal(per_leaf[n], t), (layout, key, n)


def test_layout_keys_and_order(start):
    params, names, _ = start
    model = _port_model(_cfg("adam", "leaf"), params)
    # the port's order of the JAX tree is jax.tree.flatten's
    assert ttrainer.jax_order([n for n, _ in model.named_parameters()]) \
        == names
    packed = ttrainer.make_layout(_cfg("adam", "packed").train, model)
    assert packed.keys == ["small.float32", "embedding.item_table"]
    assert packed.groups["small.float32"] == [
        n for n in names if n != "embedding.item_table"]
    flat = ttrainer.make_layout(_cfg("adam", "flat_packed").train, model)
    assert flat.groups["flat"] == packed.groups["small.float32"] + [
        "embedding.item_table"]
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrainer.make_optimizer(_cfg("adagrad", "leaf").train)
