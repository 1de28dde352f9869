"""The port's `parallel/` against the JAX package's, on the CPU.

In process: `build_mesh`'s shapes and errors, the engine scope's
validation and no-op, the row ranges.  Across four gloo processes
(tests/torch_dist_worker.py, one spawn for the module): the psum and a2a
engines at mesh 1x4 and 2x2, their rows and table gradients
`torch.equal` to the one-rank `take_dtable` lookup; MTAM, SASrec and bpr
sharded steps at 2x2, the loss within rtol 1e-5 of JAX's `compute_loss`
and of JAX's sharded step on four of the eight virtual CPU devices (bpr's
with JAX's negative injected), the sharded evaluation equal to the
one-rank evaluation; three Gru4Rec steps and the a2a and psum MTAM
trajectories against the port's unsharded steps (JAX's tolerance, rtol
2e-4 / atol 2e-5); uneven filler rows over a 4x1 data axis, the loss
the one-rank loss; SASrec at dropout 0.5 drawing the global batch's
masks; the flat and packed optimizer layouts.  Parameters come from the
JAX init through `bridge`; batches from numpy with one filler row
(tests/torch_zoo_parity.py).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_worker
import torch_zoo_parity as zp
from mtamrecommender_tpu.config import ExperimentConfig as JConfig
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.parallel import sharding as jshard
from mtamrecommender_tpu.parallel.dist_trainer import \
    make_sharded_train_step as jsharded_step
from mtamrecommender_tpu.parallel.mesh import build_mesh as jbuild_mesh
from mtamrecommender_tpu.train.trainer import make_optimizer as jmake_opt
from mtamrecommender_tpu_torch.config import ExperimentConfig as TConfig
from mtamrecommender_tpu_torch.config import MeshConfig
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops.kernels.embedding_kernel import take_dtable
from mtamrecommender_tpu_torch.parallel import embedding_shard as es
from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
from mtamrecommender_tpu_torch.parallel import sharding
from mtamrecommender_tpu_torch.parallel.mesh import build_mesh
from mtamrecommender_tpu_torch.train import evaluate as ev
from mtamrecommender_tpu_torch.train.trainer import (make_optimizer,
                                                     make_train_step)
from mtamrecommender_tpu_torch.types import Batch

torch.set_num_threads(2)

WORLD = 4
EP = {"mesh.model_axis_size": 2, "mesh.shard_embeddings": True}
TRAJ_RTOL, TRAJ_ATOL = 2e-4, 2e-5
ENGINE_MESHES = {"1x4": {"model_axis_size": 4}, "2x2": {"model_axis_size": 2}}
STEP_MODELS = ("MTAM", "SASrec", "bpr")
BPR_SEED = 3
UNEVEN = [1, 1, 1, 1, 1, 0, 0, 0]      # 4x1: the last rank has no valid row


def _engine_inputs():
    r = np.random.RandomState(0)
    return (torch.tensor(r.randn(64, 16).astype(np.float32)),
            torch.tensor(r.randint(0, 53, (8, 5)).astype(np.int32)))


def _batch_dict(tb):
    return tb._asdict()


def _spec(name, kind, model, over=(), batch_seeds=(5,), valid=zp.VALID,
          **extra):
    _, tmodel = zp.models(model, zp.cfg(model, **dict(over)))
    return {"name": name, "kind": kind, "over": _overrides(model, over),
            "meta": tuple(zp.meta()[1]),
            "params": {n: p.detach().clone()
                       for n, p in tmodel.named_parameters()},
            "batches": [_batch_dict(zp.batches(seed=s, valid=valid)[1])
                        for s in batch_seeds], **extra}


def _overrides(model, over):
    return {"model.experiment_type": model, "model.num_units": zp.D,
            "model.num_blocks": zp.HOPS, "model.dropout": 0.0,
            "data.max_seq_len": zp.L, "model.vocab_pad_multiple": 16,
            **dict(over)}


def _specs():
    table, ids = _engine_inputs()
    specs = [{"name": f"engines_{k}", "kind": "engines", "mesh": m,
              "table": table, "ids": ids} for k, m in ENGINE_MESHES.items()]
    for model in STEP_MODELS:
        extra = {"eval_batch": _batch_dict(zp.batches(seed=9)[1])}
        if model == "bpr":
            extra["neg_id"] = zp.jax_negative(BPR_SEED)
        specs.append(_spec(f"step_{model}", "steps", model, EP, **extra))
    specs.append(_spec("traj_Gru4Rec", "steps", "Gru4Rec", EP,
                       batch_seeds=(0, 1, 2)))
    for engine in ("a2a", "psum"):
        specs.append(_spec(
            f"traj_{engine}", "steps", "MTAM",
            {**EP, "mesh.embedding_engine": engine}, batch_seeds=(0, 1, 2),
            eval_batch=_batch_dict(zp.batches(seed=9)[1])))
    specs.append(_spec("uneven", "steps", "MTAM",
                       {"mesh.model_axis_size": 1}, valid=UNEVEN))
    for mesh in ("2x2", "4x1"):
        specs.append(_spec(
            f"dropout_{mesh}", "steps", "SASrec",
            {**(EP if mesh == "2x2" else {}), "model.dropout": 0.5},
            batch_seeds=(0, 1)))
    for layout in ("flatten_optimizer", "pack_small_leaves"):
        specs.append(_spec(f"layout_{layout}", "steps", "MTAM",
                           {**EP, f"train.{layout}": True},
                           batch_seeds=(0, 1)))
    return specs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs = _specs()
    outs = torch_dist_worker.spawn(specs, WORLD,
                                   tmp_path_factory.mktemp("parallel"))
    return {s["name"]: s for s in specs}, outs


def _one_rank(spec, n_steps=None, gen_seed=0):
    """The port's unsharded steps on a spec: (metrics a step, model)."""
    c = TConfig().with_overrides(**{
        k: v for k, v in spec["over"].items() if not k.startswith("mesh.")})
    model = torch_dist_worker._model(spec, c)
    opt = make_optimizer(c.train)
    state = opt.init(model)
    vocab = zp.meta()[1].item_vocab
    step = make_train_step(get_model(c.model.experiment_type), c, opt, vocab,
                           "cpu", torch.Generator().manual_seed(gen_seed))
    metrics = []
    for b in spec["batches"][:n_steps]:
        state, m = step(model, state, Batch(**b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, model


def _close_params(got, model, rtol=TRAJ_RTOL, atol=TRAJ_ATOL):
    own = dict(model.named_parameters())
    assert set(got) == set(own)
    for name, p in own.items():
        torch.testing.assert_close(got[name], p.detach(), rtol=rtol,
                                   atol=atol, msg=name)


# ------------------------------------------------------------ in process

@pytest.mark.parametrize("world,over,shape", [
    (8, {}, (8, 1)), (8, {"model_axis_size": 2}, (4, 2)),
    (4, {"model_axis_size": 4}, (1, 4)),
    (6, {"data_axis_size": 3, "model_axis_size": 2}, (3, 2))])
def test_build_mesh_shapes(world, over, shape):
    mesh = build_mesh(MeshConfig(**over), world, rank=world - 1)
    assert (mesh.data, mesh.model) == shape
    assert mesh.shape == {"data": shape[0], "model": shape[1]}
    assert (mesh.data_index, mesh.model_index) == (shape[0] - 1,
                                                   shape[1] - 1)
    model_groups = mesh_lib.group_lists(mesh, "model")
    data_groups = mesh_lib.group_lists(mesh, "data")
    assert model_groups[-1][-1] == world - 1 == data_groups[-1][-1]
    assert data_groups[-1] == [d * shape[1] + shape[1] - 1
                               for d in range(shape[0])]
    assert sorted(sum(model_groups, [])) == list(range(world)) == \
        sorted(sum(data_groups, []))


@pytest.mark.parametrize("world,over", [
    (8, {"model_axis_size": 3}),
    (8, {"data_axis_size": 3, "model_axis_size": 2}),
    (2, {"data_axis_size": 3})])
def test_build_mesh_errors(world, over):
    with pytest.raises(ValueError):
        build_mesh(MeshConfig(**over), world, 0)


def test_engine_scope_validation_and_noop():
    mesh = build_mesh(MeshConfig(model_axis_size=2), 2, 0)
    with pytest.raises(ValueError, match="unknown embedding_engine"):
        with es.engine_scope(mesh, "bogus"):
            pass
    # PyTorch has no partitioner: gspmd runs the psum engine
    with es.engine_scope(mesh, "gspmd"):
        assert es.active_gather() is not None
    mesh1 = build_mesh(MeshConfig(model_axis_size=1), 2, 0)
    with es.engine_scope(mesh1, "a2a"):
        assert es.active_gather() is None
    assert es.active_gather() is None


def test_collectives_without_a_group_are_the_identity():
    x = torch.randn(3, 4, requires_grad=True)
    y = mesh_lib.reduce_from_group(mesh_lib.copy_to_group(x, None), None)
    y = mesh_lib.all_to_all(y, None)
    (y * 2).sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, torch.full_like(x, 2))
    assert torch.equal(mesh_lib.all_reduce_max(x, None), x.detach())


def test_place_and_rows():
    mesh = build_mesh(MeshConfig(model_axis_size=2), 4, 3)   # (1, 1)
    cfg = MeshConfig(model_axis_size=2, shard_embeddings=True)
    t = {"embedding.item_table": torch.arange(16.).reshape(8, 2),
         "att.0.q.w": torch.ones(2, 2)}
    placed = sharding.place_tensors(mesh, cfg, t)
    assert torch.equal(placed["embedding.item_table"], t[
        "embedding.item_table"][4:])
    assert placed["att.0.q.w"] is t["att.0.q.w"]
    with pytest.raises(ValueError, match="does not split"):
        sharding.row_range(mesh, 7)
    _, tb = zp.batches()
    part = sharding.place_batch(mesh, cfg, tb)
    assert torch.equal(part.items, tb.items[4:])
    assert not sharding.tables_sharded(mesh, MeshConfig(model_axis_size=2))


# ------------------------------------------------------------ four ranks

@pytest.mark.parametrize("mesh", sorted(ENGINE_MESHES))
@pytest.mark.parametrize("engine", ["psum", "a2a"])
def test_engines_exact(runs, mesh, engine):
    _, outs = runs
    table, ids = _engine_inputs()
    t = table.clone().requires_grad_(True)
    rows = take_dtable(t, ids)
    torch.sin(rows).sum().backward()
    for out in outs:
        got = out[f"engines_{mesh}"]
        assert torch.equal(got[engine], rows.detach())
        assert torch.equal(got[f"{engine}_grad"], t.grad)
        assert got["gspmd_is_psum"]


def _jax_losses(model, over, rng_seed):
    """JAX's compute_loss and its sharded step on four of the eight
    virtual devices (a 2x2 mesh), on the spec's parameters and batch."""
    c = JConfig().with_overrides(**_overrides(model, over))
    params = zp.jax_params(model, c)
    jb, _ = zp.batches()
    jmeta, _ = zp.meta()
    rng = jax.random.PRNGKey(rng_seed)
    ref = float(jax.jit(lambda p, b: jbase.compute_loss(
        jget_model(model), p, c.model, b, True, rng,
        jmeta.item_vocab)["loss"])(params, jb))
    mesh = jbuild_mesh(c.mesh, jax.devices()[:4])
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    opt = jmake_opt(c.train)
    placed = jshard.place_params(mesh, c.mesh, params)
    assert placed["embedding"]["item_table"].sharding.spec == P("model",
                                                                None)
    o_pl = jax.device_put(opt.init(params),
                          jshard.replicated_tree(mesh, opt.init(params)))
    step = jsharded_step(jget_model(model), c, opt, mesh, placed,
                         jmeta.item_vocab)
    _, _, m = step(placed, o_pl, jshard.place_batch(mesh, c.mesh, jb), rng)
    return ref, float(m["loss"])


@pytest.mark.parametrize("model", STEP_MODELS)
def test_sharded_step_matches_jax(runs, model, devices):
    specs, outs = runs
    spec = specs[f"step_{model}"]
    ref, sharded = _jax_losses(model, EP, BPR_SEED)
    one, one_model = _one_rank(spec)
    for out in outs:
        got = out[f"step_{model}"]
        assert got["table_rows"] == 32          # 64 padded rows over 2
        if model == "bpr":
            # JAX draws its negative from the rng: injected here
            loss = got["scoped_loss"]
        else:
            loss = got["metrics"][0]["loss"]
        np.testing.assert_allclose(loss, ref, rtol=1e-5)
        np.testing.assert_allclose(loss, sharded, rtol=1e-5)
        # the step with the generator's negative: the one-rank step's
        np.testing.assert_allclose(got["metrics"][0]["loss"],
                                   one[0]["loss"], rtol=1e-5)
        _close_params(got["params"], one_model)
        want = ev.make_eval_step(get_model(model), TConfig().with_overrides(
            **_overrides(model, {})).model,
            valid_vocab=zp.meta()[1].item_vocab)(
            one_model, Batch(**spec["eval_batch"]))
        for k, v in want.items():
            assert got["eval"][k] == pytest.approx(float(v), abs=1e-6), k


@pytest.mark.parametrize("name", ["traj_Gru4Rec", "traj_a2a", "traj_psum"])
def test_sharded_trajectory_matches_unsharded(runs, name):
    specs, outs = runs
    one, model = _one_rank(specs[name])
    for out in outs:
        got = out[name]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   [m["loss"] for m in one], rtol=1e-5)
        _close_params(got["params"], model)
    assert torch.equal(outs[0][name]["params"]["embedding.item_table"],
                       outs[3][name]["params"]["embedding.item_table"])


def test_uneven_filler_rows(runs, devices):
    specs, outs = runs
    spec = specs["uneven"]
    one, model = _one_rank(spec)
    c = JConfig().with_overrides(**_overrides("MTAM", {}))
    jb, _ = zp.batches(valid=UNEVEN)
    ref = float(jax.jit(lambda p, b: jbase.compute_loss(
        jget_model("MTAM"), p, c.model, b, True, None,
        zp.meta()[0].item_vocab)["loss"])(zp.jax_params("MTAM", c), jb))
    for out in outs:
        m = out["uneven"]["metrics"][0]
        for k in ("loss", "ce", "l2"):
            np.testing.assert_allclose(m[k], one[0][k], rtol=1e-6)
        np.testing.assert_allclose(m["loss"], ref, rtol=1e-5)
        _close_params(out["uneven"]["params"], model)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_dropout_draws_the_global_batch_masks(runs, mesh):
    specs, outs = runs
    name = f"dropout_{mesh}"
    one, model = _one_rank(specs[name])
    for out in outs:
        np.testing.assert_allclose(
            [m["loss"] for m in out[name]["metrics"]],
            [m["loss"] for m in one], rtol=1e-5)
        _close_params(out[name]["params"], model)


@pytest.mark.parametrize("layout", ["flatten_optimizer", "pack_small_leaves"])
def test_optimizer_layouts_on_the_mesh(runs, layout):
    specs, outs = runs
    name = f"layout_{layout}"
    one, model = _one_rank(specs[name])
    for out in outs:
        np.testing.assert_allclose(
            [m["loss"] for m in out[name]["metrics"]],
            [m["loss"] for m in one], rtol=1e-5)
        _close_params(out[name]["params"], model)


def test_workers_import_neither_jax_nor_the_jax_package(runs):
    _, outs = runs
    for out in outs:
        assert out["imported"] == []
        assert out["collectives"]["all_to_all"] > 0
        assert out["collectives"]["host_staged"] == 0     # CPU tensors
