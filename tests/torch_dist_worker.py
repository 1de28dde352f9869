"""One rank of the port's multi-process CPU checks (tests/test_torch_parallel.py,
tests/test_torch_context_parallel.py, tests/test_torch_dist_smoke.py).

The parent test writes ``<dir>/spec.pt``: a list of scenarios, each a dict
of plain values and CPU tensors (parameters by name, batches by field,
config overrides).  Every rank brings up gloo through
`parallel.dist_trainer.initialize_distributed` on a file store in
``<dir>``, runs every scenario in order (each makes its mesh's groups,
so every rank calls the same collectives in the same order) and writes
``<dir>/out_<rank>.pt``: one dict of results a scenario.  The worker
imports neither JAX nor the JAX package; it records what it imported
under ``"imported"``.

Usage: python torch_dist_worker.py <rank> <world> <dir>
"""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

from mtamrecommender_tpu_torch.config import ExperimentConfig, MeshConfig  # noqa: E402
from mtamrecommender_tpu_torch.models import base  # noqa: E402
from mtamrecommender_tpu_torch.models.registry import get_model  # noqa: E402
from mtamrecommender_tpu_torch.ops import attention as att  # noqa: E402
from mtamrecommender_tpu_torch.parallel import context_parallel as cp  # noqa: E402
from mtamrecommender_tpu_torch.parallel import dist_trainer as dt  # noqa: E402
from mtamrecommender_tpu_torch.parallel import embedding_shard as es  # noqa: E402
from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from mtamrecommender_tpu_torch.parallel import sharding  # noqa: E402
from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer  # noqa: E402
from mtamrecommender_tpu_torch.train.trainer import (TrainState,  # noqa: E402
                                                     layout_kind)
from mtamrecommender_tpu_torch.types import Batch, DatasetMeta  # noqa: E402


def make_mesh(cfg: MeshConfig):
    return mesh_lib.attach_groups(mesh_lib.build_mesh(cfg))


def engines(spec):
    """The psum and a2a engines' rows and table gradients (gathered)
    against the one-rank `take_dtable` lookup's."""
    cfg = MeshConfig(**{**spec["mesh"], "shard_embeddings": True})
    mesh = make_mesh(cfg)
    table, ids = spec["table"], spec["ids"]
    lo, hi = sharding.row_range(mesh, table.shape[0])
    out = {}
    for name, fn in (("psum", es.sharded_gather), ("a2a",
                                                   es.sharded_gather_a2a)):
        shard = table[lo:hi].clone().requires_grad_(True)
        rows = fn(mesh, shard, ids)
        torch.sin(rows).sum().backward()
        grad = sharding.gather_tensors(mesh, cfg,
                                       {"item_table": shard.grad})
        out[name] = rows.detach()
        out[f"{name}_grad"] = grad["item_table"]
    with es.engine_scope(mesh, "gspmd"):
        out["gspmd_is_psum"] = es.active_gather() is not None
    return out


def _cfg(spec):
    return ExperimentConfig().with_overrides(**spec["over"])


def _model(spec, cfg):
    model = get_model(cfg.model.experiment_type).init(
        torch.Generator().manual_seed(0), cfg.model,
        DatasetMeta(*spec["meta"]))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(spec["params"][name])
    return model


def _step_fn(spec, cfg, mesh, model):
    vocab = DatasetMeta(*spec["meta"]).item_vocab
    opt = dt.make_sharded_optimizer(cfg, mesh)
    sharding.place_params(mesh, cfg.mesh, model)
    gen = torch.Generator().manual_seed(spec.get("gen_seed", 0))
    step = dt.make_sharded_train_step(
        get_model(cfg.model.experiment_type), cfg, opt, mesh, vocab, "cpu",
        gen)
    return opt, step, vocab


def steps(spec):
    """Sharded train steps over ``batches``: each step's global metrics,
    the parameters gathered after them, the sharded evaluation of the
    final model on ``eval_batch`` and, given ``neg_id``, the loss of the
    sharded forward with that negative injected."""
    cfg = _cfg(spec)
    mesh = make_mesh(cfg.mesh)
    model = _model(spec, cfg)
    opt, step, vocab = _step_fn(spec, cfg, mesh, model)
    out = {}
    mdef = get_model(cfg.model.experiment_type)
    if spec.get("neg_id") is not None:
        local = sharding.place_batch(mesh, cfg.mesh,
                                     Batch(**spec["batches"][0]))
        with torch.no_grad(), dt._engine_scope(mesh, cfg):
            m = base.compute_loss(mdef, model, cfg.model, local, vocab,
                                  neg_id=spec["neg_id"])
        out["scoped_loss"] = float(dt_sum(mesh, cfg, m["loss"]))
    opt_state = opt.init(model)
    losses = []
    for b in spec["batches"]:
        opt_state, metrics = step(model, opt_state, Batch(**b))
        losses.append({k: float(v) for k, v in metrics.items()})
    out["metrics"] = losses
    out["params"] = sharding.gather_params(mesh, cfg.mesh, model)
    out["table_rows"] = model.embedding.item_table.shape[0]
    if spec.get("eval_batch") is not None:
        ev = dt.make_sharded_eval_step(mdef, cfg, mesh, valid_vocab=vocab)
        out["eval"] = {k: float(v) for k, v in
                       ev(model, Batch(**spec["eval_batch"])).items()}
    return out


def dt_sum(mesh, cfg, x):
    x = x.detach().clone()
    return mesh_lib.all_reduce_(x, mesh.group(cfg.mesh.data_axis_name))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def cp_attention(spec):
    """The key-sharded time attention's output and gradients (of
    sum(out * probe) wrt the block's parameters, the queries and the
    keys); raises pass back as their message."""
    mesh = make_mesh(MeshConfig(**spec["mesh"]))
    block = att.attention_block(_clone(spec["block"]))
    q = spec["q"].clone().requires_grad_(True)
    k = spec["k"].clone().requires_grad_(True)
    try:
        with cp.cp_scope(mesh):
            out = att.time_aware_multihead_attention(
                block, q, k, spec["kl"], spec["ql"], spec["tq"], spec["tk"],
                num_heads=spec["heads"])
    except ValueError as exc:
        return {"error": str(exc)}
    (out * spec["probe"]).sum().backward()
    grads = {n: p.grad for n, p in block.named_parameters()}
    return {"out": out.detach(), "grads": grads, "dq": q.grad, "dk": k.grad}


def resume(spec):
    """Six sharded steps with a save after the third, then a restore of
    that checkpoint and the last three again; and, given ``restore_dir``,
    a whole-model checkpoint (of another world size) restored and
    stepped."""
    cfg = _cfg(spec)
    mesh = make_mesh(cfg.mesh)
    model = _model(spec, cfg)
    opt, step, _ = _step_fn(spec, cfg, mesh, model)
    placement = sharding.Placement(mesh, cfg.mesh, layout_kind(cfg.train))
    batches = [Batch(**b) for b in spec["batches"]]

    def run(model, opt_state, lo, hi):
        losses = []
        for b in batches[lo:hi]:
            opt_state, m = step(model, opt_state, b)
            losses.append(float(m["loss"]))
        return opt_state, losses

    out = {}
    opt_state = opt.init(model)
    ckpt = Checkpointer(spec["ckpt_dir"], placement=placement)
    if spec.get("restore_dir") is None:
        opt_state, a = run(model, opt_state, 0, 3)
        ckpt.save(TrainState(model, opt_state, 3))
        opt_state, tail = run(model, opt_state, 3, 6)
        out["a"] = a + tail
        out["params_a"] = sharding.gather_params(mesh, cfg.mesh, model)
        template = TrainState(model, opt_state, 6)
    else:
        template = TrainState(model, opt_state, 0)
        ckpt = Checkpointer(spec["restore_dir"], placement=placement)
    restored = ckpt.restore(template)
    out["restored_step"] = restored.step
    _, out["b"] = run(restored.model, restored.opt_state, 3, 6)
    out["params_b"] = sharding.gather_params(mesh, cfg.mesh, restored.model)
    return out


def spawn(specs, world, where, timeout=240):
    """Run ``specs`` on ``world`` gloo ranks, a process each, in the
    directory ``where``; returns each rank's results."""
    where = str(where)
    torch.save(specs, os.path.join(where, "spec.pt"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         where], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=where) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(os.path.join(where, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


KINDS = {"engines": engines, "steps": steps, "cp_attention": cp_attention,
         "resume": resume}


def main():
    rank, world, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dt.initialize_distributed("gloo", f"file://{os.path.join(where, 'store')}",
                              world, rank)
    specs = torch.load(os.path.join(where, "spec.pt"), weights_only=False)
    results = {spec["name"]: KINDS[spec["kind"]](spec) for spec in specs}
    results["imported"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                      "mtamrecommender_tpu"))
    results["collectives"] = dict(mesh_lib.collective_calls)
    torch.save(results, os.path.join(where, f"out_{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
