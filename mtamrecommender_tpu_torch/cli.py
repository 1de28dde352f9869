"""Training CLI — the `train_process.py` equivalent (the counterpart of
mtamrecommender_tpu/cli.py).

Usage:

    python -m mtamrecommender_tpu_torch --experiment_name MTAM_ml1m
    python -m mtamrecommender_tpu_torch --type synthetic_timed \\
        --experiment_type MTAM --set train.max_epochs=3
    python -m mtamrecommender_tpu_torch --type synthetic --device cpu ...
    python -m torch.distributed.run --nproc_per_node 2 \
        -m mtamrecommender_tpu_torch --model_parallel 2 ...

Presets come from config.get_preset (the reference's --experiment_name
dispatch); every config leaf is overridable with --set
section.leaf=value.  The run: load the raw log (`data.ingest`), build the
examples with the native builder (`data.fastprep`, falling back to the
Python builder and its cache on RuntimeError), train with
`train.trainer.Trainer` (evaluation on its cadence, checkpoints under
``data/check_point/<run_name>`` of the working directory), and resume
from the latest checkpoint with ``--set train.load_type=full``.

It runs on CUDA unless ``--device cpu``.  ``--use_pallas`` is accepted
and ignored (the port routes to its kernels by shape).  ``--set
model.num_heads=2`` (any count dividing ``model.num_units``) runs
multi-head attention in every model that reads it (MTAM, PISTRec, the
self-attention models), as the JAX package does on its jnp path: the
attention and readout kernels take one head, so the attention takes
the dense route (plain PyTorch) while the GRU and table kernels still
run.

Under ``python -m torch.distributed.run`` (its ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK``) the ranks form a mesh (`parallel.mesh.build_mesh`
over ``mesh.*``: ``--model_parallel N`` sets ``mesh.model_axis_size=N``,
``mesh.shard_embeddings=true`` and ``model.vocab_pad_multiple=max(128,
N)``, as JAX's command line does; ``--embedding_engine`` sets
``mesh.embedding_engine``) and train with the `Trainer`'s sharded steps.
The process group's backend is ``--dist_backend``: by default NCCL on
CUDA (one card a rank: rank r of a host takes ``cuda:<LOCAL_RANK>``) and
gloo on the CPU; ranks that share a card ask for ``--dist_backend
gloo``, since NCCL refuses two ranks on one device.  Only rank 0 logs,
writes events and writes checkpoints (the single-device format).
``--profile`` writes a torch.profiler trace of the fit under
``<run_dir>/profile`` (rank 0's).  The JAX package's persistent XLA compile cache
(`_enable_compile_cache`) has no counterpart: the port compiles its
kernels once into ``build/`` and PyTorch's eager ops compile nothing.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, List, Optional

from mtamrecommender_tpu_torch.config import (ExperimentConfig, get_preset,
                                              preset_names)

def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def build_config(args: argparse.Namespace) -> ExperimentConfig:
    cfg = get_preset(args.experiment_name) if args.experiment_name \
        else ExperimentConfig()
    over = {}
    if args.type:
        over["data.dataset"] = args.type
    if args.experiment_type:
        over["model.experiment_type"] = args.experiment_type
    if args.version:
        over["version"] = args.version
    if args.train_batch_size:
        over["train.train_batch_size"] = args.train_batch_size
    if args.load_type:
        over["train.load_type"] = args.load_type
    if args.use_pallas:
        over["model.use_pallas"] = True
    if args.model_parallel > 1:
        over["mesh.model_axis_size"] = args.model_parallel
        over["mesh.shard_embeddings"] = True
        over["model.vocab_pad_multiple"] = max(128, args.model_parallel)
    if args.embedding_engine:
        over["mesh.embedding_engine"] = args.embedding_engine
    for item in args.set or []:
        key, _, raw = item.partition("=")
        over[key] = _parse_value(raw)
    return cfg.with_overrides(**over) if over else cfg


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mtamrecommender_tpu_torch",
        description="sequential-recommender training on PyTorch/CUDA")
    p.add_argument("--experiment_name", choices=preset_names(), default=None,
                   help="named preset (reference --experiment_name)")
    p.add_argument("--type", default=None, help="dataset (reference --type)")
    p.add_argument("--experiment_type", default=None,
                   help="model family (reference --experiment_type)")
    p.add_argument("--version", default=None)
    p.add_argument("--train_batch_size", type=int, default=None)
    p.add_argument("--load_type", default=None,
                   choices=["from_scratch", "full", "fine_tune"])
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="dotted config override, e.g. model.num_blocks=5")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted and ignored: the port routes to its "
                        "kernels by shape")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model-axis size: row-shard the tables over it")
    p.add_argument("--embedding_engine", default=None,
                   choices=["gspmd", "a2a", "psum"],
                   help="sharded-lookup engine (gspmd runs psum: PyTorch "
                        "has no partitioner)")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend under "
                        "torch.distributed.run (default nccl on cuda, gloo "
                        "on cpu; gloo where ranks share a card)")
    p.add_argument("--data_root", default=None)
    p.add_argument("--run_root", default="data/runs")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the fit under "
                        "<run_dir>/profile")
    p.add_argument("--statistics", action="store_true",
                   help="print dataset statistics and exit "
                        "(reference experiment_name=statistics)")
    p.add_argument("--top_pop", action="store_true",
                   help="evaluate the non-learned TopPop/P-Pop baselines")
    p.add_argument("--no_fast_prep", action="store_true",
                   help="force the Python example builder")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu runs "
                        "the kernels' plain twins)")
    return p


def _distributed(cfg: ExperimentConfig, args: argparse.Namespace):
    """(mesh or None, device) from torch.distributed.run's environment:
    the mesh validated before any process group is made, then the
    group brought up with the caller's backend and the mesh's groups
    attached."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if world <= 1 and cfg.mesh.model_axis_size <= 1 \
            and cfg.mesh.data_axis_size <= 1:
        return None, args.device
    from mtamrecommender_tpu_torch.parallel import dist_trainer
    from mtamrecommender_tpu_torch.parallel.mesh import (attach_groups,
                                                         build_mesh)
    mesh = build_mesh(cfg.mesh, world, rank)
    device = args.device
    if world > 1:
        import torch
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            device = f"cuda:{local % max(torch.cuda.device_count(), 1)}"
            torch.cuda.set_device(torch.device(device))
        backend = args.dist_backend or ("gloo" if device == "cpu"
                                        else "nccl")
        dist_trainer.initialize_distributed(backend, None, world, rank)
    return attach_groups(mesh), device


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    cfg = build_config(args)
    if args.data_root:
        cfg = cfg.with_overrides(**{"data.data_root": args.data_root})
    mesh, device = _distributed(cfg, args)
    try:
        return _run(cfg, args, mesh, device)
    finally:
        if mesh is not None and mesh.world_size > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(cfg: ExperimentConfig, args: argparse.Namespace, mesh,
         device) -> int:

    from mtamrecommender_tpu_torch.data.ingest import (data_statistics,
                                                       load_origin_data)
    from mtamrecommender_tpu_torch.data.pipeline import pack_examples
    from mtamrecommender_tpu_torch.data.prepare import prepare_examples
    from mtamrecommender_tpu_torch.utils.logging import create_log, quiet_log

    chief = mesh is None or mesh.rank == 0
    logger = create_log(cfg.data.dataset, cfg.model.experiment_type,
                        cfg.version) if chief else quiet_log()
    logger.info("resolved config: %s", json.dumps(cfg.to_dict()))
    if mesh is not None:
        logger.info("mesh: %s", mesh.shape)

    origin = load_origin_data(cfg.data)
    if args.statistics:
        for k, v in data_statistics(origin).items():
            logger.info("statistics %s = %s", k, v)
        return 0

    train = test = None
    if not (args.top_pop or args.no_fast_prep):
        # native example builder; falls back to the Python builder for
        # unsupported configs / a missing toolchain
        from mtamrecommender_tpu_torch.data import fastprep
        try:
            train, test, _ = fastprep.build_packed(origin, cfg.data)
            logger.info("examples (native builder): train=%d test=%d",
                        len(train), len(test))
        except RuntimeError as exc:
            logger.info("fastprep fallback: %s", exc)

    if train is None:
        cache_dir = os.path.join(cfg.data.data_root, "train_data",
                                 cfg.data.dataset)
        prepared = prepare_examples(origin, cfg.data, cache_dir=cache_dir)
        logger.info("examples: train=%d test=%d items=%d users=%d",
                    len(prepared.train_set), len(prepared.test_set),
                    prepared.meta.item_count, prepared.meta.user_count)

        if args.top_pop:
            from mtamrecommender_tpu_torch.models.top_pop import (
                eval_p_pop, eval_top_pop)
            for name, metrics in (("TopPop", eval_top_pop(
                    prepared.train_set, prepared.test_set)),
                    ("P-Pop", eval_p_pop(prepared.train_set,
                                         prepared.test_set))):
                logger.info("%s: %s", name,
                            {k: round(v, 4) for k, v in metrics.items()})
            return 0

        train = pack_examples(prepared.train_set, prepared.meta)
        test = pack_examples(prepared.test_set, prepared.meta)

    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.checkpoint import (Checkpointer,
                                                            apply_load_type)
    from mtamrecommender_tpu_torch.train.trainer import Trainer

    run_name = f"{cfg.data.dataset}_{cfg.model.experiment_type}_{cfg.version}"
    run_dir = os.path.join(args.run_root, run_name)
    trainer = Trainer(cfg=cfg, model=get_model(cfg.model.experiment_type),
                      train_data=train, test_data=test, run_dir=run_dir,
                      use_tensorboard=args.tensorboard, device=device,
                      mesh=mesh)

    ckpt_dir = os.path.join("data", "check_point", run_name)
    checkpointer = Checkpointer(ckpt_dir, placement=trainer.placement)
    state = trainer.init_state()
    try:
        state, cursor = apply_load_type(cfg.train, state, ckpt_dir,
                                        optimizer_init=trainer.optimizer.init,
                                        with_cursor=True,
                                        placement=trainer.placement)
    except FileNotFoundError as exc:
        # load_type=full before the first save (e.g. a fleet retry of a
        # run that crashed pre-checkpoint): start from scratch instead of
        # refusing to run
        logger.info("no checkpoint to restore (%s); training from scratch",
                    exc)
        cursor = None
    start_epoch = skip_steps = 0
    if cursor is not None:
        start_epoch, skip_steps = trainer.resume_from_cursor(cursor, state)
        logger.info("resuming at step %d (epoch %d, skipping %d steps)",
                    state.step, start_epoch, skip_steps)

    profiler = None
    if args.profile and chief:
        import torch
        activities = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    try:
        state = trainer.fit(state, max_epochs=args.max_epochs,
                            max_steps=args.max_steps,
                            checkpointer=checkpointer,
                            start_epoch=start_epoch, skip_steps=skip_steps)
    finally:
        if profiler is not None:
            profiler.stop()
            os.makedirs(os.path.join(run_dir, "profile"), exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(run_dir, "profile", "trace.json"))
        checkpointer.close()
    logger.info("done at step %d; best: %s", state.step,
                {k: round(v, 4) for k, v in trainer.best.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
