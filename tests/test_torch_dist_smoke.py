"""Two-process runs of the port on gloo, on the CPU.

Two ranks (tests/torch_dist_worker.py, one spawn for the module) run
six sharded MTAM steps at mesh 1x2 (row-sharded tables, the packed
optimizer layout) with a `Checkpointer` save after the third, restore
that checkpoint and replay the last three: the losses and parameters are
bit-identical to the unbroken run's, in both ranks.  The checkpoint is
the single-device format: the 2-rank checkpoint restores on one rank,
and a one-rank checkpoint restores on two, each then stepping within
rtol 1e-5 of the other's run.  The command line runs under
``python -m torch.distributed.run`` on two CPU ranks with
``--model_parallel 2``, and its checkpoint resumes in one process.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker
import torch_zoo_parity as zp
from mtamrecommender_tpu_torch import cli
from mtamrecommender_tpu_torch.config import ExperimentConfig as TConfig
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer
from mtamrecommender_tpu_torch.train.trainer import (TrainState,
                                                     make_optimizer,
                                                     make_train_step)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVER = {"model.experiment_type": "MTAM", "model.num_units": zp.D,
        "model.num_blocks": zp.HOPS, "model.dropout": 0.0,
        "data.max_seq_len": zp.L, "model.vocab_pad_multiple": 16,
        "train.pack_small_leaves": True}
EP = {"mesh.model_axis_size": 2, "mesh.shard_embeddings": True}
SEEDS = range(100, 106)


def _params():
    _, model = zp.models("MTAM", zp.cfg("MTAM", **OVER))
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _spec(name, where, **extra):
    return {"name": name, "kind": "resume", "over": {**OVER, **EP},
            "meta": tuple(zp.meta()[1]), "params": _params(),
            "batches": [zp.batches(seed=s)[1]._asdict() for s in SEEDS],
            "ckpt_dir": str(where / f"{name}_ckpt"), **extra}


def _one_rank_cfg():
    return TConfig().with_overrides(**OVER)


def _one_rank_steps(model, opt_state, lo, hi):
    c = _one_rank_cfg()
    opt = make_optimizer(c.train)
    step = make_train_step(get_model("MTAM"), c, opt,
                           zp.meta()[1].item_vocab, "cpu")
    losses = []
    for s in list(SEEDS)[lo:hi]:
        opt_state, m = step(model, opt_state, zp.batches(seed=s)[1])
        losses.append(float(m["loss"]))
    return opt_state, losses


def _fresh_model():
    c = _one_rank_cfg()
    spec = {"meta": tuple(zp.meta()[1]), "params": _params()}
    return torch_dist_worker._model(spec, c), make_optimizer(c.train)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    where = tmp_path_factory.mktemp("dist")
    # the one-rank run, saved after its third step
    model, opt = _fresh_model()
    opt_state, losses = _one_rank_steps(model, opt.init(model), 0, 3)
    Checkpointer(str(where / "one_rank")).save(TrainState(model, opt_state,
                                                          3))
    _, tail = _one_rank_steps(model, opt_state, 3, 6)
    one = {"losses": losses + tail,
           "params": {n: p.detach().clone()
                      for n, p in model.named_parameters()}}
    specs = [_spec("resume", where),
             _spec("from_one_rank", where,
                   restore_dir=str(where / "one_rank"))]
    outs = torch_dist_worker.spawn(specs, 2, where)
    return where, one, outs


def test_two_process_resume_is_bit_identical(runs):
    _, _, outs = runs
    for out in outs:
        got = out["resume"]
        assert got["restored_step"] == 3
        assert len(got["a"]) == 6 and got["a"][3:] == got["b"]
        for name, p in got["params_a"].items():
            assert torch.equal(p, got["params_b"][name]), name
        assert out["imported"] == []
    assert outs[0]["resume"]["a"] == outs[1]["resume"]["a"]


def test_two_rank_run_matches_one_rank(runs):
    _, one, outs = runs
    np.testing.assert_allclose(outs[0]["resume"]["a"], one["losses"],
                               rtol=1e-5)
    for name, p in one["params"].items():
        torch.testing.assert_close(outs[0]["resume"]["params_a"][name], p,
                                   rtol=2e-4, atol=2e-5, msg=name)


def test_one_rank_checkpoint_restores_on_two_ranks(runs):
    _, one, outs = runs
    for out in outs:
        got = out["from_one_rank"]
        assert got["restored_step"] == 3
        np.testing.assert_allclose(got["b"], one["losses"][3:], rtol=1e-5)
        for name, p in one["params"].items():
            torch.testing.assert_close(got["params_b"][name], p, rtol=2e-4,
                                       atol=2e-5, msg=name)


def test_two_rank_checkpoint_restores_on_one_rank(runs):
    where, _, outs = runs
    model, opt = _fresh_model()
    restored = Checkpointer(str(where / "resume_ckpt")).restore(
        TrainState(model, opt.init(model), 0))
    assert restored.step == 3
    assert restored.model.embedding.item_table.shape[0] == 64
    _, losses = _one_rank_steps(restored.model, restored.opt_state, 3, 6)
    np.testing.assert_allclose(losses, outs[0]["resume"]["b"], rtol=1e-5)


SMALL = ["--type", "synthetic", "--experiment_type", "MTAM",
         "--set", "data.synth_users=60", "--set", "data.synth_items=40",
         "--set", "data.max_seq_len=8", "--set", "model.num_units=8",
         "--set", "model.num_blocks=1",
         "--set", "train.train_batch_size=32",
         "--set", "train.test_batch_size=64",
         "--set", "train.eval_freq=2", "--set", "train.save_freq=2",
         "--version", "dist", "--device", "cpu"]


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_under_torch_distributed_run(tmp_path, monkeypatch):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    paths = ["--run_root", str(tmp_path / "runs"), "--data_root",
             str(tmp_path / "data")]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "mtamrecommender_tpu_torch",
         "--model_parallel", "2", "--max_steps", "4", *SMALL, *paths],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    # only rank 0 logs
    assert log.count("mesh: {'data': 1, 'model': 2}") == 1, log[-4000:]
    assert log.count("done at step 4") == 1
    run_dir = tmp_path / "runs" / "synthetic_MTAM_dist"
    events = [json.loads(x) for x in
              (run_dir / "events.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events if "hr@10" in e] == [0, 2, 4, 4]
    ckpt = tmp_path / "data" / "check_point" / "synthetic_MTAM_dist"
    assert sorted(os.listdir(ckpt)) == ["2", "4"]
    # the 2-rank checkpoint resumes in one process
    monkeypatch.chdir(tmp_path)
    cap = _Capture()
    logger = logging.getLogger("mtamrec_torch")
    logger.addHandler(cap)
    try:
        assert cli.main(SMALL + paths + [
            "--max_steps", "6", "--set", "model.vocab_pad_multiple=128",
            "--set", "train.load_type=full"]) == 0
    finally:
        logger.removeHandler(cap)
    assert any(m.startswith("resuming at step 4") for m in cap.lines)
    assert "done at step 6" in cap.lines[-1]
