"""The port's command line and fleet on ``--device cpu``.

`cli.main` runs in process (``--statistics`` and ``--top_pop`` log the
values the JAX package's CLI logs; a 12-step bpr run writes
``events.jsonl`` and a checkpoint, and a second run with
``--set train.load_type=full`` resumes from it), the fleet runs one
3-step experiment in a subprocess, and a subprocess with ``pandas``,
``jax`` and ``mtamrecommender_tpu`` made unimportable imports the port's
data path, CLI, fleet, `Trainer` and ``chip_smoke.py`` and trains
through the CLI with the native builder.  The mesh options set JAX's
overrides; a mesh that does not fit the world raises `build_mesh`'s
ValueError (tests/test_torch_dist_smoke.py runs them on two ranks).
"""

import json
import logging
import os
import subprocess
import sys

import pytest
import torch

from mtamrecommender_tpu import cli as jcli
from mtamrecommender_tpu_torch import cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--type", "synthetic",
         "--set", "data.synth_users=60", "--set", "data.synth_items=40",
         "--set", "data.max_seq_len=8", "--set", "model.num_units=8",
         "--set", "model.num_blocks=1",
         "--set", "train.train_batch_size=32",
         "--set", "train.test_batch_size=64",
         "--set", "train.eval_freq=1000"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logged(main, name, argv):
    """The messages ``main(argv)`` logs through the logger ``name``."""
    cap = _Capture()
    logger = logging.getLogger(name)
    logger.addHandler(cap)
    try:
        assert main(argv) == 0
    finally:
        logger.removeHandler(cap)
    return [m for m in cap.lines if not m.startswith("resolved config")]


@pytest.mark.parametrize("flag", ["--statistics", "--top_pop"])
def test_statistics_and_top_pop_log_jax_values(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = SMALL + [flag, "--data_root", str(tmp_path / "d")]
    want = _logged(jcli.main, "mtamrec", argv)
    got = _logged(cli.main, "mtamrec_torch", argv + ["--device", "cpu"])
    assert got == want
    assert any(("statistics events" if flag == "--statistics"
                else "TopPop:") in m for m in got)


def test_train_checkpoint_and_resume(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = SMALL + ["--experiment_type", "bpr", "--version", "clitest",
                    "--run_root", str(tmp_path / "runs"),
                    "--data_root", str(tmp_path / "data"), "--device", "cpu",
                    "--set", "train.eval_freq=4", "--set",
                    "train.save_freq=4"]
    lines = _logged(cli.main, "mtamrec_torch", argv + ["--max_steps", "12"])
    assert any(m.startswith("examples (native builder)") for m in lines)
    assert "done at step 12" in lines[-1]
    run_dir = tmp_path / "runs" / "synthetic_bpr_clitest"
    events = [json.loads(x) for x in
              (run_dir / "events.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events if "hr@10" in e] == [0, 4, 8, 12, 12]
    assert any("train_loss" in e for e in events)
    ckpt = tmp_path / "data" / "check_point" / "synthetic_bpr_clitest"
    assert sorted(os.listdir(ckpt)) == ["12", "4", "8"]
    with open(ckpt / "12" / "cursor.json") as f:
        assert "gen_state" in json.load(f)

    lines = _logged(cli.main, "mtamrec_torch", argv + [
        "--max_steps", "16", "--set", "train.load_type=full", "--profile"])
    assert any(m.startswith("resuming at step 12") for m in lines)
    assert "done at step 16" in lines[-1]
    assert (run_dir / "profile" / "trace.json").exists()

    # the Python builder, and its cache
    lines = _logged(cli.main, "mtamrec_torch", SMALL + [
        "--experiment_type", "bpr", "--max_steps", "2", "--no_fast_prep",
        "--version", "cachetest", "--run_root", str(tmp_path / "runs"),
        "--data_root", str(tmp_path / "data"), "--device", "cpu"])
    assert any(m.startswith("examples: train=") for m in lines)
    assert (tmp_path / "data" / "train_data" / "synthetic" /
            "train_data.txt").exists()


def test_unported_options_raise(monkeypatch):
    """The mesh options run since parallel/ is ported: they set JAX's
    overrides, and a mesh that does not fit the world raises
    build_mesh's ValueError before any process group is made."""
    for flags in (["--model_parallel", "2"], ["--embedding_engine", "a2a"],
                  ["--model_parallel", "4", "--embedding_engine", "psum"]):
        got = cli.build_config(cli.make_parser().parse_args(flags))
        want = jcli.build_config(jcli.make_parser().parse_args(flags))
        assert got.to_dict() == want.to_dict()
    cfg = cli.build_config(cli.make_parser().parse_args(
        ["--model_parallel", "2", "--embedding_engine", "a2a"]))
    assert (cfg.mesh.model_axis_size, cfg.mesh.shard_embeddings,
            cfg.model.vocab_pad_multiple, cfg.mesh.embedding_engine) == \
        (2, True, 128, "a2a")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="mesh 3x1 != device count 2"):
        cli.main(SMALL + ["--set", "mesh.data_axis_size=3", "--device",
                          "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="does not divide device count 1"):
        cli.main(["--model_parallel", "2", "--device", "cpu"])
    args = cli.make_parser().parse_args(
        ["--experiment_name", "MTAMb7_elec", "--set", "model.num_blocks=9",
         "--use_pallas", "--version", "x"])
    cfg = cli.build_config(args)
    assert cfg.model.num_blocks == 9 and cfg.version == "x"
    assert args.device == "cuda"


def test_fleet_single_experiment(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "mtamrecommender_tpu_torch.fleet",
         "--datasets", "synthetic", "--models", "bpr", "--max_steps", "3",
         "--device", "cpu",
         "--run_root", str(tmp_path / "runs"),
         "--log_dir", str(tmp_path / "logs"),
         "--set", "data.synth_users=40", "--set", "data.synth_items=25",
         "--set", "data.max_seq_len=6", "--set", "model.num_units=8",
         "--set", "train.train_batch_size=16",
         "--set", "train.test_batch_size=32",
         "--set", "train.eval_freq=1000"],
        env=_env(), cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "finished synthetic/bpr: ok" in proc.stdout
    log = (tmp_path / "logs" / "synthetic_bpr.log").read_text()
    assert "done at step 3" in log


BLOCKED = """
import sys
for name in ("pandas", "jax", "mtamrecommender_tpu"):
    sys.modules[name] = None          # any import of them now fails
import chip_smoke  # noqa: F401
from mtamrecommender_tpu_torch import cli, fleet  # noqa: F401
from mtamrecommender_tpu_torch.data import fastprep, ingest, pipeline, prepare  # noqa: F401
from mtamrecommender_tpu_torch.train.trainer import Trainer  # noqa: F401
rc = cli.main(sys.argv[1:])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "pandas", "jax", "jaxlib", "mtamrecommender_tpu")
    and sys.modules[m] is not None)
print("LOADED", loaded, "RC", rc)
"""


def test_port_runs_without_pandas_or_jax(tmp_path):
    for flag in ([], ["fleet"]):
        mod = ".".join(["mtamrecommender_tpu_torch"] + flag)
        proc = subprocess.run([sys.executable, "-m", mod, "--help"],
                              env=_env(), cwd=str(tmp_path),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and "--device" in proc.stdout, \
            proc.stderr
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED] + SMALL + [
            "--experiment_type", "MTAM", "--max_steps", "3", "--device",
            "cpu", "--run_root", str(tmp_path / "runs"),
            "--data_root", str(tmp_path / "data")],
        env=_env(), cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED [] RC 0" in proc.stdout
    assert "examples (native builder)" in proc.stderr
    assert "done at step 3" in proc.stderr
