"""Serving a trained model from disk: `Recommender.from_checkpoint` and
the JSON-lines service `serve.main`, against the JAX package's.

The JAX package writes an Orbax checkpoint; JAX restores it and the
parameters cross through `bridge.load_jax_params` into the port's own
checkpoint (the port cannot read Orbax).  Both sides then serve the same
requests from their directories: top-10 ids equal, scores within 1e-4
(f32, as tests/test_torch_serve.py holds `recommend`).
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mtamrecommender_tpu import config as jconfig
from mtamrecommender_tpu import serve as jserve
from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.train import checkpoint as jckpt
from mtamrecommender_tpu.train import trainer as jtrainer
from mtamrecommender_tpu_torch import config as tconfig
from mtamrecommender_tpu_torch import serve as tserve
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train import checkpoint as tckpt
from mtamrecommender_tpu_torch.train.trainer import TrainState

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
D, HOPS, L = 16, 2, 12
USERS, ITEMS, CATS = 20, 60, 5
SCORE_ATOL = 1e-4
# main's flags, the same for both packages
FLAGS = ["--items", str(ITEMS), "--users", str(USERS), "--categories",
         str(CATS), "--max_seq_len", str(L), "--num_units", str(D),
         "--num_blocks", str(HOPS)]


def _cfgs():
    over = {"model.num_units": D, "model.num_blocks": HOPS,
            "data.max_seq_len": L}
    return (tconfig.ExperimentConfig().with_overrides(**over),
            jconfig.ExperimentConfig().with_overrides(**over))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A JAX checkpoint of MTAM's parameters (seed 4) and the port's of
    the same parameters, converted through the bridge."""
    root = tmp_path_factory.mktemp("ckpts")
    cfg, jcfg = _cfgs()
    jmeta = jtypes.DatasetMeta(USERS, ITEMS, CATS, L)
    params = jget_model("MTAM").init(jax.random.PRNGKey(4), jcfg.model, jmeta)
    opt = jtrainer.make_optimizer(jcfg.train)
    jdir = str(root / "jax")
    ck = jckpt.Checkpointer(jdir)
    ck.save(jtrainer.TrainState(params, opt.init(params), step=9), wait=True)
    ck.close()
    ck = jckpt.Checkpointer(jdir)
    restored = ck.restore(jtrainer.TrainState(params, opt.init(params)))
    ck.close()
    model = load_jax_params(
        get_model("MTAM").init(torch.Generator().manual_seed(0), cfg.model,
                               ttypes.DatasetMeta(USERS, ITEMS, CATS, L)),
        jax.device_get(restored.params))
    pdir = str(root / "port")
    tckpt.Checkpointer(pdir).save(TrainState(model, None, step=9))
    return jdir, pdir


def _requests():
    rng = np.random.RandomState(31)
    base = 1_700_000_000.0
    reqs = []
    for i, n in enumerate([0, 1, 4, L - 1, 2 * L, 7]):  # empty; past L-1
        hist = [[int(rng.randint(1, ITEMS + 1)), int(rng.randint(1, CATS + 1)),
                 base + 3600.0 * 5 * j + int(rng.randint(0, 3000))]
                for j in range(n)]
        req = {"history": hist, "request_time": base + 3600.0 * 300,
               "user_id": int(rng.randint(0, USERS + 1))}
        if i % 2:
            req["k"] = 5 + i
        reqs.append(req)
    return reqs


def _lines(reqs):
    return "\n".join(json.dumps(r) for r in reqs[:3]) + "\n\n" + \
        "\n".join(json.dumps(r) for r in reqs[3:]) + "\n"


def _assert_same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["items"] == w["items"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=SCORE_ATOL,
                                   rtol=0)


def test_from_checkpoint_serves_jax_top10(checkpoints):
    jdir, pdir = checkpoints
    cfg, jcfg = _cfgs()
    jmeta = jtypes.DatasetMeta(USERS, ITEMS, CATS, L)
    tmeta = ttypes.DatasetMeta(USERS, ITEMS, CATS, L)
    reqs = _requests()
    hists = [[tuple(e) for e in r["history"]] for r in reqs]
    times = [r["request_time"] for r in reqs]
    users = [r["user_id"] for r in reqs]
    want = jserve.Recommender.from_checkpoint(jcfg, jmeta, jdir).recommend(
        hists, times, k=10, user_ids=users)
    rec = tserve.Recommender.from_checkpoint(cfg, tmeta, pdir, device="cpu")
    assert rec.device.type == "cpu"
    got = rec.recommend(hists, times, k=10, user_ids=users)
    _assert_same_answers(
        [{"items": [i for i, _ in row], "scores": [s for _, s in row]}
         for row in got],
        [{"items": [i for i, _ in row], "scores": [s for _, s in row]}
         for row in want])
    assert all(len(row) == 10 for row in got)


def test_from_checkpoint_runs_on_cuda_by_default(checkpoints, monkeypatch):
    _, pdir = checkpoints
    cfg, _ = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Recommender.from_checkpoint(
            cfg, ttypes.DatasetMeta(USERS, ITEMS, CATS, L), pdir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--checkpoint", pdir, *FLAGS])


def test_from_checkpoint_of_an_empty_directory_raises(tmp_path):
    cfg, _ = _cfgs()
    with pytest.raises(FileNotFoundError):
        tserve.Recommender.from_checkpoint(
            cfg, ttypes.DatasetMeta(USERS, ITEMS, CATS, L), str(tmp_path),
            device="cpu")


def _run_main(main, argv, text, monkeypatch, capsys):
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert main(argv) == 0
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines()]


def test_main_answers_like_jax_main(checkpoints, monkeypatch, capsys):
    jdir, pdir = checkpoints
    text = _lines(_requests())
    want = _run_main(jserve.main, ["--checkpoint", jdir, *FLAGS], text,
                     monkeypatch, capsys)
    got = _run_main(tserve.main, ["--checkpoint", pdir, *FLAGS, "--device",
                                  "cpu"], text, monkeypatch, capsys)
    assert len(got) == 6                          # the blank line skipped
    _assert_same_answers(got, want)
    assert [len(a["items"]) for a in got] == [10, 6, 10, 8, 10, 10]
    # scores rounded to 5 places, as JAX's main writes them
    assert all(round(s, 5) == s for a in got for s in a["scores"])
    # --k and --set reach the service
    got = _run_main(tserve.main, ["--checkpoint", pdir, *FLAGS, "--device",
                                  "cpu", "--k", "3", "--set",
                                  "model.compute_dtype=\"float32\""],
                    json.dumps(_requests()[0]) + "\n", monkeypatch, capsys)
    assert len(got) == 1 and len(got[0]["items"]) == 3


def test_python_m_serve_runs_main(checkpoints, monkeypatch, capsys):
    _, pdir = checkpoints
    text = _lines(_requests())
    res = subprocess.run(
        [sys.executable, "-m", "mtamrecommender_tpu_torch.serve",
         "--checkpoint", pdir, *FLAGS, "--device", "cpu"],
        input=text, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = [json.loads(line) for line in res.stdout.splitlines()]
    want = _run_main(tserve.main, ["--checkpoint", pdir, *FLAGS, "--device",
                                   "cpu"], text, monkeypatch, capsys)
    _assert_same_answers(got, want)
