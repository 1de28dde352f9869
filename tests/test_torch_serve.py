"""The port's serving surface, its import rules and its weight bridge.

`Recommender` is held against the JAX package's `Recommender` on the same
parameters and histories (f32, top-10 ids); the port must import neither
JAX nor the JAX package, and must not run on the CPU unless asked to.
"""

import os
import re
import shutil
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
from mtamrecommender_tpu_torch import config as tconfig
from mtamrecommender_tpu_torch import serve as tserve
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.models.registry import get_model

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "mtamrecommender_tpu_torch"
L = 12


def _setup(**model_kw):
    cfg = tconfig.ExperimentConfig().with_overrides(**{
        "model.num_units": 16, "model.num_blocks": 2, "model.dropout": 0.0,
        "data.max_seq_len": L, "model.use_pallas": True,
        **{f"model.{k}": v for k, v in model_kw.items()}})
    jcfg = jconfig.ExperimentConfig().with_overrides(**{
        f"{s}.{k}": v for s in ("model", "data")
        for k, v in tconfig.dataclasses.asdict(getattr(cfg, s)).items()})
    jmeta = jtypes.DatasetMeta(20, 60, 5, L)
    params = jax.device_get(jget_model("MTAM").init(jax.random.PRNGKey(0),
                                                    jcfg.model, jmeta))
    return cfg, jcfg, params, jmeta, ttypes.DatasetMeta(20, 60, 5, L)


def _histories():
    rng = np.random.RandomState(21)
    base = 1_700_000_000.0
    lengths = [0, 1, 3, L - 1, 2 * L, 5]   # empty, and longer than L-1
    hists = [[(int(rng.randint(1, 61)), int(rng.randint(1, 6)),
               base + 3600.0 * 7 * i + rng.randint(0, 3000))
              for i in range(n)] for n in lengths]
    return hists, [base + 3600.0 * 400] * len(hists)


def test_batch_from_histories_matches_jax():
    cfg, jcfg, params, jmeta, tmeta = _setup()
    jrec = jserve.Recommender(jcfg, jmeta, params)
    trec = tserve.Recommender(cfg, tmeta, params, device="cpu")
    hists, req = _histories()
    jb = jrec.batch_from_histories(hists, req, user_ids=[3] * len(hists))
    tb = trec.batch_from_histories(hists, req, user_ids=[3] * len(hists))
    for field in jb._fields:
        np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                      np.asarray(getattr(jb, field)),
                                      err_msg=field)
    assert tb.seq_len[0] == 1 and tb.seq_len[4] == L


def test_recommend_matches_jax_top10_f32():
    cfg, jcfg, params, jmeta, tmeta = _setup()
    hists, req = _histories()
    want = jserve.Recommender(jcfg, jmeta, params).recommend(hists, req, k=10)
    got = tserve.Recommender(cfg, tmeta, params, device="cpu").recommend(
        hists, req, k=10)
    assert [[i for i, _ in row] for row in got] == \
        [[i for i, _ in row] for row in want]
    np.testing.assert_allclose([[s for _, s in row] for row in got],
                               [[s for _, s in row] for row in want],
                               atol=1e-4, rtol=0)
    # the empty history still gets 10 finite recommendations
    assert len(got[0]) == 10 and all(np.isfinite(s) for _, s in got[0])


def test_recommender_runs_on_cuda_by_default(monkeypatch):
    cfg, _, params, _, tmeta = _setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Recommender(cfg, tmeta, params)
    assert tserve.Recommender(cfg, tmeta, params,
                              device="cpu").device.type == "cpu"


def test_bridge_is_strict():
    cfg, _, params, _, tmeta = _setup()
    model = get_model("MTAM").init(torch.Generator().manual_seed(0),
                                   cfg.model, tmeta)
    names = set(params_from_jax(params))
    assert names == set(dict(model.named_parameters()))
    assert {"embedding.item_table", "rnn.w_gate_h", "rnn.time_history_w1",
            "att.0.q.w", "att.1.time_output_w2", "att.1.ln.gamma",
            "ln_out.beta"} <= names
    assert tuple(model.att[0].time_input_w1.shape) == (1, L)

    missing = jax.tree.map(lambda x: x, params)
    del missing["rnn"]["time_w12"]
    with pytest.raises(KeyError, match="rnn.time_w12"):
        load_jax_params(model, missing)
    extra = jax.tree.map(lambda x: x, params)
    extra["rnn"]["time_w99"] = np.zeros(16, np.float32)
    with pytest.raises(KeyError, match="time_w99"):
        load_jax_params(model, extra)
    wrong = jax.tree.map(lambda x: x, params)
    wrong["att"][1]["q"]["w"] = np.zeros((16, 8), np.float32)
    with pytest.raises(ValueError, match="att.1.q.w"):
        load_jax_params(model, wrong)
    before = model.rnn.w_gate_h.detach().clone()
    bad_leaf = jax.tree.map(lambda x: x, params)
    bad_leaf["ln_out"]["gamma"] = "ones"
    with pytest.raises(TypeError):
        load_jax_params(model, bad_leaf)
    assert torch.equal(model.rnn.w_gate_h, before)   # nothing half-loaded


def test_registry_and_config():
    with pytest.raises(KeyError, match="known"):
        get_model("NARM+++")
    for name in jconfig.preset_names():
        assert tconfig.get_preset(name).to_dict() == \
            jconfig.get_preset(name).to_dict()
    assert tconfig.__file__ != jconfig.__file__


_IMPORT_RE = re.compile(
    r"^\s*(?:from|import)\s+(jax\b|mtamrecommender_tpu(?!_torch)\b)"
    r"|import_module\(\s*['\"](jax|mtamrecommender_tpu(?!_torch))\b",
    re.MULTILINE)


def test_port_never_imports_jax_or_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in sources if _IMPORT_RE.search(p.read_text())]
    assert offenders == []
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mtamrecommender_tpu'] = None\n"
        "import mtamrecommender_tpu_torch as port\n"
        "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('imported', len([k for k in sys.modules\n"
        "      if k.startswith('mtamrecommender_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    # alone in a directory, without the port, it fails too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
