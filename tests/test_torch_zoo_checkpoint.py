"""MTAM_hybird (the concat head), T_SeqRec (the T-SeqRec cell), bpr
(BPRMF's bpr output mode) and NARM (the plain readout and the concat
head) from disk: a `Checkpointer` round trip, `evaluate_dataset` of the
restored model against JAX's evaluation of the same parameters (within
1e-6), and, after two CPU training steps and a save, `Recommender.
from_checkpoint` and `serve.main` giving the in-memory model's ids."""

import io
import json
import sys

import numpy as np
import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.train import evaluate as jeval
from mtamrecommender_tpu_torch import serve as tserve
from mtamrecommender_tpu_torch.data import device_data as tdd
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.serve import Recommender
from mtamrecommender_tpu_torch.train import checkpoint as tckpt
from mtamrecommender_tpu_torch.train import evaluate as teval
from mtamrecommender_tpu_torch.train import trainer as ttrainer
from mtamrecommender_tpu_torch.train.trainer import TrainState

from helpers import make_batch

torch.set_num_threads(2)

MODELS = ("MTAM_hybird", "T_SeqRec", "bpr", "NARM")
EVAL_ATOL = 1e-6


def _skeleton(name, c):
    _, tmeta = zp.meta()
    return get_model(name).init(torch.Generator().manual_seed(7), c.model,
                                tmeta)


def _histories():
    rng = np.random.RandomState(21)
    base = 1_700_000_000.0
    hists = [[(int(rng.randint(1, 61)), int(rng.randint(1, 6)),
               base + 3600.0 * 4 * j) for j in range(n)]
             for n in (0, 1, 5, zp.L - 1, 2 * zp.L)]
    return hists, [base + 3600.0 * 200] * len(hists)


@pytest.mark.parametrize("name", MODELS)
def test_round_trip_evaluates_like_jax(name, tmp_path):
    c = zp.cfg(name)
    params, model = zp.models(name, c)
    jmeta, tmeta = zp.meta()
    jb, tb = zp.batches()
    want = jeval.make_eval_step(jget_model(name), c.model,
                                valid_vocab=jmeta.item_vocab)(params, jb)
    opt = ttrainer.make_optimizer(c.train)
    tckpt.Checkpointer(str(tmp_path)).save(
        TrainState(model, opt.init(model), step=0))
    ck = tckpt.Checkpointer(str(tmp_path))
    restored = ck.restore(TrainState(_skeleton(name, c),
                                     opt.init(_skeleton(name, c))))
    ck.close()
    for (n, p), (_, q) in zip(model.named_parameters(),
                              restored.model.named_parameters()):
        assert torch.equal(p, q), n
    step = teval.make_eval_step(get_model(name), c.model,
                                valid_vocab=tmeta.item_vocab)
    got = teval.evaluate_dataset(step, restored.model, [(0, tb)])
    assert set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key] - float(value)) <= EVAL_ATOL, key


def _trained(name, c, steps=2):
    _, tmeta = zp.meta()
    jmeta, _ = zp.meta()
    big = make_batch(jmeta, batch_size=steps * zp.B, seed=2)
    arrays = {f: np.asarray(getattr(big, f))
              for f in tdd.DeviceDataset._fields}
    data = tdd.to_device(arrays, device="cpu")
    order = torch.tensor(tdd.epoch_order(steps * zp.B, zp.B,
                                         np.random.RandomState(1))[0])
    _, model = zp.models(name, c)
    opt = ttrainer.make_optimizer(c.train)
    run = ttrainer.make_superstep(get_model(name), c, opt, tmeta.item_vocab,
                                  zp.B, device="cpu")
    state, stacked = run(model, opt.init(model), data, order, 0, steps)
    assert torch.isfinite(stacked["loss"]).all()
    return TrainState(model, state, step=steps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_from_checkpoint_serves_the_in_memory_ids(name, dtype, tmp_path):
    c = zp.cfg(name, **{"model.compute_dtype": dtype})
    _, tmeta = zp.meta()
    state = _trained(name, c)
    tckpt.Checkpointer(str(tmp_path)).save(state)
    hists, req = _histories()
    got = Recommender.from_checkpoint(c, tmeta, str(tmp_path),
                                      device="cpu").recommend(hists, req,
                                                              k=10)
    want = Recommender(c, tmeta, state.model, device="cpu").recommend(
        hists, req, k=10)
    assert [[i for i, _ in r] for r in got] == \
        [[i for i, _ in r] for r in want]
    assert all(len(r) == 10 for r in got)


def test_serve_main_serves_a_concat_model(tmp_path, monkeypatch, capsys):
    name = "MTAM_hybird"
    c = zp.cfg(name)
    _, tmeta = zp.meta()
    state = _trained(name, c)
    tckpt.Checkpointer(str(tmp_path)).save(state)
    hists, req = _histories()
    lines = "".join(json.dumps({"history": [list(e) for e in h],
                                "request_time": t, "k": 5}) + "\n"
                    for h, t in zip(hists, req))
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    capsys.readouterr()
    assert tserve.main([
        "--checkpoint", str(tmp_path), "--experiment_type", name,
        "--items", "60", "--users", "20", "--categories", "5",
        "--max_seq_len", str(zp.L), "--num_units", str(zp.D),
        "--num_blocks", str(zp.HOPS), "--set", "model.vocab_pad_multiple=16",
        "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    want = Recommender(c, tmeta, state.model, device="cpu").recommend(
        hists, req, k=5)
    assert [a["items"] for a in got] == [[i for i, _ in r] for r in want]
