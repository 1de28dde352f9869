"""The port's `Trainer` against the JAX package's, step for step.

A tiny MTAM (d=16, 2 hops, L=12) on a synthetic_timed log of 120 users,
built by each package's own data path, trains for two epochs in both
packages from the same initial parameters: JAX's `Trainer.init_state`,
carried across with `bridge.load_jax_params` into the port's
`Trainer.init_state`.  Both draw each epoch's order from
``RandomState(cfg.train.seed)``, so they visit the same rows.

Tolerances: each step's loss within 1e-4 relative of JAX's (f32 Adam
drifts by a few ulps a step; ROADMAP.md Queue 3 item 2); each
evaluation's hr@k and ndcg@k within 2 / n_test of JAX's, which allows two
test rows' ranks to flip on near-ties.  Within the port: steps_per_call
1 and 4 and the host path give ``torch.equal`` parameters; a mid-epoch
checkpoint resumed in a fresh trainer equals the unbroken run bit for
bit, for MTAM and for SASrec at dropout 0.5 (the cursor carries the step
generator's state); the paired best rule, the zero-step resume and the
divergence error behave as JAX's `tests/test_train.py` pins them.
"""

import json

import jax
import pytest
import torch

from mtamrecommender_tpu.config import ExperimentConfig as JExperimentConfig
from mtamrecommender_tpu.data import ingest as jingest
from mtamrecommender_tpu.data import pipeline as jpipeline
from mtamrecommender_tpu.data import prepare as jprepare
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.train import trainer as jtrainer
from mtamrecommender_tpu_torch.bridge import load_jax_params
from mtamrecommender_tpu_torch.config import ExperimentConfig
from mtamrecommender_tpu_torch.data import ingest, pipeline, prepare
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer
from mtamrecommender_tpu_torch.train.trainer import (Trainer, TrainState,
                                                     moments)

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
OVER = {"data.dataset": "synthetic_timed", "data.synth_users": 120,
        "data.synth_items": 60, "data.synth_categories": 6,
        "data.synth_events_per_user": 12, "data.max_seq_len": 12,
        "model.num_units": 16, "model.num_blocks": 2, "model.dropout": 0.0,
        "train.train_batch_size": 32, "train.test_batch_size": 64,
        "train.eval_freq": 25, "train.display_freq": 1}


def _cfg(cls=ExperimentConfig, **kw):
    return cls().with_overrides(**{**OVER, **kw})


@pytest.fixture(scope="module")
def data():
    cfg = _cfg()
    p = prepare.prepare_examples(ingest.load_origin_data(cfg.data), cfg.data)
    return (pipeline.pack_examples(p.train_set, p.meta),
            pipeline.pack_examples(p.test_set, p.meta))


def _events(run_dir):
    with open(f"{run_dir}/events.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = {r["step"]: r["train_loss"] for r in recs if "train_loss" in r}
    evals = [r for r in recs if "hr@10" in r]
    return losses, evals


def _trainer(cfg, name, train, test, run_dir, **kw):
    return Trainer(cfg=cfg, model=get_model(name), train_data=train,
                   test_data=test, run_dir=str(run_dir), device="cpu", **kw)


def test_fit_trajectory_against_jax(data, tmp_path):
    jcfg = _cfg(JExperimentConfig)
    jp = jprepare.prepare_examples(jingest.load_origin_data(jcfg.data),
                                   jcfg.data)
    jtrain = jpipeline.pack_examples(jp.train_set, jp.meta)
    jtest = jpipeline.pack_examples(jp.test_set, jp.meta)
    jt = jtrainer.Trainer(cfg=jcfg, model=jget_model("MTAM"),
                          train_data=jtrain, test_data=jtest,
                          run_dir=str(tmp_path / "jax"))
    jstate = jt.init_state()
    params = jax.device_get(jstate.params)
    jt.fit(jstate, max_epochs=2)

    train, test = data
    cfg = _cfg()
    t = _trainer(cfg, "MTAM", train, test, tmp_path / "port")
    skeleton = get_model("MTAM").init(torch.Generator().manual_seed(1),
                                      cfg.model, train.meta)
    state = t.init_state(TrainState(load_jax_params(skeleton, params), None))
    state = t.fit(state, max_epochs=2)

    jlosses, jevals = _events(tmp_path / "jax")
    losses, evals = _events(tmp_path / "port")
    n_steps = -(-len(train) // 32)
    assert state.step == 2 * n_steps and sorted(losses) == sorted(jlosses)
    assert len(losses) == 2 * n_steps
    for step, loss in losses.items():
        assert abs(loss - jlosses[step]) <= LOSS_RTOL * abs(jlosses[step]), \
            (step, loss, jlosses[step])
    # the initial eval, one every 25 steps, the last one
    assert [e["step"] for e in evals] == [e["step"] for e in jevals]
    assert len(evals) == 2 + 2 * n_steps // 25
    for e, je in zip(evals, jevals):
        for key in je:
            if "@" in key:
                assert abs(e[key] - je[key]) <= 2 / len(test), (e["step"],
                                                                key)
    assert set(t.best) == set(jt.best)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _assert_same(a, b):
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_steps_per_call_and_host_path_equal(data, tmp_path):
    train, test = data
    runs = []
    for k, (spc, resident) in enumerate(((1, True), (4, True), (1, False))):
        cfg = _cfg(**{"train.steps_per_call": spc, "train.eval_freq": 5})
        t = _trainer(cfg, "MTAM", train, test, tmp_path / f"r{k}",
                     device_resident=resident)
        state = t.fit(max_epochs=1, max_steps=9)
        assert state.step == 9
        runs.append((_params(state.model), _events(tmp_path / f"r{k}")[0]))
    for p, losses in runs[1:]:
        _assert_same(runs[0][0], p)
        assert losses == runs[0][1]


@pytest.mark.parametrize("name,over", [
    ("MTAM", {}),
    ("SASrec", {"model.dropout": 0.5, "train.steps_per_call": 4})])
def test_mid_epoch_resume_exact(data, tmp_path, name, over):
    train, test = data
    cfg = _cfg(**{**over, "train.eval_freq": 10_000})
    n_steps = -(-len(train) // 32)
    full = _trainer(cfg, name, train, test, tmp_path / "full").fit(
        max_epochs=2)

    t_a = _trainer(cfg, name, train, test, tmp_path / "a")
    ck = Checkpointer(str(tmp_path / "ck"))
    mid = t_a.fit(max_epochs=2, max_steps=n_steps + 3, checkpointer=ck)
    assert mid.step == n_steps + 3 and ck.latest_step() == n_steps + 3

    t_b = _trainer(cfg, name, train, test, tmp_path / "b")
    restored, cursor = ck.restore(t_b.init_state(), with_cursor=True)
    assert len(cursor["gen_state"]) > 0
    start_epoch, skip = t_b.resume_from_cursor(cursor, restored)
    assert (start_epoch, skip) == (1, 3)
    resumed = t_b.fit(restored, max_epochs=2, start_epoch=start_epoch,
                      skip_steps=skip)
    assert resumed.step == full.step == 2 * n_steps
    _assert_same(_params(full.model), _params(resumed.model))
    for key, m in moments(full.opt_state).items():
        _assert_same(m, moments(resumed.opt_state)[key])
    if name == "SASrec":
        # the generator's state carried the draws: without it the resumed
        # run draws other masks
        t_c = _trainer(cfg, name, train, test, tmp_path / "c")
        again, cursor = ck.restore(t_c.init_state(), with_cursor=True)
        del cursor["gen_state"]
        e, s = t_c.resume_from_cursor(cursor, again)
        other = t_c.fit(again, max_epochs=2, start_epoch=e, skip_steps=s)
        got, want = _params(other.model), _params(full.model)
        assert any(not torch.equal(got[n], want[n]) for n in want)


def test_fit_noop_when_resumed_past_max_steps(data, tmp_path):
    train, test = data
    t = _trainer(_cfg(), "MTAM", train, test, tmp_path / "run")
    state = t.fit(max_epochs=1, max_steps=4)
    assert state.step == 4
    before = _params(state.model)
    ck = Checkpointer(str(tmp_path / "ck"))
    state = t.fit(state, max_epochs=1, max_steps=4, checkpointer=ck)
    assert state.step == 4 and ck.latest_step() == 4
    _assert_same(before, _params(state.model))


def test_divergence_surfaces(data, tmp_path):
    train, test = data
    cfg = _cfg(**{"train.learning_rate": 1e25,
                  "train.max_gradient_norm": 1e12})
    t = _trainer(cfg, "Gru4Rec", train, test, tmp_path / "run")
    with pytest.raises(FloatingPointError, match="non-finite train loss"):
        t.fit(max_epochs=3, max_steps=60)


def test_best_so_far_and_cursor(data, tmp_path):
    train, test = data
    cfg = _cfg()
    t_a = _trainer(cfg, "Gru4Rec", train, test, tmp_path / "a")
    t_a.best = {"hr@10": 0.61, "ndcg@10": 0.44}
    cur = t_a._capture_cursor(epoch=1, epoch_start_step=5)
    assert cur["best"] == {"hr@10": 0.61, "ndcg@10": 0.44}

    # a fresh trainer restores the dict verbatim
    t_b = _trainer(cfg, "Gru4Rec", train, test, tmp_path / "b")
    t_b.resume_from_cursor(cur, t_b.init_state())
    assert t_b.best == {"hr@10": 0.61, "ndcg@10": 0.44}
    # merging uses the paired rule: hr and ndcg at k must both improve
    t_b.best = {"hr@10": 0.10, "ndcg@10": 0.50}
    t_b.resume_from_cursor(cur, t_b.init_state())
    assert t_b.best == {"hr@10": 0.10, "ndcg@10": 0.50}
    t_b.best = {"hr@10": 0.10, "ndcg@10": 0.20}
    t_b.resume_from_cursor(cur, t_b.init_state())
    assert t_b.best == {"hr@10": 0.61, "ndcg@10": 0.44}
    del cur["best"]
    t_c = _trainer(cfg, "Gru4Rec", train, test, tmp_path / "c")
    t_c.resume_from_cursor(cur, t_c.init_state())
    assert t_c.best == {}

    # _cursor_for_save refreshes best and adds the generator's state; the
    # epoch-start fields stay as captured
    t_a.best = {"hr@10": 0.2}
    t_a._cursor = t_a._capture_cursor(epoch=3, epoch_start_step=42)
    t_a.best["hr@10"] = 0.9
    torch.rand(3, generator=t_a.gen)
    saved = t_a._cursor_for_save()
    assert saved["best"] == {"hr@10": 0.9} and t_a._cursor["best"] == {
        "hr@10": 0.2}
    assert saved["epoch"] == 3 and saved["step_at_epoch_start"] == 42
    assert saved["gen_state"] == t_a.gen.get_state().tolist()
    json.dumps(saved)
    t_a._cursor = None
    assert t_a._cursor_for_save() is None

    # evaluate's paired rule: an eval that improves only hr keeps best
    t_d = _trainer(cfg, "Gru4Rec", train, test, tmp_path / "d")
    state = t_d.init_state()
    m = t_d.evaluate(state)
    t_d.best = {f"hr@{k}": 2.0 for k in cfg.train.topk}
    t_d.best.update({f"ndcg@{k}": 0.0 for k in cfg.train.topk})
    t_d.evaluate(state)
    assert t_d.best["ndcg@10"] == 0.0 and m["hr@10"] <= 1.0
