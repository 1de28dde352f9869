"""The port's full-catalog evaluation (`train.evaluate`) against the JAX
package's `train/evaluate.py`.

The JAX package's metric goldens and tie-break cases, then the ranks and
metrics on seeded integer-valued scores (many ties) with holes in
``valid``, AUC given JAX's own negatives, and a whole evaluation: the
same converted parameters on a synthetic_timed test set built with JAX's
``prepare_examples`` / ``pack_examples`` (its last batch padded), every
metric within 1e-6 of JAX's ``evaluate_dataset`` in f32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.config import DataConfig
from mtamrecommender_tpu.config import ExperimentConfig as JExperimentConfig
from mtamrecommender_tpu.data.ingest import load_synthetic_timed
from mtamrecommender_tpu.data.pipeline import batch_iterator, pack_examples
from mtamrecommender_tpu.data.prepare import prepare_examples
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.train import evaluate as jeval
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params
from mtamrecommender_tpu_torch.config import ExperimentConfig
from mtamrecommender_tpu_torch.data import device_data as tdd
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train import evaluate as teval

torch.set_num_threads(2)

D, L, HOPS = 16, 12, 2
EVAL_ATOL = 1e-6
TEST_BATCH = 16          # 60 test rows: 3 full batches and 12 live rows


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


# ------------------------------------------------------------ goldens

def test_hr_ndcg_goldens():
    # catalog of 6, 3 rows with known ranks
    scores = torch.tensor([
        [9.0, 1.0, 2.0, 3.0, 4.0, 5.0],   # target 0 -> rank 0
        [9.0, 1.0, 2.0, 3.0, 4.0, 5.0],   # target 3 -> rank 3
        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],   # target 2, all tied -> rank 2
    ])
    targets = torch.tensor([0, 3, 2], dtype=torch.int32)
    valid = torch.ones(3)
    m = teval.topk_metrics(scores, targets, valid, ks=(1, 5))
    assert float(m["hr@1"]) == pytest.approx(1 / 3)
    assert float(m["hr@5"]) == pytest.approx(1.0)
    want_ndcg5 = (math.log(2) / math.log(2)
                  + math.log(2) / math.log(5)
                  + math.log(2) / math.log(4)) / 3
    assert float(m["ndcg@5"]) == pytest.approx(want_ndcg5, rel=1e-5)
    # invalid rows drop out of the mean
    m2 = teval.topk_metrics(scores, targets, torch.tensor([1.0, 1.0, 0.0]),
                            ks=(1,))
    assert float(m2["hr@1"]) == pytest.approx(0.5)
    # no valid row: every metric 0, not NaN
    m3 = teval.topk_metrics(scores, targets, torch.zeros(3), ks=(1,))
    assert float(m3["hr@1"]) == 0.0 and float(m3["ndcg@1"]) == 0.0


def test_rank_tie_break_matches_topk_order():
    scores = torch.tensor([[2.0, 5.0, 5.0, 1.0]])
    # tf.nn.top_k breaks ties by lower index: order = [1, 2, 0, 3]
    assert int(teval.ranks_from_scores(scores, torch.tensor([2]))[0]) == 1
    assert int(teval.ranks_from_scores(scores, torch.tensor([1]))[0]) == 0
    # the same order as torch.topk's (and tf.nn.top_k's) on these rows
    order = torch.topk(scores, 4, dim=1).indices[0].tolist()
    for pos, item in enumerate(order):
        assert int(teval.ranks_from_scores(scores,
                                           torch.tensor([item]))[0]) == pos
    assert teval.TOPK == jeval.TOPK


# ------------------------------------------------------------ against JAX

def _tied_scores(seed, b=64, v=53):
    """Integer-valued scores in [0, 8): about v/8 ties a value; targets
    anywhere in the catalog; about a third of the rows invalid."""
    r = np.random.RandomState(seed)
    scores = r.randint(0, 8, (b, v)).astype(np.float32)
    targets = r.randint(0, v, b).astype(np.int32)
    valid = (r.rand(b) > 0.33).astype(np.float32)
    return scores, targets, valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ranks_and_metrics_match_jax_with_ties(seed):
    scores, targets, valid = _tied_scores(seed)
    want_rank = np.asarray(jeval.ranks_from_scores(jnp.asarray(scores),
                                                   jnp.asarray(targets)))
    got_rank = teval.ranks_from_scores(_t(scores), _t(targets))
    np.testing.assert_array_equal(got_rank.numpy(), want_rank)
    ks = (1, 5, 10, 30, 50)
    want = jeval.topk_metrics(jnp.asarray(scores), jnp.asarray(targets),
                              jnp.asarray(valid), ks)
    got = teval.topk_metrics(_t(scores), _t(targets), _t(valid), ks)
    assert set(got) == set(want) == {f"{m}@{k}" for m in ("hr", "ndcg")
                                     for k in ks}
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   atol=EVAL_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("num_negatives", [1, 7])
def test_auc_matches_jax_given_its_negatives(num_negatives):
    scores, targets, valid = _tied_scores(11)
    rng = jax.random.PRNGKey(num_negatives)
    want = float(jeval.auc(jnp.asarray(scores), jnp.asarray(targets),
                           jnp.asarray(valid), rng, num_negatives))
    # JAX's draw, as its auc makes it
    neg = np.asarray(jax.random.randint(rng, (scores.shape[0], num_negatives),
                                        0, scores.shape[1]))
    got = teval.auc(_t(scores), _t(targets), _t(valid), negatives=_t(neg))
    np.testing.assert_allclose(got.item(), want, atol=EVAL_ATOL, rtol=0)


def test_auc_draws_only_from_the_generator_given():
    scores, targets, valid = _tied_scores(12)
    with pytest.raises(ValueError, match="Generator"):
        teval.auc(_t(scores), _t(targets), _t(valid))
    torch.manual_seed(0)
    a = teval.auc(_t(scores), _t(targets), _t(valid),
                  gen=torch.Generator().manual_seed(5), num_negatives=4)
    torch.manual_seed(99)                    # the global generator: unused
    b = teval.auc(_t(scores), _t(targets), _t(valid),
                  gen=torch.Generator().manual_seed(5), num_negatives=4)
    assert torch.equal(a, b) and 0.0 <= a.item() <= 1.0


# ------------------------------------------------------------ a whole eval

@pytest.fixture(scope="module")
def timed_test_set():
    cfg = DataConfig(dataset="synthetic_timed", synth_users=60,
                     synth_items=40, synth_categories=5,
                     synth_events_per_user=12, max_seq_len=L,
                     user_count_limit=10_000)
    prepared = prepare_examples(load_synthetic_timed(cfg), cfg)
    return pack_examples(prepared.test_set, prepared.meta)


def _cfgs():
    cfg = ExperimentConfig().with_overrides(**{
        "model.num_units": D, "model.num_blocks": HOPS,
        "model.dropout": 0.0, "data.max_seq_len": L,
        "model.vocab_pad_multiple": 16, "model.use_pallas": True})
    jcfg = JExperimentConfig().with_overrides(**{
        f"model.{k}": v for k, v in cfg.model.__dict__.items()})
    return cfg, jcfg.with_overrides(**{"data.max_seq_len": L})


def _arrays(ds):
    return {f: getattr(ds, f) for f in tdd.DeviceDataset._fields}


def test_eval_batches_are_jax_batch_iterator_batches(timed_test_set):
    ds = timed_test_set
    assert len(ds) % TEST_BATCH != 0
    want = list(batch_iterator(ds, TEST_BATCH))
    got = list(teval.eval_batches(tdd.to_device(_arrays(ds), device="cpu"),
                                  TEST_BATCH))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2, 3]
    for (_, tb), (_, jb) in zip(got, want):
        for field in jb._fields:
            np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                          np.asarray(getattr(jb, field)),
                                          err_msg=field)
    assert int(got[-1][1].valid.sum()) == len(ds) - 3 * TEST_BATCH


@pytest.mark.parametrize("use_pallas", [False, True])
def test_evaluate_dataset_matches_jax_f32(timed_test_set, use_pallas):
    ds = timed_test_set
    cfg, jcfg = _cfgs()
    cfg = cfg.with_overrides(**{"model.use_pallas": use_pallas})
    jcfg = jcfg.with_overrides(**{"model.use_pallas": use_pallas})
    meta = ds.meta
    tmeta = ttypes.DatasetMeta(*meta)
    params = jax.device_get(jget_model("MTAM").init(jax.random.PRNGKey(3),
                                                    jcfg.model, meta))
    jstep = jeval.make_eval_step(jget_model("MTAM"), jcfg.model,
                                 valid_vocab=meta.item_vocab)
    want = jeval.evaluate_dataset(jstep, params,
                                  batch_iterator(ds, TEST_BATCH))
    model = load_jax_params(get_model("MTAM").init(
        torch.Generator().manual_seed(0), cfg.model, tmeta), params)
    tstep = teval.make_eval_step(get_model("MTAM"), cfg.model,
                                 valid_vocab=tmeta.item_vocab)
    got = teval.evaluate_dataset(
        tstep, model, teval.eval_batches(tdd.to_device(_arrays(ds),
                                                       device="cpu"),
                                         TEST_BATCH))
    assert set(got) == set(want) and len(got) == 2 * len(teval.TOPK)
    for key, value in want.items():
        assert isinstance(got[key], float)
        assert abs(got[key] - value) <= EVAL_ATOL, (key, got[key], value)
    assert 0.0 < got["hr@50"] <= 1.0
    # one batch's metrics alone, straight from the step
    jb = next(batch_iterator(ds, TEST_BATCH))[1]
    tb = next(teval.eval_batches(tdd.to_device(_arrays(ds), device="cpu"),
                                 TEST_BATCH))[1]
    one_want = jstep(params, jb)
    one_got = tstep(tstep.cast(model), tb)
    for key in one_want:
        assert abs(one_got[key].item() - float(one_want[key])) <= EVAL_ATOL


def test_eval_step_casts_once_and_computes_without_grad():
    cfg, _ = _cfgs()
    cfg = cfg.with_overrides(**{"model.compute_dtype": "bfloat16"})
    tmeta = ttypes.DatasetMeta(20, 60, 5, L)
    model = get_model("MTAM").init(torch.Generator().manual_seed(0),
                                   cfg.model, tmeta)
    step = teval.make_eval_step(get_model("MTAM"), cfg.model,
                                ks=(1, 10), valid_vocab=tmeta.item_vocab)
    cast = step.cast(model)
    assert cast is not model
    assert all(p.dtype == torch.bfloat16 for p in cast.parameters())
    assert step.cast(cast) is cast                 # already cast: no copy
    r = np.random.RandomState(0)
    n = 20
    seq_len = r.randint(2, L + 1, n).astype(np.int32)
    items = np.where(np.arange(L)[None] < seq_len[:, None],
                     r.randint(1, 61, (n, L)), 0).astype(np.int32)
    arrays = dict(user_id=r.randint(1, 21, n), items=items,
                  cats=(items > 0).astype(np.int32),
                  times=np.cumsum(r.rand(n, L), 1).astype(np.float32),
                  time_last=np.zeros((n, L), np.float32),
                  time_now=np.zeros((n, L), np.float32),
                  positions=np.tile(np.arange(L), (n, 1)),
                  target_id=r.randint(1, 61, n),
                  target_cat=np.ones(n, np.int32),
                  target_time=np.full(n, 20.0, np.float32), seq_len=seq_len)
    data = tdd.to_device(arrays, device="cpu")
    got = teval.evaluate_dataset(step, model, teval.eval_batches(data, 8))
    assert set(got) == {"hr@1", "hr@10", "ndcg@1", "ndcg@10"}
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in got.values())
    assert teval.evaluate_dataset(step, model, iter(())) == {}
    metrics = step(cast, next(teval.eval_batches(data, 8))[1])
    assert all(not v.requires_grad for v in metrics.values())
