"""The port's ingestion (`data/ingest.py`, `data/masking.py`) against the
JAX package's, row for row.

Each loader runs in both packages on the same config: every column of
the port's `EventLog` equals the JAX package's DataFrame column, value
for value and in order (the same rows in the same order, not only the
same multiset).  ml-1m runs from the repo's fixture (64 ratings, one
same-second pair), copied under ``tmp_path``, and from a fixture written
here with numpy: one user with 400 ratings in 60 distinct seconds (many
ties), full-row duplicates, and a rating of a movie the movies file
lacks.  The CSV caches the two packages write are byte-equal and each
loads in the other.
"""

import os
import random
import shutil

import numpy as np
import pytest
import torch

from mtamrecommender_tpu.config import DataConfig as JDataConfig
from mtamrecommender_tpu.data import ingest as jingest
from mtamrecommender_tpu.data import masking as jmasking
from mtamrecommender_tpu_torch.config import DataConfig
from mtamrecommender_tpu_torch.data import ingest, masking

from torch_data_fixtures import write_tie_fixture

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CSV_DATASETS = ("yoochoose", "tmall", "taobaoapp", "music", "beauty", "elec")


def assert_rows_equal(df, log):
    assert len(log) == len(df)
    for col in ingest.COLUMNS:
        want = df[col].tolist()
        got = log[col].tolist()
        assert got == want, col
        assert log[col].dtype.kind == np.asarray(df[col]).dtype.kind, col


def test_masking_matches_jax():
    rng = np.random.RandomState(0)
    stamps = np.cumsum(rng.randint(0, 40 * 86400, 30)).tolist()
    mask = masking.mask_index_list_behavior(30)
    assert mask == jmasking.mask_index_list_behavior(30)
    assert masking.mask_index_list_behavior(30, True) == [29]
    for causality in ("unidirection", "random", "time_window"):
        a, b = random.Random(3), random.Random(3)
        for index in mask:
            assert masking.select_window(
                causality, index, stamps, mask, length_limit=12,
                py_random=a) == jmasking.select_window(
                causality, index, stamps, mask, length_limit=12,
                py_random=b)
    hours = [s // 3600 for s in stamps]
    assert masking.time_features(hours, hours[-1] + 5) == \
        jmasking.time_features(hours, hours[-1] + 5)
    for n in (2, 9, 15):
        np.testing.assert_array_equal(masking.gap_list(n),
                                      jmasking.gap_list(n))
    gap = masking.gap_list(9)
    assert masking.time_bucket_features(stamps, stamps[-1], gap) == \
        jmasking.time_bucket_features(stamps, stamps[-1], gap)
    assert masking.mask_index_list_bert(
        30, 0.2, np.random.RandomState(5)) == jmasking.mask_index_list_bert(
        30, 0.2, np.random.RandomState(5))
    items = rng.randint(0, 40, 30).tolist()
    assert masking.negative_items(items, mask[:5], 40, 6,
                                  np.random.RandomState(1)) == \
        jmasking.negative_items(items, mask[:5], 40, 6,
                                np.random.RandomState(1))
    with pytest.raises(ValueError, match="unknown causality"):
        masking.select_window("nope", 1, stamps, mask)


@pytest.mark.parametrize("name", ["synthetic", "synthetic_sessions",
                                  "synthetic_timed"])
def test_synthetic_loaders_row_for_row(name):
    kw = dict(dataset=name, synth_users=40, synth_items=50,
              synth_categories=5, synth_events_per_user=12, seed=7)
    assert_rows_equal(jingest.load_origin_data(JDataConfig(**kw)),
                      ingest.load_origin_data(DataConfig(**kw)))


def test_synthetic_timed_one_category():
    """No derangement exists for one category: both hop to itself."""
    kw = dict(dataset="synthetic_timed", synth_users=10, synth_items=20,
              synth_categories=1, synth_events_per_user=8)
    assert_rows_equal(jingest.load_origin_data(JDataConfig(**kw)),
                      ingest.load_origin_data(DataConfig(**kw)))


@pytest.mark.parametrize("name", CSV_DATASETS)
def test_csv_loaders_row_for_row(name, tmp_path):
    shutil.copytree(os.path.join(FIXTURES, "orgin_data"),
                    str(tmp_path / "orgin_data"))
    kw = dict(dataset=name, data_root=str(tmp_path))
    jdf = jingest.load_origin_data(JDataConfig(**kw))
    log = ingest.load_origin_data(DataConfig(**kw))
    assert_rows_equal(jdf, log)
    assert ingest.data_statistics(log) == jingest.data_statistics(jdf)


def test_csv_loader_errors_match(tmp_path):
    kw = dict(dataset="tmall", data_root=str(tmp_path))
    with pytest.raises(FileNotFoundError) as jerr:
        jingest.load_origin_data(JDataConfig(**kw))
    with pytest.raises(FileNotFoundError) as err:
        ingest.load_origin_data(DataConfig(**kw))
    assert str(err.value) == str(jerr.value)
    (tmp_path / "orgin_data").mkdir()
    (tmp_path / "orgin_data" / "tmall.csv").write_text(
        "user_id,item_id,time_stamp\n1,2,3\n")
    with pytest.raises(ValueError) as jerr:
        jingest.load_origin_data(JDataConfig(**kw))
    with pytest.raises(ValueError) as err:
        ingest.load_origin_data(DataConfig(**kw))
    assert str(err.value) == str(jerr.value)
    with pytest.raises(KeyError) as jerr:
        jingest.load_origin_data(JDataConfig(dataset="nope"))
    with pytest.raises(KeyError) as err:
        ingest.load_origin_data(DataConfig(dataset="nope"))
    assert str(err.value) == str(jerr.value)


def _copy_ml1m(root, src):
    (root / "raw_data").mkdir(parents=True)
    shutil.copytree(src, str(root / "raw_data" / "ml-1m"))
    return str(root)


@pytest.mark.parametrize("fixture", ["repo", "ties"])
def test_ml1m_row_for_row(fixture, tmp_path):
    src = os.path.join(FIXTURES, "ml-1m")
    if fixture == "ties":
        src = str(tmp_path / "src")
        write_tie_fixture(src)
    for frac, mins in ((1.0, (5, 5)), (0.8, (1, 1)), (0.5, (5, 3))):
        tag = f"{frac}_{mins[0]}_{mins[1]}"
        kw = dict(dataset="ml_1m", user_sample_frac=frac,
                  min_user_actions=mins[0], min_item_actions=mins[1])
        jroot = _copy_ml1m(tmp_path / f"j{tag}", src)
        root = _copy_ml1m(tmp_path / f"t{tag}", src)
        jdf = jingest.load_origin_data(JDataConfig(data_root=jroot, **kw))
        log = ingest.load_origin_data(DataConfig(data_root=root, **kw))
        assert_rows_equal(jdf, log)
        # the caches are byte-equal, and each package reads the other's
        cache = os.path.join("orgin_data", "movielens.csv")
        with open(os.path.join(jroot, cache), "rb") as a, \
                open(os.path.join(root, cache), "rb") as b:
            assert a.read() == b.read()
        assert_rows_equal(jingest.load_origin_data(
            JDataConfig(data_root=root, **kw)), ingest.load_origin_data(
            DataConfig(data_root=jroot, **kw)))


def test_min_activity_filter_and_statistics():
    rng = np.random.RandomState(2)
    import pandas as pd
    cols = {"user_id": rng.randint(0, 30, 500).astype(np.int64),
            "item_id": rng.randint(0, 80, 500).astype(np.int64),
            "time_stamp": rng.randint(0, 10 ** 6, 500).astype(np.int64),
            "cat_id": rng.randint(0, 6, 500).astype(np.int64)}
    jdf = jingest.min_activity_filter(pd.DataFrame(cols), 12, 7)
    log = ingest.min_activity_filter(ingest.EventLog(**cols), 12, 7)
    assert_rows_equal(jdf, log)
    assert 0 < len(log) < 500
    assert ingest.data_statistics(log) == jingest.data_statistics(jdf)


def test_csv_reader_infers_pandas_types(tmp_path):
    import pandas as pd
    path = tmp_path / "mixed.csv"
    path.write_text('a,b,c,d\n1,1.5,x,"q,r"\n-2,,y,s\n3,4,,t\n')
    got = ingest.read_csv(str(path))
    want = pd.read_csv(str(path))
    assert got["a"].dtype == np.int64 and got["a"].tolist() == [1, -2, 3]
    np.testing.assert_array_equal(got["b"], want["b"].to_numpy())
    assert got["c"][:2].tolist() == ["x", "y"] and np.isnan(got["c"][2])
    assert got["d"].tolist() == want["d"].tolist()
