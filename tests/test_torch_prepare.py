"""The port's example construction, packing, batching, native builder and
popularity baselines against the JAX package's.

  * `prepare_examples`: the train and test lists equal JAX's list for
    list (the same examples in the same order), in all three causality
    modes, with ``test_cap`` and ``user_count_limit`` biting, on a
    synthetic log and on the ml-1m tie fixture
    (`torch_data_fixtures.write_tie_fixture`), where numpy's quicksort
    leaves one user's same-second events in another order than a stable
    sort would (checked here, so the test bites);
  * the reference-format caches are byte-equal, and each package loads
    the other's;
  * `pack_examples` and `batch_iterator` (shuffled, with a padded last
    batch) give equal arrays;
  * `fastprep.build_packed` gives the arrays of the JAX package's native
    builder (built by the port into ``build/torch_native/``; the JAX
    package's own library built here without a race, `jax_native`);
  * `top_pop` gives equal metrics.
"""

import fcntl
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from mtamrecommender_tpu.config import DataConfig as JDataConfig
from mtamrecommender_tpu.data import fastprep as jfastprep
from mtamrecommender_tpu.data import ingest as jingest
from mtamrecommender_tpu.data import pipeline as jpipeline
from mtamrecommender_tpu.data import prepare as jprepare
from mtamrecommender_tpu.models import top_pop as jtop_pop
from mtamrecommender_tpu_torch.config import DataConfig
from mtamrecommender_tpu_torch.data import (device_data, fastprep, ingest,
                                            pipeline, prepare)
from mtamrecommender_tpu_torch.models import top_pop

from torch_data_fixtures import write_tie_fixture

torch.set_num_threads(2)

FIELDS = ("user_id", "items", "cats", "times", "time_last", "time_now",
          "positions", "target_id", "target_cat", "target_time", "seq_len")
SYNTH = dict(dataset="synthetic_timed", synth_users=60, synth_items=50,
             synth_categories=5, synth_events_per_user=14, max_seq_len=10)
# 41 of the 60 users are processed and 25 of their 41 test rows kept
BITING = dict(user_count_limit=40, test_cap=25)


def _synth(**kw):
    kw = {**SYNTH, **kw}
    return (jingest.load_origin_data(JDataConfig(**kw)), JDataConfig(**kw),
            ingest.load_origin_data(DataConfig(**kw)), DataConfig(**kw))


def _compile_jax_native(so: Path) -> bool:
    """native/Makefile's build of the JAX package's library into a
    temporary directory beside ``so``, then renamed into place: a loader
    never sees half a library."""
    tmp = so.parent / f".tmp.{os.getpid()}"
    try:
        subprocess.run(["make", "-C", jfastprep._NATIVE_DIR,
                        f"BUILD={os.path.relpath(tmp, jfastprep._NATIVE_DIR)}"],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp / so.name, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native builder, loaded in this process.  Each
    test process that imports it may run `make -C native` at once, and
    make writes the library in place, so a process can load half a
    file and give up on it.  Here, under an fcntl lock on a file in the
    ignored native/build/, a missing library is built by native/Makefile
    into a temporary directory and renamed into place
    (`_compile_jax_native`), the package's failed-load flag is reset in
    this process and the library loaded; a library that does not load is
    built again the same way.  Skips only
    where no compiler builds it, as the package itself reports."""
    so = Path(jfastprep._SO_PATH)
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / ".fastprep.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for rebuild in (not so.exists(), True):
            if rebuild and not _compile_jax_native(so):
                break
            jfastprep._load_failed = False
            if jfastprep.available():
                return
    pytest.skip("the JAX package's native builder did not build")


@pytest.fixture(scope="module")
def ties(tmp_path_factory):
    root = tmp_path_factory.mktemp("ties")
    write_tie_fixture(str(root / "raw_data" / "ml-1m"))
    kw = dict(dataset="ml_1m", max_seq_len=50)
    jdf = jingest.load_origin_data(JDataConfig(data_root=str(root), **kw))
    log = ingest.load_origin_data(DataConfig(data_root=str(root), **kw))
    return jdf, log, kw


def _assert_prepared_equal(a, b):
    assert b.train_set == a.train_set
    assert b.test_set == a.test_set
    assert tuple(b.meta) == tuple(a.meta)
    np.testing.assert_array_equal(b.gap, a.gap)
    assert b.item_category == a.item_category


@pytest.mark.parametrize("causality", ["unidirection", "random",
                                       "time_window"])
def test_prepare_examples_list_for_list(causality):
    jdf, jcfg, log, cfg = _synth(causality=causality, time_window_days=1,
                                 **BITING)
    a = jprepare.prepare_examples(jdf, jcfg)
    b = prepare.prepare_examples(log, cfg)
    _assert_prepared_equal(a, b)
    assert len({ex[0] for ex in b.train_set}) == 41
    assert len(b.test_set) == 25
    assert str(b.train_set[:50]) == str(a.train_set[:50])


@pytest.mark.parametrize("causality", ["unidirection", "time_window"])
def test_prepare_ties_and_duplicates(ties, causality):
    jdf, log, kw = ties
    for remove_duplicate in (True, False):
        over = dict(causality=causality, remove_duplicate=remove_duplicate)
        a = jprepare.prepare_examples(jdf, JDataConfig(**kw, **over))
        b = prepare.prepare_examples(log, DataConfig(**kw, **over))
        _assert_prepared_equal(a, b)
    # the tie order is not a stable sort's: pandas' quicksort permutes
    # user 1's same-second events, and the port's numpy sort does too
    mapped, _, _ = prepare.map_process(log)
    seq = mapped.select(mapped.user_id == 0)
    seq = seq.select(prepare.keep_last_duplicates(seq))
    assert len(seq) > 300 and len(seq) < 400
    quick = np.argsort(seq.time_stamp, kind="quicksort")
    assert not np.array_equal(quick, np.argsort(seq.time_stamp,
                                                kind="stable"))
    got = prepare.dedup_sort_user(seq, False)
    want = jprepare.dedup_sort_user(
        jprepare.map_process(jdf)[0].query("user_id == 0"), True)
    for col in ingest.COLUMNS:
        assert got[col].tolist() == want[col].tolist(), col


def test_keep_last_duplicates_matches_pandas():
    import pandas as pd
    rng = np.random.RandomState(4)
    cols = {c: rng.randint(0, 3, 300).astype(np.int64)
            for c in ingest.COLUMNS}
    want = pd.DataFrame(cols).drop_duplicates(keep="last").index.to_numpy()
    got = prepare.keep_last_duplicates(ingest.EventLog(**cols))
    np.testing.assert_array_equal(got, want)
    assert len(got) < 81


def test_caches_cross_read(tmp_path):
    jdf, jcfg, log, cfg = _synth(**BITING)
    a = jprepare.prepare_examples(jdf, jcfg, cache_dir=str(tmp_path / "j"))
    b = prepare.prepare_examples(log, cfg, cache_dir=str(tmp_path / "t"))
    for name in ("train_data.txt", "test_data.txt"):
        with open(tmp_path / "j" / name, "rb") as f, \
                open(tmp_path / "t" / name, "rb") as g:
            assert f.read() == g.read()
    # each package reads the other's cache (the log is not looked at)
    _assert_prepared_equal(a, prepare.prepare_examples(
        None, cfg, cache_dir=str(tmp_path / "j")))
    _assert_prepared_equal(b, jprepare.prepare_examples(
        None, jcfg, cache_dir=str(tmp_path / "t")))


def _arrays_equal(ours, theirs):
    for name in FIELDS:
        got = getattr(ours, name)
        want = getattr(theirs, name)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
        assert got.dtype == np.asarray(want).dtype, name


def test_pack_and_batch_iterator():
    jdf, jcfg, log, cfg = _synth()
    a = jprepare.prepare_examples(jdf, jcfg)
    b = prepare.prepare_examples(log, cfg)
    jtrain = jpipeline.pack_examples(a.train_set, a.meta)
    train = pipeline.pack_examples(b.train_set, b.meta)
    _arrays_equal(train, jtrain)
    assert tuple(train.meta) == tuple(jtrain.meta)
    short = pipeline.pack_examples(b.train_set, b.meta, max_len=6)
    _arrays_equal(short, jpipeline.pack_examples(a.train_set, a.meta,
                                                 max_len=6))
    for kw in (dict(shuffle=True), dict(drop_remainder=True), {}):
        jit = jpipeline.batch_iterator(jtrain, 37, rng=np.random.RandomState(
            3), **kw)
        it = pipeline.batch_iterator(train, 37, rng=np.random.RandomState(3),
                                     **kw)
        pairs = list(zip(it, jit))
        assert len(pairs) == (len(train) // 37 if kw.get("drop_remainder")
                              else -(-len(train) // 37))
        for (step, batch), (jstep, jbatch) in pairs:
            assert step == jstep and batch.items.device.type == "cpu"
            _arrays_equal(batch, jbatch)
            np.testing.assert_array_equal(batch.valid.numpy(),
                                          np.asarray(jbatch.valid))
    # the last, padded batch: pad rows have seq_len 2 and valid 0
    assert int(batch.valid.sum()) == len(train) % 37
    assert (batch.seq_len[len(train) % 37:] == 2).all()


def test_device_dataset_from_packed_and_prefetch_on_cpu():
    _, _, log, cfg = _synth()
    b = prepare.prepare_examples(log, cfg)
    train = pipeline.pack_examples(b.train_set, b.meta)
    data = device_data.to_device(train, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(data, name).numpy(),
                                      getattr(train, name))
    batches = list(pipeline.batch_iterator(train, 64))
    moved = list(pipeline.prefetch_to_device(iter(batches), device="cpu"))
    assert len(moved) == len(batches)
    for (s, got), (t, want) in zip(moved, batches):
        assert s == t and all(x is y for x, y in zip(got, want))


def _row_set(ds):
    rows = Counter()
    for k in range(len(ds)):
        rows[tuple(np.asarray(getattr(ds, f)[k]).tobytes()
                   for f in FIELDS)] += 1
    return rows


@pytest.mark.parametrize("causality", ["unidirection", "random",
                                       "time_window"])
def test_fastprep_equals_jax_native(jax_native, causality):
    jdf, jcfg, log, cfg = _synth(causality=causality, time_window_days=1,
                                 **BITING)
    jtrain, jtest, jmeta = jfastprep.build_packed(jdf, jcfg)
    train, test, meta = fastprep.build_packed(log, cfg)
    assert tuple(meta) == tuple(jmeta)
    _arrays_equal(train, jtrain)
    _arrays_equal(test, jtest)
    assert len(test) == 25
    # and the same rows as the port's Python builder (no cap: the two
    # builders cap with different samples)
    _, _, log, cfg = _synth(causality=causality, time_window_days=1)
    prepared = prepare.prepare_examples(log, cfg)
    train, test, _ = fastprep.build_packed(log, cfg)
    assert _row_set(train) == _row_set(pipeline.pack_examples(
        prepared.train_set, prepared.meta))
    assert _row_set(test) == _row_set(pipeline.pack_examples(
        prepared.test_set, prepared.meta))


def test_fastprep_ties_equal_jax_native(jax_native, ties):
    jdf, log, kw = ties
    for remove_duplicate in (True, False):
        jtrain, jtest, _ = jfastprep.build_packed(
            jdf, JDataConfig(**kw, remove_duplicate=remove_duplicate))
        train, test, _ = fastprep.build_packed(
            log, DataConfig(**kw, remove_duplicate=remove_duplicate))
        _arrays_equal(train, jtrain)
        _arrays_equal(test, jtest)


def test_fastprep_library_and_refusals():
    assert fastprep.available()
    path = fastprep.library_path()
    assert path.parent == fastprep.REPO_DIR / "build" / "torch_native"
    assert path.exists()
    _, _, log, _ = _synth()
    with pytest.raises(RuntimeError, match="causality"):
        fastprep.build_packed(log, DataConfig(**{**SYNTH,
                                                 "causality": "bert"}))


def test_top_pop_equal(ties):
    jdf, log, kw = ties
    a = jprepare.prepare_examples(jdf, JDataConfig(**kw))
    b = prepare.prepare_examples(log, DataConfig(**kw))
    for ours, theirs in ((top_pop.eval_top_pop, jtop_pop.eval_top_pop),
                         (top_pop.eval_p_pop, jtop_pop.eval_p_pop)):
        assert ours(b.train_set, b.test_set) == theirs(a.train_set,
                                                       a.test_set)
    assert top_pop.global_popularity(b.train_set) == \
        jtop_pop.global_popularity(a.train_set)
