"""The port's host utilities against the JAX package's: the legacy
embedding-config reader, the run archives (`tb_tools`) and the analysis
figures (`figures`), all on the CPU.

`figures.generate_from_checkpoint` restores a checkpoint of the port's
`Checkpointer` and is held against JAX's from an Orbax checkpoint of the
same parameters (converted with `bridge.load_jax_params`) on the same
test batch: the t-SNE coordinates and labels, and each history heatmap
within 1e-5.  `figures.main` runs with non-default shape flags (two
heads, the scalar gate, vocab padding) and with ``--config_json``, as
tests/test_cli.py runs JAX's.  MTAM at d=16, one block, L=8, on small
synthetic data.
"""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.config import ExperimentConfig as JConfig
from mtamrecommender_tpu.data.ingest import load_origin_data as jload
from mtamrecommender_tpu.data.pipeline import batch_iterator as jbatches
from mtamrecommender_tpu.data.pipeline import pack_examples as jpack
from mtamrecommender_tpu.data.prepare import prepare_examples as jprepare
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.utils import embedding_config as jec
from mtamrecommender_tpu.utils import figures as jfig
from mtamrecommender_tpu.utils import tb_tools as jtb
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params
from mtamrecommender_tpu_torch.config import ExperimentConfig
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer
from mtamrecommender_tpu_torch.train.trainer import TrainState
from mtamrecommender_tpu_torch.utils import embedding_config as tec
from mtamrecommender_tpu_torch.utils import figures as tfig
from mtamrecommender_tpu_torch.utils import tb_tools as ttb

torch.set_num_threads(2)

SMALL = {"model.experiment_type": "MTAM", "model.num_units": 16,
         "model.num_blocks": 1, "data.max_seq_len": 8,
         "data.synth_users": 50, "data.synth_items": 30,
         "data.synth_categories": 4, "data.synth_events_per_user": 10,
         "data.dataset": "synthetic", "model.num_heads": 2,
         "model.time_gate_mode": "scalar", "model.vocab_pad_multiple": 8}


def test_read_embedding_config_matches_jax(tmp_path):
    path = tmp_path / "emb.csv"
    path.write_text("# name,vocab,dim\nitem_id,3706,128\n\n"
                    " cate_id ,18,16\nuser_id,6040,64\nitem_id,10,8\n")
    got = tec.read_embedding_config(str(path))
    assert got == jec.read_embedding_config(str(path))
    assert list(got.items()) == [("item_id", (10, 8)), ("cate_id", (18, 16)),
                                 ("user_id", (6040, 64))]


def _tree(root, files):
    for rel, data in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)


def test_archive_round_trip_is_byte_equal(tmp_path):
    rng = np.random.RandomState(0)
    files = {"run_a/events.jsonl": b'{"step": 0}\n',
             "run_a/tb/events.out": rng.bytes(5000),
             "run_b/nested/deep/x.bin": rng.bytes(70000),
             "run_b/empty.txt": b""}
    _tree(tmp_path / "runs", files)
    (tmp_path / "runs" / "loose_file").write_bytes(b"not a run")
    written = ttb.archive_runs(str(tmp_path / "runs"), str(tmp_path / "arc"))
    assert [os.path.basename(p) for p in written] == ["run_a.tar.xz",
                                                      "run_b.tar.xz"]
    # the JAX package's archives name the same runs
    jwritten = jtb.archive_runs(str(tmp_path / "runs"), str(tmp_path / "jarc"))
    assert [os.path.basename(p) for p in jwritten] == \
        [os.path.basename(p) for p in written]
    out = tmp_path / "restored"
    assert ttb.extract_archives(str(tmp_path / "arc"), str(out)) == written
    for rel in files:
        assert filecmp.cmp(tmp_path / "runs" / rel, out / rel, shallow=False)
    # and each package unpacks the other's archives
    jtb.extract_archives(str(tmp_path / "arc"), str(tmp_path / "by_jax"))
    ttb.extract_archives(str(tmp_path / "jarc"), str(tmp_path / "by_port"))
    for rel in files:
        for where in ("by_jax", "by_port"):
            assert filecmp.cmp(tmp_path / "runs" / rel, tmp_path / where / rel,
                               shallow=False)


def test_tsne_and_heatmap_match_jax():
    rng = np.random.RandomState(0)
    table = rng.randn(33, 8).astype(np.float32)
    cats = {i: i % 4 + 1 for i in range(1, 31)}
    got = tfig.item_embedding_tsne(table, cats, max_items=25)
    want = jfig.item_embedding_tsne(table, cats, max_items=25)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert got[0].shape == (25, 2)
    emb = rng.randn(8, 8)
    heat = tfig.history_similarity_heatmap(emb, 5)
    np.testing.assert_array_equal(heat,
                                  jfig.history_similarity_heatmap(emb, 5))
    np.testing.assert_allclose(np.diag(heat), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of MTAM parameters (JAX's init) saved twice: as an Orbax
    checkpoint by the JAX package and as the port's checkpoint; the
    config, the JAX package's prepared data and a 4-row test batch."""
    from mtamrecommender_tpu.train.checkpoint import \
        Checkpointer as JCheckpointer
    from mtamrecommender_tpu.train.trainer import TrainState as JState
    from mtamrecommender_tpu.train.trainer import make_optimizer

    root = tmp_path_factory.mktemp("figures")
    jcfg = JConfig().with_overrides(**SMALL)
    prepared = jprepare(jload(jcfg.data), jcfg.data)
    params = jax.device_get(jget_model("MTAM").init(
        jax.random.PRNGKey(3), jcfg.model, prepared.meta))
    ckpt = JCheckpointer(str(root / "jax"))
    ckpt.save(JState(params=params,
                     opt_state=make_optimizer(jcfg.train).init(params),
                     step=1), wait=True)
    ckpt.close()
    cfg = ExperimentConfig().with_overrides(**SMALL)
    meta = ttypes.DatasetMeta(*prepared.meta)
    model = load_jax_params(get_model("MTAM").init(
        torch.Generator().manual_seed(0), cfg.model, meta), params)
    Checkpointer(str(root / "port")).save(TrainState(model, None, 1))
    _, jbatch = next(jbatches(jpack(prepared.test_set, prepared.meta), 4))
    return dict(root=root, jcfg=jcfg, cfg=cfg, prepared=prepared, meta=meta,
                jbatch=jbatch)


def test_generate_from_checkpoint_matches_jax(checkpoints):
    c = checkpoints
    tbatch = ttypes.batch_from_numpy(
        {f: np.asarray(getattr(c["jbatch"], f)) for f in c["jbatch"]._fields},
        device="cpu")
    want, wpaths = jfig.generate_from_checkpoint(
        c["jcfg"], c["prepared"].meta, c["prepared"].item_category,
        str(c["root"] / "jax"), str(c["root"] / "jfigs"),
        test_batch=c["jbatch"], user_rows=3, max_items=20)
    got, paths = tfig.generate_from_checkpoint(
        c["cfg"], c["meta"], c["prepared"].item_category,
        str(c["root"] / "port"), str(c["root"] / "figs"), test_batch=tbatch,
        user_rows=3, max_items=20, device="cpu")
    np.testing.assert_array_equal(got["tsne_labels"], want["tsne_labels"])
    np.testing.assert_allclose(got["tsne_coords"], want["tsne_coords"],
                               rtol=1e-5, atol=1e-5)
    assert len(got["heatmaps"]) == len(want["heatmaps"]) == 3
    for hm, jhm in zip(got["heatmaps"], want["heatmaps"]):
        assert hm.shape == jhm.shape
        np.testing.assert_allclose(hm, jhm, atol=1e-5, rtol=0)
    assert sorted(paths) == sorted(wpaths)
    for p in paths.values():
        assert p is not None and os.path.getsize(p) > 0


def test_figures_main_with_shape_flags(tmp_path, monkeypatch, capsys):
    """The run's shape flags given one by one (two heads, the scalar gate,
    vocab padding; the default synthetic data at L=8), then the same run
    through ``--config_json``; flags of another width do not fit the
    checkpoint and raise."""
    monkeypatch.chdir(tmp_path)
    flags = ["--type", "synthetic", "--num_units", "16", "--num_blocks", "1",
             "--max_seq_len", "8", "--num_heads", "2", "--time_gate_mode",
             "scalar", "--vocab_pad_multiple", "8"]
    cfg = ExperimentConfig().with_overrides(**{
        k: v for k, v in SMALL.items() if not k.startswith("data.synth")})
    from mtamrecommender_tpu_torch.data.ingest import load_origin_data
    from mtamrecommender_tpu_torch.data.prepare import prepare_examples
    meta = prepare_examples(load_origin_data(cfg.data), cfg.data).meta
    model = get_model("MTAM").init(torch.Generator().manual_seed(1),
                                   cfg.model, meta)
    Checkpointer(str(tmp_path / "ckpt")).save(TrainState(model, None, 2))
    common = ["--checkpoint", str(tmp_path / "ckpt"), "--heatmap_users", "2",
              "--max_items", "20", "--device", "cpu"]
    assert tfig.main(flags + common + ["--out_dir", str(tmp_path / "a")]) == 0
    printed = capsys.readouterr().out
    assert "heatmap_1:" in printed and "(matplotlib" not in printed
    assert (tmp_path / "a" / "item_tsne.png").exists()

    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    assert tfig.main(["--config_json", str(cfg_path), "--out_dir",
                      str(tmp_path / "b")] + common) == 0
    assert (tmp_path / "b" / "history_heatmap_1.png").exists()
    with pytest.raises(ValueError, match="in the checkpoint"):
        tfig.main(flags + ["--num_units", "12"] + common)


def test_figures_imports_no_plotting_library_at_import():
    """sklearn and matplotlib load inside the functions that need them."""
    import subprocess
    import sys
    code = ("import sys; import mtamrecommender_tpu_torch.utils.figures; "
            "print('sklearn' in sys.modules, 'matplotlib' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=repo, check=True).stdout
    assert out.split() == ["False", "False"]
