"""MTAM at two heads against the JAX package, the models that fix one
head (NARM, LSTUR, STAMP) under ``num_heads=2``, and `cli.main` training
MTAM with ``--set model.num_heads=2``.  The self-attention models at two
heads: tests/test_torch_multihead_sa_models.py; PISTRec:
tests/test_torch_multihead_pistrec.py.

At h = 2 no attention or readout kernel runs in either package (their
`supported` refuse more than one head): JAX takes its jnp attention and
its hop-batched jnp readout, the port its dense route and the plain
PyTorch readouts; the GRU pair still runs its kernel route.

Inputs, tolerances and the JAX routes: tests/torch_zoo_parity.py.  In
bf16 MTAM is held against JAX's Pallas route (its GRU kernel carries the
state in f32, as the port does).
"""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as tgk
from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as trc
from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as trk

torch.set_num_threads(2)

HEADS = (("model.num_heads", 2),)


def test_loss_and_grads_match_jax_f32():
    zp.check_f32("MTAM", False, HEADS)


def test_loss_and_grads_match_jax_bf16():
    zp.check_bf16("MTAM", True, HEADS)


def test_scores_match_jax_f32():
    zp.check_scores_f32("MTAM", False, HEADS)


def _spy(monkeypatch):
    """Counts of the kernel wrappers' calls (their twins on the CPU) and
    of the dense route's forwards, by name and mode."""
    calls = {}

    def wrap(module, fn_name):
        fn = getattr(module, fn_name)

        def counted(*a, **k):
            mode = a[0] if a and isinstance(a[0], str) else None
            calls[(fn_name, mode)] = calls.get((fn_name, mode), 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, fn_name, counted)

    for module, fn_name in ((tak, "fused_attention"),
                            (tak, "fused_attention_bwd"),
                            (tak, "dense_attention"),
                            (trc, "readout_chain"),
                            (trc, "readout_chain_bwd"),
                            (trk, "fused_readout"),
                            (trk, "fused_readout_bwd"),
                            (tgk, "gru_scan"), (tgk, "gru_scan_bwd")):
        wrap(module, fn_name)
    return calls


def check_step_calls(name, want, monkeypatch):
    """One f32 step of ``name`` at two heads calls exactly ``want``."""
    calls = _spy(monkeypatch)
    c = zp.cfg(name, **dict(HEADS))
    _, model = zp.models(name, c)
    _, tb = zp.batches()
    _, tmeta = zp.meta()
    tbase.compute_loss(get_model(name), model, c.model, tb,
                       tmeta.item_vocab)["loss"].backward()
    assert calls == want


def test_training_step_leaves_the_attention_kernels(monkeypatch):
    """One f32 step at two heads: the GRU pair and no attention or
    readout kernel (the readout in plain PyTorch)."""
    check_step_calls("MTAM", {("gru_scan", "tgru"): 1,
                              ("gru_scan_bwd", "tgru"): 1}, monkeypatch)


def test_mtam_serving_takes_the_dense_route_a_hop(monkeypatch):
    """Scoring at two heads: the GRU scan, then one dense-route call a
    hop (JAX serves hop by hop on its jnp path there)."""
    calls = _spy(monkeypatch)
    zp.scores("MTAM", over=HEADS)
    assert calls == {("gru_scan", "tgru"): 1,
                     ("dense_attention", "time"): zp.HOPS}


@pytest.mark.parametrize("name", ["NARM", "LSTUR", "STAMP"])
def test_one_head_models_ignore_num_heads(name):
    """NARM, LSTUR and STAMP keep one head whatever the config says (JAX
    `models/hybrid.py:59`): at num_heads=2 the port matches JAX, and its
    loss and gradients equal those at one head."""
    zp.check_f32(name, False, HEADS)
    _, tb = zp.batches()
    runs = []
    for over in ((), HEADS):
        c = zp.cfg(name, **dict(over))
        _, model = zp.models(name, c)
        runs.append(zp.port_loss_and_grads(name, c, model, tb))
    (m1, g1), (m2, g2) = runs
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(g1[n], g2[n]) for n in g1)


def test_cli_trains_mtam_at_two_heads(tmp_path, monkeypatch):
    """`cli.main` with ``--set model.num_heads=2``: three steps and an
    evaluation, the attention on the dense route."""
    from test_torch_cli import SMALL, _logged

    from mtamrecommender_tpu_torch import cli
    monkeypatch.chdir(tmp_path)
    before = tak.dense_fwd["time"]
    lines = _logged(cli.main, "mtamrec_torch", SMALL + [
        "--experiment_type", "MTAM", "--set", "model.num_heads=2",
        "--max_steps", "3", "--version", "heads", "--run_root",
        str(tmp_path / "runs"), "--data_root", str(tmp_path / "data"),
        "--device", "cpu"])
    assert "done at step 3" in lines[-1]
    assert tak.dense_fwd["time"] > before
