"""The port's PISTRec (a time self-attention stack at Tq = Tk = L, the
T-SeqRec cell, a time readout at Tq = 1 over the self-attended history
and a softmax switch over the three) against the JAX package in its
"soft" mode: init key paths and shapes, one step's loss and every
gradient leaf in f32 and bf16 against both JAX routes, the scores; and
the kernels its training step takes (the attention pair in time mode,
the chain readout pair, the GRU pair in tseqrec mode), and its refusal
of an unknown mode.  The other modes: tests/test_torch_pistrec_hard.py
and tests/test_torch_pistrec_modes.py.  Inputs, routes and tolerances:
tests/torch_zoo_parity.py; in bf16 `zp.check_bf16_where_routes_agree`
(JAX's two routes disagree on some leaves in bf16, where the hour
stamps keep only their high bits)."""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as tgk
from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as trc

torch.set_num_threads(2)

NAME = "pistrec"
MODE = "soft"
OVER = (("model.pistrec_type", MODE),)


def test_init_matches_jax_key_paths():
    zp.check_init_keys(NAME, OVER)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_grads_match_jax_f32(use_pallas):
    grads = zp.check_f32(NAME, use_pallas, OVER)
    for leaf in ("switch.w", "switch.b", "self_att.1.time_input_w",
                 "cross_att.0.q.w", "rnn.time_kernel_w2"):
        assert grads[leaf].abs().sum() > 0, leaf


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_grads_match_jax_bf16(use_pallas):
    zp.check_bf16_where_routes_agree(NAME, use_pallas, OVER)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_scores_match_jax_f32(use_pallas):
    zp.check_scores_f32(NAME, use_pallas, OVER)


def test_training_step_takes_the_ported_kernels(monkeypatch):
    """One f32 step calls the self-attention pair in time mode once a
    block each way, the chain readout pair once each way and the GRU
    pair in tseqrec mode once each way (their twins on the CPU)."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: calls.append(
            (name, a[0] if isinstance(a[0], str) else None))
            or fn(*a, **k))

    for module, name in ((tak, "fused_attention"),
                         (tak, "fused_attention_bwd"),
                         (trc, "readout_chain"), (trc, "readout_chain_bwd"),
                         (tgk, "gru_scan"), (tgk, "gru_scan_bwd")):
        spy(module, name)
    c = zp.cfg(NAME, **dict(OVER))
    _, model = zp.models(NAME, c)
    _, tb = zp.batches()
    _, tmeta = zp.meta()
    tbase.compute_loss(get_model(NAME), model, c.model, tb,
                       tmeta.item_vocab)["loss"].backward()
    assert sorted(calls) == sorted(
        [("fused_attention", "time")] * zp.HOPS
        + [("fused_attention_bwd", "time")] * zp.HOPS
        + [("readout_chain", None), ("readout_chain_bwd", None),
           ("gru_scan", "tseqrec"), ("gru_scan_bwd", "tseqrec")])


def test_unknown_mode_refused():
    c = zp.cfg(NAME, **{"model.pistrec_type": "mixed"})
    _, model = zp.models(NAME, zp.cfg(NAME))
    _, tb = zp.batches()
    with pytest.raises(ValueError, match="pistrec_type"):
        get_model(NAME).apply(model, c.model, tb, train=False)
