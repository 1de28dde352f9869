"""Zoo models past 64 keys against the JAX package: one f32 training step
at the reference's 150-event cap (``data.max_seq_len`` 150) of
MTAM_with_T_SeqRec at its preset's 6 hops, NARM++ (one hop) and PISTRec
in its "hard" mode, against JAX's step on its jnp route.

On the card these steps take the designs that change past 64 keys: the
chain readout pair's "blocked" design (65 <= L <= 256) for the Tq = 1
time readout, and in PISTRec the self-attention pair's "wide" designs;
chip_smoke.py's phase 15 holds them there against the CPU.  Here the
port's CPU step runs the same routes through the plain twins: the chain
twins are called once each a step, over every hop at once (6, 1 and, at
torch_zoo_parity's two blocks, 2 hops).  Inputs and tolerances:
tests/torch_zoo_parity.py (`seq_lens(150)`: two full rows, two ragged
rows past 64 keys, short rows, a filler row), save the position table's
padding row (PAD_ROW_REL); PISTRec's hard switch gets no gradient, as in
JAX.
"""

import pytest
import torch

import torch_zoo_parity as zp
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as trc

torch.set_num_threads(2)

L150 = 150
CASES = {"MTAM_with_T_SeqRec": (("model.num_blocks", 6),),
         "NARM++": (),
         "pistrec": (("model.pistrec_type", "hard"),)}
HOPS = {"MTAM_with_T_SeqRec": 6, "NARM++": 1, "pistrec": zp.HOPS}
# the position table's padding row sums the cotangents of the batch's
# padded slots (hundreds at L=150) in another order than JAX's scatter:
# held to 1e-4 of the leaf's largest |value|, as
# tests/test_torch_chain_blocked_design.py holds MTAM's at L=150
PAD_ROW_REL = 1e-4


@pytest.fixture
def chain_hops(monkeypatch):
    """The hop count of each chain twin call (as the kernels count
    launches)."""
    calls = {}
    for name in ("readout_chain_plain", "readout_chain_bwd_plain"):
        plain = getattr(trc, name)

        def run(*args, _plain=plain, _name=name):
            # k_all [n, B, L, d]: the forward's fourth argument, and the
            # backward's after g, klen and qz
            calls.setdefault(_name, []).append(args[3].shape[0])
            return _plain(*args)
        monkeypatch.setattr(trc, name, run)
    return calls


def test_the_designs_change_past_64_keys():
    """At the zoo's width the chain pair takes its blocked design at
    L=150 (staged at L=50) and PISTRec's self-attention the wide designs
    (tile at L=50): the kernels these steps exercise on the card."""
    for dtype in (torch.float32, torch.bfloat16):
        assert trc.chain_fwd_design(dtype, 50, zp.D) == "staged"
        assert trc.chain_fwd_design(dtype, L150, zp.D) == "blocked"
        assert trc.chain_bwd_design(dtype, L150, zp.D) == "blocked"
        assert tak.attention_fwd_design(dtype, 1, L150, zp.D) == "blocked"
        assert tak.attention_fwd_design(dtype, L150, L150, zp.D) == "wide"
        assert tak.attention_bwd_design(dtype, L150, L150, zp.D) == "wide"


@pytest.mark.parametrize("name", list(CASES))
def test_step_past_64_keys_matches_jax_f32(chain_hops, name):
    over = (("data.max_seq_len", L150),) + CASES[name]
    assert max(zp.seq_lens(L150)) == L150 and sorted(zp.seq_lens(L150))[-3] > 64
    grads = zp.check_f32(name, False, over, pad_row_rel=PAD_ROW_REL)
    # one chain forward and one backward, over every hop at once
    assert chain_hops == {"readout_chain_plain": [HOPS[name]],
                          "readout_chain_bwd_plain": [HOPS[name]]}
    if name == "pistrec":
        assert not grads["switch.w"].any() and not grads["switch.b"].any()
        assert grads["self_att.0.time_input_b1"].abs().sum() > 0
        assert tuple(grads["self_att.0.time_input_b1"].shape) == (L150, L150)
