"""The port's kernel modules against the JAX package's Pallas kernels.

Each wrapper in mtamrecommender_tpu_torch/ops/kernels/ runs its plain
PyTorch twin on CPU tensors; these tests hold that twin against the JAX
kernel (run in interpret mode on the CPU, as tests/test_pallas.py runs
it) and against the JAX kernel's jnp reference, on the same inputs made
with numpy from a seed.  The CUDA kernels themselves are checked against
the same twins on the card by chip_smoke.py.

Tolerances: f32 paths agree to atol 1e-5 (both sides sum f32 products,
in different orders).  With bf16 inputs the port and the Pallas kernel
both carry the GRU state in f32 and round only the product operands to
bf16, so they still agree to 1e-5, while the JAX jnp scan, which carries
the state in bf16, sits ~1e-3 away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import attention_kernel as jak
from mtamrecommender_tpu.ops.pallas import gru_kernel as jgk
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as tgk

torch.set_num_threads(2)

ATOL_F32 = 1e-5

B, L, U = 8, 12, 16
GRU_ORDER = ("gate_x", "cand_x", "e1", "e2", "lengths", "h0", "w_gate_h",
             "w_cand_h", "b_gate", "b_cand", "cell_vecs")


def _gru_inputs(seed=3):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return {
        "gate_x": f(B, L, 2 * U, scale=0.8), "cand_x": f(B, L, U, scale=0.8),
        "e1": f(B, L, U, scale=0.5),
        "e2": np.abs(f(B, L, U, scale=0.5)),
        # lengths cover an empty row, a one-step row and full rows
        "lengths": np.array([0, 1, L, 5, L, 3, 7, L], np.int32),
        "h0": f(B, U, scale=0.5),   # non-zero initial state
        "w_gate_h": f(U, 2 * U, scale=0.3), "w_cand_h": f(U, U, scale=0.3),
        "b_gate": f(2 * U, scale=0.1), "b_cand": f(U, scale=0.1),
        "cell_vecs": f(4, U, scale=0.5),
    }


def _as_jax(arrays, dtype):
    return [jnp.asarray(arrays[k]) if k == "lengths"
            else jnp.asarray(arrays[k], dtype) for k in GRU_ORDER]


def _as_torch(arrays, dtype):
    return [torch.tensor(arrays[k]) if k == "lengths"
            else torch.tensor(arrays[k]).to(dtype) for k in GRU_ORDER]


@pytest.mark.parametrize("mode", ["plain", "tseqrec", "tgru"])
def test_gru_scan_plain_matches_jax_f32(mode):
    a = _gru_inputs()
    want_kernel = np.asarray(jgk.gru_scan(mode, *_as_jax(a, jnp.float32)))
    want_ref = np.asarray(jgk._reference_scan(mode, *_as_jax(a, jnp.float32)))
    got = tgk.gru_scan(mode, *_as_torch(a, torch.float32))
    assert got.dtype == torch.float32 and got.shape == (B, L, U)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL_F32, rtol=0)
    # dynamic_rnn length semantics: zero output past each row's length
    lengths = a["lengths"]
    for b in range(B):
        assert not got[b, lengths[b]:].any()


@pytest.mark.parametrize("mode", ["plain", "tseqrec", "tgru"])
def test_gru_scan_plain_bf16_carries_state_in_f32(mode):
    a = _gru_inputs(seed=4)
    want_kernel = np.asarray(jgk.gru_scan(mode, *_as_jax(a, jnp.bfloat16)),
                             np.float32)
    bf16_carry = np.asarray(
        jgk._reference_scan(mode, *_as_jax(a, jnp.bfloat16))
        .astype(jnp.float32))
    got = tgk.gru_scan(mode, *_as_torch(a, torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=ATOL_F32, rtol=0)
    # the jnp scan's bf16 carry is a different (coarser) computation
    assert np.abs(got.numpy() - bf16_carry).max() > 100 * ATOL_F32


TQ, TK, D = 1, 12, 16


def _att_inputs(dtype_np=np.float32, seed=7):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(dtype_np)  # noqa: E731
    t_k = np.sort(r.rand(B, TK).astype(np.float32) * 500, axis=1)
    return {
        "q": f(B, TQ, D), "k": f(B, TK, D), "v": f(B, TK, D),
        "t_q": (t_k.max(1, keepdims=True) + 3.0)[:, :TQ], "t_k": t_k,
        "tqw": f(B, TQ, D, scale=0.3), "rawk": f(B, TK, D),
        "w1": f(TQ, TK, scale=0.3), "b1": f(TQ, TK, scale=0.3),
        "wo1": f(TQ, TK, scale=0.3), "wo2": f(TQ, TK, scale=0.3),
        "bo": f(TQ, TK, scale=0.3),
        # key_len covers an all-masked row, one key and the full memory
        "key_len": np.array([0, 1, TK, 5, TK, 3, 11, 2], np.int32),
    }


ATT_ORDER = ("q", "k", "v", "t_q", "t_k", "tqw", "rawk", "w1", "b1", "wo1",
             "wo2", "bo", "key_len")


@pytest.mark.parametrize("mode", ["time", "plain", "tisas"])
def test_fused_attention_plain_matches_jax_f32(mode):
    a = _att_inputs()
    jargs = [jnp.asarray(a[k]) for k in ATT_ORDER]
    want_ref = np.asarray(jak._reference_middle(mode, *jargs))
    want_kernel = np.asarray(jak.fused_attention(mode, *jargs,
                                                 jak.dm_dummy()))
    got = tak.fused_attention(mode, *[torch.tensor(a[k]) for k in ATT_ORDER])
    assert got.dtype == torch.float32 and got.shape == (B, TQ, D)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL_F32, rtol=0)
    # The Pallas kernel pads Tk to 128 before masking, so a row whose keys
    # are all masked spreads its weight over the padded columns too; the
    # port, like the reference, is uniform over the row's Tk keys.
    live = a["key_len"] > 0
    np.testing.assert_allclose(got.numpy()[live], want_kernel[live],
                               atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got.numpy()[~live],
                               a["v"][~live].mean(axis=1, keepdims=True),
                               atol=ATOL_F32, rtol=0)


def test_wrappers_reject_bad_operands():
    a = _gru_inputs()
    args = _as_torch(a, torch.float32)
    with pytest.raises(ValueError, match="mode"):
        tgk.gru_scan("lstm", *args)
    bad = list(args)
    bad[5] = bad[5][:, :-1]                       # h0 [B, u-1]
    with pytest.raises(ValueError, match="h0"):
        tgk.gru_scan("tgru", *bad)
    mixed = list(args)
    mixed[0] = mixed[0].to(torch.bfloat16)        # one bf16 operand
    with pytest.raises(TypeError):
        tgk.gru_scan("tgru", *mixed)
    att = [torch.tensor(_att_inputs()[k]) for k in ATT_ORDER]
    att[-1] = att[-1].long()                      # key_len int64
    with pytest.raises(TypeError, match="key_len"):
        tak.fused_attention("time", *att)


def test_cpu_tensors_never_build_a_kernel(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached the CUDA build")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "library", refuse)
    before = (dict(tgk.launches), dict(tak.launches))
    tgk.gru_scan("tgru", *_as_torch(_gru_inputs(), torch.float32))
    tak.fused_attention("time", *[torch.tensor(_att_inputs()[k])
                                  for k in ATT_ORDER])
    assert (tgk.launches, tak.launches) == before


# ------------------------------------------------------------ backwards
#
# gru_scan_bwd_plain is held against the JAX Pallas backward
# (gru_kernel.gru_scan_bwd, interpret mode), against jax.vjp through
# gru_scan_vjp, and against torch autograd through gru_scan_plain (an
# oracle that shares no code with the twin); f32 at atol 1e-5.  With bf16
# inputs the twin and the Pallas kernel round the same operands, but a
# product operand that lands on a rounding boundary may round the other
# way after a differently ordered f32 sum, so bf16 is held to 1e-3 of
# each output's largest |value|.

from mtamrecommender_tpu.ops.pallas import embedding_kernel as jek  # noqa: E402
from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as tek  # noqa: E402

GRAD_NAMES = ("gate_x", "cand_x", "e1", "e2", "h0", "w_gate_h", "w_cand_h",
              "b_gate", "b_cand", "cell_vecs")
REL_BWD_BF16 = 1e-3


def _cotangent(seed=9):
    return np.random.RandomState(seed).randn(B, L, U).astype(np.float32)


@pytest.mark.parametrize("mode", ["plain", "tseqrec", "tgru"])
def test_gru_scan_bwd_plain_matches_jax_f32(mode):
    a = _gru_inputs()
    g = _cotangent()
    jargs = _as_jax(a, jnp.float32)
    outs = jgk.gru_scan(mode, *jargs)
    want = jgk.gru_scan_bwd(mode, jnp.asarray(g), outs, *jargs)
    _, vjp = jax.vjp(lambda *x: jgk.gru_scan_vjp(mode, *x[:4], jargs[4],
                                                 *x[4:]),
                     *jargs[:4], *jargs[5:])
    want_vjp = vjp(jnp.asarray(g))
    targs = _as_torch(a, torch.float32)
    got = tgk.gru_scan_bwd(mode, torch.tensor(g),
                           tgk.gru_scan(mode, *targs), *targs)
    # torch autograd through the forward twin
    leaves = [t.clone().requires_grad_(True) if i != 4 else t
              for i, t in enumerate(targs)]
    out = tgk.gru_scan_plain(mode, *leaves)
    oracle = torch.autograd.grad(out, leaves[:4] + leaves[5:],
                                 torch.tensor(g), allow_unused=True)
    for i, name in enumerate(GRAD_NAMES):
        assert got[i].dtype == torch.float32, name
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=ATOL_F32, rtol=0, err_msg=name)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want_vjp[i]),
                                   atol=ATOL_F32, rtol=0, err_msg=name)
        o = (torch.zeros_like(got[i]) if oracle[i] is None
             else oracle[i])
        np.testing.assert_allclose(got[i].numpy(), o.numpy(),
                                   atol=ATOL_F32, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["plain", "tseqrec", "tgru"])
def test_gru_scan_bwd_plain_matches_jax_bf16(mode):
    a = _gru_inputs(seed=5)
    g = _cotangent(seed=6)
    jargs = _as_jax(a, jnp.bfloat16)
    outs = jgk.gru_scan(mode, *jargs)
    want = jgk.gru_scan_bwd(mode, jnp.asarray(g), outs, *jargs)
    targs = _as_torch(a, torch.bfloat16)
    got = tgk.gru_scan_bwd(mode, torch.tensor(g),
                           tgk.gru_scan(mode, *targs), *targs)
    for i, name in enumerate(GRAD_NAMES):
        w = np.asarray(want[i], np.float32)
        err = np.abs(got[i].numpy() - w).max()
        assert err <= REL_BWD_BF16 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("mode", ["plain", "tseqrec", "tgru"])
def test_gru_recompute_plain_reproduces_jax_forward(mode):
    # the backward's recompute pass: every step's gates and candidate from
    # h0 and the JAX kernel's saved outputs give back those outputs
    a = _gru_inputs(seed=11)
    outs = np.asarray(jgk.gru_scan(mode, *_as_jax(a, jnp.float32)))
    t = dict(zip(GRU_ORDER, _as_torch(a, torch.float32)))
    h_prev = torch.cat([t["h0"][:, None], torch.tensor(outs[:, :-1])], 1)
    r, ug, cand, rh = tgk.gru_recompute_plain(
        t["gate_x"], t["cand_x"], h_prev, t["w_gate_h"], t["w_cand_h"],
        t["b_gate"], t["b_cand"])
    np.testing.assert_allclose(rh.numpy(), (r * h_prev).numpy(), rtol=0,
                               atol=0)
    vec = t["cell_vecs"]
    if mode == "plain":
        new_h = ug * h_prev + (1 - ug) * cand
    elif mode == "tseqrec":
        new_h = ug * h_prev * t["e1"] + (1 - ug) * cand * t["e2"]
    else:
        weight = torch.relu(t["e1"] + h_prev * vec[0])
        ts = torch.sigmoid(vec[1] * weight + vec[2] * t["e2"] + vec[3])
        new_h = ug * h_prev + (1 - ug) * cand * ts
    alive = (torch.arange(L)[None, :] < t["lengths"][:, None]).numpy()
    np.testing.assert_allclose(new_h.numpy()[alive], outs[alive],
                               atol=ATOL_F32, rtol=0)


def test_gru_scan_bwd_design_is_checked_before_any_launch(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("an unknown design reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)
    targs = _as_torch(_gru_inputs(), torch.float32)
    outs = tgk.gru_scan("tgru", *targs)
    with pytest.raises(ValueError, match="design"):
        tgk._launch_bwd("tgru", torch.tensor(_cotangent()), outs, *targs,
                        _design="simt")
    assert tgk.BWD_DESIGNS[0] == "two_product"   # the default


def test_gru_scan_vjp_casts_cotangents_to_input_types():
    a = _gru_inputs()
    args = [t.requires_grad_(True) if t.is_floating_point() else t
            for t in _as_torch(a, torch.bfloat16)]
    out = tgk.gru_scan_vjp("tgru", *args)
    out.sum().backward()
    for name, t in zip(GRU_ORDER, args):
        if name == "lengths":
            continue
        assert t.grad is not None and t.grad.dtype == torch.bfloat16, name
    # dead steps of a row pass nothing back to its inputs
    assert not args[0].grad[0].any()          # lengths[0] == 0


def _dtable_inputs(seed=17, n_rows=6, width=5, vocab=40, d=16):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 30, size=(n_rows, width)).astype(np.int32)
    ids[:, 3:] = 0                      # padding: row 0 heavily duplicated
    ids[0, :3] = 7                      # another duplicated id
    table = r.randn(vocab, d).astype(np.float32)   # rows 30..39: padding
    ct = r.randn(n_rows, width, d).astype(np.float32)
    return table, ids, ct


def test_take_dtable_backward_matches_jax_f32():
    table, ids, ct = _dtable_inputs()
    jt, ji = jnp.asarray(table), jnp.asarray(ids)
    want_kernel = jax.vjp(lambda t: jek.take_dtable(t, ji), jt)[1](
        jnp.asarray(ct))[0]
    want_take = jax.vjp(lambda t: jnp.take(t, ji, axis=0), jt)[1](
        jnp.asarray(ct))[0]
    tt = torch.tensor(table, requires_grad=True)
    out = tek.take_dtable(tt, torch.tensor(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    out.backward(torch.tensor(ct))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_kernel),
                               atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_take),
                               atol=ATOL_F32, rtol=0)
    assert not tt.grad[30:].any()          # padded rows get no gradient


def test_dtable_bf16_sums_in_f32_and_rounds_once():
    _, ids, ct = _dtable_inputs(seed=18)
    flat = torch.tensor(ids.reshape(-1))
    ct_bf = torch.tensor(ct.reshape(-1, ct.shape[-1])).to(torch.bfloat16)
    got = tek.dtable(ct_bf, flat, 40)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jek._dtable_impl(jnp.asarray(ct_bf.float().numpy(),
                                                   jnp.bfloat16),
                                       jnp.asarray(flat.numpy()), 40),
                      np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_dtable_rejects_bad_ids():
    ct = torch.ones((4, 8))
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        tek.dtable(ct, torch.tensor([0, 1, 5, 2], dtype=torch.int32), 5)
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        tek.dtable(ct, torch.tensor([0, -1, 2, 2], dtype=torch.int32), 5)
    with pytest.raises(TypeError, match="int32"):
        tek.dtable(ct, torch.tensor([0, 1, 2, 2]), 5)


def test_cpu_backwards_never_build_a_kernel(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached the CUDA build")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "library", refuse)
    before = (dict(tgk.bwd_launches), dict(tek.launches),
              dict(tak.launches), dict(tak.bwd_launches))
    args = [t.requires_grad_(True) if t.is_floating_point() else t
            for t in _as_torch(_gru_inputs(), torch.float32)]
    tgk.gru_scan_vjp("tgru", *args).sum().backward()
    table, ids, _ = _dtable_inputs()
    tt = torch.tensor(table, requires_grad=True)
    tek.take_dtable(tt, torch.tensor(ids)).sum().backward()
    a = _self_att_inputs()
    for mode in tak.MODES:
        targs = _torch_att(a, torch.float32, grad=True)
        dm = torch.tensor(a["dm"]) if mode.endswith("_drop") else None
        tak.fused_attention_vjp(mode, *targs, dm).sum().backward()
    assert (tgk.bwd_launches, tek.launches, tak.launches,
            tak.bwd_launches) == before


# ------------------------------------------------- attention at Tq > 1
#
# Self-attention shapes (Tq = Tk = L), as the three self-attention models
# run the kernel.  The twins are held against the JAX Pallas kernels
# (interpret mode) and against the jnp reference `_reference_middle`
# (through jax.vjp for the backward), f32 at 1e-5 of each output's
# largest |value|.  The Pallas kernels pad Tk to 128 before they mask, so
# rows with key_len == 0 are held against the reference only (and the
# Pallas backward, whose gate cotangents sum over all rows, gets inputs
# without such a row).  bf16: the twin and the Pallas backward round the
# same product operands (g, the dropped weights, ds0, dpre_tqk) to bf16,
# but an operand on a rounding boundary may round the other way after a
# differently ordered f32 sum, so bf16 is held to 1e-3 of each output's
# largest |value|, as the GRU backward is (measured: <= 3e-7).

TL = 8                                   # Tq = Tk
ATT_GRAD_NAMES = ("dq", "dk", "dv", "dtqw", "drawk", "dw1", "db1", "dwo1",
                  "dwo2", "dbo")
ATT_DIFF = (0, 1, 2, 5, 6, 7, 8, 9, 10, 11)   # the differentiable inputs
TIME_ONLY = ATT_GRAD_NAMES[3:]   # None outside time mode
REL_ATT_BWD_BF16 = 1e-3


def _self_att_inputs(seed=8, key_len=(0, 1, TL, 5, TL, 3, 7, 2)):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    t = np.sort(r.rand(B, TL).astype(np.float32) * 500, axis=1)
    keep = 0.5
    return {
        "q": np.maximum(f(B, TL, D), 0), "k": np.maximum(f(B, TL, D), 0),
        "v": np.maximum(f(B, TL, D), 0), "t_q": t, "t_k": t,
        "tqw": f(B, TL, D, scale=0.3), "rawk": f(B, TL, D),
        "w1": f(TL, TL, scale=0.3), "b1": f(TL, TL, scale=0.3),
        "wo1": f(TL, TL, scale=0.3), "wo2": f(TL, TL, scale=0.3),
        "bo": f(TL, TL, scale=0.3),
        "key_len": np.array(key_len, np.int32),
        "dm": (r.rand(B, TL, TL) < keep).astype(np.float32) / keep,
        "g": f(B, TL, D),
    }


def _torch_att(a, dtype, grad=False):
    out = []
    for i, name in enumerate(ATT_ORDER):
        t = torch.tensor(a[name])
        if name != "key_len":
            t = t.to(dtype)
            if grad and i in ATT_DIFF:
                t.requires_grad_(True)
        out.append(t)
    return out


def _jax_att(a, dtype):
    return [jnp.asarray(a[n]) if n == "key_len" else jnp.asarray(a[n], dtype)
            for n in ATT_ORDER]


def _jax_dm(a, mode):
    return jnp.asarray(a["dm"]) if mode.endswith("_drop") else jak.dm_dummy()


def _assert_bwd_output(mode, name, got, want, rel):
    """One backward output: outside time mode the time-only ones are None
    (the JAX cotangent is all zeros there), the others within ``rel`` of
    the largest |want|."""
    if name in TIME_ONLY and mode != "time":
        assert got is None, name
        assert not np.asarray(want, np.float32).any(), name
        return
    assert got.dtype == torch.float32, name
    _assert_rel(got.numpy(), want, rel, name)


def _assert_rel(got, want, rel, what, rows=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, \
        (what, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("mode", ["plain_drop", "tisas_drop"])
def test_fused_attention_plain_drop_modes_match_jax_f32(mode):
    a = _self_att_inputs()
    jargs = _jax_att(a, jnp.float32)
    dm = jnp.asarray(a["dm"])
    want_ref = np.asarray(jak._reference_middle(mode, *jargs, dm=dm))
    want_kernel = np.asarray(jak.fused_attention(mode, *jargs, dm))
    got = tak.fused_attention(mode, *_torch_att(a, torch.float32),
                              torch.tensor(a["dm"]))
    assert got.dtype == torch.float32 and got.shape == (B, TL, D)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL_F32, rtol=0)
    live = a["key_len"] > 0
    np.testing.assert_allclose(got.numpy()[live], want_kernel[live],
                               atol=ATOL_F32, rtol=0)
    # a dropped weight takes no part, a kept one counts twice (keep 0.5)
    base = tak.fused_attention(mode[:-5], *_torch_att(a, torch.float32))
    assert not torch.allclose(got, base)


@pytest.mark.parametrize("mode", ["plain", "time", "tisas"])
def test_fused_attention_plain_matches_jax_at_tq_gt_1(mode):
    """The forward modes at the self-attention shape Tq = Tk."""
    a = _self_att_inputs()
    jargs = _jax_att(a, jnp.float32)
    want_ref = np.asarray(jak._reference_middle(mode, *jargs))
    want_kernel = np.asarray(jak.fused_attention(mode, *jargs,
                                                 jak.dm_dummy()))
    got = tak.fused_attention(mode, *_torch_att(a, torch.float32)).numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL_F32, rtol=0)
    live = a["key_len"] > 0
    np.testing.assert_allclose(got[live], want_kernel[live], atol=ATOL_F32,
                               rtol=0)


@pytest.mark.parametrize("mode", ["plain", "time", "tisas", "plain_drop",
                                  "tisas_drop"])
def test_fused_attention_bwd_plain_matches_jax_f32(mode):
    # every row: jax.vjp of the jnp reference
    a = _self_att_inputs()
    jargs = _jax_att(a, jnp.float32)
    dm = jnp.asarray(a["dm"]) if mode.endswith("_drop") else None
    diff = [jargs[i] for i in ATT_DIFF]

    def ref(*x):
        full = list(jargs)
        for i, xi in zip(ATT_DIFF, x):
            full[i] = xi
        return jak._reference_middle(mode, *full, dm=dm)

    _, vjp = jax.vjp(ref, *diff)
    want_ref = vjp(jnp.asarray(a["g"]))
    tdm = torch.tensor(a["dm"]) if dm is not None else None
    got = tak.fused_attention_bwd(mode, torch.tensor(a["g"]),
                                  *_torch_att(a, torch.float32), tdm)
    for name, x, w in zip(ATT_GRAD_NAMES, got, want_ref):
        _assert_bwd_output(mode, name, x, w, ATOL_F32)
    # live rows only: jax.vjp of the Pallas kernel (its backward kernel)
    a = _self_att_inputs(key_len=(4, 1, TL, 5, TL, 3, 7, 2))
    jargs = _jax_att(a, jnp.float32)
    _, vjp = jax.vjp(
        lambda *x: jak.fused_attention(
            mode, *x[:3], jargs[3], jargs[4], *x[3:], jargs[12],
            _jax_dm(a, mode)),
        *[jargs[i] for i in ATT_DIFF])
    want_kernel = vjp(jnp.asarray(a["g"]))
    got = tak.fused_attention_bwd(mode, torch.tensor(a["g"]),
                                  *_torch_att(a, torch.float32), tdm)
    for name, x, w in zip(ATT_GRAD_NAMES, got, want_kernel):
        _assert_bwd_output(mode, name, x, w, ATOL_F32)


@pytest.mark.parametrize("mode", ["plain", "time", "tisas", "plain_drop",
                                  "tisas_drop"])
def test_fused_attention_bwd_plain_matches_pallas_bf16(mode):
    a = _self_att_inputs(seed=9, key_len=(4, 1, TL, 5, TL, 3, 7, 2))
    jargs = _jax_att(a, jnp.bfloat16)
    want = jak._fused_attention_bwd(mode, jnp.asarray(a["g"]), *jargs,
                                    _jax_dm(a, mode))
    tdm = torch.tensor(a["dm"]) if mode.endswith("_drop") else None
    got = tak.fused_attention_bwd(mode, torch.tensor(a["g"]),
                                  *_torch_att(a, torch.bfloat16), tdm)
    for name, x, w in zip(ATT_GRAD_NAMES, got, want):
        _assert_bwd_output(mode, name, x, w, REL_ATT_BWD_BF16)


def test_fused_attention_bwd_dead_query_rows_add_nothing():
    """Query rows past query_len get a zero cotangent from the tail; such
    a row passes nothing to dk, dv, drawk or the gate params, whatever
    its q and tqw hold, and gets dq = dtqw = 0."""
    a = _self_att_inputs()
    g = a["g"].copy()
    dead = np.arange(TL)[None, :] >= a["key_len"][:, None]
    g[dead] = 0.0
    args = _torch_att(a, torch.float32)
    base = tak.fused_attention_bwd("time", torch.tensor(g), *args)
    moved = [t.clone() for t in args]
    r = np.random.RandomState(0)
    for i in (0, 5):                                  # q and tqw
        noise = torch.tensor(r.randn(*moved[i].shape).astype(np.float32))
        moved[i][torch.tensor(dead)] += noise[torch.tensor(dead)]
    other = tak.fused_attention_bwd("time", torch.tensor(g), *moved)
    for name, x, y in zip(ATT_GRAD_NAMES, base, other):
        if name in ("dq", "dtqw"):
            assert not x[torch.tensor(dead)].any(), name
            assert not y[torch.tensor(dead)].any(), name
        else:
            assert torch.equal(x, y), name


def test_fused_attention_vjp_casts_cotangents_to_input_types():
    a = _self_att_inputs()
    args = _torch_att(a, torch.bfloat16, grad=True)
    tak.fused_attention_vjp("time", *args).float().sum().backward()
    for i, (name, t) in enumerate(zip(ATT_ORDER, args)):
        if i in ATT_DIFF:
            assert t.grad is not None and t.grad.dtype == torch.bfloat16, name
        else:
            assert t.grad is None, name        # t_q, t_k, key_len
    # outside time mode only q, k and v get a gradient: the output does
    # not depend on tqw, rawk or the gate params there
    dm = torch.tensor(a["dm"], requires_grad=True)
    args = _torch_att(a, torch.float32, grad=True)
    tak.fused_attention_vjp("plain_drop", *args, dm).sum().backward()
    assert dm.grad is None
    for i, (name, t) in enumerate(zip(ATT_ORDER, args)):
        assert (t.grad is not None) == (i in (0, 1, 2)), name


def test_attention_wrappers_check_the_mask():
    args = _torch_att(_self_att_inputs(), torch.float32)
    with pytest.raises(ValueError, match="dm"):
        tak.fused_attention("plain_drop", *args)
    dm = torch.ones((B, TL, TL))
    with pytest.raises(ValueError, match="only the"):
        tak.fused_attention("plain", *args, dm)
    with pytest.raises(ValueError, match="dm"):
        tak.fused_attention("tisas_drop", *args, dm.to(torch.bfloat16))
    with pytest.raises(ValueError, match="g must be"):
        tak.fused_attention_bwd("time", torch.ones((B, TL, D + 1)), *args)
