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


def test_gru_scan_bwd_plain_matches_jax_bf16():
    a = _gru_inputs(seed=5)
    g = _cotangent(seed=6)
    jargs = _as_jax(a, jnp.bfloat16)
    outs = jgk.gru_scan("tgru", *jargs)
    want = jgk.gru_scan_bwd("tgru", jnp.asarray(g), outs, *jargs)
    targs = _as_torch(a, torch.bfloat16)
    got = tgk.gru_scan_bwd("tgru", torch.tensor(g),
                           tgk.gru_scan("tgru", *targs), *targs)
    for i, name in enumerate(GRAD_NAMES):
        w = np.asarray(want[i], np.float32)
        err = np.abs(got[i].numpy() - w).max()
        assert err <= REL_BWD_BF16 * np.abs(w).max(), (name, err)


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
    before = (dict(tgk.bwd_launches), dict(tek.launches))
    args = [t.requires_grad_(True) if t.is_floating_point() else t
            for t in _as_torch(_gru_inputs(), torch.float32)]
    tgk.gru_scan_vjp("tgru", *args).sum().backward()
    table, ids, _ = _dtable_inputs()
    tt = torch.tensor(table, requires_grad=True)
    tek.take_dtable(tt, torch.tensor(ids)).sum().backward()
    assert (tgk.bwd_launches, tek.launches) == before
