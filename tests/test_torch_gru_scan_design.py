"""The GRU scan forward's designs: the names, the route by width, and
the plain twin over a long chain at the narrowest kernel width.

The CUDA kernel runs only on the card (chip_smoke.py holds both designs
against `gru_scan_plain` there); here the route and the checks before a
build are pure Python, and `gru_scan` on CPU tensors runs the twin,
which is held against the JAX package's Pallas scan in interpret mode.

Tolerances, as tests/test_torch_kernels.py states them: atol 1e-5 in
f32 (both sides sum f32 products, in different orders), and in bf16 too,
since both carry the state in f32 and round only the product operands,
while JAX's jnp scan, which carries the state in bf16, sits far away.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import gru_kernel as jgk
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as tgk

torch.set_num_threads(2)

ATOL = 1e-5
ORDER = ("gate_x", "cand_x", "e1", "e2", "lengths", "h0", "w_gate_h",
         "w_cand_h", "b_gate", "b_cand", "cell_vecs")


def _inputs(b, seq, u, lengths, seed):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return {
        "gate_x": f(b, seq, 2 * u, scale=0.8), "cand_x": f(b, seq, u, scale=0.8),
        "e1": f(b, seq, u, scale=0.5), "e2": np.abs(f(b, seq, u, scale=0.5)),
        "lengths": np.array(lengths, np.int32), "h0": f(b, u, scale=0.5),
        "w_gate_h": f(u, 2 * u, scale=1 / np.sqrt(u)),
        "w_cand_h": f(u, u, scale=1 / np.sqrt(u)),
        "b_gate": f(2 * u, scale=0.1), "b_cand": f(u, scale=0.1),
        "cell_vecs": f(4, u, scale=0.5),
    }


def _jax(a, dtype):
    return [jnp.asarray(a[k]) if k == "lengths" else jnp.asarray(a[k], dtype)
            for k in ORDER]


def _torch(a, dtype):
    return [torch.tensor(a[k]) if k == "lengths"
            else torch.tensor(a[k]).to(dtype) for k in ORDER]


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


def test_gru_scan_design_is_checked_before_any_build(no_build):
    args = _torch(_inputs(2, 3, 32, [3, 1], seed=0), torch.float32)
    with pytest.raises(ValueError, match="design"):
        tgk._launch("tgru", *args, _design="simt")
    assert tgk.FWD_DESIGNS[0] == "sliced"     # the default
    assert set(tgk.FWD_DESIGNS) == {"sliced", "unit_column"}


@pytest.mark.parametrize("u", [32, 64, 96, 128])
def test_fwd_design_slices_every_width_up_to_128(u):
    assert tgk.fwd_design(u) == "sliced"


def test_fwd_design_keeps_unit_column_past_128(no_build):
    # u = 160 fits in shared memory in bf16 only; it keeps the earlier
    # design, and forcing the sliced design there is refused before any
    # build
    assert tgk.fwd_design(160) == "unit_column"
    args = _torch(_inputs(1, 2, 160, [2], seed=1), torch.bfloat16)
    with pytest.raises(ValueError, match="sliced"):
        tgk._launch("tgru", *args, _design="sliced")


# u = 32 is the narrowest width the kernel takes (8 values of k a slice);
# 200 steps carry h through a long chain; the rows cover an empty
# history, one step and the full length
LONG_B, LONG_L, LONG_U = 3, 200, 32
LONG_LENGTHS = [0, 1, LONG_L]


@pytest.mark.parametrize("mode", tgk.MODES)
def test_gru_scan_long_chain_matches_jax_f32(mode):
    a = _inputs(LONG_B, LONG_L, LONG_U, LONG_LENGTHS, seed=21)
    want = np.asarray(jgk.gru_scan(mode, *_jax(a, jnp.float32)))
    got = tgk.gru_scan(mode, *_torch(a, torch.float32))
    assert got.dtype == torch.float32
    assert got.shape == (LONG_B, LONG_L, LONG_U)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    for b, n in enumerate(LONG_LENGTHS):
        assert not got[b, n:].any()      # zero past each row's length


@pytest.mark.parametrize("mode", tgk.MODES)
def test_gru_scan_long_chain_bf16_carries_state_in_f32(mode):
    a = _inputs(LONG_B, LONG_L, LONG_U, LONG_LENGTHS, seed=22)
    want = np.asarray(jgk.gru_scan(mode, *_jax(a, jnp.bfloat16)), np.float32)
    bf16_carry = np.asarray(
        jgk._reference_scan(mode, *_jax(a, jnp.bfloat16)).astype(jnp.float32))
    got = tgk.gru_scan(mode, *_torch(a, torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the jnp scan's bf16 carry is a different (coarser) computation
    assert np.abs(got.numpy() - bf16_carry).max() > 100 * ATOL
