"""The blockwise attention kernel's designs, and what holds the tiled
ones.

On the card, `fused_attention_blockwise` launches one of four designs of
csrc/fused_attention_blockwise.cu, picked by shape in
`blockwise_design`: at Tq = 1 each row's keys split across blocks
("split", held in tests/test_torch_blockwise_split.py); for Tq > 1 and d
a multiple of 16 up to 128, tensor-core tiles ("mma", bf16) or register
tiles ("regtile", f32); FMA from shared memory ("simt") everywhere else.  chip_smoke.py holds the
tiled designs against the plain twin, `fused_attention_blockwise_plain`;
here that twin, at Tq = 80 (a 64-query tile and a ragged one) and Tk =
1100 (two full 512-key blocks and a ragged third), is held against the
JAX `fused_attention` (`_attn_kernel_blockwise`, Pallas in interpret
mode) on the same numpy inputs, in the three modes: in bf16 as the mma
design rounds, and in f32 with the max moved every 64 keys, as the
register-tiled design moves it.

Rows: one full, one whose live keys end inside the first 512-key block,
one with no live key, which the two packages treat differently by design
(tests/test_torch_blockwise.py::test_key_len_zero_row_both_ways) and is
left out of the comparison.  Tolerances: 5e-3 of the largest |value| in
bf16 (both round each block's exp(s - m) to bf16 before @ v), 1e-5 in
f32 (p is not rounded; the block size moves float rounding only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import attention_kernel as pk
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak

torch.set_num_threads(2)

D = 16
REL_F32, REL_BF16 = 1e-5, 5e-3
MODES = ("plain", "time", "tisas")


def _inputs(tq, tk, seed):
    """q, k, v, t_q, t_k, tqw, rawk, five [Tq, Tk] gate params, key_len:
    numpy f32 (key_len int32) for three rows: full, 300 live keys, none."""
    r = np.random.RandomState(seed)
    b = 3
    hours = np.sort(r.rand(b, tk).astype(np.float32) * 3000, axis=1)
    t_q = np.sort(r.rand(b, tq).astype(np.float32) * 3000, axis=1)
    arrays = [r.randn(b, tq, D), r.randn(b, tk, D), r.randn(b, tk, D),
              t_q, hours, r.randn(b, tq, D) * 0.3, r.randn(b, tk, D)]
    arrays += [r.randn(tq, tk) * 0.3 for _ in range(5)]
    return ([np.asarray(a, np.float32) for a in arrays]
            + [np.array([tk, 300, 0], np.int32)])


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("d", [8, 48, 128, 256])
@pytest.mark.parametrize("tq", [1, 2, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blockwise_design_by_shape(dtype, tq, d):
    want = "split" if tq == 1 else "simt"
    if tq > 1 and d in (48, 128):
        want = "mma" if dtype == torch.bfloat16 else "regtile"
    assert tak.blockwise_design(dtype, tq, d) == want


@pytest.mark.parametrize("mode", MODES)
def test_bf16_twin_matches_pallas_past_one_query_tile(mode):
    tq, tk = 80, 1100
    arrays = _inputs(tq, tk, seed=11)
    targs = [torch.tensor(a).to(torch.bfloat16) for a in arrays[:-1]]
    assert tak.blockwise_design(torch.bfloat16, tq, D) == "mma"
    got = tak.fused_attention_blockwise_plain(
        mode, *targs, torch.tensor(arrays[-1])).numpy()
    want = np.asarray(pk.fused_attention(
        mode, *[jnp.asarray(a, jnp.bfloat16) for a in arrays[:-1]],
        jnp.asarray(arrays[-1]), pk.dm_dummy(jnp.bfloat16)))
    assert got.shape == want.shape == (3, tq, D)
    live = [0, 1]
    assert _rel(got[live], want[live]) <= REL_BF16


@pytest.mark.parametrize("mode", MODES)
def test_f32_twin_at_64_key_blocks_matches_pallas(mode):
    """The register-tiled design moves the max every 64 keys, the Pallas
    kernel every 512: in f32, where p is not rounded, that moves float
    rounding only.  The twin at 64-key blocks against Pallas."""
    tq, tk = 80, 1100
    arrays = _inputs(tq, tk, seed=14)
    targs = [torch.tensor(a) for a in arrays[:-1]]
    assert tak.blockwise_design(torch.float32, tq, D) == "regtile"
    got = tak.fused_attention_blockwise_plain(
        mode, *targs, torch.tensor(arrays[-1]), key_block=64).numpy()
    want = np.asarray(pk.fused_attention(
        mode, *[jnp.asarray(a) for a in arrays[:-1]],
        jnp.asarray(arrays[-1]), pk.dm_dummy(jnp.float32)))
    assert got.shape == want.shape == (3, tq, D)
    live = [0, 1]
    assert _rel(got[live], want[live]) <= REL_F32


@pytest.mark.parametrize("dtype,tq,d,design", [
    (torch.float32, 8, D, "mma"), (torch.bfloat16, 1, D, "mma"),
    (torch.bfloat16, 8, D, "wgmma"), (torch.bfloat16, 8, D, "regtile"),
    (torch.float32, 1, D, "regtile"), (torch.float32, 8, 8, "regtile")])
def test_launch_refuses_a_design_the_shape_does_not_take(dtype, tq, d,
                                                         design):
    """Only chip_smoke.py forces a design, and "mma" or "regtile" only
    where `blockwise_design` picks it; the refusal comes before any
    launch."""
    arrays = _inputs(tq, 1100, seed=12)
    for i in (0, 1, 2, 5, 6):                 # q k v tqw rawk: d columns
        arrays[i] = np.ascontiguousarray(arrays[i][..., :d])
    args = [torch.tensor(a).to(dtype) for a in arrays[:-1]]
    with pytest.raises(ValueError, match="does not take"):
        tak._launch_blockwise("plain", *args, torch.tensor(arrays[-1]),
                              _design=design)


def test_cpu_tensors_take_the_twin_and_launch_nothing():
    arrays = _inputs(80, 1100, seed=13)
    counters = (tak.blockwise_launches, tak.blockwise_mma_launches,
                tak.blockwise_regtile_launches)
    before = [dict(c) for c in counters]
    for dtype in (torch.bfloat16, torch.float32):
        args = [torch.tensor(a).to(dtype) for a in arrays[:-1]]
        for mode in MODES:
            got = tak.fused_attention_blockwise(mode, *args,
                                                torch.tensor(arrays[-1]))
            want = tak.fused_attention_blockwise_plain(
                mode, *args, torch.tensor(arrays[-1]))
            assert torch.equal(got, want)
    assert [dict(c) for c in counters] == before
