"""The blockwise attention kernel's split design at Tq = 1, held on the
CPU through its arithmetic composed in plain PyTorch.

On the card `fused_attention_blockwise` at Tq = 1 (MTAM's serving hops
past 1024 keys) takes the "split" design of
csrc/fused_attention_blockwise.cu: each row's keys in splits of
`SPLIT_KEYS` keys, a block each, which write the split's max m_s, its
sum l_s of the unrounded p = exp(s - m_s) and acc_s = sum round(p) v; a
second launch merges a row's splits in order.  chip_smoke.py holds the
kernel against the plain twin `fused_attention_blockwise_plain` there.
Here `_split_design_plain`, the same steps in plain PyTorch, is held
against that twin and against JAX's `fused_attention`
(`_attn_kernel_blockwise`, Pallas in interpret mode) on the same numpy
inputs: Tq = 1, Tk = 1100 (five 256-key splits, the last ragged), d =
16, f32 and bf16, the three modes.  Rows: every key live; no live key;
live keys ending inside the first split (100), so that its other four
splits lie wholly past them; 300 live keys (a split boundary inside the
Pallas kernel's first 512-key block); 600 (one past its first block).
The row with no live key takes its Tk keys at weight 1/Tk in the port,
while the Pallas kernel pads Tk to a multiple of 512 and spreads the
weight over the padding too (tests/test_torch_blockwise.py): it is held
against the twin and left out of the comparison with JAX.

Tolerances, of the largest |value|: f32 1e-5 (p is not rounded; where
the max moves only changes float rounding); bf16 5e-3, as
tests/test_torch_blockwise_design.py holds the tiled design (each side
rounds p to bf16 against its own max: the split's here, the running max
of the 512-key block in the Pallas kernel and the twin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import attention_kernel as pk
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

D, TK = 16, 1100
KEY_LEN = (TK, 0, 100, 300, 600)
NO_LIVE = 1
REL = {"float32": 1e-5, "bfloat16": 5e-3}
MODES = ("plain", "time", "tisas")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, key_len=KEY_LEN, tk=TK):
    """q, k, v, t_q, t_k, tqw, rawk, five [1, Tk] gate params (numpy
    f32), key_len (int32): a query an hour after each row's last key."""
    r = np.random.RandomState(seed)
    b = len(key_len)
    hours = np.sort(r.rand(b, tk).astype(np.float32) * 3000, axis=1)
    arrays = [r.randn(b, 1, D), r.randn(b, tk, D), r.randn(b, tk, D),
              hours[:, -1:] + 1.0, hours, r.randn(b, 1, D) * 0.3,
              r.randn(b, tk, D)]
    arrays += [r.randn(1, tk) * 0.3 for _ in range(5)]
    return ([np.asarray(a, np.float32) for a in arrays]
            + [np.array(key_len, np.int32)])


def _torch(arrays, dtype):
    return [torch.tensor(a).to(dtype) for a in arrays[:-1]] \
        + [torch.tensor(arrays[-1])]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


@pytest.mark.parametrize("d", [8, 16, 100, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tq1_takes_the_split_design(dtype, d):
    assert tak.blockwise_design(dtype, 1, d) == "split"
    assert "split" in tak.BLOCKWISE_DESIGNS


def test_split_length_is_one_constant():
    """One length for every batch and Tk: a row's bits do not depend on
    the rows beside it.  At B=64, Tk=2048 that is 8 splits a row, 512
    blocks; a split fits the kernel's limit."""
    assert tak.SPLIT_KEYS == 256 <= tak.SPLIT_MAX_KEYS
    assert 64 * -(-2048 // tak.SPLIT_KEYS) >= 256


@pytest.mark.parametrize("design,split", [("wgmma", None), ("tiles", None),
                                          ("mma", None), ("regtile", None),
                                          ("split", 0), ("split", 1025)])
def test_unknown_design_or_split_refused_before_any_build(no_build, design,
                                                          split):
    args = _torch(_inputs(0), torch.float32)
    with pytest.raises(ValueError, match="does not take|a split takes"):
        tak._launch_blockwise("time", *args, _design=design, _split=split)


def test_split_design_refused_past_tq1(no_build):
    arrays = _inputs(1)
    args = _torch(arrays, torch.bfloat16)
    args[0] = args[0].expand(-1, 2, -1).contiguous()
    with pytest.raises(ValueError, match="does not take"):
        tak._launch_blockwise("plain", *args, _design="split")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_split_and_merge_matches_twin_and_pallas(dname, mode):
    dtype, jdtype = DTYPES[dname]
    arrays = _inputs(seed=len(mode) + 7 * (dname == "bfloat16"))
    args = _torch(arrays, dtype)
    got = tak._split_design_plain(mode, *args)
    assert got.dtype == torch.float32 and got.shape == (len(KEY_LEN), 1, D)
    assert bool(torch.isfinite(got).all())
    twin = tak.fused_attention_blockwise_plain(mode, *args)
    assert _rel(got.numpy(), twin.numpy()) <= REL[dname]
    # the row with no live key: the mean of its Tk value rows
    mean = args[2][NO_LIVE].float().mean(0)
    assert _rel(got[NO_LIVE, 0].numpy(), mean.numpy()) <= REL[dname]
    want = np.asarray(pk.fused_attention(
        mode, *[jnp.asarray(a, jdtype) for a in arrays[:-1]],
        jnp.asarray(arrays[-1]), pk.dm_dummy(jdtype)), np.float32)
    live = [r for r, n in enumerate(KEY_LEN) if n > 0]
    assert _rel(got.numpy()[live], want[live]) <= REL[dname]


@pytest.mark.parametrize("split", [64, 100, 256, 1024])
def test_splits_wholly_past_the_live_keys_add_nothing(split):
    """A split at or past the keys the weights reach has m = -inf, l = 0:
    the merge skips it.  The row ending inside the first split gives the
    same result at every split length, and that of one split of its own
    live keys."""
    arrays = _inputs(seed=3)
    args = _torch(arrays, torch.float32)
    got = tak._split_design_plain("time", *args, split=split)
    alone = tak._split_design_plain("time", *args, split=TK)
    np.testing.assert_allclose(got.numpy(), alone.numpy(), rtol=0,
                               atol=1e-6 * alone.abs().max().item())


def test_cpu_tensors_take_the_twin_and_launch_nothing():
    args = _torch(_inputs(5), torch.bfloat16)
    before = dict(tak.blockwise_split_launches)
    got = tak.fused_attention_blockwise("time", *args)
    assert torch.equal(got, tak.fused_attention_blockwise_plain("time", *args))
    assert tak.blockwise_split_launches == before
