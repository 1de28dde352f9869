"""The GRU pair and the table gradients at widths their kernels are not
built for: the zero padding their CUDA wrappers apply, held on the CPU.

On the card `gru_scan` and `gru_scan_bwd` run a width-u scan at
`gru_kernel.kernel_width(u)` (u rounded up to a multiple of 32, at least
32) on operands that `_pad_gru_operands` zero-pads, each half of the
[r | u] gate axis on its own, and `_slice_gru_grads` cuts the cotangents
back; `dtable` and `scatter_add` pad the cotangent's d to the next of
`KERNEL_WIDTHS` and slice the table gradient.  Those helpers are plain
functions on tensors, so here the composition pad -> twin at the padded
width -> slice is held against the twin at the native width and against
the JAX package, on inputs made with numpy from a seed: u = 16 and 48,
f32 and bf16, all three cell modes, lengths 0, 1, L and ragged; d = 16,
48 and 96.

Tolerances: the padded twin against the native one 1e-6 absolute for the
GRU pair (a padded unit adds exact zeros to each product; the products'
f32 sums may run in another order at the other width) and bit-equal for
the table gradients (a column's sum reads no other column).  Against
JAX those of tests/test_torch_kernels.py: the scan and, in f32, its
backward to atol 1e-5 against the Pallas kernels in interpret mode; the
bf16 backward to 1e-3 of each output's largest |value|.  The table
gradients against `jax.vjp` of `jnp.take`: f32 within 1e-5 of the
largest |value| (the same numbers summed in another order); in bf16
`dtable` (f32 sums, rounded once) within one bf16 ulp of the f32 vjp
rounded once, and `scatter_add` (rounded after every add) within one ulp
of JAX's sequential Pallas `_scatter_add_impl`, as
tests/test_torch_dtable.py and tests/test_torch_gather.py hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mtamrecommender_tpu.ops.pallas import embedding_kernel as jek
from mtamrecommender_tpu.ops.pallas import gru_kernel as jgk
from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as tek
from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as tgk

torch.set_num_threads(2)

B, L = 4, 9
LENGTHS = [0, 1, L, 5]
PAD_ATOL = 1e-6
JAX_ATOL = 1e-5
REL_BWD_BF16 = 1e-3
ORDER = ("gate_x", "cand_x", "e1", "e2", "lengths", "h0", "w_gate_h",
         "w_cand_h", "b_gate", "b_cand", "cell_vecs")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _gru_inputs(u, seed):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return {
        "gate_x": f(B, L, 2 * u, scale=0.8), "cand_x": f(B, L, u, scale=0.8),
        "e1": f(B, L, u, scale=0.5), "e2": np.abs(f(B, L, u, scale=0.5)),
        "lengths": np.array(LENGTHS, np.int32), "h0": f(B, u, scale=0.5),
        "w_gate_h": f(u, 2 * u, scale=1 / np.sqrt(u)),
        "w_cand_h": f(u, u, scale=1 / np.sqrt(u)),
        "b_gate": f(2 * u, scale=0.1), "b_cand": f(u, scale=0.1),
        "cell_vecs": f(4, u, scale=0.5)}


def _torch(a, dtype):
    return [torch.tensor(a[k]) if k == "lengths"
            else torch.tensor(a[k]).to(dtype) for k in ORDER]


def _jax(a, dtype):
    return [jnp.asarray(a[k]) if k == "lengths" else jnp.asarray(a[k], dtype)
            for k in ORDER]


@pytest.mark.parametrize("u,width", [(16, 32), (48, 64), (32, 32),
                                     (100, 128), (129, 160)])
def test_kernel_width(u, width):
    assert tgk.kernel_width(u) == width


def test_padding_keeps_each_gate_half_in_place():
    """The update gate's columns of the padded [r | u] axes start at the
    padded width: padding the 2u axis at its end would move them."""
    u, width = 16, 32
    args = _torch(_gru_inputs(u, seed=0), torch.float32)
    padded = tgk._pad_gru_operands(width, *args)
    gx, wgh, bg = padded[0], padded[6], padded[8]
    assert gx.shape == (B, L, 2 * width) and wgh.shape == (width, 2 * width)
    for got, src in ((gx, args[0]), (wgh[:u], args[6]), (bg, args[8])):
        assert torch.equal(got[..., :u], src[..., :u])
        assert torch.equal(got[..., width:width + u], src[..., u:])
        assert not got[..., u:width].any() and not got[..., width + u:].any()
    assert not wgh[u:].any()


@pytest.mark.parametrize("mode", tgk.MODES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("u", [16, 48])
def test_padded_scan_and_backward_match_native_and_jax(u, dname, mode):
    dtype, jdtype = DTYPES[dname]
    a = _gru_inputs(u, seed=u + len(mode))
    g = np.random.RandomState(u).randn(B, L, u).astype(np.float32)
    args = _torch(a, dtype)
    width = tgk.kernel_width(u)
    padded = tgk._pad_gru_operands(width, *args)
    out_w = tgk.gru_scan_plain(mode, *padded)
    assert not out_w[..., u:].any()          # a padded unit's h stays 0
    out = out_w[..., :u]
    native = tgk.gru_scan_plain(mode, *args)
    np.testing.assert_allclose(out.numpy(), native.numpy(), atol=PAD_ATOL,
                               rtol=0)
    jargs = _jax(a, jdtype)
    jouts = jgk.gru_scan(mode, *jargs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jouts, np.float32),
                               atol=JAX_ATOL, rtol=0)
    for b, n in enumerate(LENGTHS):
        assert not out[b, n:].any()

    pad = (0, width - u)
    grads_w = tgk.gru_scan_bwd_plain(mode, F.pad(torch.tensor(g), pad),
                                     F.pad(native, pad), *padded)
    grads = tgk._slice_gru_grads(u, *grads_w)
    want = tgk.gru_scan_bwd_plain(mode, torch.tensor(g), native, *args)
    jwant = jgk.gru_scan_bwd(mode, jnp.asarray(g), jouts, *jargs)
    for got, nat, jw in zip(grads, want, jwant):
        jw = np.asarray(jw, np.float32)
        assert got.shape == nat.shape == jw.shape
        np.testing.assert_allclose(got.numpy(), nat.numpy(), atol=PAD_ATOL,
                                   rtol=0)
        if dname == "float32":
            np.testing.assert_allclose(got.numpy(), jw, atol=JAX_ATOL, rtol=0)
        else:
            err = np.abs(got.numpy() - jw).max()
            assert err <= REL_BWD_BF16 * max(np.abs(jw).max(), 1e-30)


# ------------------------------------------------------- table gradients

VOCAB, N_IDS = 70, 400
BF16_ULP = 2.0 ** -7


def _ids_and_ct(d, dtype, seed):
    """Ids with repeats (id 3 in every fifth slot) and rows no id names."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, 60, N_IDS).astype(np.int32)
    ids[::5] = 3
    ct = r.randn(N_IDS, d).astype(np.float32)
    return ids, torch.tensor(ct).to(dtype)


@pytest.mark.parametrize("d,width", [(16, 32), (48, 64), (96, 128),
                                     (200, 256), (32, 32)])
def test_table_kernel_width(d, width):
    assert tek.kernel_width("dtable", d) == width


def test_table_kernel_width_past_256_raises():
    with pytest.raises(ValueError, match="up to 256"):
        tek.kernel_width("scatter_add", 257)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48, 96])
def test_padded_dtable_matches_native_and_jax(d, dname):
    dtype, _ = DTYPES[dname]
    ids, ct = _ids_and_ct(d, dtype, seed=d)
    tids = torch.tensor(ids)
    width = tek.kernel_width("dtable", d)
    padded = tek.dtable_plain(tek._pad_columns(ct, width), tids, VOCAB)
    assert not padded[:, d:].any()
    got = padded[:, :d]
    assert torch.equal(got, tek.dtable_plain(ct, tids, VOCAB))
    take = np.asarray(jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids), axis=0),
                              jnp.zeros((VOCAB, d), jnp.float32))[1](
        jnp.asarray(ct.float().numpy()))[0])
    got = got.float().numpy()
    scale = np.abs(take).max()
    if dname == "float32":
        np.testing.assert_allclose(got, take, atol=1e-5 * scale, rtol=0)
    else:
        once = torch.tensor(take).to(torch.bfloat16).float().numpy()
        assert np.all(np.abs(got - once)
                      <= BF16_ULP * np.abs(once) + 1e-5 * scale)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48, 96])
def test_padded_scatter_add_matches_native_and_jax(d, dname):
    dtype, jdtype = DTYPES[dname]
    ids, ct = _ids_and_ct(d, dtype, seed=d + 1)
    tids = torch.tensor(ids)
    width = tek.kernel_width("scatter_add", d)
    padded = tek.scatter_add_plain(tek._pad_columns(ct, width), tids, VOCAB)
    assert not padded[:, d:].any()
    got = padded[:, :d]
    assert torch.equal(got, tek.scatter_add_plain(ct, tids, VOCAB))
    got = got.float().numpy()
    if dname == "float32":
        take = np.asarray(jax.vjp(
            lambda t: jnp.take(t, jnp.asarray(ids), axis=0),
            jnp.zeros((VOCAB, d), jnp.float32))[1](
                jnp.asarray(ct.numpy()))[0])
        np.testing.assert_allclose(got, take,
                                   atol=1e-5 * np.abs(take).max(), rtol=0)
    else:
        want = np.asarray(jek._scatter_add_impl(
            jnp.asarray(ct.float().numpy(), jdtype), jnp.asarray(ids), VOCAB),
            np.float32)
        mag = np.abs(want)
        ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(
            np.where(mag > 0, mag, 1))) - 7), 0.0)
        assert (np.abs(got - want) <= ulp).all()
