"""The chain readout pair's blocked design, held on the CPU through its
arithmetic composed in plain PyTorch, and MTAM's training step at the
reference's 150-event cap against JAX.

On the card `readout_chain` and `readout_chain_bwd` with 65 <= L <= 256
keys and d a multiple of 16 up to 128 take the "blocked" design of
csrc/readout_chain.cu and csrc/readout_chain_bwd.cu: a block a batch row
streams each hop's K and tprec rows of the live keys and V rows of the
reached keys through a ring of shared-memory slots, 64 keys a slot; the
score dots a half-warp a key into an f32 strip of all L keys, the
softmax over the strip, the key sums by the 16 key slices h, h+16, ...
taken in key order across the blocks (the backward reads V and K with
tprec twice a hop).  chip_smoke.py's phases 2f and 14 hold the kernels
against the plain twins there.  Here `_blocked_fwd_design_plain` and
`_blocked_bwd_design_plain`, those steps in plain PyTorch, are held
against the twins and against JAX's `_chain_fwd` / `_chain_bwd_impl`
(the Pallas kernels in interpret mode) on the same numpy inputs: f32 and
bf16, (L, d) = (65, 16), (150, 128), (255, 64), positional and scalar
(constant) wo2 rows, ragged key lengths with a full row and a
query-masked row, and at 1, 3 and 6 hops (NARM+'s, MTAM's and
MTAM_with_T_SeqRec's readouts) at (L, d) = (65, 16) (bf16 against the
Pallas pair at 3 hops only); a row with no live key against the twins (and the
Pallas forward; the Pallas backward gives that row a score gradient
where the jnp reference gives none, tests/test_torch_chain_bwd_design.py).
The routing, the refusals before any build and the launch counters
use a stand-in library.  Then one MTAM training step at L=150, d=16
through the port's CPU path (the twins, and again with the blocked
design's compositions in their place) against JAX's step on its jnp
route and on its chain-kernel route (`READOUT_CHAIN_OPT_IN`, the Pallas
chain in interpret mode, the GRU on jnp).

Tolerances, of each output's largest |value|: f32 1e-5 (f32 sums in
other orders); bf16 2e-2, as the staged design's tests hold it.  The
step: the loss terms within 1e-5, every f32 gradient leaf within 1e-5 of
its largest |value| against the jnp route and 1e-4 against the chain
route (tests/test_torch_readout_chain_paths.py's rule), save the
position table's padding row, 1e-4 (it sums the batch's 606 padded
slots in another order than JAX's scatter).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_chain_bwd_design as bwd_design
import test_torch_chain_fwd_design as fwd_design
import torch_zoo_parity as zp
from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu.ops.pallas import flags as pallas_flags
from mtamrecommender_tpu.ops.pallas import readout_chain_kernel as jrc
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as trc

from helpers import make_batch

torch.set_num_threads(2)

REL = fwd_design.REL
SHAPES = ((65, 16), (150, 128), (255, 64))
_inputs, _as_jax, _as_torch = (fwd_design._inputs, fwd_design._as_jax,
                               fwd_design._as_torch)


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tk", [1, 64, 65, 150, 255, 256])
@pytest.mark.parametrize("d", [16, 48, 128, 40])
def test_blocked_design_predicate(dtype, tk, d):
    """"staged" up to 64 keys, "blocked" from 65 to 256, both at d a
    multiple of 16; "rows" at any other d; the pair alike."""
    want = ("rows" if d % 16 else "staged" if tk <= trc.STAGED_KEYS
            else "blocked")
    assert trc.chain_fwd_design(dtype, tk, d) == want
    assert trc.chain_bwd_design(dtype, tk, d) == want
    assert trc.FWD_DESIGNS.index("blocked") == 1 == \
        trc.BWD_DESIGNS.index("blocked")


# the forward design tests' fixture: a build reached fails the test
no_build = fwd_design.no_build


@pytest.mark.parametrize("tk,d", [(50, 128), (64, 16), (150, 40), (255, 8)])
def test_forced_blocked_outside_its_range_refused_before_any_build(
        no_build, tk, d):
    with pytest.raises(ValueError, match="does not take"):
        trc._launch(fwd_design._meta_like(tk, d), _design="blocked")
    g, args, curs = bwd_design._meta_like(tk, d)
    with pytest.raises(ValueError, match="does not take"):
        trc._launch_bwd(g, args, curs, _design="blocked")


@pytest.mark.parametrize("operand", ["k_all", "v_all", "tprec", "wq"])
def test_forced_blocked_misaligned_refused_before_any_build(
        no_build, operand):
    args = list(fwd_design._meta_like(150, 128))
    i = trc._OPERANDS.index(operand)
    args[i] = fwd_design._shifted(args[i])
    with pytest.raises(ValueError, match="blocked design takes .* 16-byte"):
        trc._launch(tuple(args), _design="blocked")
    g, bargs, curs = bwd_design._meta_like(150, 128)
    bargs = list(bargs)
    bargs[i - 1] = fwd_design._shifted(bargs[i - 1])
    with pytest.raises(ValueError, match="blocked design takes .* 16-byte"):
        trc._launch_bwd(g, tuple(bargs), curs, _design="blocked")


@pytest.mark.parametrize("tk,d,forced,misaligned,design", [
    (150, 128, None, None, "blocked"), (65, 16, None, None, "blocked"),
    (255, 64, None, None, "blocked"), (256, 128, None, None, "blocked"),
    (150, 128, "rows", None, "rows"), (150, 128, None, "v_all", "rows"),
    (150, 128, None, "tprec", "rows"), (150, 128, None, "gate_part",
                                        "blocked"),
    (150, 40, None, None, "rows"), (64, 128, None, None, "staged")])
def test_launch_asks_for_the_design_and_counts_it(monkeypatch, tk, d, forced,
                                                  misaligned, design):
    """Forward and backward: the launch asks the library for the design
    `chain_fwd_design` picks (the rows design where k_all, v_all, tprec
    or wq is not 16-byte aligned, decided before the launch), or the one
    forced; the counters count every launch, the blocked design's and
    the rows design's apart."""
    fwd_lib, bwd_lib = fwd_design._FakeLib(), bwd_design._FakeLib()
    monkeypatch.setattr(trc, "_library", lambda: fwd_lib)
    monkeypatch.setattr(trc, "_bwd_library", lambda: bwd_lib)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    args = list(fwd_design._meta_like(tk, d))
    g, bargs, curs = bwd_design._meta_like(tk, d)
    bargs = list(bargs)
    if misaligned:
        i = trc._OPERANDS.index(misaligned)
        args[i] = fwd_design._shifted(args[i])
        bargs[i - 1] = fwd_design._shifted(bargs[i - 1])
    before = (trc.launches, trc.blocked_launches, trc.rows_launches,
              trc.bwd_launches, trc.bwd_blocked_launches,
              trc.bwd_rows_launches)
    out, curs_out = trc._launch(tuple(args), _design=forced)
    grads = trc._launch_bwd(g, tuple(bargs), curs, _design=forced)
    assert fwd_lib.designs == [trc.FWD_DESIGNS.index(design)]
    assert bwd_lib.designs == [trc.BWD_DESIGNS.index(design)]
    blocked, rows = int(design == "blocked"), int(design == "rows")
    assert (trc.launches, trc.blocked_launches, trc.rows_launches,
            trc.bwd_launches, trc.bwd_blocked_launches,
            trc.bwd_rows_launches) == (
        before[0] + 1, before[1] + blocked, before[2] + rows,
        before[3] + 1, before[4] + blocked, before[5] + rows)
    assert tuple(out.shape) == (4, d) and tuple(curs_out.shape) == (3, 4, d)
    assert [tuple(x.shape) for x in grads[1:5]] == [
        (3, 4, tk, d), (3, 4, tk, d), (3, 4, tk, d), (3, 4, tk)]


# ------------------------------------------------------------ the model

def _pallas_bwd(g, ins, dname, jcurs):
    return jrc._chain_bwd_impl(jnp.asarray(g, jnp.dtype(dname)),
                               *_as_jax(ins, dname)[1:], jcurs)


@pytest.mark.parametrize("gate_mode", ["positional", "scalar"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("tk,d", SHAPES)
def test_blocked_design_matches_twins_and_pallas(tk, d, dname, gate_mode):
    """Every row, forward and backward: the compositions against the
    twins in the same dtype and against JAX's Pallas pair in interpret
    mode on the same inputs (the backward from JAX's hop-input chain);
    the masked query's row gets no score gradient."""
    ins = _inputs(tk, d, gate_mode, seed=3 * tk + d + len(gate_mode))
    args = _as_torch(ins, dname)
    got = trc._blocked_fwd_design_plain(*args)
    assert got[0].dtype == getattr(torch, dname)
    fwd_design._hold(got, trc.readout_chain_plain(*args), dname, "twin")
    jargs = _as_jax(ins, dname)
    jout, jcurs = jrc._chain_fwd(*jargs)
    fwd_design._hold(got, [np.asarray(jout, np.float32),
                           np.asarray(jcurs, np.float32)], dname, "pallas")
    b = len(ins["klen"])
    g = np.random.RandomState(tk + d).randn(b, d).astype(np.float32)
    tg = torch.tensor(g).to(getattr(torch, dname))
    curs = torch.tensor(np.asarray(jcurs))
    grads = trc._blocked_bwd_design_plain(tg, *args[1:], curs)
    bwd_design._hold(grads, trc.readout_chain_bwd_plain(tg, *args[1:], curs),
                     dname, "twin")
    bwd_design._hold(grads, [np.asarray(x, np.float32)
                             for x in _pallas_bwd(g, ins, dname, jcurs)],
                     dname, "pallas")
    per_row = dict(zip(trc._GRADS, grads))
    assert not per_row["dk"][:, 3].float().any()
    assert not per_row["dgp"][:, 3].float().any()


# the readouts' hop counts: NARM+ / NARM++ 1, MTAM 3, MTAM_with_T_SeqRec's
# preset 6, at one blocked shape (two key blocks; SHAPES' first, whose
# Pallas pair at 3 hops is traced above)
HOP_COUNTS, HOPS_SHAPE = (1, 3, 6), (65, 16)


@pytest.mark.parametrize("gate_mode", ["positional", "scalar"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", HOP_COUNTS)
def test_blocked_design_over_hops_matches_twins_and_pallas(n, dname,
                                                           gate_mode):
    """The compositions at n hops (L=65, d=16) against the twins, f32 and
    bf16, positional and scalar wo2 rows, and against JAX's Pallas pair
    in interpret mode on the same inputs in f32 (in bf16 at 3 hops, as
    the test above): each hop's input in the chain (curs [n, B, d]) and
    every hop's cotangents [n, ...]; the masked query's row gets no
    score gradient in any hop.  (Each Pallas trace in interpret mode
    costs seconds: bf16 at 1 and 6 hops is held against the twins.)"""
    tk, d = HOPS_SHAPE
    ins = _inputs(tk, d, gate_mode, seed=7 * n + len(gate_mode), n=n)
    args = _as_torch(ins, dname)
    got = trc._blocked_fwd_design_plain(*args)
    assert tuple(got[1].shape) == (n, len(ins["klen"]), d)
    fwd_design._hold(got, trc.readout_chain_plain(*args), dname, "twin")
    pallas = dname == "float32" or n == fwd_design.N_HOPS
    b = len(ins["klen"])
    g = np.random.RandomState(n + d).randn(b, d).astype(np.float32)
    tg = torch.tensor(g).to(getattr(torch, dname))
    if pallas:
        jout, jcurs = jrc._chain_fwd(*_as_jax(ins, dname))
        fwd_design._hold(got, [np.asarray(jout, np.float32),
                               np.asarray(jcurs, np.float32)], dname,
                         "pallas")
        curs = torch.tensor(np.asarray(jcurs))
    else:
        curs = got[1]
    grads = trc._blocked_bwd_design_plain(tg, *args[1:], curs)
    assert tuple(grads[1].shape) == (n, b, tk, d)
    bwd_design._hold(grads, trc.readout_chain_bwd_plain(tg, *args[1:], curs),
                     dname, "twin")
    if pallas:
        bwd_design._hold(grads, [np.asarray(x, np.float32)
                                 for x in _pallas_bwd(g, ins, dname, jcurs)],
                         dname, "pallas")
    per_row = dict(zip(trc._GRADS, grads))
    assert not per_row["dk"][:, 3].float().any()
    assert not per_row["dgp"][:, 3].float().any()


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("tk,d", [(150, 128), (255, 64)])
def test_blocked_design_key_len_zero_row(tk, d, dname):
    """A row with no live key (row 1): a uniform softmax over all L keys,
    so V is read to L (every key block) and dv = w do there, while dk, dt
    and dgp are exactly 0.  The forward against the twin and the Pallas
    kernel, the backward against the twin."""
    ins = _inputs(tk, d, "positional", seed=5 * tk + d, with_empty=True)
    assert ins["klen"][1] == 0
    args = _as_torch(ins, dname)
    got = trc._blocked_fwd_design_plain(*args)
    fwd_design._hold(got, trc.readout_chain_plain(*args), dname, "twin")
    fwd_design._hold(got, [np.asarray(x, np.float32)
                           for x in jrc._chain_fwd(*_as_jax(ins, dname))],
                     dname, "pallas")
    b = len(ins["klen"])
    tg = torch.tensor(np.random.RandomState(d).randn(b, d).astype(
        np.float32)).to(getattr(torch, dname))
    grads = trc._blocked_bwd_design_plain(tg, *args[1:], got[1])
    bwd_design._hold(grads, trc.readout_chain_bwd_plain(tg, *args[1:],
                                                        got[1]),
                     dname, "twin")
    for i in (1, 3, 4):                              # dk, dt, dgp
        assert not grads[i][:, 1].float().any()
    assert grads[2][:, 1, tk - 1].float().abs().max() > 0   # dv at key L-1


def test_blocked_models_refuse_shapes_outside_the_design():
    for tk, d in ((64, 16), (150, 40)):
        args = _as_torch(_inputs(tk, d, "scalar", seed=1), "float32")
        with pytest.raises(ValueError, match="does not take"):
            trc._blocked_fwd_design_plain(*args)
        _, curs = trc.readout_chain(*args)
        with pytest.raises(ValueError, match="does not take"):
            trc._blocked_bwd_design_plain(
                torch.zeros(len(args[1]), d), *args[1:], curs)


@pytest.mark.parametrize("tk", [65, 150, 255])
def test_key_blocks_cover_every_key_once(tk):
    """The padded keys are whole blocks of BLOCK_KEYS; the 16 key slices
    of each block, taken block after block, visit keys l = h, h+16, ... of
    every half-warp h in key order and every key < L once."""
    keys = trc._padded_keys("blocked", tk)
    assert keys % trc.BLOCK_KEYS == 0 and keys - trc.BLOCK_KEYS < tk <= keys
    for h in range(trc.HALVES):
        taken = [k0 + h + trc.HALVES * s
                 for k0 in range(0, keys, trc.BLOCK_KEYS)
                 for s in range(trc.BLOCK_KEYS // trc.HALVES)]
        assert taken == list(range(h, keys, trc.HALVES))
    assert sorted(k for h in range(trc.HALVES)
                  for k in range(h, keys, trc.HALVES)) == list(range(keys))


# ------------------------------------------------------ MTAM's L=150 step

L150, D_STEP, HOPS_STEP = 150, 16, 3
STEP_SEQ_LENS = [1, 2, L150, 67, L150, 3, 100, 129]


def _step_cfg(use_pallas):
    return zp.ExperimentConfig().with_overrides(**{
        "model.experiment_type": "MTAM", "model.num_units": D_STEP,
        "model.num_blocks": HOPS_STEP, "model.dropout": 0.0,
        "data.max_seq_len": L150, "model.vocab_pad_multiple": 16,
        "model.use_pallas": use_pallas,
        # the Pallas route: the readout chain alone (the GRU on jnp)
        "model.pallas_scope": "attention"})


def _step_meta():
    return (jtypes.DatasetMeta(20, 60, 5, L150),
            ttypes.DatasetMeta(20, 60, 5, L150))


def _step_batch():
    jmeta, _ = _step_meta()
    jb = make_batch(jmeta, batch_size=len(STEP_SEQ_LENS), seed=15,
                    seq_lens=STEP_SEQ_LENS)
    return jb, zp.to_torch_batch(jb)


def _step_params():
    jmeta, _ = _step_meta()
    return jax.device_get(jget_model("MTAM").init(
        jax.random.PRNGKey(0), _step_cfg(False).model, jmeta))


@functools.lru_cache(maxsize=None)
def _jax_step(chain_route):
    """JAX's f32 loss terms and gradients: the jnp route, or the chain
    kernel route (READOUT_CHAIN_OPT_IN, the Pallas chain in interpret
    mode)."""
    cfg = _step_cfg(chain_route)
    jmeta, _ = _step_meta()
    jb, _ = _step_batch()
    saved = jatt.READOUT_CHAIN_OPT_IN, pallas_flags._scope
    jatt.READOUT_CHAIN_OPT_IN = chain_route
    try:
        def loss_fn(p):
            m = jbase.compute_loss(jget_model("MTAM"), p, cfg.model, jb,
                                   True, None, jmeta.item_vocab)
            return m["loss"], m

        (_, metrics), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(_step_params())
        metrics = {k: float(v) for k, v in metrics.items()}
    finally:
        # the trace set the package's kernel scope: put back what other
        # tests in this process find
        jatt.READOUT_CHAIN_OPT_IN, pallas_flags._scope = saved
    return metrics, params_from_jax(jax.device_get(grads))


@pytest.fixture
def chain_calls(monkeypatch):
    """Counts the chain twins' calls (as the kernels count launches)."""
    calls = {}
    for name in ("readout_chain_plain", "readout_chain_bwd_plain"):
        plain = getattr(trc, name)

        def run(*args, _plain=plain, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*args)
        monkeypatch.setattr(trc, name, run)
    return calls


@pytest.mark.parametrize("twins", ["plain", "blocked"])
@pytest.mark.parametrize("chain_route", [False, True], ids=["jnp", "chain"])
def test_mtam_l150_step_matches_both_jax_routes(chain_calls, monkeypatch,
                                                twins, chain_route):
    """One f32 MTAM training step at L=150 (a full row, ragged rows, a row
    whose history is empty) on the CPU: one chain forward and one
    backward (the blocked design's range), with the twins or the blocked
    design's compositions in their place; the loss terms and every
    gradient leaf against JAX's step."""
    assert trc.chain_fwd_design(torch.float32, L150, D_STEP) == "blocked"
    if twins == "blocked":
        monkeypatch.setattr(trc, "readout_chain_plain",
                            trc._blocked_fwd_design_plain)
        monkeypatch.setattr(trc, "readout_chain_bwd_plain",
                            trc._blocked_bwd_design_plain)
    _, tmeta = _step_meta()
    cfg = _step_cfg(False)
    model = load_jax_params(get_model("MTAM").init(
        torch.Generator().manual_seed(0), cfg.model, tmeta), _step_params())
    _, tb = _step_batch()
    got, tgrads = zp.port_loss_and_grads("MTAM", cfg, model, tb)
    if twins == "plain":
        assert chain_calls == {"readout_chain_plain": 1,
                               "readout_chain_bwd_plain": 1}
    want, jgrads = _jax_step(chain_route)
    for key in ("loss", "ce", "l2"):
        np.testing.assert_allclose(got[key].item(), want[key], atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    rel_grad = 1e-4 if chain_route else 1e-5
    assert set(tgrads) == set(jgrads)
    for leaf, g in tgrads.items():
        w = jgrads[leaf].numpy()
        scale = max(np.abs(w).max(), 1e-30)
        diff = np.abs(g.numpy() - w)
        if leaf == "embedding.pos_table":
            # row 0, the padding position's, sums the cotangents of the
            # batch's 606 padded slots in another order than JAX's
            # scatter: 1.2e-5 of the leaf's largest |value| apart at
            # L=150 (every other row within 3e-7), held to 1e-4
            assert diff[0].max() <= 1e-4 * scale, leaf
            diff = diff[1:]
        assert diff.max() <= rel_grad * scale, leaf
