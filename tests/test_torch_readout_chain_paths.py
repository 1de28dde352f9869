"""MTAM's training readout below 256 keys in the port against JAX.

Below 256 keys the port trains MTAM's Tq=1 readout through the chain
kernel pair (`readout_chain_stack`: the hop-batched projections, then
`readout_chain_vjp`), which the JAX package runs only with
`READOUT_CHAIN_OPT_IN`; its default there is the hop-batched jnp readout.
Here, on the same parameters (the JAX init, converted by
`bridge.load_jax_params`) and the same numpy inputs: the stack against
the plain `single_query_readout` under autograd; `vanilla_attention_stack
(train=True)` against both JAX routes, forward and every gradient; a row
with ``key_len == 0`` against the jnp reference; the route by length,
read from the twins' calls (they count as the kernels count launches on
the card); and one MTAM training step through the chain.

Tolerances: f32 outputs within atol 1e-5, f32 gradients within 1e-5 of
each leaf's largest |value| (against JAX's chain route 1e-4, as
tests/test_pallas.py holds that route to the jnp one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu import types as jtypes
from mtamrecommender_tpu.config import ExperimentConfig
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu_torch import types as ttypes
from mtamrecommender_tpu_torch.bridge import load_jax_params, params_from_jax
from mtamrecommender_tpu_torch.models import base as tbase
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops import attention as tatt
from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as tak
from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as trc
from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as trk

from helpers import make_batch

torch.set_num_threads(2)

D, HOPS, B, L = 16, 3, 6, 50
KEY_LEN = [L, 9, 1, L - 4, 23, 2]
ATOL_F32, REL_GRAD, REL_GRAD_PALLAS = 1e-5, 1e-5, 1e-4


def _cfg(L_, gate="positional"):
    return ExperimentConfig().with_overrides(**{
        "model.num_units": D, "model.num_blocks": HOPS, "model.dropout": 0.0,
        "data.max_seq_len": L_, "model.vocab_pad_multiple": 16,
        "model.use_pallas": True, "model.time_gate_mode": gate})


def _models(cfg, L_):
    jmeta = jtypes.DatasetMeta(20, 60, 5, L_)
    tmeta = ttypes.DatasetMeta(20, 60, 5, L_)
    params = jax.device_get(jget_model("MTAM").init(jax.random.PRNGKey(0),
                                                    cfg.model, jmeta))
    model = get_model("MTAM").init(torch.Generator().manual_seed(0),
                                   cfg.model, tmeta)
    return params, load_jax_params(model, params)


def _readout_inputs(L_, key_len, seed=12):
    r = np.random.RandomState(seed)
    enc = r.randn(B, L_, D).astype(np.float32)
    dec = r.randn(B, 1, D).astype(np.float32)
    t_keys = np.sort(r.rand(B, L_).astype(np.float32) * 3000, axis=1)
    t_q = t_keys[:, -1:] + 2.0
    qlen = np.ones((B,), np.int32)
    qlen[1] = 0                                       # one masked query
    return dict(enc=enc, dec=dec, key_len=np.asarray(key_len, np.int32),
                qlen=qlen, t_q=t_q, t_keys=t_keys,
                w_out=r.randn(B, D).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _port(att, x, stack=None, train=True):
    """The port's readout (``stack``, or the vanilla_attention_stack
    route) on x's inputs: (out, d out.w_out / d enc, / d dec, / d hop
    params by name)."""
    for p in att.parameters():
        p.grad = None
    tenc = torch.tensor(x["enc"], requires_grad=True)
    tdec = torch.tensor(x["dec"], requires_grad=True)
    kw = dict(num_heads=1, t_queries=torch.tensor(x["t_q"]),
              t_keys=torch.tensor(x["t_keys"]))
    args = (att, tenc, tdec, torch.tensor(x["key_len"]),
            torch.tensor(x["qlen"]))
    if stack is None:
        out = tatt.vanilla_attention_stack(*args, kind="time", train=train,
                                           **kw)
    else:
        out = stack(*args, **kw)
    (out * torch.tensor(x["w_out"])).sum().backward()
    return (out.detach().numpy(), tenc.grad.numpy(), tdec.grad.numpy(),
            {n: p.grad.numpy() for n, p in att.named_parameters()})


def _jax(params_att, x, opt_in, monkeypatch):
    """JAX's training readout: the default (the hop-batched jnp readout)
    or, with READOUT_CHAIN_OPT_IN, the Pallas chain in interpret mode."""
    monkeypatch.setattr(jatt, "READOUT_CHAIN_OPT_IN", opt_in)

    def jloss(att, enc_, dec_):
        out = jatt.vanilla_attention_stack(
            att, enc_, dec_, jnp.asarray(x["key_len"]),
            jnp.asarray(x["qlen"]), kind="time", num_heads=1,
            dropout_rate=0.0, train=True, t_queries=jnp.asarray(x["t_q"]),
            t_keys=jnp.asarray(x["t_keys"]), use_pallas=True)
        return jnp.sum(out * x["w_out"]), out

    (_, out), g = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        params_att, jnp.asarray(x["enc"]), jnp.asarray(x["dec"]))
    return (np.asarray(out), np.asarray(g[1]), np.asarray(g[2]),
            {n: t.numpy() for n, t in
             params_from_jax(jax.device_get(g[0])).items()})


def _assert_match(got, want, rel_grad, rows=slice(None)):
    np.testing.assert_allclose(got[0][rows], want[0][rows], atol=ATOL_F32,
                               rtol=0)
    for i, what in ((1, "enc"), (2, "dec")):
        assert _rel(got[i][rows], want[i][rows]) <= rel_grad, what
    if isinstance(rows, slice):
        assert set(got[3]) == set(want[3])
        for name, g in got[3].items():
            assert _rel(g, want[3][name]) <= rel_grad, name


@pytest.mark.parametrize("gate", ["positional", "scalar"])
def test_chain_stack_matches_single_query_readout(gate):
    cfg = _cfg(L, gate)
    _, model = _models(cfg, L)
    x = _readout_inputs(L, KEY_LEN)
    chain = _port(model.att, x, tatt.readout_chain_stack)
    plain = _port(model.att, x, tatt.single_query_readout)
    _assert_match(chain, plain, REL_GRAD)


@pytest.mark.parametrize("opt_in", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("gate", ["positional", "scalar"])
def test_training_readout_matches_both_jax_routes(monkeypatch, gate, opt_in):
    """vanilla_attention_stack(train=True) against JAX's default route
    and its chain-kernel route: the output and the gradients of the
    memory, the query and every hop parameter."""
    cfg = _cfg(L, gate)
    params, model = _models(cfg, L)
    x = _readout_inputs(L, KEY_LEN, seed=3)
    got = _port(model.att, x)
    want = _jax(params["att"], x, opt_in, monkeypatch)
    _assert_match(got, want, REL_GRAD_PALLAS if opt_in else REL_GRAD)


def test_key_len_zero_row_follows_the_jnp_reference(monkeypatch):
    """A row with no live key: uniform weights over its L keys and no
    score gradient, as JAX's jnp readout gives, on every row; JAX's chain
    route (whose Pallas backward gives the row a score gradient) agrees
    on the live rows and not on that one."""
    cfg = _cfg(L)
    params, model = _models(cfg, L)
    key_len = list(KEY_LEN)
    key_len[3] = 0
    x = _readout_inputs(L, key_len, seed=4)
    got = _port(model.att, x)
    _assert_match(got, _jax(params["att"], x, False, monkeypatch), REL_GRAD)
    pallas = _jax(params["att"], x, True, monkeypatch)
    live = [r for r in range(B) if r != 3]
    _assert_match(got, pallas, REL_GRAD_PALLAS, rows=live)
    np.testing.assert_allclose(got[0][3], pallas[0][3], atol=ATOL_F32)
    assert _rel(got[1][3], pallas[1][3]) > 1e-3       # d enc of that row


# ------------------------------------------------------------ routes

@pytest.fixture
def twins_count(monkeypatch):
    """Each plain twin counts its calls as its kernel counts launches."""
    calls = {}

    def counting(module, name):
        plain = getattr(module, name)

        def run(*args):
            calls[name] = calls.get(name, 0) + 1
            return plain(*args)
        monkeypatch.setattr(module, name, run)

    for name in ("readout_chain_plain", "readout_chain_bwd_plain"):
        counting(trc, name)
    for name in ("fused_readout_plain", "fused_readout_bwd_plain"):
        counting(trk, name)
    for name in ("fused_attention_plain", "fused_attention_blockwise_plain",
                 "fused_attention_bwd_plain"):
        counting(tak, name)
    real = tatt.single_query_readout

    def single(*a, **k):
        calls["single_query_readout"] = calls.get("single_query_readout",
                                                  0) + 1
        return real(*a, **k)
    monkeypatch.setattr(tatt, "single_query_readout", single)
    return calls


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("tk", [12, 255, 256, 1024, 1100])
def test_chain_route_by_length(twins_count, tk, train):
    """Training: the chain below 256 keys, the fused readout over 256 to
    1024, `single_query_readout` past 1024.  Serving never takes the
    chain: the fused readout over 256 to 1024 keys, else one attention
    launch a hop (single tile up to 1024 keys, blockwise past)."""
    gen = torch.Generator().manual_seed(1)
    att = torch.nn.ModuleList(
        tatt.TimeAttentionBlock(p) for p in tatt.init_attention_stack(
            gen, HOPS, D, kind="time", t_q_len=1, t_k_len=tk,
            gate_mode="scalar"))
    x = _readout_inputs(tk, [tk, 9, 1, tk - 3, 5, tk], seed=tk)
    if train:
        out = _port(att, x)[0]
    else:
        with torch.no_grad():
            out = tatt.vanilla_attention_stack(
                att, torch.tensor(x["enc"]), torch.tensor(x["dec"]),
                torch.tensor(x["key_len"]), torch.tensor(x["qlen"]),
                kind="time", num_heads=1, t_queries=torch.tensor(x["t_q"]),
                t_keys=torch.tensor(x["t_keys"]), train=False).numpy()
    assert out.shape == (B, D) and np.isfinite(out).all()
    if 256 <= tk <= 1024:
        want = {"fused_readout_plain": 1}
        if train:
            want["fused_readout_bwd_plain"] = 1
    elif train and tk < 256:
        want = {"readout_chain_plain": 1, "readout_chain_bwd_plain": 1}
    elif train:
        want = {"single_query_readout": 1}
    elif tk <= 1024:
        want = {"fused_attention_plain": HOPS}
    else:
        want = {"fused_attention_blockwise_plain": HOPS}
    assert twins_count == want


def test_mtam_training_step_takes_the_chain(twins_count):
    """One MTAM training step at L=12 (bench.py's route at the CPU tests'
    size): one chain forward and one chain backward; the loss finite and
    every hop parameter given a gradient."""
    L_ = 12
    cfg = _cfg(L_)
    _, model = _models(cfg, L_)
    jmeta = jtypes.DatasetMeta(20, 60, 5, L_)
    jb = make_batch(jmeta, batch_size=B, seed=5,
                    seq_lens=[1, 2, L_, 5, L_, 7])
    tb = ttypes.batch_from_numpy({f: np.asarray(getattr(jb, f))
                                  for f in jb._fields}, device="cpu")
    metrics = tbase.compute_loss(get_model("MTAM"), model, cfg.model, tb,
                                 jmeta.item_vocab)
    metrics["loss"].backward()
    assert twins_count == {"readout_chain_plain": 1,
                           "readout_chain_bwd_plain": 1}
    assert torch.isfinite(metrics["loss"])
    for name, p in model.att.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_readout_chain_stack_takes_one_head():
    cfg = _cfg(L)
    _, model = _models(cfg, L)
    x = _readout_inputs(L, KEY_LEN)
    assert not trc.supported(L, D, 2)
    with pytest.raises(NotImplementedError, match="one head"):
        tatt.readout_chain_stack(
            model.att, torch.tensor(x["enc"]), torch.tensor(x["dec"]),
            torch.tensor(x["key_len"]), torch.tensor(x["qlen"]),
            num_heads=2, t_queries=torch.tensor(x["t_q"]),
            t_keys=torch.tensor(x["t_keys"]))
