"""The chain readout pair at ONE hop, NARM+'s and NARM++'s training
readout at L=50 (every earlier model reads out in 2 or more hops).

The twins (`readout_chain_plain`, `readout_chain_bwd_plain`) and the
staged design's models (`_staged_fwd_design_plain`,
`_staged_bwd_design_plain`, the CUDA kernels' arithmetic in plain
PyTorch) against JAX's `_chain_fwd` and `_chain_bwd_impl` in interpret
mode at n = 1 hop, f32 and bf16, (L, d) = (50, 128) and (17, 16),
positional and scalar wo2, ragged key lengths with a masked query; and
`readout_chain_stack` with one block against JAX's readout at its
parameters.  chip_smoke.py (phase 2f) holds the CUDA pair at one hop.

Tolerances as tests/test_torch_chain_bwd_design.py: of each output's
largest |value|, f32 1e-5, bf16 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu.ops.pallas import readout_chain_kernel as jrc
from mtamrecommender_tpu_torch.bridge import params_from_jax
from mtamrecommender_tpu_torch.ops import attention as tatt
from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as trc

torch.set_num_threads(2)

REL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = ((50, 128), (17, 16))
_UNTYPED = ("klen", "qz")


def _inputs(L, d, gate_mode, seed):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    key_len = np.array([L, 1, 3, L // 2, L, max(L - 5, 1)], np.int32)
    b = len(key_len)
    wo2 = (np.repeat(f(1, 1, scale=0.5), L, axis=1) if gate_mode == "scalar"
           else f(1, L, scale=0.5))
    qz = np.ones((b,), np.float32)
    qz[3] = 0.0                                     # a masked query
    return {
        "dec": f(b, 1, d), "klen": key_len, "qz": qz,
        "k_all": np.maximum(f(1, b, L, d), 0.0),
        "v_all": np.maximum(f(1, b, L, d), 0.0),
        "tprec": f(1, b, L, d, scale=0.5), "gate_part": f(1, b, L, scale=0.5),
        "wo2": wo2, "wq": f(1, d, d, scale=d ** -0.5), "bq": f(1, d, scale=0.1),
        "lng": 1.0 + f(1, d, scale=0.1), "lnb": f(1, d, scale=0.1)}


def _as_jax(ins, dtype):
    jdt = jnp.dtype(dtype)
    return [jnp.asarray(ins[k]) if k in _UNTYPED else jnp.asarray(ins[k], jdt)
            for k in trc._OPERANDS]


def _as_torch(ins, dtype):
    tdt = getattr(torch, dtype)
    return [torch.tensor(ins[k]) if k in _UNTYPED
            else torch.tensor(ins[k]).to(tdt) for k in trc._OPERANDS]


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("gate_mode", ["positional", "scalar"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("tk,d", SHAPES)
def test_one_hop_pair_matches_pallas(tk, d, dname, gate_mode):
    ins = _inputs(tk, d, gate_mode, seed=tk + d + len(gate_mode))
    jargs = _as_jax(ins, dname)
    jout, jcurs = jrc._chain_fwd(*jargs)
    args = _as_torch(ins, dname)
    out, curs = trc.readout_chain(*args)
    staged = trc._staged_fwd_design_plain(*args)
    for got in (out, staged[0]):
        assert _rel(got, jout) <= REL[dname]
    assert _rel(curs, jcurs) <= REL[dname] and curs.shape[0] == 1
    b = len(ins["klen"])
    g = np.random.RandomState(tk * d).randn(b, d).astype(np.float32)
    tg = torch.tensor(g).to(getattr(torch, dname))
    pallas = jrc._chain_bwd_impl(jnp.asarray(g, jnp.dtype(dname)),
                                 *jargs[1:], jcurs)
    tcurs = torch.tensor(np.asarray(jcurs))
    for got in (trc.readout_chain_bwd(tg, *args[1:], tcurs),
                trc._staged_bwd_design_plain(tg, *args[1:], tcurs)):
        for name, x, w in zip(trc._GRADS, got, pallas):
            w = np.asarray(w, np.float32).reshape(tuple(x.shape))
            assert _rel(x, w) <= REL[dname], name
        # the masked query's row: no score gradient reaches its keys
        assert not dict(zip(trc._GRADS, got))["dk"][:, 3].float().any()


def test_one_block_stack_matches_jax():
    """`readout_chain_stack` with one time block (the route NARM+ and
    NARM++ train on at L=50) against JAX's readout with its chain kernel
    in interpret mode: output and every gradient, f32."""
    B, L, D = 6, 50, 16
    jp = jax.device_get(jatt.init_attention_stack(
        jax.random.PRNGKey(2), 1, D, kind="time", t_q_len=1, t_k_len=L))
    flat = params_from_jax(jp[0])
    nested = {}
    for k, v in flat.items():
        head, *rest = k.split(".")
        if rest:
            nested.setdefault(head, {})[rest[0]] = v
        else:
            nested[head] = v
    blocks = torch.nn.ModuleList([tatt.attention_block(nested)])
    r = np.random.RandomState(8)
    enc = r.randn(B, L, D).astype(np.float32)
    dec = r.randn(B, 1, D).astype(np.float32)
    t_keys = np.sort(r.rand(B, L).astype(np.float32) * 300, axis=1)
    t_q = t_keys[:, -1:] + 2.0
    key_len = np.array([L, 1, 9, 30, L, 2], np.int32)
    ones = np.ones((B,), np.int32)
    w = r.randn(B, D).astype(np.float32)
    old = jatt.READOUT_CHAIN_OPT_IN
    jatt.READOUT_CHAIN_OPT_IN = True
    try:
        def jloss(p, e, q):
            out = jatt.vanilla_attention_stack(
                p, e, q, jnp.asarray(key_len), jnp.asarray(ones), kind="time",
                num_heads=1, dropout_rate=0.0, train=True,
                t_queries=jnp.asarray(t_q), t_keys=jnp.asarray(t_keys),
                use_pallas=True)
            return jnp.sum(out * w), out

        (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
            jp, jnp.asarray(enc), jnp.asarray(dec))
    finally:
        jatt.READOUT_CHAIN_OPT_IN = old
    te = torch.tensor(enc, requires_grad=True)
    td = torch.tensor(dec, requires_grad=True)
    out = tatt.readout_chain_stack(
        blocks, te, td, torch.tensor(key_len), torch.tensor(ones),
        num_heads=1, t_queries=torch.tensor(t_q), t_keys=torch.tensor(t_keys))
    (out * torch.tensor(w)).sum().backward()
    assert _rel(out.detach(), want) <= REL["float32"]
    assert _rel(te.grad, jg[1]) <= REL["float32"]
    assert _rel(td.grad, jg[2]) <= REL["float32"]
    jgp = params_from_jax(jax.device_get(jg[0]))
    for name, p in blocks.named_parameters():
        assert _rel(p.grad, jgp[name]) <= REL["float32"], name
