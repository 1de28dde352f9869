"""The port's key-axis context parallelism against the JAX package's, on
the CPU.

Across four gloo processes (tests/torch_dist_worker.py, one spawn for the
module), `parallel.context_parallel.cp_time_attention` through
`ops.attention.time_aware_multihead_attention` inside a `cp_scope`: the
output at mesh 2x2 (two key shards, two heads) and at L=1024 over four
key shards within atol 1e-5 of the unsharded port and of JAX's CP on the
virtual CPU mesh; the gradients of sum(out * probe) with respect to the
block's parameters, the queries and the keys over four key shards within
rtol 2e-5 / atol 2e-6 of both; the positional gate's and an indivisible
key length's ValueError; and MTAM's sharded step with the scalar gate,
row-sharded tables and CP at 2x2: the loss within rtol 1e-5 of JAX's
`compute_loss`, the updated parameters within rtol 5e-5 / atol 5e-6 of
JAX's single-device step and of the port's unsharded step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
import torch_zoo_parity as zp
from mtamrecommender_tpu.config import ExperimentConfig as JConfig
from mtamrecommender_tpu.config import MeshConfig as JMeshConfig
from mtamrecommender_tpu.models import base as jbase
from mtamrecommender_tpu.models.registry import get_model as jget_model
from mtamrecommender_tpu.ops import attention as jatt
from mtamrecommender_tpu.parallel import context_parallel as jcp
from mtamrecommender_tpu.parallel.mesh import build_mesh as jbuild_mesh
from mtamrecommender_tpu.train.trainer import make_optimizer as jmake_opt
from mtamrecommender_tpu.train.trainer import make_train_step as jmake_step
from mtamrecommender_tpu_torch.bridge import params_from_jax
from mtamrecommender_tpu_torch.config import ExperimentConfig as TConfig
from mtamrecommender_tpu_torch.config import MeshConfig
from mtamrecommender_tpu_torch.models.registry import get_model
from mtamrecommender_tpu_torch.ops import attention as att
from mtamrecommender_tpu_torch.parallel import context_parallel as cp
from mtamrecommender_tpu_torch.parallel.mesh import build_mesh
from mtamrecommender_tpu_torch.train.trainer import (make_optimizer,
                                                     make_train_step)

torch.set_num_threads(2)

WORLD = 4
C = 8
# name: (JAX key axis, port mesh, B, Tk, heads, gate mode, seed)
CASES = {"exact_2x2": (2, {"model_axis_size": 2}, 8, 16, 2, "scalar", 0),
         "long_1x4": (4, {"model_axis_size": 4}, 2, 1024, 1, "scalar", 5),
         "grad_1x4": (4, {"model_axis_size": 4}, 4, 16, 2, "scalar", 9),
         "positional": (2, {"model_axis_size": 2}, 8, 16, 1, "positional", 0),
         "indivisible": (4, {"model_axis_size": 4}, 2, 18, 1, "scalar", 0)}
STEP_OVER = {"model.experiment_type": "MTAM", "model.num_units": zp.D,
             "model.num_blocks": zp.HOPS, "model.dropout": 0.0,
             "data.max_seq_len": zp.L, "model.vocab_pad_multiple": 16,
             "model.time_gate_mode": "scalar", "mesh.model_axis_size": 2,
             "mesh.shard_embeddings": True, "mesh.context_parallel": True}


def _inputs(B, Tk, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, 1, C).astype(np.float32),
            r.randn(B, Tk, C).astype(np.float32),
            r.randint(1, Tk + 1, B).astype(np.int32),
            np.ones(B, np.int32),
            (r.rand(B, 1) * 400).astype(np.float32),
            (r.rand(B, Tk) * 400).astype(np.float32))


def _jax_block(gate, seed):
    key = 2 if seed == 9 else 0
    return jatt.init_time_mha_block(jax.random.PRNGKey(key), C, 1, 16,
                                    gate_mode=gate)


def _nested(tree):
    if isinstance(tree, dict):
        return {k: _nested(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _probe():
    return np.cos(np.arange(C, dtype=np.float32))


def _specs():
    specs = []
    for name, (_, mesh, B, Tk, heads, gate, seed) in CASES.items():
        q, k, kl, ql, tq, tk = (torch.tensor(x) for x in _inputs(B, Tk,
                                                                 seed))
        specs.append({"name": name, "kind": "cp_attention", "mesh": mesh,
                      "block": _nested(jax.device_get(_jax_block(gate,
                                                                 seed))),
                      "q": q, "k": k, "kl": kl, "ql": ql, "tq": tq,
                      "tk": tk, "heads": heads,
                      "probe": torch.tensor(_probe())})
    c = zp.cfg("MTAM", **STEP_OVER)
    _, model = zp.models("MTAM", c)
    specs.append({"name": "cp_step", "kind": "steps", "over": STEP_OVER,
                  "meta": tuple(zp.meta()[1]),
                  "params": {n: p.detach().clone()
                             for n, p in model.named_parameters()},
                  "batches": [zp.batches()[1]._asdict()]})
    return specs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs = _specs()
    outs = torch_dist_worker.spawn(specs, WORLD,
                                   tmp_path_factory.mktemp("cp"))
    return {s["name"]: s for s in specs}, outs


def _jax_cp(name, grads=False):
    """JAX's CP output (or gradients wrt params, q, k) on the virtual
    mesh with the case's key axis."""
    axis, _, B, Tk, heads, gate, seed = CASES[name]
    mesh = jbuild_mesh(JMeshConfig(model_axis_size=axis))
    params = _jax_block(gate, seed)
    q, k, kl, ql, tq, tk = (jnp.asarray(x) for x in _inputs(B, Tk, seed))
    probe = jnp.asarray(_probe())

    def loss(pp, qq, kk):
        with jcp.cp_scope(mesh):
            out, _ = jatt.time_aware_multihead_attention(
                pp, qq, kk, kl, ql, tq, tk, num_heads=heads, train=False)
        return jnp.sum(out * probe), out

    if grads:
        g = jax.jit(jax.grad(lambda *a: loss(*a)[0], argnums=(0, 1, 2)))(
            params, q, k)
        return params_from_jax(jax.device_get(g[0])), \
            torch.tensor(np.asarray(g[1])), torch.tensor(np.asarray(g[2]))
    return torch.tensor(np.asarray(jax.jit(loss)(params, q, k)[1]))


def _port_unsharded(spec):
    block = att.attention_block(torch_dist_worker._clone(spec["block"]))
    q = spec["q"].clone().requires_grad_(True)
    k = spec["k"].clone().requires_grad_(True)
    out = att.time_aware_multihead_attention(
        block, q, k, spec["kl"], spec["ql"], spec["tq"], spec["tk"],
        num_heads=spec["heads"])
    (out * spec["probe"]).sum().backward()
    return out.detach(), {n: p.grad for n, p in block.named_parameters()}, \
        q.grad, k.grad


def test_cp_scope_noop_on_a_one_wide_axis():
    mesh = build_mesh(MeshConfig(model_axis_size=1), 2, 0)
    with cp.cp_scope(mesh):
        assert cp.active_cp() is None
    mesh = build_mesh(MeshConfig(model_axis_size=2), 2, 1)
    with cp.cp_scope(mesh):
        assert cp.active_cp()[0] is mesh
    assert cp.active_cp() is None


@pytest.mark.parametrize("name", ["exact_2x2", "long_1x4"])
def test_cp_output_exact(runs, name, devices):
    specs, outs = runs
    want, _, _, _ = _port_unsharded(specs[name])
    jax_cp = _jax_cp(name)
    for out in outs:
        got = out[name]["out"]
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(got, jax_cp, atol=1e-5, rtol=1e-5)


def test_cp_gradient_parity(runs, devices):
    specs, outs = runs
    _, grads, dq, dk = _port_unsharded(specs["grad_1x4"])
    jgrads, jdq, jdk = _jax_cp("grad_1x4", grads=True)
    assert set(jgrads) == set(grads)
    for out in outs:
        got = out["grad_1x4"]
        for name, g in grads.items():
            for want in (g, jgrads[name]):
                torch.testing.assert_close(got["grads"][name], want,
                                           rtol=2e-5, atol=2e-6, msg=name)
        for g, want in ((got["dq"], (dq, jdq)), (got["dk"], (dk, jdk))):
            for w in want:
                torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name,match", [("positional", "scalar"),
                                        ("indivisible", "not divisible")])
def test_cp_errors(runs, name, match):
    _, outs = runs
    for out in outs:
        assert match in out[name]["error"]


def test_cp_through_the_sharded_train_step(runs, devices):
    specs, outs = runs
    spec = specs["cp_step"]
    jc = JConfig().with_overrides(**STEP_OVER)
    jmeta, tmeta = zp.meta()
    params = zp.jax_params("MTAM", jc)
    jb, tb = zp.batches()
    ref = jax.jit(lambda p, b: jbase.compute_loss(
        jget_model("MTAM"), p, jc.model, b, True, None,
        jmeta.item_vocab))(params, jb)
    opt = jmake_opt(jc.train)
    jnew, _, _ = jmake_step(jget_model("MTAM"), jc, opt, jmeta.item_vocab)(
        params, opt.init(params), jb, jax.random.PRNGKey(3))
    jnew = params_from_jax(jax.device_get(jnew))
    tc = TConfig().with_overrides(**{k: v for k, v in STEP_OVER.items()
                                     if not k.startswith("mesh.")})
    model = torch_dist_worker._model(spec, tc)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    topt = make_optimizer(tc.train)
    make_train_step(get_model("MTAM"), tc, topt, tmeta.item_vocab, "cpu")(
        model, topt.init(model), tb)
    for out in outs:
        got = out["cp_step"]
        np.testing.assert_allclose(got["metrics"][0]["loss"],
                                   float(ref["loss"]), rtol=1e-5)
        assert got["table_rows"] == 32
        moved = False
        for name, p in model.named_parameters():
            for want in (jnew[name], p.detach()):
                torch.testing.assert_close(got["params"][name], want,
                                           rtol=5e-5, atol=5e-6, msg=name)
            moved |= not torch.equal(got["params"][name], before[name])
        assert moved
