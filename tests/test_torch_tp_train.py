"""Training over the (dp, tp) mesh on the CPU (gloo ranks): the port's
``llama.train_step`` under Megatron tensor parallelism and under FSDP
against the single-process step, and the port's dry run against the JAX
package's (``__graft_entry__._dryrun_multichip_cpu``'s first legs:
``llama.train_step`` jitted over ``parallel.mesh.param_shardings`` and
``fsdp_param_shardings`` with dp-sharded tokens).

Each world of ranks is spawned once for the module; its cases are
asserted one by one below. f32, so the sharded step must give the
single-process loss and every leaf's grad to 1e-5 (relative L2): a
sharded backward that all-reduced the row-parallel outputs' gradient
again would scale every upstream grad by tp, and a dp step that missed
the global mean would halve them."""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_tp_ranks
from infinistore_tpu.models import llama as jl
from infinistore_tpu.parallel import mesh as jmesh
from infinistore_tpu_torch import graft_entry, serving
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe
from infinistore_tpu_torch.parallel.launch import run_ranks
from infinistore_tpu_torch.parallel.mesh import TensorParallel

CFG = tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=8,
                     n_kv_heads=4, d_ff=128, max_seq=64, page_size=8,
                     dtype="float32")
WORLDS = {2: (1, 2, ("tp",)), 4: (2, 2, ("tp", "fsdp"))}
CASES = [("tp2", 2, "tp"), ("dp2xtp2", 4, "tp"), ("dp2xtp2_fsdp", 4, "fsdp")]
TOL = 1e-5


def _tree():
    """Seeded f32 weights with Qwen2-style q/k/v biases and an output
    bias, so the bias rules are trained too."""
    p = tl.init_params(torch.Generator().manual_seed(3), CFG, "cpu")
    g = torch.Generator().manual_seed(4)
    for layer in p["layers"]:
        for name, n in (("bq", CFG.n_heads), ("bk", CFG.n_kv_heads),
                        ("bv", CFG.n_kv_heads), ("bo", 0)):
            width = n * CFG.head_dim if n else CFG.d_model
            layer[name] = 0.1 * torch.randn(width, generator=g)
    return torch_tp_ranks.tree_map_numpy(p)


@pytest.fixture(scope="module")
def runs():
    tree = _tree()
    tokens = np.random.default_rng(5).integers(
        0, CFG.vocab_size, (4, 17), dtype=np.int32)
    out = {}
    for world, (dp, tp, cases) in WORLDS.items():
        out[world] = run_ranks(torch_tp_ranks.train_cases, world,
                               (dp, tp, CFG, tree, tokens, cases),
                               device="cpu")[0]
    # The single-process step on the whole batch.
    params = torch_tp_ranks.tree_to_torch(tree)
    opt = tl.adamw(params, 1e-3)
    loss = float(tl.train_step(params, opt, CFG, torch.from_numpy(tokens)))
    ref = torch_tp_ranks.tree_map_numpy(params, grad=True)
    return out, (loss, ref)


@pytest.mark.parametrize("case,world,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_step_matches_single_process(runs, case, world, kind):
    out, (ref_loss, ref_grads) = runs
    loss, grads = out[world][kind]
    assert abs(loss - ref_loss) <= TOL * abs(ref_loss), (loss, ref_loss)
    ref = dict(torch_tp_ranks.flat_leaves(ref_grads))
    got = dict(torch_tp_ranks.flat_leaves(grads))
    assert got.keys() == ref.keys()
    for name, g in got.items():
        r = ref[name]
        assert g.shape == r.shape, name
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
        assert err <= TOL, (case, name, err)


def test_fsdp_err(runs):
    """The dry run's fsdp_err: the FSDP step's loss against the tp
    step's on the same mesh."""
    out, _ = runs
    assert abs(out[4]["fsdp"][0] - out[4]["tp"][0]) < 1e-3


def _jax_dryrun_loss(jparams, cfg):
    """The JAX dry run's first leg (``_dryrun_multichip_cpu``): one
    jitted train_step over a dp=2, tp=2 mesh of 4 CPU devices."""
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=2), jax.devices()[:4])
    params = jax.device_put(jparams, jmesh.param_shardings(mesh, jparams))
    optimizer = optax.adamw(1e-3)
    tokens = jax.device_put(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32),
                                          dtype=np.int32),
        NamedSharding(mesh, P("dp")))
    _, _, loss = jax.jit(
        lambda p, o, t: jl.train_step(p, o, cfg, t, optimizer)
    )(params, optimizer.init(params), tokens)
    return float(loss)


def test_dryrun_multichip_reproduces_jax_loss(capsys):
    """``graft_entry.dryrun_multichip(4, "cpu")`` on the JAX dry run's
    weights (``init_params(PRNGKey(0))`` of the tiny bf16 config) and
    tokens prints its line and gives the JAX dry run's loss: both models
    compute in bf16, each rounding in its own places, so the two losses
    agree to 1e-3 of the loss (an eighth of bf16's epsilon; 7.7e-5 is
    read here), not to the bit."""
    jcfg = jl.LlamaConfig(**dataclasses.asdict(graft_entry.tiny_cfg()))
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    bits = jax.tree_util.tree_map(
        lambda a: np.asarray(a).view(np.uint16), jparams)
    r = graft_entry.dryrun_multichip(4, "cpu", params=bits)
    line = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh dp=2 tp=2, loss=" in line
    assert "tp_pallas_decode=4way" in line
    assert r["fsdp_err"] < 1e-3 and r["tp_decode_err"] < 1e-4
    jax_loss = _jax_dryrun_loss(jparams, jcfg)
    assert abs(r["loss"] - jax_loss) <= 1e-3 * abs(jax_loss), (
        r["loss"], jax_loss)


def test_tp_refuses_int8_weights_moe_and_indivisible_heads():
    """What tensor parallelism does not take raises before any
    collective: int8 weight leaves (the JAX rules leave them
    replicated), the MoE's routed FFN (it waits for expert parallelism)
    and head counts that do not divide by tp."""
    tp = object.__new__(TensorParallel)  # the checks read tp alone
    tp.tp = 2
    params = tl.init_params(torch.Generator().manual_seed(0), CFG, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="int8"):
        tl.prefill(tl.quantize_params(params, CFG), CFG, toks, tp=tp)
    with pytest.raises(NotImplementedError, match="MoE"):
        tl._forward_stack(params, CFG, toks, ffn=lambda layer, x: x, tp=tp)
    mcfg = moe.MoEConfig(dtype="float32")
    mparams = moe.init_params(torch.Generator().manual_seed(0), mcfg, "cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        serving.ServingEngine(mparams, mcfg, model=moe, device="cpu",
                              mesh=object())
    tp.tp = 3
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        tl.prefill(params, CFG, toks, tp=tp)
