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
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_tp_ranks
from infinistore_tpu.models import llama as jl
from infinistore_tpu.parallel import mesh as jmesh
from infinistore_tpu_torch import _native, graft_entry, serving
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe
from infinistore_tpu_torch.parallel import mesh as pmesh
from infinistore_tpu_torch.parallel.launch import free_port, run_ranks
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


def _jax_dryrun_line():
    """The JAX dry run itself (``python __graft_entry__.py --dryrun 4``,
    every leg) in a subprocess on 4 CPU devices; its store leg runs on
    the port's build of the store library (``INFINISTORE_TPU_NATIVE_LIB``:
    the JAX package's own does not build on this toolchain)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["INFINISTORE_TPU_NATIVE_LIB"] = _native.build_native()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, os.path.join(root,
                                                     "__graft_entry__.py"),
                        "--dryrun", "4"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout.strip().splitlines()[-1]


_NUMBER = re.compile(r"(loss|fsdp_err|ring_err|err)=([-+.e0-9]+)")


def _readings(line):
    """The line with its measured numbers blanked, and the numbers:
    [(field, value)] in order."""
    return (_NUMBER.sub(r"\1=#", line),
            [(m.group(1), float(m.group(2).rstrip(",")))
             for m in _NUMBER.finditer(line)])


def _jax_dryrun_weights(jcfg):
    """The JAX dry run's weights at n = 4, as it draws them: the tiny
    Llama (PRNGKey(0)), the MoE at ep = 2 (PRNGKey(1)), the pipeline's
    stages (PRNGKey(3)) and microbatches (PRNGKey(4))."""
    from infinistore_tpu.models import moe as jmoe

    def bits(tree):
        return jax.tree_util.tree_map(
            lambda a: (np.asarray(a).view(np.uint16)
                       if a.dtype == jnp.bfloat16 else np.asarray(a)), tree)

    moe_cfg = jmoe.MoEConfig(vocab_size=256, d_model=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=128, n_experts=2,
                             top_k=2, max_seq=64, page_size=8)
    stages = [np.asarray(jax.random.normal(k, (16, 16)) / np.sqrt(16))
              for k in jax.random.split(jax.random.PRNGKey(3), 4)]
    return {"llama": bits(jl.init_params(jax.random.PRNGKey(0), jcfg)),
            "moe": bits(jmoe.init_params(jax.random.PRNGKey(1), moe_cfg)),
            "pp_stages": stages,
            "pp_x": np.asarray(jax.random.normal(jax.random.PRNGKey(4),
                                                 (8, 2, 16)))}


def test_dryrun_multichip_reproduces_jax_loss(capsys):
    """``graft_entry.dryrun_multichip(4, "cpu")`` on the JAX dry run's
    weights and inputs prints the JAX dry run's line field for field:
    every field and count the same (mesh, sp = 4, ep = 2, pp = 4, 4 pages
    handed 2 -> 2, tiering, 4-way tp decode), each check met (FSDP
    within 1e-3; ring, pipeline and tp decode within 1e-4), and the two
    losses equal to 1e-3 of each (both models compute in bf16, each
    rounding in its own places: 7.7e-5 of the tp loss is read here)."""
    jcfg = jl.LlamaConfig(**dataclasses.asdict(graft_entry.tiny_cfg()))
    r = graft_entry.dryrun_multichip(4, "cpu",
                                     weights=_jax_dryrun_weights(jcfg))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == r["line"]
    jax_line = _jax_dryrun_line()
    skeleton, got = _readings(line)
    jax_skeleton, want = _readings(jax_line)
    assert skeleton == jax_skeleton, (line, jax_line)
    for (field, a), (_, b) in zip(got, want):
        if field == "loss":
            assert abs(a - b) <= 1e-3 * abs(b), (field, a, b)
        else:
            assert a < (1e-3 if field == "fsdp_err" else 1e-4), (field, a)
    assert abs(r["loss"] - _jax_dryrun_loss(
        jax.tree_util.tree_map(jnp.asarray, jl.init_params(
            jax.random.PRNGKey(0), jcfg)), jcfg)) <= 1e-3 * abs(r["loss"])


def test_tp_refuses_int8_weights_moe_and_indivisible_heads():
    """What tensor parallelism takes and what it still refuses. int8
    weight leaves (placed by their parent's Megatron rule) and the MoE's
    routed FFN (its router and experts replicated, as the JAX rules
    leave them) now run under tp, here on a one-rank gloo mesh in this
    process: the int8 prefill gives the single-device logits, the routed
    stack returns, and a MoE engine on the mesh serves. Training over
    int8 leaves still raises (``llama.trainable``, under the tp and the
    FSDP placements alike), and so do head counts that do not divide by
    tp, before any collective."""
    params = tl.init_params(torch.Generator().manual_seed(0), CFG, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    quantized = tl.quantize_params(params, CFG)
    mcfg = moe.MoEConfig(dtype="float32")
    mparams = moe.init_params(torch.Generator().manual_seed(0), mcfg, "cpu")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=1, tp=1), "cpu")
        tp = TensorParallel(mesh)
        got, _ = tl.prefill(quantized, CFG, toks, tp=tp)
        want, _ = tl.prefill(quantized, CFG, toks)
        assert torch.equal(got, want)
        out, _ = tl._forward_stack(params, CFG, toks,
                                   ffn=lambda layer, x: x, tp=tp)
        assert out.shape == (1, 4, CFG.vocab_size)
        eng = serving.ServingEngine(pmesh.shard_params(mesh, mparams), mcfg,
                                    model=moe, device="cpu", mesh=mesh)
        assert len(eng.run([serving.Request("r", [1, 2, 3], 2)])["r"]) == 2
        for rule in (pmesh.param_shardings, pmesh.fsdp_param_shardings):
            sharded = pmesh.shard_params(mesh, quantized,
                                         rule(mesh, quantized))
            with pytest.raises(TypeError, match="int8"):
                tl.adamw(sharded, 1e-3)
    finally:
        dist.destroy_process_group()
    with pytest.raises(TypeError, match="int8"):
        tl.trainable(quantized)
    tp = object.__new__(TensorParallel)  # the checks read tp alone
    tp.tp = 3
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        tl.prefill(params, CFG, toks, tp=tp)
