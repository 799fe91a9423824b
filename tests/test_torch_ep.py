"""Expert parallelism: the port's MoE training step on a (dp=2, ep=2)
mesh of gloo CPU ranks (``models/moe.py``: ``make_ep_mesh``,
``param_shardings``, ``shard_params``, ``ExpertParallel``) against the
JAX package's step on ``moe.make_ep_mesh(dp=2, ep=2)``
(``tests/test_moe.py::test_expert_parallel_matches_single_device``) and
against the port's single-process step, on the JAX weights and tokens.
float32: the loss to rtol 1e-4 against JAX (the JAX test's own
tolerance), to 1e-5 against the single-process step, and every leaf's
grad to 1e-5 (relative L2). The ranks are spawned once."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks
from infinistore_tpu.models import moe as jmoe
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe as tmoe
from infinistore_tpu_torch.parallel.launch import run_ranks

DP, EP = 2, 2
TOL = 1e-5


def _cfgs():
    """test_moe.py's tiny_cfg, in both packages (capacity factor 1.0, so
    the capacity drops tokens and the routing over dp is exercised)."""
    kw = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, n_experts=4, top_k=2, max_seq=64,
              page_size=8, dtype="float32")
    return (jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw),
            jmoe.MoEConfig(capacity_factor=1.0, **kw),
            tmoe.MoEConfig(capacity_factor=1.0, **kw))


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg, jcfg_drop, tcfg_drop = _cfgs()
    jparams = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    out = {}
    for name, jc, tc in (("default", jcfg, tcfg),
                         ("drops", jcfg_drop, tcfg_drop)):
        port = run_ranks(torch_parallel_ranks.ep_step, DP * EP,
                         (DP, EP, tc, tree, tokens), device="cpu",
                         timeout=300)[0]
        params = torch_parallel_ranks.tree_to_torch(tree)
        opt = tl.adamw(params, 1e-3)
        one = float(tmoe.train_step(params, opt, tc, torch.from_numpy(
            tokens)))
        out[name] = (jc, port, one,
                     torch_parallel_ranks.tree_map_numpy(params, grad=True))
    return jparams, tokens, out


def _jax_ep_loss(jparams, cfg, tokens):
    mesh = jmoe.make_ep_mesh(dp=DP, ep=EP, devices=jax.devices()[:DP * EP])
    optimizer = optax.adamw(1e-3)
    sh = jax.device_put(jparams, jmoe.param_shardings(mesh, jparams))
    sh_tokens = jax.device_put(jnp.asarray(tokens),
                               NamedSharding(mesh, P("dp")))
    _, _, loss = jax.jit(
        lambda p, o, t: jmoe.train_step(p, o, cfg, t, optimizer)
    )(sh, optimizer.init(sh), sh_tokens)
    return float(loss)


@pytest.mark.parametrize("name", ["default", "drops"])
def test_ep_loss_matches_jax_ep_step(runs, name):
    jparams, tokens, out = runs
    jcfg, port, one, _ = out[name]
    ref = _jax_ep_loss(jparams, jcfg, tokens)
    np.testing.assert_allclose(port["loss"], ref, rtol=1e-4)
    assert abs(port["loss"] - one) <= TOL * abs(one), (port["loss"], one)


@pytest.mark.parametrize("name", ["default", "drops"])
def test_ep_grads_match_single_process(runs, name):
    """Every leaf's grad, experts gathered over ep, against the
    single-process step's: the experts' input gradient summed over ep,
    the combine reduced once, the aux loss counted once, the replicated
    leaves summed over dp."""
    _, _, out = runs
    _, port, _, ref = out[name]
    got = dict(torch_parallel_ranks.flat_leaves(port["grads"]))
    want = dict(torch_parallel_ranks.flat_leaves(ref))
    assert got.keys() == want.keys()
    for leaf, g in got.items():
        r = want[leaf]
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
        assert err <= TOL, (name, leaf, err)


def test_expert_leaves_are_sharded(runs):
    """The expert stacks hold E/ep experts per rank, placed Shard(0) over
    ep; the router and attention stay whole (replicated)."""
    _, _, out = runs
    jcfg, port, _, _ = out["default"]
    e, d, ff = jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    local = port["local"]
    assert local["e_gate"] == ((e // EP, d, ff), [None, 0])
    assert local["e_up"] == ((e // EP, d, ff), [None, 0])
    assert local["e_down"] == ((e // EP, ff, d), [None, 0])
    assert local["router"] == ((d, e), [None, None])
    assert local["wq"][1] == [None, None]
