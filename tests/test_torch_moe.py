"""The port's sparse-MoE family (``infinistore_tpu_torch.models.moe``)
against the JAX package's ``models/moe.py`` on the CPU, at
``tests/test_moe.py``'s tiny config, with the same weights
(``llama.params_from_jax``) and the same numpy inputs: routing (the JAX
dispatch and combine tensors rebuilt from the port's slot indices, the
aux loss), the dense forward, prefix prefill, paged decode and verify,
the loss and every leaf's grad, two AdamW steps against optax, and the
port's ServingEngine against the JAX engine token for token. float32
unless stated; each tolerance is stated beside its test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from infinistore_tpu import serving as js
from infinistore_tpu.models import moe as jm
from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM)
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.models import moe as tm

# float32, differing from the JAX package only in summation order.
TOL_F32 = 1e-5
# bfloat16: the packages round at different points (rms_norm, the
# combine); 2e-2 is the port's bf16 tolerance against the JAX models.
TOL_BF16 = 2e-2
# Grads and the dense-vs-paged identities through 2 layers: 1e-4, the
# Llama family's (tests/test_torch_train.py).
TOL_GRAD = 1e-4


def tiny_cfg(**kw):
    d = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, n_experts=4, top_k=2, max_seq=64, page_size=8,
             dtype="float32")
    d.update(kw)
    return jm.MoEConfig(**d)


def _tcfg(jcfg):
    return tm.MoEConfig(**dataclasses.asdict(jcfg))


def _numpy_tree(jparams):
    def conv(x):
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(conv, jparams)


def _pair(jcfg, seed):
    jparams = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, tl.params_from_jax(_numpy_tree(jparams), device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _f32(a).ravel(), _f32(b).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _paths(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _at(tparams, path):
    node = tparams
    for p in path:
        node = node[p.key if hasattr(p, "key") else p.idx]
    return node


# ---- parameters ----------------------------------------------------------


def test_params_keep_the_router_float32_in_a_bf16_tree():
    jcfg = tiny_cfg(dtype="bfloat16")
    jparams, tparams = _pair(jcfg, 0)
    layer = tparams["layers"][0]
    assert layer["router"].dtype == torch.float32
    assert layer["e_gate"].dtype == torch.bfloat16
    assert tparams["embed"].dtype == torch.bfloat16
    for path, leaf in _paths(jparams):
        got = _at(tparams, path)
        assert tuple(got.shape) == leaf.shape
        np.testing.assert_array_equal(_f32(got), _f32(leaf))
    own = tm.init_params(torch.Generator().manual_seed(0), _tcfg(jcfg),
                         "cpu")
    assert sorted(own["layers"][0]) == sorted(layer)
    for path, leaf in _paths(jparams):
        got = _at(own, path)
        assert tuple(got.shape) == leaf.shape
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name


# ---- routing -------------------------------------------------------------


def _dense_from_indices(r, n_experts):
    """The JAX package's [T, E, C] dispatch and combine tensors, rebuilt
    from the port's slot indices."""
    T, k = r.expert.shape
    dispatch = torch.zeros(T, n_experts, r.capacity)
    combine = torch.zeros(T, n_experts, r.capacity)
    t = torch.arange(T)[:, None].expand(T, k)[r.kept]
    dispatch[t, r.expert[r.kept], r.slot[r.kept]] = 1.0
    combine[t, r.expert[r.kept], r.slot[r.kept]] = r.gate[r.kept]
    return dispatch, combine


# (config, share of valid tokens or None). The tokens share a common
# direction, so the router favours some experts and the default factor
# (1.5) drops tokens.
ROUTE_CASES = {
    "default": (dict(), None),
    "no_drop": (dict(capacity_factor=4.0), None),
    "tight": (dict(capacity_factor=0.25, n_experts=2, top_k=1), None),
    "valid": (dict(), 0.6),             # 40% of the tokens masked out
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_matches_jax(case):
    """Slots, drops and gates: the JAX dispatch tensor exactly, the
    combine tensor and the aux loss to float32 rounding (the port
    renormalises the same two gates in another order)."""
    kw, keep_share = ROUTE_CASES[case]
    jcfg = tiny_cfg(**kw)
    jparams, tparams = _pair(jcfg, 1)
    rng = np.random.default_rng(2)
    h = (rng.standard_normal((96, jcfg.d_model))
         + 2.0 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    valid = None if keep_share is None else rng.random(96) < keep_share
    d_j, c_j, aux_j = jm._route(jparams["layers"][0], jnp.asarray(h), jcfg,
                                None if valid is None
                                else jnp.asarray(valid))
    r = tm._route(tparams["layers"][0], torch.from_numpy(h), _tcfg(jcfg),
                  None if valid is None else torch.from_numpy(valid))
    assert r.capacity == d_j.shape[2] == jcfg.capacity(96)
    d_t, c_t = _dense_from_indices(r, jcfg.n_experts)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=1e-6)
    assert abs(float(r.aux) - float(aux_j)) <= TOL_F32 * abs(float(aux_j))
    dropped = int((r.selected & ~r.kept).sum())
    if case in ("default", "tight"):
        assert dropped > 0
    if case == "no_drop":
        assert dropped == 0
    if case == "valid":
        assert not r.selected[torch.from_numpy(~valid)].any()


def test_route_replays_a_given_choice():
    """``choice`` replays a routing: the router's own top-k gives the same
    Routing; another choice takes those experts, with the router's
    probabilities of them renormalised as gates."""
    jcfg = tiny_cfg()
    _, tparams = _pair(jcfg, 1)
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (40, jcfg.d_model)).astype(np.float32))
    layer, cfg = tparams["layers"][0], _tcfg(jcfg)
    own = tm._route(layer, h, cfg)
    again = tm._route(layer, h, cfg, choice=own.expert)
    for a, b in zip(own, again):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    other = (own.expert + 1) % jcfg.n_experts
    r = tm._route(layer, h, cfg, choice=other)
    probs = torch.softmax((h.double() @ layer["router"].double()).float(),
                          dim=-1).gather(1, other)
    assert torch.equal(r.expert, other)
    torch.testing.assert_close(r.gate, probs / probs.sum(1, keepdim=True))


# ---- the model -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_dense_matches_jax(dtype):
    """Logits and the aux loss: float32 to 1e-5 relative, bfloat16 to
    2e-2 (relative L2 over all logits)."""
    jcfg = tiny_cfg(dtype=dtype)
    jparams, tparams = _pair(jcfg, 3)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    lj, kvs_j, aux_j = jm.forward_dense(jparams, jcfg, jnp.asarray(tokens))
    lt, kvs_t, aux_t = tm.forward_dense(tparams, _tcfg(jcfg),
                                        torch.from_numpy(tokens))
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    assert lt.dtype == torch.float32 and lt.shape == lj.shape
    assert _rel(lt, lj) <= tol, _rel(lt, lj)
    assert abs(float(aux_t) - float(aux_j)) <= tol * abs(float(aux_j))
    for (kj, vj), (kt, vt) in zip(kvs_j, kvs_t):
        assert _rel(kt, kj) <= tol and _rel(vt, vj) <= tol


def test_prefill_with_prefix_matches_jax():
    jcfg = tiny_cfg(capacity_factor=4.0)
    jparams, tparams = _pair(jcfg, 5)
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (1, 27)).astype(np.int32)
    p = 16
    _, kvs_j = jm.prefill(jparams, jcfg, jnp.asarray(tokens[:, :p]))
    lj, sj = jm.prefill_with_prefix(jparams, jcfg, jnp.asarray(tokens[:, p:]),
                                    kvs_j)
    prefix_t = [(torch.from_numpy(np.array(k)), torch.from_numpy(
        np.array(v))) for k, v in kvs_j]
    lt, st = tm.prefill_with_prefix(tparams, _tcfg(jcfg),
                                    torch.from_numpy(tokens[:, p:]),
                                    prefix_t)
    assert _rel(lt, lj) <= TOL_F32, _rel(lt, lj)
    for (kj, vj), (kt, vt) in zip(sj, st):
        assert _rel(kt, kj) <= TOL_F32 and _rel(vt, vj) <= TOL_F32


def _pool(jcfg, tokens, tparams, jparams, max_pages):
    """Prefill each row (lens differ), page the KV into a pool: (JAX
    pools, port pools, page table, lens)."""
    lens = [len(t) for t in tokens]
    table = np.zeros((len(tokens), max_pages), np.int32)
    shape = (jcfg.n_layers, len(tokens) * max_pages + 1,
             *jcfg.kv_page_shape())
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    nxt = 1
    for b, toks in enumerate(tokens):
        _, kvs = jm.prefill(jparams, jcfg, jnp.asarray([toks], jnp.int32))
        for li, (k, v) in enumerate(kvs):
            kpg, vpg = jm._llama.kv_to_pages(jcfg, k, v)
            n = kpg.shape[1]
            kp[li, nxt:nxt + n] = np.asarray(kpg[0])
            vp[li, nxt:nxt + n] = np.asarray(vpg[0])
        table[b, :max_pages] = np.arange(nxt, nxt + max_pages)
        nxt += max_pages
    return kp, vp, table, np.asarray(lens, np.int32)


def test_decode_and_verify_steps_match_jax():
    """One paged decode step (a row with an empty cache among them) and
    one verify step with ragged valid_len, at the default capacity:
    logits and every updated page, 1e-4 (the Llama family's paged
    tolerance)."""
    jcfg = tiny_cfg(max_seq=128)
    jparams, tparams = _pair(jcfg, 7)
    tcfg = _tcfg(jcfg)
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(0, jcfg.vocab_size, n)) for n in (13, 9, 1)]
    kp, vp, table, lens = _pool(jcfg, prompts, tparams, jparams, 5)
    lens[2] = 0  # an inactive row: out of routing
    token = rng.integers(0, jcfg.vocab_size, 3).astype(np.int32)
    lj, kj, vj = jm.decode_step(jparams, jcfg, jnp.asarray(token),
                                jnp.asarray(lens), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(table))
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    lt, kt, vt = tm.decode_step(tparams, tcfg, torch.from_numpy(token),
                                torch.from_numpy(lens), kt, vt,
                                torch.from_numpy(table))
    assert _rel(lt[:2], lj[:2]) <= TOL_GRAD, _rel(lt[:2], lj[:2])
    assert _rel(kt, kj) <= TOL_GRAD and _rel(vt, vj) <= TOL_GRAD

    m = 4
    toks = rng.integers(0, jcfg.vocab_size, (3, m)).astype(np.int32)
    seq = np.asarray([14, 10, 0], np.int32)
    valid_len = np.asarray([4, 2, 0], np.int32)
    lj, kj2, vj2 = jm.verify_step(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(seq), kj, vj,
                                  jnp.asarray(table),
                                  valid_len=jnp.asarray(valid_len))
    lt, kt, vt = tm.verify_step(tparams, tcfg, torch.from_numpy(toks),
                                torch.from_numpy(seq), kt, vt,
                                torch.from_numpy(table),
                                valid_len=torch.from_numpy(valid_len))
    live = np.arange(m)[None, :] < valid_len[:, None]
    assert _rel(lt[torch.from_numpy(live)], np.asarray(lj)[live]) \
        <= TOL_GRAD
    # Page 0 is the scratch page padded columns write: compare the rest.
    assert _rel(kt[:, 1:], kj2[:, 1:]) <= TOL_GRAD
    assert _rel(vt[:, 1:], vj2[:, 1:]) <= TOL_GRAD


def test_loss_and_grads_match_jax():
    """loss_fn (NLL + aux_loss_weight x aux) and every leaf's grad, the
    float32 router among them, against jax.value_and_grad: loss 1e-5
    relative, grads 1e-4 relative L2."""
    jcfg = tiny_cfg()
    jparams, tparams = _pair(jcfg, 9)
    tokens = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss_fn),
                              static_argnums=1)(jparams, jcfg,
                                                jnp.asarray(tokens))
    leaves = tl.trainable(tparams)
    assert len(leaves) == len(_paths(jparams))
    t_loss = tm.loss_fn(tparams, _tcfg(jcfg), torch.from_numpy(tokens))
    t_grads = torch.autograd.grad(t_loss, leaves)
    by_id = {id(t): g for t, g in zip(leaves, t_grads)}
    assert abs(float(t_loss.detach()) - float(j_loss)) <= \
        TOL_F32 * abs(float(j_loss))
    for path, jg in _paths(j_grads):
        tg = by_id[id(_at(tparams, path))]
        assert torch.isfinite(tg).all()
        assert _rel(tg, jg) <= TOL_GRAD, (jax.tree_util.keystr(path),
                                          _rel(tg, jg))
    router = by_id[id(tparams["layers"][0]["router"])]
    assert router.dtype == torch.float32 and router.abs().max() > 0


# Adam's first update is lr * g / (|g| + eps): where |g| sits near eps a
# summation-order difference in g becomes a large weight difference
# (tests/test_torch_train.py explains the floor).
NOISE_FLOOR = 1e-6


def test_two_train_steps_match_optax():
    """Two moe.train_steps (llama.adamw) against the JAX train_step with
    optax.adamw(1e-3): losses within 1e-5 relative, weights within 2e-5
    absolute, except where a grad sits at the noise floor (held to
    Adam's largest two-step move, at most one weight in a thousand)."""
    jcfg = tiny_cfg()
    jparams, tparams = _pair(jcfg, 11)
    tcfg = _tcfg(jcfg)
    tokens = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    optimizer = optax.adamw(1e-3)
    opt_state = optimizer.init(jparams)
    opt = tl.adamw(tparams, 1e-3)
    floor = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, bool),
                                   jparams)
    grad_fn = jax.jit(jax.grad(jm.loss_fn), static_argnums=1)
    step = jax.jit(lambda p, o, t: jm.train_step(p, o, jcfg, t, optimizer))
    for _ in range(2):
        grads = grad_fn(jparams, jcfg, jnp.asarray(tokens))
        floor = jax.tree_util.tree_map(
            lambda f, g: f | ((np.abs(g) < NOISE_FLOOR) & (g != 0)), floor,
            grads)
        jparams, opt_state, j_loss = step(jparams, opt_state,
                                          jnp.asarray(tokens))
        t_loss = tm.train_step(tparams, opt, tcfg, torch.from_numpy(tokens))
        assert abs(float(t_loss) - float(j_loss)) <= \
            TOL_F32 * abs(float(j_loss))
    n_floor = n_all = 0
    for (path, jp), (_, low) in zip(_paths(jparams), _paths(floor)):
        diff = np.abs(_f32(_at(tparams, path)) - _f32(jp))
        name = jax.tree_util.keystr(path)
        assert diff[~low].max(initial=0) <= 2e-5, (name, diff[~low].max())
        assert diff[low].max(initial=0) <= 2 * 1e-3 * (1 + 1e-4), name
        n_floor += int(low.sum())
        n_all += low.size
    assert n_floor <= 1e-3 * n_all, (n_floor, n_all)


# ---- serving: the port's engine against the JAX engine -------------------


@pytest.fixture(scope="module")
def serve_models():
    """capacity_factor 4: no token drops on any pass at these sizes
    (tests/test_moe.py's serving config); and the default factor."""
    out = {}
    for name, kw in (("no_drop", dict(capacity_factor=4.0)),
                     ("default", dict())):
        jcfg = tiny_cfg(max_seq=128, **kw)
        jparams, tparams = _pair(jcfg, 13)
        out[name] = (jcfg, jparams, _tcfg(jcfg), tparams)
    return out


ENGINE_CASES = {
    "plain": ("no_drop", dict(max_slots=2, total_pages=32)),
    "spec": ("no_drop", dict(max_slots=2, spec_k=2)),
    "chunk": ("no_drop", dict(max_slots=2, prefill_chunk=4)),
    "burst": ("no_drop", dict(max_slots=2, host_steps=4)),
    # Chunked prefill at the default capacity with idle slots: padding
    # and inactive rows must not take real tokens' expert slots.
    "chunk_default_capacity": ("default", dict(max_slots=8,
                                               prefill_chunk=4)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_token_parity_with_jax(serve_models, case):
    model, sc = ENGINE_CASES[case]
    jcfg, jparams, tcfg, tparams = serve_models[model]
    rng = np.random.default_rng(14)
    # The repetitive prompt makes prompt lookup draft (spec runs verify).
    prompts = [[3, 7, 3, 7, 3, 7, 3, 7, 3, 7, 3, 7, 3],
               [int(t) for t in rng.integers(0, jcfg.vocab_size, 21)],
               [int(t) for t in rng.integers(0, jcfg.vocab_size, 6)]]

    def requests(mod):
        return [mod.Request(f"r{i}", p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    j_eng = js.ServingEngine(jparams, jcfg, js.ServingConfig(**sc),
                             model=jm)
    want = j_eng.run(requests(js))
    t_eng = ts.ServingEngine(tparams, tcfg, ts.ServingConfig(**sc),
                             model=tm, device="cpu")
    assert t_eng.run(requests(ts)) == want
    for key in ("decode_steps", "decoded_tokens", "spec_proposed",
                "spec_accepted", "chunk_steps", "burst_steps"):
        assert t_eng.stats[key] == j_eng.stats[key], key
    if case == "spec":
        assert t_eng.stats["spec_proposed"] > 0
    if case.startswith("chunk"):
        assert t_eng.stats["chunk_steps"] > 0
    if case == "burst":
        assert t_eng.stats["burst_steps"] > 0


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=16,
    ))
    srv.start()
    yield srv
    srv.stop()


def test_multiturn_prefix_hit_through_port_store(serve_models, port_server):
    """Turn 2 extends turn 1: it restores turn 1's MoE pages from the
    port's own store (a prefix hit) and emits a cold engine's tokens."""
    _, _, tcfg, tparams = serve_models["no_drop"]
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=port_server.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    store = CudaKVStore(conn, device="cpu")
    try:
        rng = np.random.default_rng(15)
        turn1 = [int(t) for t in rng.integers(0, tcfg.vocab_size, 16)]
        eng1 = ts.ServingEngine(tparams, tcfg, store=store, model=tm,
                                device="cpu")
        out1 = eng1.run([ts.Request("t1", turn1, max_new_tokens=8)])
        assert eng1.stats["offloaded_pages"] > 0
        convo = turn1 + out1["t1"]
        page = tcfg.page_size
        turn2 = convo[: (len(convo) // page) * page] + [
            int(t) for t in rng.integers(0, tcfg.vocab_size, 5)]
        eng2 = ts.ServingEngine(tparams, tcfg, store=store, model=tm,
                                device="cpu")
        out2 = eng2.run([ts.Request("t2", turn2, max_new_tokens=6)])
        assert eng2.stats["prefix_hit_pages"] > 0
        cold = ts.ServingEngine(tparams, tcfg, model=tm, device="cpu")
        assert out2["t2"] == cold.run([ts.Request("x", turn2,
                                                  max_new_tokens=6)])["x"]
    finally:
        store.close()
        conn.close()
