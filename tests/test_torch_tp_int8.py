"""Int8 weights under tensor parallelism (gloo ranks on the CPU, tp = 2,
float32): the port's Megatron placement of ``{"int8", "scale"}`` leaves
(``parallel.mesh.param_shardings``: each rank holds the block it computes
on), its model steps on them (``models/llama.py`` with ``tp=``) and its
ServingEngine over them (``mesh=``), against the JAX package on
``parallel.mesh.shard_params(quantize_params(...))`` over 2 of the
8-device virtual mesh's devices, whose rules replicate the int8 leaves
(GSPMD computes each device's columns from the whole leaf).

- Each rank's int8 block and scale equal the slice of the whole leaf
  its parent's rule gives: column-parallel weights and lm_head split
  their int8 columns and per-column scales; row-parallel weights split
  their int8 rows and keep the whole scale; the embedding splits d_model
  and keeps its per-row scale. The fingerprint of the shards is the
  whole tree's.
- ``prefill``, ``prefill_with_prefix`` and ``decode_step`` give the JAX
  functions' logits (and KV, and updated pages) to 1e-5. The
  row-parallel scale multiplies once, after the all-reduce
  (``llama._row_parallel``): one device's order, up to the grouping of
  the sum, which is what the 1e-5 holds; ``test_row_parallel_scale_
  after_the_sum`` shows the order itself.
- The tp engine (plain, spec, chunk) emits the JAX engine's tokens
  exactly; with a store it writes the single-device port engine's
  pages under the same keys (layer 0 byte-equal: the same columns of
  the same products; layer 1 behind row-parallel all-reduces, to 1e-5)
  and hits pages that engine wrote.

The ranks are spawned once for the module, with a time limit of their
own."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_tp_ranks
from infinistore_tpu import serving as js
from infinistore_tpu.models import llama as jl
from infinistore_tpu.parallel import mesh as jmesh
from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM)
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.parallel import mesh as pmesh
from infinistore_tpu_torch.parallel.launch import run_ranks

JCFG = jl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=8,
                      n_kv_heads=4, d_ff=128, max_seq=128, page_size=8,
                      dtype="float32")
TCFG = tl.LlamaConfig(**dataclasses.asdict(JCFG))
MODES = {"plain": dict(max_slots=2), "spec": dict(max_slots=2, spec_k=2),
         "chunk": dict(max_slots=2, prefill_chunk=4)}
TP = 2
TOL = 1e-5
RANK_TIMEOUT = 240  # seconds, for each spawn of the ranks


def step_inputs(cfg, seed, n_pages=12, verify=False):
    """Whole numpy inputs of the four model steps (batch 2): a prompt, a
    cached prefix's KV and its suffix, page pools with a page table, and
    a decode token (and a ragged verify batch)."""
    rng = np.random.default_rng(seed)
    L, kv, hd, page = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, \
        cfg.page_size

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    pages = (L, n_pages, page, kv, hd)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32),
        "prefix": [(f32(2, 16, kv, hd), f32(2, 16, kv, hd))
                   for _ in range(L)],
        "suffix": rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32),
        "k_pages": f32(*pages), "v_pages": f32(*pages),
        "table": rng.permutation(np.arange(1, n_pages))[:8].reshape(
            2, 4).astype(np.int32),
        "seq_lens": np.array([11, 20], np.int32),
        "token": rng.integers(0, cfg.vocab_size, 2).astype(np.int32),
    }
    if verify:
        out["verify"] = rng.integers(0, cfg.vocab_size, (2, 3)).astype(
            np.int32)
        out["valid_len"] = np.array([3, 2], np.int32)
    return out


def jax_steps(model, params, cfg, inputs):
    """The JAX package's steps on the same inputs (params sharded or
    not), as numpy: the same layout as ``torch_tp_ranks.model_steps``."""
    def kv(kvs):
        return [(np.asarray(k), np.asarray(v)) for k, v in kvs]

    out = {}
    logits, kvs = jax.jit(lambda p, t: model.prefill(p, cfg, t))(
        params, inputs["tokens"])
    out["prefill"] = (np.asarray(logits), kv(kvs))
    logits, kvs = jax.jit(lambda p, t, pre: model.prefill_with_prefix(
        p, cfg, t, pre))(params, inputs["suffix"], inputs["prefix"])
    out["prefix"] = (np.asarray(logits), kv(kvs))
    args = [inputs[k] for k in ("seq_lens", "k_pages", "v_pages", "table")]
    logits, kp, vp = jax.jit(lambda p, t, *a: model.decode_step(
        p, cfg, t, *a))(params, inputs["token"], *args)
    out["decode"] = (np.asarray(logits), np.asarray(kp), np.asarray(vp))
    if "verify" in inputs:
        logits, kp, vp = jax.jit(lambda p, t, *a: model.verify_step(
            p, cfg, t, *a))(params, inputs["verify"], *args,
                            inputs["valid_len"])
        out["verify"] = (np.asarray(logits), np.asarray(kp), np.asarray(vp))
    return out


def join_heads(ranks, step):
    """Every rank's (logits, per-rank KV or pages) of ``step`` -> rank
    0's logits (the same on every rank: checked) and the KV or pages
    with the ranks' kv heads joined (dim -2)."""
    logits = [r[step][0] for r in ranks]
    assert all(np.array_equal(x, logits[0]) for x in logits[1:]), step
    rest = [r[step][1:] for r in ranks]
    if step in ("prefill", "prefix"):
        joined = [tuple(np.concatenate([r[0][li][j] for r in rest], axis=-2)
                        for j in range(2))
                  for li in range(len(rest[0][0]))]
        return logits[0], joined
    return logits[0], tuple(np.concatenate([r[j] for r in rest], axis=-2)
                            for j in range(2))


def arrays(x):
    """The arrays of nested lists and tuples, in order."""
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from arrays(y)
    else:
        yield x


def assert_steps_match(ranks, ref, steps, tol=TOL):
    """Each step's logits and its KV or pages (the ranks' kv heads
    joined) against ``ref``'s, to ``tol``."""
    for step in steps:
        logits, tail = join_heads(ranks, step)
        np.testing.assert_allclose(logits, ref[step][0], rtol=tol, atol=tol,
                                   err_msg=step)
        want = ref[step][1] if step in ("prefill", "prefix") \
            else ref[step][1:]
        got, want = list(arrays(tail)), list(arrays(want))
        assert len(got) == len(want), step
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=step)


def jax_mesh():
    return jmesh.make_mesh(jmesh.MeshConfig(dp=1, tp=TP), jax.devices()[:TP])


def _server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=16))
    srv.start()
    return srv


def _store(srv):
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    return torch_tp_ranks.RecordingStore(conn, "cpu")


def _close(store):
    store.close()
    store.conn.close()


@pytest.fixture(scope="module")
def quantized():
    jq = jl.quantize_params(jl.init_params(jax.random.PRNGKey(0), JCFG),
                            JCFG)
    return jq, jax.tree_util.tree_map(np.asarray, jq)


@pytest.fixture(scope="module")
def steps(world):
    return world["steps"]


@pytest.fixture(scope="module")
def engines(world):
    return world["engines"]


# Whole-leaf dim each part of an int8 leaf is split on (None: whole).
SPLITS = {"embed": (1, None), "lm_head": (1, 0),
          **{n: (1, 0) for n in ("wq", "wk", "wv", "w_gate", "w_up")},
          "wo": (0, None), "w_down": (0, None)}


def _blocks(tree):
    """(parent name, part, whole leaf) of every int8 leaf."""
    yield "embed", tree["embed"]
    yield "lm_head", tree["lm_head"]
    for layer in tree["layers"]:
        for name in SPLITS:
            if name in layer:
                yield name, layer[name]


def test_each_rank_holds_its_slice_of_every_int8_leaf(quantized, steps):
    _, tree = quantized
    ranks, _ = steps
    for r, out in enumerate(ranks):
        local = list(_blocks(out["local"]))
        for (name, whole), (_, mine) in zip(_blocks(tree), local):
            for part, dim in zip(("int8", "scale"), SPLITS[name]):
                want = whole[part] if dim is None else np.split(
                    whole[part], TP, axis=dim)[r]
                assert mine[part].dtype == whole[part].dtype, (name, part)
                np.testing.assert_array_equal(mine[part], want,
                                              err_msg=f"{name}.{part}")
        held = sum(b["int8"].nbytes for _, b in local)
        assert held * TP == sum(b["int8"].nbytes for _, b in _blocks(tree))
        np.testing.assert_array_equal(out["local"]["final_ln"],
                                      tree["final_ln"])


def test_shards_fingerprint_as_the_whole_tree(quantized, steps):
    _, tree = quantized
    ranks, _ = steps
    whole = ts.weights_fingerprint(tl.params_from_jax(tree, "cpu"))
    assert all(r["fingerprint"] == whole for r in ranks)


@pytest.mark.parametrize("step", ["prefill", "prefix", "decode"])
def test_tp_int8_steps_match_jax_on_the_sharded_tree(steps, step):
    ranks, ref = steps
    assert_steps_match(ranks, ref, [step])


class _FakeTP:
    """Rank 0 of two, in one process: ``reduce`` adds rank 1's partial
    product to rank 0's, as the all-reduce does."""
    tp = 2

    def __init__(self, other):
        self.other = other

    def reduce(self, mine):
        return mine + self.other


def test_row_parallel_scale_after_the_sum():
    """``_row_parallel`` on an int8 wo: the replicated per-column scale
    multiplies the summed partial products once, after the all-reduce,
    bit for bit; one device computes (h @ int8) * scale on the finished
    sum, so the two differ only in the grouping of the sum (1e-6 here)."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(5, 32, generator=g)
    w = tl._quantize_leaf(torch.randn(32, 16, generator=g), torch.float32)
    parts = [h[:, :16] @ w["int8"][:16].float(),
             h[:, 16:] @ w["int8"][16:].float()]
    rank0 = {"int8": w["int8"][:16], "scale": w["scale"]}
    got = tl._row_parallel(h[:, :16], rank0, _FakeTP(parts[1]))
    assert torch.equal(got, (parts[0] + parts[1]) * w["scale"])
    torch.testing.assert_close(got, tl._matmul(h, w), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def world(quantized):
    """One spawn of the ranks for the module: the model steps, then the
    engines, after the JAX references and the single-device engine's
    pages."""
    jq, tree = quantized
    jsh = jmesh.shard_params(jax_mesh(), jq)
    inputs = step_inputs(JCFG, 1)
    step_ref = jax_steps(jl, jsh, JCFG, inputs)
    rng = np.random.default_rng(31)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, 128, n)], mx)
            for i, (n, mx) in enumerate([(11, 6), (19, 5)])]
    ref = {name: js.ServingEngine(jsh, JCFG, js.ServingConfig(**sc)).run(
        [js.Request(r, p, n) for r, p, n in reqs])
        for name, sc in MODES.items()}
    servers = {"one": _server(), "tp": _server()}
    try:
        single = _store(servers["one"])
        try:
            eng = ts.ServingEngine(tl.params_from_jax(tree, "cpu"), TCFG,
                                   ts.ServingConfig(max_slots=2),
                                   store=single, device="cpu")
            ref["single"] = eng.run(torch_tp_ranks._requests(reqs))
            ref["namespace"] = eng._ns
            single_keys = list(single.put_keys)
        finally:
            _close(single)
        hit_reqs = [(f"h{i}", p + ref["plain"][r] + [int(t) for t in
                                                    rng.integers(0, 128, 5)],
                     4) for i, (r, p, _) in enumerate(reqs)]
        ref["hit"] = js.ServingEngine(jsh, JCFG).run(
            [js.Request(r, p, n) for r, p, n in hit_reqs])
        ranks = run_ranks(torch_tp_ranks.several, TP, ([
            (torch_tp_ranks.tp_steps, (TP, "llama", TCFG, tree, inputs)),
            (torch_tp_ranks.serve_cases,
             (TP, TCFG, tree, MODES, reqs, servers["tp"].service_port,
              servers["one"].service_port, hit_reqs))],),
            device="cpu", timeout=RANK_TIMEOUT)
        pages = {}
        for name, srv in servers.items():
            st = _store(srv)
            try:
                pages[name] = st.get_kv_pages_host(
                    single_keys, TCFG.kv_page_shape(), torch.float32).numpy()
            finally:
                _close(st)
    finally:
        for srv in servers.values():
            srv.stop()
    return {"steps": ([r[0] for r in ranks], step_ref),
            "engines": ([r[1] for r in ranks], ref, single_keys, pages)}


@pytest.mark.parametrize("mode", list(MODES))
def test_tp_int8_engine_emits_the_jax_engine_tokens(engines, mode):
    out, ref, _, _ = engines
    for rank_out in out:
        assert rank_out[mode] == ref[mode], mode


def test_tp_int8_offload_writes_the_single_device_pages(engines):
    out, ref, single_keys, pages = engines
    legs = [r["offload"] for r in out]
    assert legs[0]["tokens"] == ref["single"] == ref["plain"]
    assert all(leg["namespace"] == ref["namespace"] for leg in legs)
    assert all(leg["pool_heads"] == TCFG.n_kv_heads // TP for leg in legs)
    assert single_keys and legs[0]["put_keys"] == single_keys
    assert all(not leg["put_keys"] for leg in legs[1:])
    for key, g, w in zip(single_keys, pages["tp"], pages["one"]):
        if "/L0/" in key:
            assert g.tobytes() == w.tobytes(), key
        else:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= TOL, (key, err)


def test_tp_int8_engine_hits_single_device_pages(engines):
    out, ref, _, _ = engines
    for rank_out in out:
        leg = rank_out["hit"]
        assert leg["stats"]["prefix_hit_pages"] > 0
        assert leg["stats"]["store_errors"] == 0
        assert leg["tokens"] == ref["hit"]


def test_tp_int8_engine_tree_is_placed_not_replicated(quantized):
    """The sharded tree's per-rank int8 bytes are 1/tp of the whole's
    (the JAX layout, replicated, would hold them all on every rank)."""
    _, tree = quantized
    whole = tl.params_from_jax(tree, "cpu")
    pl = pmesh.param_shardings(None, whole)
    assert pl["layers"][0]["wo"]["int8"][1].dim == 0
    assert pl["layers"][0]["wq"]["scale"][1].dim == 0
    assert pl["embed"]["scale"][1].is_replicate()
    assert pl["lm_head"]["scale"][1].dim == 0
