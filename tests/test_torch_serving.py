"""The port's ServingEngine against the JAX package's, on the same weights
(``params_from_jax``) and the same requests, and against the port's own
store server. float32 on the CPU, so greedy streams must agree token for
token; seeded sampled streams too, since both engines sample on the host
with numpy from the same seed. Content keys and the key namespace must
be byte-identical, so both engines hit each other's pages in one store."""

import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from infinistore_tpu import serving as js
from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                   InfinityConnection, ServerConfig,
                                   TYPE_SHM)
from infinistore_tpu_torch import cuda as tcuda
from infinistore_tpu_torch import serving as ts
from infinistore_tpu_torch.cuda import CudaKVStore
from infinistore_tpu_torch.models import llama as tl
from infinistore_tpu_torch.serving_http import ServingHTTPServer

JCFG = jl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=128, max_seq=128, page_size=8,
                      dtype="float32")
JCFG_WINDOW = dataclasses.replace(JCFG, window=16)


def _tcfg(jcfg):
    return tl.LlamaConfig(**dataclasses.asdict(jcfg))


def _numpy_tree(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def models():
    """{name: (jax cfg, jax params, port cfg, port params)}."""
    out = {}
    for name, jcfg in (("full", JCFG), ("window", JCFG_WINDOW)):
        jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, jparams, _tcfg(jcfg),
                     tl.params_from_jax(_numpy_tree(jparams), device="cpu"))
    return out


def _prompt(rng, n):
    return [int(t) for t in rng.integers(0, JCFG.vocab_size, n)]


# ---- content keys --------------------------------------------------------


@pytest.mark.parametrize("jcfg", [JCFG, JCFG_WINDOW],
                         ids=["full", "window"])
def test_keys_and_namespace_byte_identical(models, jcfg):
    name = "window" if jcfg.window else "full"
    _, jparams, tcfg, tparams = models[name]
    rng = np.random.default_rng(0)
    tokens = _prompt(rng, 45)
    for ns in ("", "model/p8"):
        assert (ts.content_page_digests(tokens, 8, 5, ns)
                == js.content_page_digests(tokens, 8, 5, ns))
        for li, kind in ((0, "k"), (1, "v")):
            assert (ts.content_page_keys(tokens, 8, 5, li, kind, ns)
                    == js.content_page_keys(tokens, 8, 5, li, kind, ns))
    sc = dict(model_id="ckpt-a", max_slots=1, total_pages=8)
    j_eng = js.ServingEngine(jparams, jcfg, js.ServingConfig(**sc))
    t_eng = ts.ServingEngine(tparams, tcfg, ts.ServingConfig(**sc),
                             device="cpu")
    assert t_eng._ns == j_eng._ns
    # The per-slot incremental chain formats the same keys.
    slot = ts._Slot(work=ts._Work(ts.Request("r", tokens[:20]),
                                  tokens[:20]),
                    page_ids=[], seq_len=45, generated=tokens[20:])
    assert t_eng._slot_digests(slot, 5) == js.content_page_digests(
        tokens, 8, 5, j_eng._ns)


# ---- store-less parity with the JAX engine -------------------------------


class _Oracle:
    """Proposes the recorded greedy continuation of a context: every
    draft is accepted."""

    def __init__(self, prompts, outputs):
        self.lookup = {}
        for p, o in zip(prompts, outputs):
            toks = list(p) + list(o)
            for i in range(len(p), len(toks)):
                self.lookup[tuple(toks[:i])] = toks[i:]

    def __call__(self, context, k):
        return self.lookup.get(tuple(context), [])[:k]


PARITY_CASES = {
    "plain": ("full", dict(max_slots=2, total_pages=32)),
    "spec": ("full", dict(max_slots=2, spec_k=3)),
    "chunked": ("full", dict(max_slots=2, prefill_chunk=8)),
    "multistep": ("full", dict(max_slots=2, host_steps=4)),
    "window": ("window", dict(max_slots=2, total_pages=32)),
    "sampled": ("full", dict(max_slots=2)),
}


@pytest.fixture(scope="module")
def mix(models):
    """Three prompts of different lengths, and an eos_id that the first
    request's plain greedy stream emits at its third token."""
    rng = np.random.default_rng(1)
    prompts = [_prompt(rng, n) for n in (5, 13, 20)]
    jcfg, jparams, _, _ = models["full"]
    ref = js.ServingEngine(jparams, jcfg, js.ServingConfig(max_slots=2))
    first = ref.run([js.Request("p", prompts[0], max_new_tokens=3)])["p"]
    return prompts, first[2]


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_engine_token_parity_with_jax(models, mix, case):
    model, sc = PARITY_CASES[case]
    jcfg, jparams, tcfg, tparams = models[model]
    prompts, eos = mix
    sc = dict(sc, eos_id=eos)
    n_new = 24 if case == "window" else 10
    sample = dict(temperature=0.8, top_k=20, seed=5)

    def requests(mod):
        out = []
        for i, p in enumerate(prompts):
            kw = sample if case == "sampled" and i == 1 else {}
            out.append(mod.Request(f"r{i}", p, max_new_tokens=n_new, **kw))
        return out

    proposer = None
    if case == "spec":
        plain = js.ServingEngine(jparams, jcfg, js.ServingConfig(**sc))
        ref = plain.run(requests(js))
        proposer = _Oracle(prompts, [ref[f"r{i}"] for i in range(3)])
    j_eng = js.ServingEngine(jparams, jcfg, js.ServingConfig(**sc),
                             proposer=proposer)
    want = j_eng.run(requests(js))
    t_eng = ts.ServingEngine(tparams, tcfg, ts.ServingConfig(**sc),
                             proposer=proposer, device="cpu")
    got = t_eng.run(requests(ts))
    assert got == want
    assert any(len(v) < n_new for v in got.values())  # an EOS stop
    for key in ("decode_steps", "decoded_tokens", "spec_proposed",
                "spec_accepted", "chunk_steps", "burst_steps"):
        assert t_eng.stats[key] == j_eng.stats[key], key
    if case == "spec":
        assert t_eng.stats["spec_accepted"] > 0
    if case == "chunked":
        assert t_eng.stats["chunk_steps"] > 0
    if case == "multistep":
        assert t_eng.stats["burst_steps"] > 0
    if case == "window":
        # 44 tokens at page 8 would hold 6 pages without release.
        assert sorted(t_eng.free_pages) == list(range(1, 32))
    assert sorted(t_eng.free_pages) == list(range(1, t_eng.sc.total_pages))


# ---- against the port's own store server ---------------------------------


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.125, minimal_allocate_size=16,
    ))
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture
def store(port_server):
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=port_server.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    st = CudaKVStore(conn, device="cpu")
    yield st
    st.close()
    conn.close()


def test_multiturn_prefix_hit_through_store(models, store):
    _, _, tcfg, tparams = models["full"]
    rng = np.random.default_rng(2)
    turn1 = _prompt(rng, 16)
    eng1 = ts.ServingEngine(tparams, tcfg, store=store, device="cpu")
    out1 = eng1.run([ts.Request("t1", turn1, max_new_tokens=8)])
    assert eng1.stats["offloaded_pages"] > 0
    convo = turn1 + out1["t1"]
    turn2 = convo[: (len(convo) // 8) * 8] + _prompt(rng, 5)
    eng2 = ts.ServingEngine(tparams, tcfg, store=store, device="cpu")
    out2 = eng2.run([ts.Request("t2", turn2, max_new_tokens=6)])
    assert eng2.stats["prefix_hit_pages"] > 0
    cold = ts.ServingEngine(tparams, tcfg, device="cpu")
    assert out2["t2"] == cold.run([ts.Request("x", turn2,
                                              max_new_tokens=6)])["x"]


def test_preemption_through_store_resumes_exactly(models, store):
    _, _, tcfg, tparams = models["full"]
    rng = np.random.default_rng(7)
    prompts = [_prompt(rng, 16) for _ in range(2)]
    sc = ts.ServingConfig(max_slots=2, total_pages=8, max_pages_per_seq=8)
    eng = ts.ServingEngine(tparams, tcfg, sc, store=store, device="cpu")
    out = eng.run([ts.Request(f"r{i}", p, max_new_tokens=24)
                   for i, p in enumerate(prompts)])
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["prefix_hit_pages"] > 0  # the resume restored pages
    for i, p in enumerate(prompts):
        big = ts.ServingEngine(tparams, tcfg,
                               ts.ServingConfig(max_slots=1, total_pages=16),
                               device="cpu")
        assert out[f"r{i}"] == big.run([ts.Request("x", p, 24)])["x"]
    assert sorted(eng.free_pages) == list(range(1, 8))


class _FlakyStore:
    """A store that fails on the chosen operation."""

    class _Conn:
        def sync(self):
            pass

    def __init__(self, fail_on):
        self.fail_on = fail_on
        self.calls = []
        self.conn = self._Conn()

    def cached_prefix_len(self, keys):
        self.calls.append("probe")
        if self.fail_on == "probe":
            raise ConnectionError("store down")
        return 1 if self.fail_on == "get" else 0

    def get_kv_pages(self, keys, page_shape, dtype, device=None):
        self.calls.append("get")
        raise ConnectionError("evicted mid-restore")

    def put_kv_pages(self, keys, pages, sync=False):
        self.calls.append("put")
        if self.fail_on == "put":
            raise ConnectionError("store down")


@pytest.mark.parametrize("fail_on", ["probe", "get", "put"])
def test_store_failure_degrades_to_storeless(models, fail_on):
    _, _, tcfg, tparams = models["full"]
    prompt = _prompt(np.random.default_rng(10), 16)
    flaky = _FlakyStore(fail_on)
    eng = ts.ServingEngine(tparams, tcfg, store=flaky, device="cpu")
    out = eng.run([ts.Request("r", prompt, max_new_tokens=5)])
    ref = ts.ServingEngine(tparams, tcfg, device="cpu").run(
        [ts.Request("x", prompt, max_new_tokens=5)])
    assert out["r"] == ref["x"]
    assert eng.stats["store_errors"] == 1
    n_calls = len(flaky.calls)
    eng.run([ts.Request("r2", prompt, max_new_tokens=3)])
    assert len(flaky.calls) == n_calls  # the downgrade is sticky


def test_quantized_store_and_misplaced_params_raise(models):
    """An int8-wire engine builds (the quantized store is ported; its
    behaviour is checked in the tests below), and parameters that lie off
    the engine's device are refused, with or without the int8 wire."""
    _, _, tcfg, tparams = models["full"]
    eng = ts.ServingEngine(tparams, tcfg,
                           ts.ServingConfig(quantized_store=True),
                           device="cpu")
    assert eng._ns.endswith("/q8")
    meta = {k: v for k, v in tparams.items()}
    meta["lm_head"] = tparams["lm_head"].to("meta")
    for quantized in (False, True):
        with pytest.raises(ValueError, match="params lie on"):
            ts.ServingEngine(meta, tcfg,
                             ts.ServingConfig(quantized_store=quantized),
                             device="cpu")


# ---- int8 pages on the wire, int8 weights --------------------------------


def test_quantized_store_namespace_matches_jax(models):
    _, jparams, tcfg, tparams = models["full"]
    for quantized in (False, True):
        sc = dict(model_id="ckpt-q", quantized_store=quantized)
        j_eng = js.ServingEngine(jparams, JCFG, js.ServingConfig(**sc))
        t_eng = ts.ServingEngine(tparams, tcfg, ts.ServingConfig(**sc),
                                 device="cpu")
        assert t_eng._ns == j_eng._ns
        assert t_eng._ns.endswith("/q8" if quantized else "/float32")


def test_multiturn_prefix_hit_through_int8_pages(models, store):
    """quantized_store=True: turn 2 hits turn 1's int8 pages and restores
    them through dequantization; int8 and raw pages never cross-hit."""
    _, _, tcfg, tparams = models["full"]
    rng = np.random.default_rng(9)
    turn1 = _prompt(rng, 16)
    qsc = ts.ServingConfig(quantized_store=True)
    tcuda.reset_copy_counters()
    eng1 = ts.ServingEngine(tparams, tcfg, qsc, store=store, device="cpu")
    out1 = eng1.run([ts.Request("t1", turn1, max_new_tokens=8)])
    assert eng1.stats["offloaded_pages"] > 0
    assert tcuda.copy_counters["staging_copies"] == 0
    convo = turn1 + out1["t1"]
    turn2 = convo[: (len(convo) // 8) * 8] + _prompt(rng, 5)
    eng2 = ts.ServingEngine(tparams, tcfg, qsc, store=store, device="cpu")
    out2 = eng2.run([ts.Request("t2", turn2, max_new_tokens=6)])
    assert eng2.stats["prefix_hit_pages"] > 0
    assert eng2.stats["restored_pages"] > 0
    # The restored pages are turn 1's KV through the int8 wire: within the
    # quantizer's error of a cold prefill's, so the streams agree here.
    cold = ts.ServingEngine(tparams, tcfg, device="cpu")
    assert out2["t2"] == cold.run([ts.Request("x", turn2,
                                              max_new_tokens=6)])["x"]

    raw = ts.ServingEngine(tparams, tcfg, store=store, device="cpu")
    raw.run([ts.Request("r", turn2, max_new_tokens=2)])
    assert raw.stats["prefix_hit_pages"] == 0
    fresh = _prompt(rng, 24)
    raw2 = ts.ServingEngine(tparams, tcfg, store=store, device="cpu")
    raw2.run([ts.Request("r2", fresh, max_new_tokens=2)])
    assert raw2.stats["offloaded_pages"] > 0
    q8 = ts.ServingEngine(tparams, tcfg, qsc, store=store, device="cpu")
    q8.run([ts.Request("q", fresh, max_new_tokens=2)])
    assert q8.stats["prefix_hit_pages"] == 0


def test_jax_and_port_engines_share_int8_pages(models, port_server):
    """A JAX engine's int8 pages, written through the port's store from
    the bytes the JAX package packs, are hits for the port's engine."""
    from infinistore_tpu.ops import kv_quant as jq

    jcfg, jparams, tcfg, tparams = models["full"]
    sc = dict(model_id="shared-q8", quantized_store=True)
    j_eng = js.ServingEngine(jparams, jcfg, js.ServingConfig(**sc))
    prompt = _prompt(np.random.default_rng(12), 17)
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=port_server.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    st = CudaKVStore(conn, device="cpu")
    try:
        _, kvs = jl.prefill(jparams, jcfg, jax.numpy.asarray([prompt]))
        digests = js.content_page_digests(prompt, 8, 2, j_eng._ns)
        for li, (k, v) in enumerate(kvs):
            for kind, x in (("k", k), ("v", v)):
                pages, _ = jl.kv_to_pages(jcfg, x[:, :16], x[:, :16])
                packed = jq.pack_pages_host(*jq.quantize_kv_pages(pages[0]))
                st.put_kv_pages(js.content_page_keys(
                    [], 0, 0, li, kind, digests=digests),
                    torch.from_numpy(packed), sync=True)
        t_eng = ts.ServingEngine(tparams, tcfg, ts.ServingConfig(**sc),
                                 store=st, device="cpu")
        assert t_eng._ns == j_eng._ns
        out = t_eng.run([ts.Request("t", prompt, max_new_tokens=4)])
        assert t_eng.stats["prefix_hit_pages"] == 2
        assert len(out["t"]) == 4
    finally:
        st.close()
        conn.close()


ENGINE_Q_CASES = {
    "plain": dict(max_slots=2, total_pages=32),
    "spec": dict(max_slots=2, spec_k=3),
    "chunked": dict(max_slots=2, prefill_chunk=8, host_steps=4),
}


@pytest.mark.parametrize("case", list(ENGINE_Q_CASES))
def test_engine_on_quantized_weights_matches_jax(models, mix, case):
    """Store-less at f32, the port's engine on quantize_params weights
    emits the JAX engine's tokens on the same quantized tree."""
    jcfg, jparams, tcfg, tparams = models["full"]
    j_q = jl.quantize_params(jparams, jcfg)
    t_q = tl.quantize_params(tparams, tcfg)
    prompts, _ = mix
    sc = ENGINE_Q_CASES[case]

    def requests(mod):
        return [mod.Request(f"r{i}", p, max_new_tokens=10)
                for i, p in enumerate(prompts)]

    want = js.ServingEngine(j_q, jcfg, js.ServingConfig(**sc)).run(
        requests(js))
    t_eng = ts.ServingEngine(t_q, tcfg, ts.ServingConfig(**sc),
                             device="cpu")
    assert t_eng.run(requests(ts)) == want


# ---- the HTTP front end --------------------------------------------------


def _post(port, body):
    return urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST"), timeout=60)


def test_http_front_end_serves_generate(models):
    _, _, tcfg, tparams = models["full"]
    eng = ts.ServingEngine(tparams, tcfg, device="cpu")
    web = ServingHTTPServer(eng)
    port = web.start()
    try:
        prompt = _prompt(np.random.default_rng(3), 11)
        results = {}

        def plain():
            results["plain"] = json.loads(_post(port, {
                "prompt": prompt, "max_new_tokens": 6,
                "stream": False}).read())

        t = threading.Thread(target=plain)
        t.start()
        streamed, final = [], None
        with _post(port, {"prompt": prompt, "max_new_tokens": 6}) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                ev = json.loads(line[6:])
                if ev.get("done"):
                    final = ev
                else:
                    streamed.append(ev["token"])
        t.join(60)
        assert final is not None and streamed == final["tokens"]
        assert len(streamed) == 6
        ref = ts.ServingEngine(tparams, tcfg, device="cpu").run(
            [ts.Request("x", prompt, max_new_tokens=6)])["x"]
        assert final["tokens"] == ref == results["plain"]["tokens"]
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=10).read())
        assert health == {"status": "ok"}
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=10).read())
        assert stats["requests_done"] == 2 and stats["engine_ok"]
        assert stats["engine"]["requests"] == 2
    finally:
        web.shutdown()
