"""The port's main path end to end on the CPU: its demo (prefill ->
per-layer offload -> prefix match -> restore -> paged decode -> prefix
hit) through the port's own server, held against the JAX model on the
same weights without any store. float32, so greedy tokens must agree
exactly and logits within 2e-4 (the JAX package's own tolerance for
its paged-vs-dense identities)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch import InfiniStoreServer, ServerConfig
from infinistore_tpu_torch.example import demo_prefill
from infinistore_tpu_torch.models import llama as tl

SEQ = 32


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.125, minimal_allocate_size=16,
    ))
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig(vocab_size=256, d_model=128, n_layers=4,
                          n_heads=4, n_kv_heads=2, d_ff=256, max_seq=256,
                          page_size=16, dtype="float32")
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tl.LlamaConfig(**{f: getattr(jcfg, f)
                             for f in jcfg.__dataclass_fields__})
    tparams = tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def demo(port_server, weights):
    _, _, tcfg, tparams = weights
    return demo_prefill.run("127.0.0.1", port_server.service_port,
                            seq_len=SEQ, device="cpu", params=tparams,
                            cfg=tcfg)


def test_demo_prints_the_milestones(port_server, weights, capsys):
    _, _, tcfg, tparams = weights
    demo_prefill.run("127.0.0.1", port_server.service_port, seq_len=SEQ,
                     device="cpu", params=tparams, cfg=tcfg)
    out = capsys.readouterr().out
    assert f"prefill: {SEQ} tokens" in out
    assert "restored KV" in out
    assert "prefix hit:" in out


def test_greedy_tokens_equal_jax_without_store(demo, weights):
    jcfg, jparams, _, _ = weights
    prompt = jnp.asarray(demo["prompt"].numpy())
    logits, kvs = jl.prefill(jparams, jcfg, prompt)
    n_pages = SEQ // jcfg.page_size
    total = n_pages + 4
    kp = jnp.zeros((jcfg.n_layers, total, *jcfg.kv_page_shape()),
                   jnp.float32)
    vp = jnp.zeros_like(kp)
    for li, (k, v) in enumerate(kvs):
        pk, pv = jl.kv_to_pages(jcfg, k, v)
        kp = kp.at[li, :n_pages].set(pk[0])
        vp = vp.at[li, :n_pages].set(pv[0])
    table = jnp.arange(total, dtype=jnp.int32)[None]
    tok = int(jnp.argmax(logits[0, -1]))
    want = [tok]
    seq_lens = jnp.asarray([SEQ], jnp.int32)
    for _ in range(16):
        lg, kp, vp = jl.decode_step(jparams, jcfg,
                                    jnp.asarray([tok], jnp.int32), seq_lens,
                                    kp, vp, table)
        tok = int(jnp.argmax(lg[0]))
        want.append(tok)
        seq_lens = seq_lens + 1
    assert demo["generated"] == want


def test_prefix_hit_logits_equal_full_prefill(demo, weights):
    _, _, tcfg, tparams = weights
    assert demo["hit"] == SEQ // tcfg.page_size
    tokens = torch.cat([demo["prompt"], demo["cont"]], dim=1)
    full, _ = tl.prefill(tparams, tcfg, tokens)
    np.testing.assert_allclose(demo["tail_logits"].numpy(),
                               full[:, SEQ:].numpy(), rtol=2e-4, atol=2e-4)
