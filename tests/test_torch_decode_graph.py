"""The decode step's one KV write and the decode graph's plumbing, on the
CPU.

``ops.paged_kv_write.kv_write_plain`` (the plain version of the CUDA
write every decode step makes, eager or captured by a
``llama.DecodeGraph``) against ``drop_mode_rows`` + ``scatter_rows``
(``verify_step``'s write): the same rows land, the same are dropped,
and of rows that share a target the last writes. ``kv_write_plain`` is
also held to the JAX package's own drop-mode write
(``scatter_kv_to_pages``) on the same pools, rows and targets, and the
port's ``decode_step`` (llama and moe, with and without a window) to the
JAX package's on the same weights and inputs. ``decode_step(...,
graph=)`` on CPU tensors takes the eager step; and an engine holds a
graph only on a card, with no mesh, for a family that offers one. The
CUDA kernel itself, and the graph against the eager step, are checked
on the card by ``chip_smoke.py`` (phases 3c and 6) and
``tools/torch_decode_graph_ab.py``."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu.models import moe as jm
from infinistore_tpu.ops import paged_attention as jpa
from infinistore_tpu_torch import serving
from infinistore_tpu_torch.models import llama, moe
from infinistore_tpu_torch.ops import paged_kv_write
from infinistore_tpu_torch.ops.paged_attention import (drop_mode_rows,
                                                       scatter_rows)

N_PAGES, PAGE, N_KV, HD, WIDTH = 9, 4, 2, 8, 3
# The port's f32 decode step against the JAX package's: the tolerance of
# the two packages' dense and paged parity tests (test_torch_llama.py).
TOL = 2e-4


def _targets(page_table, seq_lens):
    """(page, slot) of each row's new token, as the decode step aims
    them: a position past the table at page N_PAGES (outside the pool)."""
    page_idx = (seq_lens // PAGE).long()
    target = page_table.gather(
        1, page_idx.clamp(max=WIDTH - 1)[:, None])[:, 0].long()
    target = torch.where(page_idx < WIDTH, target, N_PAGES)
    return target, (seq_lens % PAGE).long()


def _case(name, batch, gen):
    """page_table [batch, WIDTH] and seq_lens [batch] of one case."""
    table = torch.randint(1, N_PAGES, (batch, WIDTH), generator=gen,
                          dtype=torch.int32)
    lens = torch.randint(0, WIDTH * PAGE, (batch,), generator=gen,
                         dtype=torch.int32)
    if name == "past_table":
        lens[::2] = WIDTH * PAGE + torch.arange(0, batch, 2,
                                                dtype=torch.int32)
    elif name == "inactive":
        # The engine's idle slots: no tokens, a table of scratch page 0;
        # all of them aim at (0, 0), and the last one writes.
        table[1::2] = 0
        lens[1::2] = 0
    elif name == "last_page":
        table[:, -1] = N_PAGES - 1
        lens[:] = WIDTH * PAGE - 1
    elif name == "ids_outside_pool":
        # -1 wraps to the last page; N_PAGES and -N_PAGES - 1 are dropped.
        table[0::3] = -1
        table[1::3] = N_PAGES
        table[2::3] = -N_PAGES - 1
    return table, lens


CASES = ("past_table", "inactive", "last_page", "ids_outside_pool",
         "mixed")


@pytest.mark.parametrize("batch", (1, 32))
@pytest.mark.parametrize("name", CASES)
def test_kv_write_matches_drop_mode_scatter(name, batch):
    gen = torch.Generator().manual_seed(CASES.index(name) * 100 + batch)
    table, lens = _case(name, batch, gen)
    page, slot = _targets(table, lens)
    k_new = torch.randn(batch, 1, N_KV, HD, generator=gen)
    v_new = torch.randn(batch, 1, N_KV, HD, generator=gen)
    k_pool = torch.randn(N_PAGES, PAGE, N_KV, HD, generator=gen)
    v_pool = torch.randn(N_PAGES, PAGE, N_KV, HD, generator=gen)

    want_k, want_v = k_pool.clone(), v_pool.clone()
    entries, rows = drop_mode_rows(page[:, None], slot[:, None], N_PAGES,
                                   PAGE)
    scatter_rows(want_k, k_new, entries, rows)
    scatter_rows(want_v, v_new, entries, rows)
    got_k, got_v = k_pool.clone(), v_pool.clone()
    paged_kv_write.write_kv_rows(got_k, got_v, k_new, v_new, page, slot)

    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    landed = int(rows.numel())
    if name in ("past_table", "ids_outside_pool") and batch > 1:
        assert landed < batch  # the case does drop rows
    if name == "inactive" and batch > 1:
        # The last idle row's KV is what scratch (0, 0) holds.
        assert torch.equal(got_k[0, 0], k_new[batch - 1, 0])


@pytest.mark.parametrize("batch", (1, 32))
@pytest.mark.parametrize("name", CASES)
def test_kv_write_matches_jax_drop_mode(name, batch):
    """kv_write_plain against the JAX package's scatter (mode="drop") on
    the same pools, rows and targets, negative wraps and ids outside the
    pool among them. JAX leaves the order of rows that share a target
    unspecified: there the JAX pool must hold one of those rows, and
    every other entry must be equal."""
    gen = torch.Generator().manual_seed(CASES.index(name) * 100 + batch + 7)
    table, lens = _case(name, batch, gen)
    page, slot = _targets(table, lens)
    k_new = torch.randn(batch, 1, N_KV, HD, generator=gen)
    v_new = torch.randn(batch, 1, N_KV, HD, generator=gen)
    k_pool = torch.randn(N_PAGES, PAGE, N_KV, HD, generator=gen)
    v_pool = torch.randn(N_PAGES, PAGE, N_KV, HD, generator=gen)

    got_k, got_v = k_pool.clone(), v_pool.clone()
    paged_kv_write.kv_write_plain(got_k, got_v, k_new, v_new, page, slot)
    pg, sl = jnp.asarray(page.numpy()), jnp.asarray(slot.numpy())
    want_k = np.asarray(jpa.scatter_kv_to_pages(
        jnp.asarray(k_pool.numpy()), jnp.asarray(k_new.numpy()), pg, sl))
    want_v = np.asarray(jpa.scatter_kv_to_pages(
        jnp.asarray(v_pool.numpy()), jnp.asarray(v_new.numpy()), pg, sl))

    # The rows each target (after the wrap) receives; dropped rows none.
    writers = {}
    for b, (p, s) in enumerate(zip(page.tolist(), slot.tolist())):
        p += N_PAGES if p < 0 else 0
        s += PAGE if s < 0 else 0
        if 0 <= p < N_PAGES and 0 <= s < PAGE:
            writers.setdefault((p, s), []).append(b)
    shared = {t: rows for t, rows in writers.items() if len(rows) > 1}
    if name == "inactive" and batch > 1:
        assert (0, 0) in shared  # the idle rows collide on scratch (0, 0)
    for got, want, new in ((got_k, want_k, k_new), (got_v, want_v, v_new)):
        got = got.numpy()
        keep = np.ones((N_PAGES, PAGE), dtype=bool)
        for (p, s), rows in shared.items():
            keep[p, s] = False
            assert any(np.array_equal(want[p, s], new[b, 0].numpy())
                       for b in rows)
            # The port's write: the last of the rows.
            np.testing.assert_array_equal(got[p, s], new[rows[-1], 0])
        np.testing.assert_array_equal(got[keep], want[keep])
    if name in ("past_table", "ids_outside_pool") and batch > 1:
        assert sum(map(len, writers.values())) < batch  # rows dropped


def _small(window=0):
    return llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                             page_size=PAGE, window=window, dtype="float32")


def _step_inputs(cfg, batch, gen):
    table = torch.randint(1, N_PAGES, (batch, WIDTH), generator=gen,
                          dtype=torch.int32)
    lens = torch.randint(1, WIDTH * PAGE, (batch,), generator=gen,
                         dtype=torch.int32)
    lens[0] = WIDTH * PAGE + 2   # past the table: its KV is dropped
    table[-1], lens[-1] = 0, 0   # an idle slot on scratch page 0
    token = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                          dtype=torch.int32)
    shape = (cfg.n_layers, N_PAGES, PAGE, cfg.n_kv_heads, cfg.head_dim)
    pools = torch.randn(shape, generator=gen), torch.randn(shape,
                                                           generator=gen)
    return token, lens, pools, table


def _numpy_tree(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


@pytest.mark.parametrize("window", (0, 6))
@pytest.mark.parametrize("family", ("llama", "moe"))
def test_decode_step_write_matches_jax_decode_step(family, window):
    """The port's decode step (its one KV write, ``write_kv_rows``)
    against the JAX package's (``scatter_kv_to_pages``, mode="drop") on
    the same weights, pools and inputs: a row past the table and an idle
    row on scratch page 0 among them. Logits and both pools, f32. The
    MoE's capacity drops no token; the JAX step routes the idle row and
    the port's does not, so for the MoE the idle row's logits and page 0
    (where its later layers' KV land) are left out."""
    fields = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=64, max_seq=64, page_size=PAGE,
                  window=window, dtype="float32")
    if family == "llama":
        jmod, tmod, jcfg = jl, llama, jl.LlamaConfig(**fields)
        cfg = llama.LlamaConfig(**fields)
    else:
        jmod, tmod = jm, moe
        jcfg = jm.MoEConfig(**fields, n_experts=4, top_k=2,
                            capacity_factor=4.0)
        cfg = moe.MoEConfig(**dataclasses.asdict(jcfg))
    jparams = jmod.init_params(jax.random.PRNGKey(5 + window), jcfg)
    params = llama.params_from_jax(_numpy_tree(jparams), device="cpu")
    gen = torch.Generator().manual_seed(7 + window)
    token, lens, (kp, vp), table = _step_inputs(cfg, 5, gen)
    want, jk, jv = jmod.decode_step(
        jparams, jcfg, jnp.asarray(token.numpy()), jnp.asarray(lens.numpy()),
        jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(table.numpy()))
    got, k, v = tmod.decode_step(params, cfg, token, lens, kp, vp, table)
    rows = slice(None) if family == "llama" else slice(0, -1)
    pages = slice(None) if family == "llama" else slice(1, None)
    np.testing.assert_allclose(got[rows].numpy(), np.asarray(want)[rows],
                               rtol=TOL, atol=TOL)
    for t, j in ((k, jk), (v, jv)):
        np.testing.assert_allclose(t[:, pages].numpy(),
                                   np.asarray(j)[:, pages], rtol=TOL,
                                   atol=TOL)


def test_decode_step_with_graph_on_cpu_takes_the_eager_step():
    cfg = _small()
    gen = torch.Generator().manual_seed(3)
    params = llama.init_params(gen, cfg, "cpu")
    token, lens, (kp, vp), table = _step_inputs(cfg, 4, gen)
    kp2, vp2 = kp.clone(), vp.clone()
    graph = llama.DecodeGraph()
    want, _, _ = llama.decode_step(params, cfg, token, lens, kp, vp, table)
    got, _, _ = llama.decode_step(params, cfg, token, lens, kp2, vp2, table,
                                  graph=graph)
    assert torch.equal(got, want)
    assert torch.equal(kp2, kp) and torch.equal(vp2, vp)
    assert graph.counters == {"decode_graph_captures": 0,
                              "decode_graph_replays": 0}


CUDA = torch.device("cuda", 0)  # a device object only: nothing runs on it


def test_graph_eligibility_rules():
    stats = {}
    graph = serving._decode_graph(llama, CUDA, {}, stats)
    assert isinstance(graph, llama.DecodeGraph) and graph.counters is stats
    assert serving._decode_graph(llama, CUDA, {"tp": object()}, {}) is None
    assert serving._decode_graph(moe, CUDA, {"ep": object()}, {}) is None
    assert serving._decode_graph(moe, CUDA, {}, {}) is None
    assert serving._decode_graph(llama, torch.device("cpu"), {}, {}) is None


def test_graph_eligibility_through_the_benchmark_spy():
    """The benchmark serves through a spy of the model module (its
    decode_step takes ``**kw``): the graph still follows the module."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "perfbench"))
    try:
        from harness.model import ModelSpy
    finally:
        sys.path.pop(0)
    assert isinstance(serving._decode_graph(ModelSpy(llama), CUDA, {}, {}),
                      llama.DecodeGraph)
    assert serving._decode_graph(ModelSpy(moe), CUDA, {}, {}) is None


@pytest.mark.parametrize("family", ("llama", "moe"))
def test_cpu_engines_decode_eager_and_count_no_graph(family):
    if family == "llama":
        cfg = _small()
        params = llama.init_params(torch.Generator().manual_seed(1), cfg,
                                   "cpu")
        model = llama
    else:
        cfg = moe.MoEConfig(vocab_size=64, d_model=32, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64,
                            page_size=PAGE, n_experts=4, top_k=2,
                            dtype="float32")
        params = moe.init_params(torch.Generator().manual_seed(1), cfg,
                                 "cpu")
        model = moe
    eng = serving.ServingEngine(
        params, cfg, serving.ServingConfig(max_slots=2, total_pages=17,
                                           max_pages_per_seq=8),
        model=model, device="cpu")
    assert eng._gkw == {}
    eng.run([serving.Request("a", [1, 2, 3, 4, 5], max_new_tokens=6),
             serving.Request("b", [6, 7], max_new_tokens=4)])
    assert eng.stats["decode_steps"] > 0
    assert eng.stats["decode_graph_captures"] == 0
    assert eng.stats["decode_graph_replays"] == 0
