"""Prefill <-> decode disaggregation demo on PyTorch (the port of
``infinistore_tpu/example/demo_prefill.py``).

The prefill worker runs the paged-KV Llama and streams each layer's KV
pages into the store as the layer finishes (LayerStreamer); the decode
worker — a fresh connection here — finds the cached prefix with
get_match_last_index, restores the pages and decodes without recomputing
the prompt. A third leg is the prefix-cache hit: a new request sharing
the prompt restores the cached pages and prefills only its new tail.

Run against a server (``python -m infinistore_tpu_torch.server``)::

    python -m infinistore_tpu_torch.example.demo_prefill --service-port 22345
"""

import argparse
import time
import uuid

import numpy as np
import torch

from infinistore_tpu_torch import ClientConfig, InfinityConnection
from infinistore_tpu_torch._device import resolve_device
from infinistore_tpu_torch.cuda import CudaKVStore, LayerStreamer
from infinistore_tpu_torch.models import llama


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(host, port, seq_len=64, device="cuda", params=None, cfg=None):
    """Run the three legs; returns a dict of what they produced (the
    greedy tokens, the prefix-hit logits and the tokens fed in)."""
    device = resolve_device(device)
    cfg = cfg or llama.LlamaConfig(
        vocab_size=256, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq=256, page_size=16,
    )
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = llama.init_params(gen, cfg, device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, seq_len)), dtype=torch.int32,
        device=device,
    )
    seq_id = f"demo_{uuid.uuid4()}"
    n_pages = seq_len // cfg.page_size

    # ---- prefill node: compute + per-layer streaming upload ----
    prefill_conn = InfinityConnection(
        ClientConfig(host_addr=host, service_port=port)
    )
    prefill_conn.connect()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, kvs = llama.prefill(params, cfg, prompt)
    _sync(device)
    t_compute = time.perf_counter() - t0

    t0 = time.perf_counter()
    with LayerStreamer(prefill_conn) as streamer:
        for li, (k, v) in enumerate(kvs):  # layer by layer, non-blocking
            kp, vp = llama.kv_to_pages(cfg, k, v)
            streamer.submit_pages(
                llama.page_keys(seq_id, li, "k", n_pages), kp[0])
            streamer.submit_pages(
                llama.page_keys(seq_id, li, "v", n_pages), vp[0])
        streamer.finish()
    t_upload = time.perf_counter() - t0
    first_token = int(torch.argmax(logits[0, -1]))
    prefill_conn.close()
    print(
        f"prefill: {seq_len} tokens, compute {t_compute*1e3:.1f} ms, "
        f"KV upload {t_upload*1e3:.1f} ms "
        f"({cfg.n_layers * 2 * n_pages} pages)"
    )

    # ---- decode node: discover prefix, restore pages, decode ----
    decode_conn = InfinityConnection(
        ClientConfig(host_addr=host, service_port=port)
    )
    decode_conn.connect()
    dstore = CudaKVStore(decode_conn, device)
    try:
        probe = llama.page_keys(seq_id, 0, "k", n_pages + 4)
        cached = dstore.cached_prefix_len(probe)
        assert cached == n_pages, \
            f"expected {n_pages} cached pages, got {cached}"
        print(f"decode: found {cached} cached pages/layer for {seq_id}")

        total_pages = n_pages + 4  # room to grow during decode
        shape = (cfg.n_layers, total_pages, *cfg.kv_page_shape())
        k_pages = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
        v_pages = torch.zeros_like(k_pages)
        t0 = time.perf_counter()
        kp, vp = llama.restore_prefix_pages(
            dstore, cfg,
            lambda li, kind: llama.page_keys(seq_id, li, kind, n_pages),
            n_pages,
        )
        k_pages[:, :n_pages] = kp
        v_pages[:, :n_pages] = vp
        _sync(device)
        t_restore = time.perf_counter() - t0
        print(f"decode: restored KV in {t_restore*1e3:.1f} ms (no recompute)")

        page_table = torch.arange(total_pages, dtype=torch.int32,
                                  device=device)[None]
        token = torch.tensor([first_token], dtype=torch.int32, device=device)
        seq_lens = torch.tensor([seq_len], dtype=torch.int32, device=device)
        generated = [first_token]
        t0 = time.perf_counter()
        for _ in range(16):
            logits, k_pages, v_pages = llama.decode_step(
                params, cfg, token, seq_lens, k_pages, v_pages, page_table
            )
            nxt = int(torch.argmax(logits[0]))
            generated.append(nxt)
            token = torch.tensor([nxt], dtype=torch.int32, device=device)
            seq_lens = seq_lens + 1
        _sync(device)
        t_decode = time.perf_counter() - t0
        print(f"decode: 16 tokens in {t_decode*1e3:.1f} ms "
              f"→ {generated[:8]}...")

        # ---- new request sharing the prompt: prefix-cache HIT ----
        s_new = cfg.page_size  # one new page of tokens after the prompt
        cont = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, s_new)), dtype=torch.int32,
            device=device,
        )
        hit = dstore.cached_prefix_len(
            llama.page_keys(seq_id, 0, "k", n_pages + s_new // cfg.page_size)
        )
        t0 = time.perf_counter()
        prefix_kvs = llama.restore_prefix_kvs(dstore, cfg, seq_id, hit)
        with torch.no_grad():
            tail_logits, _ = llama.prefill_with_prefix(params, cfg, cont,
                                                       prefix_kvs)
        _sync(device)
        t_hit = time.perf_counter() - t0
        print(
            f"prefix hit: {hit} pages reused, prefilled {s_new} new tokens "
            f"over a {hit * cfg.page_size}-token cached prefix in "
            f"{t_hit*1e3:.1f} ms (prefix FLOPs skipped)"
        )
    finally:
        dstore.close()
        decode_conn.close()
    return {"prompt": prompt, "generated": generated, "cont": cont,
            "tail_logits": tail_logits, "hit": hit}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--service-port", type=int, default=22345)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    run(args.host, args.service_port, args.seq_len, args.device)
