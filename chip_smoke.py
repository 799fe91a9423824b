#!/usr/bin/env python3
"""Drive infinistore_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Device and build: the card's name and power limit; the store library
   and the CUDA kernels built from this checkout's sources into
   infinistore_tpu_torch/_build/ (side by side), with their build times.
2. Flash prefill kernel (csrc/flash_prefill.cu) against its plain
   PyTorch version on the card, at the main path's shapes.
3. Paged decode kernel (csrc/paged_decode.cu) against its plain version:
   ragged lengths, a shuffled pool, a table padded with out-of-range ids.
4. The main path at Llama-3.1-8B width (random weights from a seed)
   through the port's own server on SHM: prefill 4 prompts streaming
   every layer's pages, find the prefix on a fresh connection, restore
   into one device page pool, decode the 4 sequences as a batch, and a
   prefix-hit request that prefills only its new tail. Launch counts
   show the path ran through both kernels.
5. A JSON line of per-kernel numbers, the card line, and as the last
   line {"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import uuid

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): bf16 tensor cores, float32 FMA, HBM.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BPS = 3.35e12

# Kernel against plain version: the largest relative L2 error over the
# output rows (one head of one query token), ||out - ref|| / ||ref|| per
# row, so a fault in any one sequence, head or query position shows at
# that row's own scale. On an H100 the sound kernels read at most 4.9e-3
# (bf16) and 8.3e-7 (f32); kernels with a planted fault (a kv tile, a
# page or the tokens past 2048 skipped, a window floor one tile or page
# high) read 0.31 and more (tools/torch_kernel_faults.py).
TOL_REL = {"bfloat16": 1.5e-2, "float32": 1e-5}

PROMPTS = (2048, 1536, 1024, 512)
DECODE_STEPS = 32
HIT_NEW = 256
SEED = 0


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(out, ref):
    """Largest relative L2 error over the rows of the last dimension."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    return ((o - r).norm(dim=-1) / r.norm(dim=-1)).max().item()


def abs_err(out, ref):
    return (out.float() - ref.float()).abs().max().item()


def bound_ms(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def build_all(native, kernels):
    times, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # re-raised below, after both finish
            errors.append(e)
        times[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=a) for a in
               (("store library", native.build_native),
                ("CUDA kernels", kernels.lib))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, t in times.items():
        say(f"build: {name} in {t:.1f} s")


# ---------------------------------------------------------------------------
# phase 2: flash prefill
# ---------------------------------------------------------------------------

def causal_pairs(s_q, s_kv, window):
    """(query, key) pairs the causal (windowed) mask keeps."""
    off = s_kv - s_q
    total = 0
    for i in range(s_q):
        hi = i + off + 1
        lo = max(0, i + off - window + 1) if window else 0
        total += hi - lo
    return total


# (dtype, batch, s_q, s_kv, window); 32 heads, 8 kv heads, hd 128.
FLASH_CASES = (
    ("bfloat16", 1, 2048, 2048, 0),   # the main path's longest prompt
    ("bfloat16", 1, 256, 2304, 0),    # the prefix-hit shape
    ("bfloat16", 1, 300, 1000, 512),  # rectangular with a window
    ("float32", 1, 192, 320, 0),
)


def flash_readings(torch, kernel, plain, gen):
    """Run the flash kernel and its plain version on every FLASH_CASES
    shape; yield (case, (q, k, v), relative error, max abs error)."""
    H, KV, D = 32, 8, 128
    for case in FLASH_CASES:
        dt, B, sq, skv, win = case

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                getattr(torch, dt))

        q, k, v = rn(B, sq, H, D), rn(B, skv, KV, D), rn(B, skv, KV, D)
        out = kernel(q, k, v, causal=True, window=win)
        torch.cuda.synchronize()
        ref = plain(q, k, v, causal=True, window=win)
        yield case, (q, k, v), rel_err(out, ref), abs_err(out, ref)


def phase_flash(torch, fa, plain, gen):
    say("== phase 2: flash prefill kernel vs plain ==")
    H, D = 32, 128
    rows = []
    for (dt, B, sq, skv, win), (q, k, v), rel, err in flash_readings(
            torch, fa.flash_prefill_attention, plain, gen):
        tol = TOL_REL[dt]
        ms = cuda_ms(torch, lambda: fa.flash_prefill_attention(
            q, k, v, causal=True, window=win), 20)
        plain_ms = cuda_ms(torch, lambda: plain(q, k, v, causal=True,
                                                window=win), 5, warmup=1)
        flops = 4.0 * B * H * D * causal_pairs(sq, skv, win)
        nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
        bms, by = bound_ms(flops, nbytes,
                           PEAK_BF16 if dt == "bfloat16" else PEAK_F32)
        lib_ms = None
        if sq == skv and dt == "bfloat16":
            # Yardstick only: one PyTorch call for the square causal case
            # (its causal mask is top-left aligned, so it cannot do the
            # rectangular one). The port never calls it.
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = cuda_ms(torch, lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True,
                                 enable_gqa=True), 20)
        say(f"flash {dt} B={B} Sq={sq} Skv={skv} window={win}: "
            f"rel err {rel:.3e} (tol {tol:g}) max|err| {err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
            f"{bms:.4f} ({by}) library_ms "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)}")
        check(rel <= tol, f"flash prefill disagrees: {rel} > {tol}")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms))
    return rows[0]  # the main path's 2048-token prompt shape


# ---------------------------------------------------------------------------
# phase 3: paged decode
# ---------------------------------------------------------------------------

def padded_table(torch, pages_per_seq, width, n_pages, rng_perm):
    """A table of distinct shuffled page ids, padded past each
    sequence's pages with -1 and n_pages + 5 in turn."""
    table = torch.empty((len(pages_per_seq), width), dtype=torch.int32)
    pos = 0
    for b, n in enumerate(pages_per_seq):
        table[b, :n] = rng_perm[pos:pos + n]
        pos += n
        pad = torch.arange(width - n) % 2
        table[b, n:] = torch.where(pad == 0, torch.tensor(-1),
                                   torch.tensor(n_pages + 5)).int()
    return table


def decode_bound(torch, seq_lens, window, B, H, KV, D, esize):
    toks = sum(min(s, window) if window else s for s in seq_lens)
    nbytes = (toks * KV * D * 2 + 2 * B * H * D) * esize
    flops = 4.0 * toks * H * D
    return bound_ms(flops, nbytes, PEAK_BF16 if esize == 2 else PEAK_F32)


DECODE_SEQ_LENS = (1, 15, 16, 17, 1000, 2048, 2049, 4000)
DECODE_CASES = (("bfloat16", 0), ("bfloat16", 256), ("float32", 0),
                ("float32", 256))  # (dtype, window)


def decode_readings(torch, kernel, plain, gen):
    """Run the paged decode kernel and its plain version on batch 8 with
    ragged DECODE_SEQ_LENS over a shuffled pool, the table padded with -1
    and out-of-range ids; yield (case, args, relative error, max abs
    error) for every DECODE_CASES entry."""
    H, KV, D, P = 32, 8, 128, 16
    need = [-(-s // P) for s in DECODE_SEQ_LENS]
    n_pages = sum(need) + 64
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        SEED)).int()
    table = padded_table(torch, need, max(need) + 2, n_pages, perm).cuda()
    sl = torch.tensor(DECODE_SEQ_LENS, dtype=torch.int32, device="cuda")
    B = len(DECODE_SEQ_LENS)
    pools = {}
    for case in DECODE_CASES:
        dt, win = case
        if dt not in pools:
            def rn(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(
                    getattr(torch, dt))
            pools[dt] = (rn(B, H, D), rn(n_pages, P, KV, D),
                         rn(n_pages, P, KV, D))
        q, kp, vp = pools[dt]
        args = (q, kp, vp, table, sl)
        out = kernel(*args, window=win)
        torch.cuda.synchronize()
        ref = plain(*args, window=win)
        yield case, args, rel_err(out, ref), abs_err(out, ref)


def phase_decode(torch, pd, plain, gen):
    say("== phase 3: paged decode kernel vs plain ==")
    H, KV, D = 32, 8, 128
    for (dt, win), args, rel, err in decode_readings(
            torch, pd.paged_flash_decode, plain, gen):
        tol = TOL_REL[dt]
        ms = cuda_ms(torch, lambda: pd.paged_flash_decode(
            *args, window=win), 50)
        bms, by = decode_bound(torch, DECODE_SEQ_LENS, win,
                               len(DECODE_SEQ_LENS), H, KV, D,
                               args[0].element_size())
        say(f"decode {dt} B={len(DECODE_SEQ_LENS)} window={win}: rel err "
            f"{rel:.3e} (tol {tol:g}) max|err| {err:.3e} kernel_ms "
            f"{ms:.4f} bound_ms {bms:.5f} ({by}: K/V bytes read / "
            f"3.35 TB/s)")
        check(rel <= tol, f"paged decode disagrees: {rel} > {tol}")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def phase_main(torch, np, report):
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM, TYPE_STREAM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops.paged_attention import (
        paged_decode_attention)

    say("== phase 4: main path at Llama-3.1-8B width ==")
    cfg = llama.LLAMA31_8B
    L, P = cfg.n_layers, cfg.page_size
    token_bytes = 2 * L * cfg.kv_page_bytes() // P
    pool_bytes = int(sum(PROMPTS) * token_bytes * 1.5)
    shm_free = shutil.disk_usage("/dev/shm").free
    say(f"store: {token_bytes // 1024} KB of KV per token, pool "
        f"{pool_bytes / 2**30:.2f} GiB, /dev/shm free "
        f"{shm_free / 2**30:.1f} GiB")
    check(shm_free > 2 * pool_bytes, "not enough /dev/shm for the pool")

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"],
                                       params["final_ln"]]
                   + [w for la in params["layers"] for w in la.values()])
    say(f"model: {n_params / 1e9:.2f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               dtype=torch.int32, device="cuda")
               for n in PROMPTS]
    new_tail = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, HIT_NEW)),
                               dtype=torch.int32, device="cuda")
    seq_ids = [f"smoke_{uuid.uuid4()}" for _ in PROMPTS]

    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=pool_bytes / 2**30,
        minimal_allocate_size=cfg.kv_page_bytes() // 1024,
        auto_increase=True, extend_size=1,
    ))
    srv.start()
    conns, stores = [], []

    def connect(ctype):
        c = InfinityConnection(ClientConfig(
            host_addr="127.0.0.1", service_port=srv.service_port,
            connection_type=ctype))
        c.connect()
        conns.append(c)
        return c

    try:
        tcuda.reset_copy_counters()
        fa.reset_launches()
        pd.reset_launches()
        n_prefills = 0
        n_steps = 0

        # -- prefill + per-layer offload --
        # One untimed prefill per prompt length first, so the timed ones
        # measure steady state rather than first-call library set-up.
        with torch.no_grad():
            for prompt in prompts:
                llama.prefill(params, cfg, prompt)
                n_prefills += 1
        pconn = connect(TYPE_SHM)
        check(pconn.shm_connected, "SHM path not active")
        first_tokens, dev_kvs = [], []
        with torch.no_grad(), tcuda.LayerStreamer(pconn) as streamer:
            for sid, prompt in zip(seq_ids, prompts):
                n = prompt.shape[1]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, kvs = llama.prefill(params, cfg, prompt)
                n_prefills += 1
                torch.cuda.synchronize()
                t_pf = time.perf_counter() - t0
                t0 = time.perf_counter()
                pages = []
                for li, (k, v) in enumerate(kvs):
                    kp, vp = llama.kv_to_pages(cfg, k, v)
                    streamer.submit_pages(
                        llama.page_keys(sid, li, "k", n // P), kp[0])
                    streamer.submit_pages(
                        llama.page_keys(sid, li, "v", n // P), vp[0])
                    pages.append((kp[0], vp[0]))
                streamer.finish()
                t_off = time.perf_counter() - t0
                dev_kvs.append(pages)
                first_tokens.append(int(torch.argmax(logits[0, -1])))
                say(f"prefill {n} tokens: {t_pf * 1e3:.2f} ms, "
                    f"{n / t_pf:.0f} tok/s; offload {n * token_bytes / 2**20:.0f}"
                    f" MiB in {t_off * 1e3:.2f} ms, "
                    f"{n * token_bytes / t_off / 1e9:.2f} GB/s")
                report[f"prefill_{n}_ms"] = t_pf * 1e3
                report[f"offload_{n}_GBps"] = n * token_bytes / t_off / 1e9
                del logits, kvs
        check(tcuda.copy_counters["staging_copies"] == 0,
              f"SHM offload made staging copies: {tcuda.copy_counters}")
        say(f"offload copies: {tcuda.copy_counters}")

        # -- a fresh connection finds every page --
        dconn = connect(TYPE_SHM)
        store = tcuda.CudaKVStore(dconn, "cuda")
        stores.append(store)
        for sid, n in zip(seq_ids, PROMPTS):
            for li in range(L):
                for kind in ("k", "v"):
                    got = store.cached_prefix_len(
                        llama.page_keys(sid, li, kind, n // P + 2))
                    check(got == n // P,
                          f"{sid} L{li}/{kind}: {got} of {n // P} pages")
        say("prefix match: every page of every layer found on a fresh "
            "connection")

        # -- restore into one device page pool --
        # Room for every decode step plus the checks' extra step.
        max_len = [n + DECODE_STEPS + 1 for n in PROMPTS]
        need = [-(-m // P) for m in max_len]
        n_pool = sum(need) + 32
        perm = torch.randperm(n_pool, generator=torch.Generator()
                              .manual_seed(SEED + 1)).int()
        table_cpu = padded_table(torch, need, max(need) + 2, n_pool, perm)
        table = table_cpu.cuda()
        pool_shape = (L, n_pool, *cfg.kv_page_shape())
        k_pool = torch.zeros(pool_shape, dtype=torch.bfloat16, device="cuda")
        v_pool = torch.zeros_like(k_pool)
        restored = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, (sid, n) in enumerate(zip(seq_ids, PROMPTS)):
            kp, vp = llama.restore_prefix_pages(
                store, cfg,
                lambda li, kind, sid=sid, n=n: llama.page_keys(
                    sid, li, kind, n // P),
                n // P)
            ids = table_cpu[b, :n // P].long().cuda()
            k_pool[:, ids] = kp
            v_pool[:, ids] = vp
            restored[sid] = (kp, vp)
        torch.cuda.synchronize()
        t_rs = time.perf_counter() - t0
        rs_bytes = sum(PROMPTS) * token_bytes
        say(f"restore: {rs_bytes / 2**20:.0f} MiB in {t_rs * 1e3:.2f} ms, "
            f"{rs_bytes / t_rs / 1e9:.2f} GB/s")
        report["restore_GBps"] = rs_bytes / t_rs / 1e9

        # -- batched greedy decode from the restored pool --
        def decode(kpool, vpool):
            nonlocal n_steps
            tok = torch.tensor(first_tokens, dtype=torch.int32,
                               device="cuda")
            lens = torch.tensor(PROMPTS, dtype=torch.int32, device="cuda")
            out = [tok]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DECODE_STEPS):
                logits, kpool, vpool = llama.decode_step(
                    params, cfg, tok, lens, kpool, vpool, table)
                n_steps += 1
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                out.append(tok)
                lens = lens + 1
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return torch.stack(out, 1).cpu(), dt, lens

        toks_store, t_dec, lens_end = decode(k_pool, v_pool)
        say(f"decode: batch {len(PROMPTS)}, {DECODE_STEPS} steps, "
            f"{t_dec / DECODE_STEPS * 1e3:.2f} ms/step")
        report["decode_ms_per_step"] = t_dec / DECODE_STEPS * 1e3

        # -- the same decode from KV kept on the device (no store) --
        k_dev = torch.zeros_like(k_pool)
        v_dev = torch.zeros_like(v_pool)
        for b, pages in enumerate(dev_kvs):
            ids = table_cpu[b, :PROMPTS[b] // P].long().cuda()
            for li, (kp, vp) in enumerate(pages):
                k_dev[li, ids] = kp
                v_dev[li, ids] = vp
        toks_dev, _, _ = decode(k_dev, v_dev)
        check(torch.equal(toks_store, toks_dev),
              "decode through the store differs from the device-KV decode")
        say(f"decode tokens equal with and without the store "
            f"(first sequence: {toks_store[0, :8].tolist()}...)")
        del k_dev, v_dev

        # -- prefix-hit request: prompt 1 + 256 new tokens --
        sid0 = seq_ids[0]
        hit = store.cached_prefix_len(llama.page_keys(
            sid0, 0, "k", (PROMPTS[0] + HIT_NEW) // P))
        check(hit == PROMPTS[0] // P, f"prefix hit {hit} pages")
        full_tokens = torch.cat([prompts[0], new_tail], dim=1)
        with torch.no_grad():
            for _ in range(2):  # the first of each leg warms its shapes
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefix_kvs = llama.restore_prefix_kvs(store, cfg, sid0, hit)
                tail, _ = llama.prefill_with_prefix(params, cfg, new_tail,
                                                    prefix_kvs)
                n_prefills += 1
                torch.cuda.synchronize()
                t_hit = time.perf_counter() - t0
                del prefix_kvs
            for _ in range(2):
                t0 = time.perf_counter()
                full, _ = llama.prefill(params, cfg, full_tokens)
                n_prefills += 1
                torch.cuda.synchronize()
                t_full = time.perf_counter() - t0
        ref = full[0, PROMPTS[0]:]
        got = tail[0]
        agree = (ref.argmax(-1) == got.argmax(-1)).float().mean().item()
        rel = ((got - ref).norm() / ref.norm()).item()
        say(f"prefix hit: {hit} pages reused, {HIT_NEW} new tokens in "
            f"{t_hit * 1e3:.2f} ms (restore + suffix prefill) vs full "
            f"{PROMPTS[0] + HIT_NEW}-token prefill {t_full * 1e3:.2f} ms; "
            f"argmax agreement {agree:.4f}, rel L2 {rel:.3e}")
        report["prefix_hit_ms"] = t_hit * 1e3
        report["full_prefill_ms"] = t_full * 1e3
        check(agree >= 0.95 and rel <= 2e-2,
              "prefix-hit logits disagree with the full prefill "
              "(need argmax agreement >= 0.95 and rel L2 <= 2e-2)")
        del full, tail

        # -- the path ran through both kernels --
        k1, k2 = fa.launches, pd.launches
        say(f"launches: flash_prefill {k1} (= {L} x {n_prefills} "
            f"prefills), paged_decode {k2} (= {L} x {n_steps} steps)")
        check(k1 == L * n_prefills, "flash prefill launch count")
        check(k2 == L * n_steps, "paged decode launch count")
        report["launches"] = {"flash_prefill": k1, "paged_decode": k2}

        # ---- checks outside the counted run ----
        # One more decode step, with the plain attention run beside the
        # kernel in every layer on that layer's own inputs. (Its token
        # lands at position lens_end, which nothing below reads.)
        layer_rel = []

        def both(*args, window=0):
            out = pd.paged_flash_decode(*args, window=window)
            ref = paged_decode_attention(*args, window=window)
            layer_rel.append(rel_err(out, ref))
            return out

        kernel_attn = llama.decode_attention
        llama.decode_attention = both
        try:
            llama.decode_step(params, cfg,
                              toks_store[:, -1].to(torch.int32).cuda(),
                              lens_end, k_pool, v_pool, table)
        finally:
            llama.decode_attention = kernel_attn
        worst = max(layer_rel)
        say(f"decode step, kernel vs plain attention in each of "
            f"{len(layer_rel)} layers: worst rel err {worst:.3e} (layer "
            f"{layer_rel.index(worst)}, tol {TOL_REL['bfloat16']:g})")
        check(len(layer_rel) == L and worst <= TOL_REL["bfloat16"],
              "decode attention kernel vs plain on the main path")

        # A STREAM restore is byte-equal to the SHM restore.
        sconn = connect(TYPE_STREAM)
        check(not sconn.shm_connected, "STREAM connection took SHM")
        sstore = tcuda.CudaKVStore(sconn, "cuda")
        stores.append(sstore)
        sid, n = seq_ids[-1], PROMPTS[-1]
        kp_s, vp_s = llama.restore_prefix_pages(
            sstore, cfg, lambda li, kind: llama.page_keys(sid, li, kind,
                                                          n // P), n // P)
        kp_m, vp_m = restored[sid]
        check(torch.equal(kp_s.view(torch.int16), kp_m.view(torch.int16))
              and torch.equal(vp_s.view(torch.int16),
                              vp_m.view(torch.int16)),
              "STREAM restore differs from SHM restore")
        say(f"STREAM restore of {n} tokens byte-equal to the SHM restore")

        # Kernel timing at the main path's decode shape.
        q = torch.randn((len(PROMPTS), cfg.n_heads, cfg.head_dim),
                        device="cuda").to(torch.bfloat16)
        args = (q, k_pool[0], v_pool[0], table, lens_end)
        out = pd.paged_flash_decode(*args)
        ref = paged_decode_attention(*args)
        rel, err = rel_err(out, ref), abs_err(out, ref)
        check(rel <= TOL_REL["bfloat16"],
              f"paged decode at main-path shape: rel err {rel}")
        ms = cuda_ms(torch, lambda: pd.paged_flash_decode(*args), 100)
        plain_ms = cuda_ms(torch, lambda: paged_decode_attention(*args), 10)
        bms, by = decode_bound(torch, lens_end.tolist(), 0, len(PROMPTS),
                               cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 2)
        say(f"decode kernel at main-path shape (batch {len(PROMPTS)}, "
            f"lens {lens_end.tolist()}): rel err {rel:.3e} max|err| "
            f"{err:.3e} kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"bound_ms {bms:.5f} ({by})")
        report["k2"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=by)
    finally:
        for s in stores:
            s.close()
        for c in conns:
            c.close()
        srv.stop()


def main():
    try:
        import torch
    except ImportError:
        say("FAIL: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False: no GPU to run on")
        return 1
    if not os.path.isdir(os.path.join(HERE, "infinistore_tpu_torch")):
        say("FAIL: run from a checkout: infinistore_tpu_torch/ is not "
            "beside chip_smoke.py")
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    from infinistore_tpu_torch import _native
    from infinistore_tpu_torch._device import disable_tf32
    from infinistore_tpu_torch.ops import _kernels
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops.paged_attention import (
        paged_decode_attention, prefill_attention)

    t_start = time.perf_counter()
    card = card_line()
    say(f"== phase 1: device and build ==\ncard: {card}")
    disable_tf32()
    try:
        build_all(_native, _kernels)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        k1 = phase_flash(torch, fa, prefill_attention, gen)
        phase_decode(torch, pd, paged_decode_attention, gen)
        report = {}
        phase_main(torch, np, report)
    except SmokeError as e:
        say(f"FAIL: {e}")
        return 1
    k2 = report["k2"]
    kernels = [
        {"name": "flash_prefill", "route": "cuda",
         "source": "infinistore_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "infinistore_tpu/ops/pallas_flash_attention.py:44",
         "launches": report["launches"]["flash_prefill"],
         "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "paged_decode", "route": "cuda",
         "source": "infinistore_tpu_torch/csrc/paged_decode.cu",
         "replaces": "infinistore_tpu/ops/pallas_paged_attention.py:34",
         "launches": report["launches"]["paged_decode"],
         "max_abs_err": k2["err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
    ]
    main_path = {k: v for k, v in report.items()
                 if k not in ("k2", "launches")}
    say("main path: " + json.dumps(main_path))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
