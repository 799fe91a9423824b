#!/usr/bin/env python3
"""Drive infinistore_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Device and build: the card's name and power limit; the store library
   and the CUDA kernels built from this checkout's sources into
   infinistore_tpu_torch/_build/ (side by side), with their build times.
2. Flash prefill kernel (csrc/flash_prefill.cu) against its plain
   PyTorch version on the card: the main path's shapes and the edges of
   its tiles (ragged, batch 2, MHA, hd 64 and 32, not causal, 17 queries
   over 2065 keys, a 256 window, f32) and the attention widths of
   Qwen2-7B (group 7), Gemma-7B and Gemma-2B (hd 256), phi-2 (hd 80) and
   Phi-3-mini (hd 96), and hd 24, 48 and 192 (inside the capacity-32, -64
   and -256 instantiations); at capacity 256 also hd 136 under a window
   and the Gemma widths over a cached prefix and under a window; each
   with the tiles its schedule visits and, where one exists, one SDPA
   call's time as a yardstick; the host time of one call.
3. Paged decode kernel (K2: csrc/paged_split.cu at m = 1) against its
   plain version: ragged lengths, a shuffled pool, a table padded with
   out-of-range ids; one 32768-token sequence at Llama-3.1-8B's heads;
   and at batch 4 the attention widths of Qwen2-7B and Qwen2-1.5B
   (groups 7 and 6), Gemma-7B and Gemma-2B (hd 256), Llama-3.1-405B
   (group 16), phi-2 (hd 80) and Phi-3-mini (hd 96); hd 24, 48 and 192;
   each case's split plan, and two launches byte-equal. K2 and K3 are
   timed eagerly (kernel_ms, CUDA events over a loop of calls: the host's
   time per call is in it) and as device time alone (graph_ms: the calls
   captured in one CUDA graph).
   3b. The int8 paged decode kernel (K4: the split-K kernel over int8
   pages, csrc/paged_split_q.cu) against its plain version, bf16 and
   f32: K2's ragged shape with and without a 256 window, the main path's
   decode shape (batch 4), a full-card shape (32 x 2048 tokens) and hd
   64 at group 2; phase 3's published widths, Phi-3-mini's (hd 96) among
   them, and hd 24, 48 and 192; each case's kernel_ms (eager) and
   graph_ms, its split plan, two launches byte-equal, and K2's graph_ms
   over the same pages dequantized, beside the byte bound.
   3c. The decode step's KV write (csrc/kv_write.cu, the fixed-shape
   write every decode step makes, eager or replayed) against its plain
   version, byte for byte, over the cells' pool (8193 pages), at the
   rows the engines give it: Mistral-7B's (8 kv heads x 128, bf16),
   Trinity-Mini's (4 x 128, bf16, also a tp = 2 slice), a tp = 2 and an
   ep rank's at f32, a tp = 8 slice (1 x 128, bf16 and f32) and Gemma's
   (16 x 256 and 1 x 256, bf16): rows past the table, idle rows on
   scratch page 0, the pool's last page, ids outside the pool, mixed,
   at batch 1 and 32; timed at batch 32 at Mistral-7B's rows (kernel_ms,
   graph_ms) against its byte bound.
4. The main path at Llama-3.1-8B width (random weights from a seed)
   through the port's own server on SHM: prefill 4 prompts streaming
   every layer's pages, find the prefix on a fresh connection, restore
   into one device page pool, decode the 4 sequences as a batch, and a
   prefix-hit request that prefills only its new tail. Launch counts
   show the path ran through both kernels.
5. Paged verify kernel (K3: csrc/paged_split.cu) against its plain
   version: the speculative-verify shape (m = 5 over K2's ragged lengths,
   with and without a window, bf16 and f32), a 512-token chunk over 1536
   cached tokens, a row whose new tokens run past the page table, m = 5
   over one 32768-token sequence, and the speculative shape at the
   widths of Qwen2-7B, Gemma-7B, Gemma-2B, phi-2 and Phi-3-mini, and at
   hd 24, 48 and 192; each case's split plan, and two launches
   byte-equal.
6. Serving at Llama-3.1-8B width, bf16, through the port's
   ServingEngine and its store on SHM: engine A (8 slots, speculative
   decoding) serves 8 cold requests, then 8 that regenerate or extend
   them (prefix hits, K3 verify steps); engine B (512-token chunked
   prefill, 4-step bursts, a pool small enough to preempt) serves 8
   more; the HTTP front end answers 4 concurrent requests over engine
   A. Launch counts show all three kernels ran (32 per model call);
   every decode step replays the engine's one decode graph (its
   counters; the KV write's launches). Apart from the counters, a
   DecodeGraph at that width against the eager step: logits bit-equal
   over 4 steps at batch 32, the pools equal, and K2 and the KV write
   seen by a profiler in every replay;
   K3 is held to its plain version per layer on one speculative and one
   chunk step; every finished request is teacher-forced through one
   dense prefill, and a planted page-table fault shows that check bites.
   6d. The sharded store tier at Llama-3.1-8B width, on the same model:
   three port servers behind a static-hash ShardedConnection over
   STREAM (shards stand for remote hosts: every byte takes the staged
   path); phase 4's 2048-token prompt's KV pages (32 layers, k and v,
   256 MiB) through CudaKVStore over it, byte-equal on the card and
   spread over every shard, GB/s beside phase 4's SHM numbers, and the
   pinned staging allocation timed alone; engine A's configuration over
   the sharded store (4 cold requests, 4 regenerated through prefix hits
   across shards, then shard 1 stopped and the 4 regenerated again:
   every request finishes, fewer hit pages, no store error, the health
   counters; K1, K2 and K3 launches; every request teacher-forced);
   profile_window around a 2048-token prefix hit restored from one SHM
   server (op deltas, store span time by op, store spans and CUDA
   kernel events in the merged trace, the restore split into pin, H2D
   copies and release); benchmark.run at BASELINE.json config 2's shape
   (16 MB in 4 KB blocks) on SHM and STREAM; warm_up with CUDA primed
   and example/client.py on cuda.
   6b. int8 at Llama-3.1-8B width, on phase 4's bf16 model: a 2048-token
   prompt's KV put int8 on SHM (16896-byte pages, no staging copy) and
   taken back raw (GB/s and H2D copies beside the same pages' bf16
   restore), then one decode step whose attention is K4 over those
   pages in all 32 layers (its launches counted), held to K4's plain
   version and beside K2 over the bf16 pages; quantize_params of the 8B
   tree, each int8 leaf kind held to float32 at full width, prefill and
   batch-4 decode with it against bf16; an engine on
   the int8 tree with quantized_store=True serving 4 cold requests and 4
   that regenerate them through int8 prefix hits, every request
   teacher-forced (delta measured over int8-restored pages) and a planted
   page-table fault caught.
   6c. MoE at Mixtral-8x7B width (mistralai/Mixtral-8x7B-v0.1's
   config.json through the port's moe_config_from_hf, cut to 16 of 32
   layers: 32 layers of bf16 weights take 93.4 GB), after phase 6b's tree
   is freed: at 2 layers a port tree turned into an HF Mixtral state dict
   and loaded back through load_hf_moe (every leaf and one prefill's
   logits equal); phase 4's main path through the MoE model (K1 and K2,
   16 launches a model call), decode ms against the byte bound of
   reading every weight, each expert's share of routed tokens; serving
   (8 cold requests and 4 regenerated through prefix hits with
   speculation, 4 through 512-token chunks and 4-step bursts: K1, K2,
   K3), no token dropped (C = T), K3 held to its plain version on a
   chunk step; every request teacher-forced by phase 6's rule as a
   reading and, as the check, with the dense pass routed as the engine
   routed each token (a planted page-table fault caught), and the
   (layer, token) pairs whose top-2 differs between the engine and the
   dense pass counted; then 4 training steps at 2 layers (K1, K5, K6;
   the float32 router gets its grad).
7. Exact parity at float32, Llama-3.1-8B widths, 4 layers: speculative,
   chunked + multi-step + preempting through the store, and a
   store-backed second round give the tokens of a plain store-less
   engine.
8. Flash backward kernels (csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu)
   and K1's row logsumexp against their plain versions, bf16 and f32:
   the training shape (2048 x 2048), a 512-token suffix over 2048 (with
   and without a 256 window), not causal, a ragged 1000, hd 64 and 32,
   and 2048 x 2048 at the widths of Qwen2-7B, Gemma-7B, Gemma-2B, phi-2
   and Phi-3-mini; 512 x 1000 at hd 24, 48, 136 and 192; Gemma-2B's
   heads over a cached prefix under a window and hd 136 at group 8 (K6's
   splits of the group); at the training shape and the Gemma widths, one
   SDPA backward (flash backend) timed in turns with K5, K6 and the D
   pass, as a yardstick; two K6 launches byte-equal at group 8.
9. Training at Llama-3.1-8B width cut to 16 layers, bf16: 4 AdamW steps
   through llama.train_step on one 2049-token batch; the loss falls,
   every leaf gets a finite grad, and each step launches K1, K5 and K6
   once per layer. Then, at 2 layers, the loss and every leaf's grad with
   the kernels against the same Function on its plain leaves (f32 and
   bf16).
10. Tensor parallel, over the (dp, tp) mesh of parallel/mesh.py:
    (a) decode_attention_tp and decode_attention_quantized_tp at
    Llama-3.1-8B's heads in one process, cut into 2 and 8 head slices:
    one K2 / K4 launch per slice, each slice against the full launch and
    the plain version, a slice's launch time beside the full one's;
    then two ranks in processes of their own, time-sharing the card over
    gloo (one card: NCCL takes a card per rank): (b) the tp = 2 engine
    at full Llama-3.1-8B width, bf16 (each rank builds the tree from the
    seed, shards it, and only rank 0 keeps the whole tree, for the
    noise reading), 4 cold requests and 4 that regenerate them
    through prefix hits in the port's SHM store: TTFT, decode ms/step
    and the gloo all-reduce's ms per call (two ranks time-sharing one
    card, not a multi-GPU reading), K1/K2 and KV-write launches per
    rank (a KV write a layer each decode step), the
    offloaded pages against a single-process engine's under the same
    keys (two planted faults read against the same bound), every
    request teacher-forced through a dense single-process prefill by
    phase 6's rule, and the tp model's logit noise held to 2x the
    kernel's; (c) at f32, 4 layers, the tp = 2 engine's plain, speculative
    and chunked tokens equal the single-process engine's; (d) one FSDP
    training step at dp = 2 (2 layers, f32): the loss and every leaf's
    grad against the single-process step.
11. The parallel set, two ranks in processes of their own time-sharing
    the card over gloo (every transfer staged through pinned host
    memory: not a multi-GPU reading): (a) ring attention over sp = 2 at
    Llama-3.1-8B's attention (32 q / 8 kv heads, hd 128, bf16), one
    32768-token sequence in 16384-token blocks, every block on K1 with
    its lse, against one K1 launch over the whole sequence, and at 4096
    tokens against the plain attention in bf16 and f32; (b) GPipe over
    pp = 2, each stage 2 Llama-3.1-8B decoder layers, 4 microbatches of
    2048 tokens, against the 4 layers in one process (forward, and each
    stage's leaf grads of one backward: K1, K5, K6 in the stages); (c)
    expert parallelism at Mixtral-8x7B width cut to 2 layers, ep = 2
    (4 experts a rank): a 2048-token prefill and one AdamW step against
    the single-process model (rows, routing agreement, loss, every leaf
    grad), and at a tiny f32 width the loss to 1e-5 with the same
    routing; (d) the device KV pool: one 2048-token prompt's K and V
    pages at 8B width (8192 pages, 256 MiB) put on rank 0 and handed to
    rank 1, then the same count held only in a CudaKVStore over SHM:
    the pool's miss, a fetch onto rank 0, a handoff, an eviction back to
    the store, each read back byte-equal; (e) the whole multi-rank dry
    run (graft_entry.dryrun_multichip) on the card.
12. int8 and MoE on a mesh, two ranks in processes of their own
    time-sharing the card over gloo (every collective staged through
    host memory: not a multi-GPU reading): (a) Llama-3.1-8B at full
    width and depth with int8 weights (init_params_quantized), tp = 2
    (each rank holds half the int8 bytes), phase 10's 4 cold requests
    through the SHM store and the same 4 again through prefix hits:
    TTFT, decode ms/step, weight bytes per rank, the offloaded pages
    against the single-process int8 engine's under the same keys (layer
    0 byte-equal, every layer within phase 10's bound, its two planted
    faults beyond it); (b) Mixtral-8x7B width cut to 8 layers, tp = 2,
    bf16 (the router and experts whole on each rank): routing agreement
    1.0 across the ranks, every request teacher-forced through a dense
    single-process prefill routed as rank 0's engine routed (phase 6c's
    check, with its planted fault); (c) the same width at 16 layers, ep
    = 2 (4 experts a rank): tokens equal to the single-process engine's
    (run before the ranks) and every layer's offloaded pages byte-equal,
    the combine all-reduce's ms; (d) float32, 2 layers: the int8 tp, MoE
    tp and MoE ep engines in plain, speculative and chunked modes give
    one process's tokens, and a MoE tp training step (d_ff cut to 1024)
    one process's loss and leaf grads (K5, K6). Each depth or width cut
    is listed under "reduced" in the phase's JSON.
13. Gemma-1 on the card, at head dim 256: (a) phase 4's main path at
    google/gemma-7b's config.json widths (vocab 256000, hidden 3072, 28
    layers, 16 / 16 heads, head_dim 256, GeGLU, (1 + w) norms, scaled
    embeddings) through the port's hf.config_from_hf, seeded random bf16
    weights, phase 4's traffic and checks (K1 at hd 256 in MHA, K2 at hd
    256), except that the prefix hit's gap to the full prefill is held to
    DELTA_FACTOR x the gap the same legs show with the plain attention
    (Gemma's bf16 products round differently at the suffix's and the
    whole prompt's row counts, and the plain attention itself misses
    phase 4's fixed bound); (b) 2
    AdamW steps of llama.train_step at google/gemma-2b's widths (hidden
    2048, 18 layers, 8 q heads over one kv head: group 8), launches of
    K1, K5 and K6 per step counted, then on fresh weights the loss and
    every leaf's grad with the kernels against the same Function on its
    plain leaves: held to TRAIN_TOL (bf16) at phase 9's 2 layers, read
    at all 18 (the depth cut is listed under "reduced"), where both
    paths' grads are also read against an f32 plain reference on the
    same weights and the kernels' worst leaf error is held to
    DELTA_FACTOR x the plain leaves'.
14. A JSON line of per-kernel numbers (six kernels and the decode
    step's KV write: phase 3c, its launches from phase 6, and the row
    shapes phase 3c held; K2's, K3's, K4's and the KV write's also carry
    graph_ms; K1's, K5's and K6's also carry "hd256":
    phases 2 and 8 at the Gemma-7B and Gemma-2B widths; tp_launches:
    launches on phase 10's path; parallel_launches: per rank on phase
    11's; mesh_launches: per rank on phase 12's; gemma_launches: on phase
    13's), after the phases' JSON lines (phase 6c's under "moe:", phase
    6d's under "sharded:", phase 10's under "tensor parallel:", phase
    11's under "parallel set:", phase 12's under "mesh:", phase 13's
    under "gemma:"), the card line, and as the last line {"ok": true,
    "device": {...}}.
"""

import collections
import dataclasses
import gc
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import uuid

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): bf16 tensor cores, float32 FMA, HBM.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BPS = 3.35e12

# Kernel against plain version: the largest relative L2 error over the
# output rows (one head of one query token), ||out - ref|| / ||ref|| per
# row, so a fault in any one sequence, head or query position shows at
# that row's own scale. On an H100 the sound kernels read at most 6.9e-3
# (bf16, at hd 32) and 8.3e-7 (f32); kernels with a planted fault (a kv
# tile, a page or the tokens past 2048 skipped, a window floor one tile
# or page high, the diagonal tile unmasked, a ring stage released early)
# read 0.31 and more (tools/torch_kernel_faults.py).
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


def graph_ms(torch, fn, iters=20, reps=5):
    """Device time of fn() alone: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so that the
    host's time per call (the wrapper's checks, the ctypes call) is not
    in it; where a kernel is shorter than that, cuda_ms measures the
    host."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def rel_err(out, ref):
    """Largest relative L2 error over the rows of the last dimension."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    return ((o - r).norm(dim=-1) / r.norm(dim=-1)).max().item()


def abs_err(out, ref):
    return (out.float() - ref.float()).abs().max().item()


def grad_rel_err(out, ref, dead_exact=False):
    """rel_err for gradients. A row whose true value is zero by
    cancellation (query 0 under a causal mask sees only key 0, so dP = D
    and dS = 0) holds only rounding noise, so each row's norm is floored
    at 1e-2 of the reference's RMS row norm. With ``dead_exact``, a row
    the reference gives exactly zero (a kv row no query sees) must be
    exactly zero (else inf)."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    norm = r.norm(dim=-1)
    if dead_exact and bool((o[norm == 0] != 0).any()):
        return float("inf")
    floor = 1e-2 * norm.square().mean().sqrt().clamp_min(1e-30)
    return ((o - r).norm(dim=-1) / norm.clamp_min(floor)).max().item()


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


FlashCase = collections.namedtuple(
    "FlashCase", "dtype batch s_q s_kv window causal n_heads n_kv hd")


def _fc(dtype, s_q, s_kv, window=0, batch=1, causal=True, n_heads=32,
        n_kv=8, hd=128):
    return FlashCase(dtype, batch, s_q, s_kv, window, causal, n_heads, n_kv,
                     hd)


FLASH_CASES = (
    _fc("bfloat16", 2048, 2048),         # the main path's longest prompt
    _fc("bfloat16", 256, 2304),          # the prefix-hit shape
    _fc("bfloat16", 300, 1000, 512),     # rectangular with a window
    _fc("bfloat16", 1000, 1000),         # ragged
    _fc("bfloat16", 1024, 1024, batch=2),
    _fc("bfloat16", 512, 512, n_heads=16, n_kv=16),  # MHA (group 1)
    _fc("bfloat16", 1000, 1000, hd=64),
    _fc("bfloat16", 700, 700, hd=32),
    _fc("bfloat16", 1000, 1000, causal=False),
    _fc("bfloat16", 17, 2065),           # a short suffix over a long prefix
    _fc("bfloat16", 2048, 2048, 256),    # sliding window
    _fc("float32", 192, 320),
    # Attention widths of published configs the JAX package's hf.py maps:
    # Qwen/Qwen2-7B (28 / 4 heads: group 7), google/gemma-7b (16 / 16,
    # hd 256) and google/gemma-2b (8 / 1, hd 256: group 8).
    _fc("bfloat16", 2048, 2048, n_heads=28, n_kv=4),
    _fc("bfloat16", 2048, 2048, n_heads=16, n_kv=16, hd=256),
    _fc("float32", 2048, 2048, n_heads=16, n_kv=16, hd=256),
    _fc("bfloat16", 2048, 2048, n_heads=8, n_kv=1, hd=256),
    _fc("float32", 2048, 2048, n_heads=8, n_kv=1, hd=256),
    # Head dims between the instantiated ones (the kernels run at the
    # next capacity up, with the real hd's scale): microsoft/phi-2 (32 /
    # 32, hd 80) and microsoft/Phi-3-mini-4k-instruct (32 / 32, hd 96).
    _fc("bfloat16", 2048, 2048, n_heads=32, n_kv=32, hd=80),
    _fc("float32", 2048, 2048, n_heads=32, n_kv=32, hd=80),
    _fc("bfloat16", 2048, 2048, n_heads=32, n_kv=32, hd=96),
    _fc("float32", 2048, 2048, n_heads=32, n_kv=32, hd=96),
    # A head dim inside each of the other instantiations (capacity 32, 64
    # and 256; no published config above has one): partial TMA boxes,
    # K6's column halves past D, a group of 4.
    *(_fc(dt, 1000, 1000, n_heads=8, n_kv=2, hd=hd)
      for hd in (24, 48, 192) for dt in ("bfloat16", "float32")),
    # Capacity 256 (64-key tiles) off the square: hd 136 (a column block
    # wholly past D) with a window, and the Gemma widths over a cached
    # prefix and under a window.
    _fc("bfloat16", 1000, 1000, 128, n_heads=8, n_kv=2, hd=136),
    _fc("bfloat16", 256, 2304, n_heads=16, n_kv=16, hd=256),
    _fc("bfloat16", 2048, 2048, 256, n_heads=8, n_kv=1, hd=256),
)
# The published hd-256 widths (Gemma-7B, Gemma-2B, 2048²): their K1
# readings go into the kernels line beside the main path's.
GEMMA_FLASH = {"gemma-7b": FLASH_CASES.index(
                   _fc("bfloat16", 2048, 2048, n_heads=16, n_kv=16, hd=256)),
               "gemma-2b": FLASH_CASES.index(
                   _fc("bfloat16", 2048, 2048, n_heads=8, n_kv=1, hd=256))}


def flash_readings(torch, kernel, plain, gen):
    """Run the flash kernel and its plain version on every FLASH_CASES
    shape; yield (case, (q, k, v), relative error, max abs error)."""
    for c in FLASH_CASES:

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                getattr(torch, c.dtype))

        q = rn(c.batch, c.s_q, c.n_heads, c.hd)
        k, v = (rn(c.batch, c.s_kv, c.n_kv, c.hd) for _ in range(2))
        out = kernel(q, k, v, causal=c.causal, window=c.window)
        torch.cuda.synchronize()
        ref = plain(q, k, v, causal=c.causal, window=c.window)
        yield c, (q, k, v), rel_err(out, ref), abs_err(out, ref)


def sdpa_ms(torch, case, q, k, v):
    """Yardstick only, never called by the port: one PyTorch SDPA call on
    the same inputs, where one exists (no window; a cached prefix through
    the lower-right causal bias, kv heads repeated outside the timed
    call), else None."""
    if case.dtype != "bfloat16" or case.window:
        return None
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if case.causal and case.s_q == case.s_kv:
        return cuda_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=True), 20)
    group = case.n_heads // case.n_kv
    kt, vt = (x.repeat_interleave(group, dim=1) for x in (kt, vt))
    mask = None
    if case.causal:
        from torch.nn.attention.bias import causal_lower_right
        mask = causal_lower_right(case.s_q, case.s_kv)
    try:
        return cuda_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask), 20)
    except RuntimeError as e:  # no SDPA backend for this shape: none
        say(f"  SDPA yardstick not available here: {e}")
        return None


def k1_tiles(fa, case, sm_count):
    """K1's schedule at the case's shape: CTAs, consumers per CTA, and
    the (consumer, kv tile) visits and how many of them are interior,
    summed over batch and heads."""
    cons = fa.k1_consumers(case.batch, case.s_q, case.n_heads, sm_count)
    walk = fa.k1_schedule(case.s_q, case.s_kv, case.causal, case.window,
                          cons, case.hd)
    visits = sum(len(t) for _, t in walk) * cons
    interior = sum(sum(flags) for _, t in walk for _, flags in t)
    heads = case.batch * case.n_heads
    return len(walk) * heads, cons, visits * heads, interior * heads


def phase_flash(torch, fa, plain, gen):
    say("== phase 2: flash prefill kernel vs plain ==")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for c, (q, k, v), rel, err in flash_readings(
            torch, fa.flash_prefill_attention, plain, gen):
        tol = TOL_REL[c.dtype]

        def kernel():
            return fa.flash_prefill_attention(q, k, v, causal=c.causal,
                                              window=c.window)

        ms = cuda_ms(torch, kernel, 20)
        plain_ms = cuda_ms(torch, lambda: plain(
            q, k, v, causal=c.causal, window=c.window), 5, warmup=1)
        pairs = (causal_pairs(c.s_q, c.s_kv, c.window) if c.causal
                 else c.s_q * c.s_kv)
        flops = 4.0 * c.batch * c.n_heads * c.hd * pairs
        nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
        bms, by = bound_ms(flops, nbytes,
                           PEAK_BF16 if c.dtype == "bfloat16" else PEAK_F32)
        lib_ms = sdpa_ms(torch, c, q, k, v)
        tiles = ""
        if c.dtype == "bfloat16" and c.hd <= 128:
            ctas, cons, visits, interior = k1_tiles(fa, c, sms)
            tiles = (f"; {ctas} CTAs of {cons} consumer(s), {visits} "
                     f"consumer tile visits, {interior} interior")
        say(f"flash {c.dtype} B={c.batch} Sq={c.s_q} Skv={c.s_kv} "
            f"window={c.window} causal={c.causal} H={c.n_heads} "
            f"KV={c.n_kv} hd={c.hd}: rel err {rel:.3e} (tol {tol:g}) "
            f"max|err| {err:.3e} kernel_ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {bms:.4f} ({by}) library_ms "
            f"{'none' if lib_ms is None else round(lib_ms, 4)}{tiles}")
        check(rel <= tol, f"flash prefill disagrees ({c}): {rel} > {tol}")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms))
        if c.dtype == "bfloat16" and c.hd > 128:
            ctas, cons, visits, interior = k1_tiles(fa, c, sms)
            say(f"  capacity 256: {ctas} CTAs of {cons} consumer(s), "
                f"{visits} consumer tile visits of {fa.k1_bk(c.hd)} keys, "
                f"{interior} interior")
    # Host time of one K1 call (checks, four tensor maps, the launch) at
    # a shape whose kernel is shorter than it, so launches do not queue.
    c = FLASH_CASES[9]
    q = torch.randn(c.batch, c.s_q, c.n_heads, c.hd, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(c.batch, c.s_kv, c.n_kv, c.hd, device="cuda",
                    dtype=torch.bfloat16)
    fa.flash_prefill_attention(q, k, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fa.flash_prefill_attention(q, k, k)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    say(f"flash host time per call (Sq={c.s_q} Skv={c.s_kv}): "
        f"{host_us:.1f} us")
    # The main path's 2048-token prompt shape, with the hd-256 widths'.
    return dict(rows[0], hd256={name: rows[i]
                                for name, i in GEMMA_FLASH.items()})


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
MAIN_DECODE_LENS = (2080, 1568, 1056, 544)  # phase 4's lens after decoding
DecodeCase = collections.namedtuple(
    "DecodeCase", "label dtype window seq_lens n_heads n_kv hd")
DECODE_CASES = (
    DecodeCase("ragged", "bfloat16", 0, DECODE_SEQ_LENS, 32, 8, 128),
    DecodeCase("main path", "bfloat16", 0, MAIN_DECODE_LENS, 32, 8, 128),
    DecodeCase("ragged", "bfloat16", 256, DECODE_SEQ_LENS, 32, 8, 128),
    DecodeCase("ragged", "float32", 0, DECODE_SEQ_LENS, 32, 8, 128),
    DecodeCase("ragged", "float32", 256, DECODE_SEQ_LENS, 32, 8, 128),
    # Published attention widths (config.json of each): any GQA group
    # (blocks of query rows) and hd 256, at the main path's batch-4 lens.
    DecodeCase("Qwen2-7B", "bfloat16", 0, MAIN_DECODE_LENS, 28, 4, 128),
    DecodeCase("Qwen2-1.5B", "bfloat16", 0, MAIN_DECODE_LENS, 12, 2, 128),
    DecodeCase("Gemma-7B", "bfloat16", 0, MAIN_DECODE_LENS, 16, 16, 256),
    DecodeCase("Gemma-7B", "float32", 0, MAIN_DECODE_LENS, 16, 16, 256),
    DecodeCase("Gemma-2B", "bfloat16", 0, MAIN_DECODE_LENS, 8, 1, 256),
    DecodeCase("Gemma-2B", "float32", 256, MAIN_DECODE_LENS, 8, 1, 256),
    DecodeCase("Llama-3.1-405B", "bfloat16", 0, MAIN_DECODE_LENS, 128, 8,
               128),
    # One long sequence: 8 (sequence, kv head) pairs for 132 SMs, only
    # the splits over its pages fill the card.
    DecodeCase("long context", "bfloat16", 0, (32768,), 32, 8, 128),
    # Head dims between the instantiated ones, as in FLASH_CASES.
    DecodeCase("phi-2", "bfloat16", 0, MAIN_DECODE_LENS, 32, 32, 80),
    DecodeCase("phi-2", "float32", 0, MAIN_DECODE_LENS, 32, 32, 80),
    DecodeCase("Phi-3-mini", "bfloat16", 0, MAIN_DECODE_LENS, 32, 32, 96),
    DecodeCase("Phi-3-mini", "float32", 256, MAIN_DECODE_LENS, 32, 32, 96),
    # A head dim inside each of the other instantiations, as in
    # FLASH_CASES.
    *(DecodeCase(f"hd {hd}", dt, win, DECODE_SEQ_LENS, 8, 2, hd)
      for hd in (24, 48, 192)
      for dt, win in (("bfloat16", 0), ("float32", 256))),
)


def decode_args(torch, c, gen):
    """A DECODE_CASES case's inputs (q, k_pages, v_pages, table,
    seq_lens): a shuffled pool, the table padded with -1 and
    out-of-range ids."""
    P = 16
    need = [-(-s // P) for s in c.seq_lens]
    n_pages = sum(need) + 64
    perm = torch.randperm(n_pages, generator=torch.Generator()
                          .manual_seed(SEED)).int()
    table = padded_table(torch, need, max(need) + 2, n_pages, perm).cuda()

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            getattr(torch, c.dtype))

    return (rn(len(c.seq_lens), c.n_heads, c.hd),
            rn(n_pages, P, c.n_kv, c.hd), rn(n_pages, P, c.n_kv, c.hd),
            table, torch.tensor(c.seq_lens, dtype=torch.int32,
                                device="cuda"))


def decode_readings(torch, kernel, plain, gen):
    """Run the paged decode kernel and its plain version on every
    DECODE_CASES shape (decode_args); yield (case, args, relative error,
    max abs error)."""
    for c in DECODE_CASES:
        args = decode_args(torch, c, gen)
        out = kernel(*args, window=c.window)
        torch.cuda.synchronize()
        ref = plain(*args, window=c.window)
        yield c, args, rel_err(out, ref), abs_err(out, ref)


def split_desc(torch, q, k_pages, table, m, window):
    """The split plan (ops/paged_split.py) of one K2, K3 or K4 launch, for
    the phase lines: CTAs, row tiles and splits."""
    from infinistore_tpu_torch.ops import _kernels, paged_split

    plan = paged_split.plan_of(q, k_pages, table, window, m,
                               _kernels.sm_count(q.device))
    ctas = plan.n_splits * plan.row_tiles * k_pages.shape[2] * q.shape[0]
    return (f"plan: {ctas} CTAs, {plan.row_tiles} tile(s) of "
            f"{plan.row_tile} rows for {plan.rows}, {plan.n_splits} "
            f"split(s) of {plan.pages_per_split} pages")


def byte_equal_runs(torch, fn):
    """Two launches of fn() give byte-equal outputs (the splits merge in
    a fixed order)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def phase_decode(torch, pd, plain, gen):
    say("== phase 3: paged decode kernel vs plain ==")
    for c, args, rel, err in decode_readings(
            torch, pd.paged_flash_decode, plain, gen):
        tol = TOL_REL[c.dtype]

        def kernel():
            return pd.paged_flash_decode(*args, window=c.window)

        ms = cuda_ms(torch, kernel, 50)
        dev_ms = graph_ms(torch, kernel)
        same = byte_equal_runs(torch, kernel)
        bms, by = decode_bound(torch, c.seq_lens, c.window,
                               len(c.seq_lens), c.n_heads, c.n_kv, c.hd,
                               args[0].element_size())
        say(f"decode {c.label} {c.dtype} B={len(c.seq_lens)} "
            f"H={c.n_heads} KV={c.n_kv} hd={c.hd} window={c.window}: rel "
            f"err {rel:.3e} (tol {tol:g}) max|err| {err:.3e} kernel_ms "
            f"{ms:.4f} graph_ms {dev_ms:.4f} bound_ms {bms:.5f} ({by}: K/V "
            f"bytes read / 3.35 TB/s); "
            f"{split_desc(torch, args[0], args[1], args[3], 1, c.window)}; "
            f"two launches byte-equal: {same}")
        check(rel <= tol, f"paged decode disagrees ({c}): {rel} > {tol}")
        check(same, f"paged decode differs between two launches ({c})")
        del args


# ---------------------------------------------------------------------------
# phase 3b: paged decode over int8 pages
# ---------------------------------------------------------------------------

# (label, dtype, seq_lens, window, hd, group, n_kv)
DECODE_Q_CASES = (
    ("ragged", "bfloat16", DECODE_SEQ_LENS, 0, 128, 4, 8),
    ("ragged", "bfloat16", DECODE_SEQ_LENS, 256, 128, 4, 8),
    ("ragged", "float32", DECODE_SEQ_LENS, 0, 128, 4, 8),
    ("ragged", "float32", DECODE_SEQ_LENS, 256, 128, 4, 8),
    ("main path", "bfloat16", MAIN_DECODE_LENS, 0, 128, 4, 8),
    ("full card", "bfloat16", (2048,) * 32, 0, 128, 4, 8),
    ("hd 64 group 2", "bfloat16", DECODE_SEQ_LENS, 0, 64, 2, 8),
    ("hd 64 group 2", "float32", DECODE_SEQ_LENS, 256, 64, 2, 8),
    # Published attention widths, as in DECODE_CASES.
    ("Qwen2-7B", "bfloat16", MAIN_DECODE_LENS, 0, 128, 7, 4),
    ("Qwen2-1.5B", "bfloat16", MAIN_DECODE_LENS, 0, 128, 6, 2),
    ("Gemma-7B", "bfloat16", MAIN_DECODE_LENS, 0, 256, 1, 16),
    ("Gemma-7B", "float32", MAIN_DECODE_LENS, 0, 256, 1, 16),
    ("Gemma-2B", "bfloat16", MAIN_DECODE_LENS, 0, 256, 8, 1),
    ("Gemma-2B", "float32", MAIN_DECODE_LENS, 256, 256, 8, 1),
    ("Llama-3.1-405B", "bfloat16", MAIN_DECODE_LENS, 0, 128, 16, 8),
    # A head dim between the instantiated ones: Phi-3-mini's (hd 96).
    ("Phi-3-mini", "bfloat16", MAIN_DECODE_LENS, 0, 96, 1, 32),
    ("Phi-3-mini", "float32", MAIN_DECODE_LENS, 256, 96, 1, 32),
    # A head dim inside each of the other instantiations, as in
    # FLASH_CASES.
    *((f"hd {hd}", dt, DECODE_SEQ_LENS, win, hd, 4, 2)
      for hd in (24, 48, 192)
      for dt, win in (("bfloat16", 0), ("float32", 256))),
    # A head dim that is not a multiple of 16 in a swizzled int8 tile
    # (rows copied 8 bytes at a time).
    *(("hd 136", dt, DECODE_SEQ_LENS, win, 136, 4, 2)
      for dt, win in (("bfloat16", 0), ("float32", 256))),
)


def decode_q_bound(seq_lens, window, B, H, KV, D, esize):
    """K4's least time: int8 K and V of each live token with their f32
    scales, KV * (2 D + 2 * 4) bytes, plus q and the output; f32 FMAs."""
    toks = sum(min(s, window) if window else s for s in seq_lens)
    nbytes = toks * KV * (2 * D + 2 * 4) + 2 * B * H * D * esize
    return bound_ms(4.0 * toks * H * D, nbytes, PEAK_F32)


def decode_q_args(torch, case, gen):
    """A DECODE_Q_CASES case's inputs (q, k_q, k_s, v_q, v_s, table,
    seq_lens): a shuffled pool of quantized pages (rows of varied scale,
    as real KV has), the table padded with -1 and out-of-range ids."""
    from infinistore_tpu_torch.ops import kv_quant

    P = 16
    _, dt, lens, win, D, G, KV = case
    need = [-(-s // P) for s in lens]
    n_pages = sum(need) + 64
    perm = torch.randperm(n_pages, generator=torch.Generator()
                          .manual_seed(SEED)).int()
    table = padded_table(torch, need, max(need) + 2, n_pages, perm).cuda()

    def pages():
        x = torch.randn((n_pages, P, KV, D), generator=gen, device="cuda")
        x *= torch.exp(0.5 * torch.randn((n_pages, P, KV, 1), generator=gen,
                                         device="cuda"))
        return kv_quant.quantize_kv_pages(x)

    q = torch.randn((len(lens), KV * G, D), generator=gen,
                    device="cuda").to(getattr(torch, dt))
    return (q, *pages(), *pages(), table,
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def decode_q_readings(torch, kernel, plain, gen):
    """Run the int8 paged decode kernel and its plain version on every
    DECODE_Q_CASES shape (decode_q_args); yield (case, args, relative
    error, max abs error)."""
    for case in DECODE_Q_CASES:
        args = decode_q_args(torch, case, gen)
        win = case[3]
        out = kernel(*args, window=win)
        torch.cuda.synchronize()
        ref = plain(*args, window=win)
        yield case, args, rel_err(out, ref), abs_err(out, ref)


def phase_decode_q(torch, pq, pd, gen):
    """K4 against its plain version; beside it K2 over the same pages
    dequantized to q's dtype. Returns the main-path shape's row."""
    from infinistore_tpu_torch.ops import kv_quant

    say("== phase 3b: int8 paged decode kernel (K4) vs plain ==")
    rows = {}
    for case, args, rel, err in decode_q_readings(
            torch, pq.paged_flash_decode_quantized,
            pq.paged_decode_quantized_plain, gen):
        label, dt, lens, win, D, G, KV = case
        q, kq, ks, vq, vs, table, sl = args
        tol = TOL_REL[dt]

        def kernel():
            return pq.paged_flash_decode_quantized(*args, window=win)

        ms = cuda_ms(torch, kernel, 50)
        dev_ms = graph_ms(torch, kernel)
        same = byte_equal_runs(torch, kernel)
        plain_ms = cuda_ms(torch, lambda: pq.paged_decode_quantized_plain(
            *args, window=win), 5, warmup=1)
        kd = kv_quant.dequantize_kv_pages(kq, ks, q.dtype)
        vd = kv_quant.dequantize_kv_pages(vq, vs, q.dtype)
        k2_ms = graph_ms(torch, lambda: pd.paged_flash_decode(
            q, kd, vd, table, sl, window=win))
        B, H = q.shape[0], q.shape[1]
        bms, by = decode_q_bound(lens, win, B, H, kq.shape[2], D,
                                 q.element_size())
        k2_bms, _ = decode_bound(torch, lens, win, B, H, kq.shape[2], D,
                                 q.element_size())
        say(f"decode_q {label} {dt} B={B} H={H} KV={KV} hd={D} "
            f"window={win}: rel "
            f"err {rel:.3e} (tol {tol:g}) max|err| {err:.3e} kernel_ms "
            f"{ms:.4f} graph_ms {dev_ms:.4f} plain_ms {plain_ms:.4f} "
            f"bound_ms {bms:.5f} ({by}); K2 over the dequantized pages "
            f"graph_ms {k2_ms:.4f} (bound {k2_bms:.5f}); "
            f"{split_desc(torch, q, kq, table, 1, win)}; two launches "
            f"byte-equal: {same}")
        check(rel <= tol, f"int8 paged decode disagrees ({label}, {dt}): "
              f"{rel} > {tol}")
        check(same, f"int8 paged decode differs between two launches "
              f"({label}, {dt})")
        rows.setdefault(label, dict(err=err, ms=ms, graph_ms=dev_ms,
                                    plain_ms=plain_ms, bound_ms=bms,
                                    bound_by=by, k2_ms=k2_ms,
                                    k2_bound_ms=k2_bms))
        del args, q, kq, ks, vq, vs, kd, vd
    return rows


# ---------------------------------------------------------------------------
# phase 3c: the decode step's KV write
# ---------------------------------------------------------------------------

# The cells' pool and table (perfbench: 8193 pages of 16 tokens, 256
# pages a sequence, in all three).
KVW_PAGES, KVW_WIDTH, KVW_PAGE = 8193, 256, 16
KVW_CASES = ("past_table", "idle_rows", "last_page", "ids_outside_pool",
             "mixed")
# The rows the decode step writes (kv heads, hd, dtype): Mistral-7B's
# and Llama-3.1-8B's (8 x 128), Trinity-Mini's (4 x 128, also a tp = 2
# rank's slice of 8 kv heads), a tp = 2 rank's and an ep rank's at f32
# (phases 10 and 12's f32 engines), a tp = 8 slice (one head), and
# Gemma's hd 256 (gemma-7b: 16 x 256, gemma-2b: 1 x 256). The first is
# the one timed.
KVW_ROWS = (("mistral", 8, 128, "bfloat16"), ("trinity", 4, 128, "bfloat16"),
            ("tp2_f32", 4, 128, "float32"), ("ep_f32", 8, 128, "float32"),
            ("tp8", 1, 128, "bfloat16"), ("tp8_f32", 1, 128, "float32"),
            ("gemma7b", 16, 256, "bfloat16"), ("gemma2b", 1, 256, "bfloat16"))


def kv_write_case(torch, name, batch, gen):
    """(page, slot) int64 [batch] of one case, aimed as the decode step
    aims them: the page of position seq_len in the row's table, or
    KVW_PAGES (outside the pool) past the table."""
    n, w, p = KVW_PAGES, KVW_WIDTH, KVW_PAGE
    table = torch.randint(1, n, (batch, w), generator=gen)
    lens = torch.randint(0, w * p, (batch,), generator=gen)
    if name == "past_table":
        lens[::2] = w * p + torch.arange(0, batch, 2)
    elif name == "idle_rows":
        # The engine's idle slots: no tokens, a table of scratch page 0;
        # all aim at (0, 0), and the last of them writes.
        table[1::2], lens[1::2] = 0, 0
    elif name == "last_page":
        table[:, -1], lens[:] = n - 1, w * p - 1
    elif name == "ids_outside_pool":
        # -1 wraps to the pool's last page; n and -n - 1 are dropped.
        table[0::3], table[1::3], table[2::3] = -1, n, -n - 1
    idx = lens // p
    page = table.gather(1, idx.clamp(max=w - 1)[:, None])[:, 0]
    return torch.where(idx < w, page, n), lens % p


def phase_kv_write(torch, kw):
    """The fixed-shape KV write (csrc/kv_write.cu) against its plain
    version on the card, byte for byte, at each of KVW_ROWS over the
    cells' pool, at batch 1 and 32; timed at batch 32 at Mistral-7B's
    rows against its byte bound. Returns the batch-32 row of the kernels
    line."""
    say("== phase 3c: the decode step's KV write vs plain ==")
    dgen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    row = {"rows": [r[0] for r in KVW_ROWS]}
    worst = 0.0
    for label, heads, hd, dtype in KVW_ROWS:
        dt = getattr(torch, dtype)
        bits = torch.int16 if dt.itemsize == 2 else torch.int32
        shape = (KVW_PAGES, KVW_PAGE, heads, hd)
        pools = [torch.randn(shape, dtype=dt, device="cuda", generator=dgen)
                 for _ in range(2)]
        for batch in (1, 32):
            for name in KVW_CASES:
                gen = torch.Generator().manual_seed(
                    SEED + 100 * batch + KVW_CASES.index(name))
                page, slot = (t.cuda() for t in kv_write_case(
                    torch, name, batch, gen))
                k, v = (torch.randn(batch, 1, heads, hd, dtype=dt,
                                    device="cuda", generator=dgen)
                        for _ in range(2))
                want = [p.clone() for p in pools]
                kw.kv_write_plain(*want, k, v, page, slot)
                got = [p.clone() for p in pools]
                before = kw.launches
                kw.kv_write(*got, k, v, page, slot)
                torch.cuda.synchronize()
                same = all(torch.equal(g.view(bits), w.view(bits))
                           for g, w in zip(got, want))
                err = max(abs_err(g, w) for g, w in zip(got, want))
                worst = max(worst, err)
                pg = page.clone()
                pg[pg < 0] += KVW_PAGES
                landed = int(((pg >= 0) & (pg < KVW_PAGES)).sum())
                say(f"kv_write {label} ({heads} x {hd} {dtype}) {name} "
                    f"batch {batch}: {landed} of {batch} rows land, "
                    f"byte-equal to the plain version: {same}, one launch: "
                    f"{kw.launches == before + 1}")
                check(same, f"kv_write differs from its plain version "
                      f"({label}, {name}, batch {batch})")
                check(kw.launches == before + 1, "kv_write launch count")
                if name in ("past_table", "ids_outside_pool") and batch > 1:
                    check(landed < batch, f"{name} dropped no row")
                del want, got
        if label != KVW_ROWS[0][0]:
            del pools
            torch.cuda.empty_cache()
            continue
        # Timed on the last case (mixed, batch 32), writing in place.
        kp, vp = pools

        def kernel():
            kw.kv_write(kp, vp, k, v, page, slot)

        ms = cuda_ms(torch, kernel, 200)
        dev_ms = graph_ms(torch, kernel)
        plain_ms = cuda_ms(torch, lambda: kw.kv_write_plain(
            kp, vp, k, v, page, slot), 5, warmup=1)
        row_bytes = heads * hd * dt.itemsize
        nbytes = 2 * 2 * batch * row_bytes + 2 * batch * 8  # k, v r + w
        bms, by = bound_ms(0, nbytes, PEAK_BF16)
        say(f"kv_write {label} batch {batch}: kernel_ms {ms:.5f} graph_ms "
            f"{dev_ms:.5f} plain_ms {plain_ms:.4f} bound_ms {bms:.6f} "
            f"({by}: {nbytes} bytes)")
        row.update(ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by)
        del pools, kp, vp
        torch.cuda.empty_cache()
    row["err"] = worst
    return row


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def phase_main(torch, np, report, params, cfg=None, model=None,
               hit_vs_plain=False):
    """Phase 4 at Llama-3.1-8B width, or the same path for another model
    family (``model`` with its ``cfg``; the caller prints the title).

    The prefix hit's logits are held to the full prefill's by phase 4's
    fixed bound, or with ``hit_vs_plain`` to the gap the same two legs
    show with the plain attention (DELTA_FACTOR x it): for a model whose
    bf16 products round differently at the suffix's and the full
    prompt's row counts, so that the plain attention itself misses the
    fixed bound."""
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM, TYPE_STREAM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_kv_write as kw
    from infinistore_tpu_torch.ops.paged_attention import (
        paged_decode_attention)

    if cfg is None:
        say("== phase 4: main path at Llama-3.1-8B width ==")
        cfg, model = llama.LLAMA31_8B, llama
    L, P = cfg.n_layers, cfg.page_size
    token_bytes = 2 * L * cfg.kv_page_bytes() // P
    pool_bytes = int(sum(PROMPTS) * token_bytes * 1.5)
    shm_free = shutil.disk_usage("/dev/shm").free
    say(f"store: {token_bytes // 1024} KB of KV per token, pool "
        f"{pool_bytes / 2**30:.2f} GiB, /dev/shm free "
        f"{shm_free / 2**30:.1f} GiB")
    check(shm_free > 2 * pool_bytes, "not enough /dev/shm for the pool")

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
        kw.reset_launches()
        n_prefills = 0
        n_steps = 0

        # -- prefill + per-layer offload --
        # One untimed prefill per prompt length first, so the timed ones
        # measure steady state rather than first-call library set-up.
        with torch.no_grad():
            for prompt in prompts:
                model.prefill(params, cfg, prompt)
                n_prefills += 1
        pconn = connect(TYPE_SHM)
        check(pconn.shm_connected, "SHM path not active")
        first_tokens, dev_kvs = [], []
        with torch.no_grad(), tcuda.LayerStreamer(pconn) as streamer:
            for sid, prompt in zip(seq_ids, prompts):
                n = prompt.shape[1]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, kvs = model.prefill(params, cfg, prompt)
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
                logits, kpool, vpool = model.decode_step(
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
                tail, _ = model.prefill_with_prefix(params, cfg, new_tail,
                                                    prefix_kvs)
                n_prefills += 1
                torch.cuda.synchronize()
                t_hit = time.perf_counter() - t0
                del prefix_kvs
            for _ in range(2):
                t0 = time.perf_counter()
                full, _ = model.prefill(params, cfg, full_tokens)
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
        report["prefix_hit_gap"] = dict(agree=agree, rel=rel)
        if not hit_vs_plain:
            check(agree >= 0.95 and rel <= 2e-2,
                  "prefix-hit logits disagree with the full prefill "
                  "(need argmax agreement >= 0.95 and rel L2 <= 2e-2)")
        del full, tail

        # -- the path ran through both kernels --
        k1, k2, kv = fa.launches, pd.launches, kw.launches
        say(f"launches: flash_prefill {k1} (= {L} x {n_prefills} "
            f"prefills), paged_decode {k2} (= {L} x {n_steps} steps), "
            f"kv_write {kv} (the same)")
        check(k1 == L * n_prefills, "flash prefill launch count")
        check(k2 == L * n_steps, "paged decode launch count")
        check(kv == L * n_steps, "kv_write launch count")
        report["launches"] = {"flash_prefill": k1, "paged_decode": k2,
                              "kv_write": kv}

        # ---- checks outside the counted run ----
        if hit_vs_plain:
            p_agree, p_rel = plain_hit_gap(torch, llama, model, params, cfg,
                                           prompts[0], new_tail)
            say(f"prefix hit with the plain attention in every prefill: "
                f"argmax agreement {p_agree:.4f}, rel L2 {p_rel:.3e}; the "
                f"kernels' {agree:.4f}, {rel:.3e} (bound: {DELTA_FACTOR:g}x"
                f" the plain gap)")
            report["prefix_hit_gap"].update(plain_agree=p_agree,
                                            plain_rel=p_rel)
            check(rel <= DELTA_FACTOR * p_rel
                  and 1 - agree <= DELTA_FACTOR * (1 - p_agree),
                  f"prefix-hit logits: the kernels' gap to the full prefill "
                  f"({agree:.4f}, {rel:.3e}) exceeds {DELTA_FACTOR:g}x the "
                  f"plain attention's ({p_agree:.4f}, {p_rel:.3e})")
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
            model.decode_step(params, cfg,
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
        dev_ms = graph_ms(torch, lambda: pd.paged_flash_decode(*args), 50)
        plain_ms = cuda_ms(torch, lambda: paged_decode_attention(*args), 10)
        bms, by = decode_bound(torch, lens_end.tolist(), 0, len(PROMPTS),
                               cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 2)
        say(f"decode kernel at main-path shape (batch {len(PROMPTS)}, "
            f"lens {lens_end.tolist()}): rel err {rel:.3e} max|err| "
            f"{err:.3e} kernel_ms {ms:.4f} graph_ms {dev_ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {bms:.5f} ({by}); "
            f"{split_desc(torch, q, k_pool[0], table, 1, 0)}")
        report["k2"] = dict(err=err, ms=ms, graph_ms=dev_ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    finally:
        for s in stores:
            s.close()
        for c in conns:
            c.close()
        srv.stop()


# ---------------------------------------------------------------------------
# phase 5: paged verify
# ---------------------------------------------------------------------------

def verify_work(seq_lens, m, width, page, window, H, KV, D, esize):
    """(FLOPs, bytes) one verify call needs: 4 H D FLOPs per (query row,
    attended position) pair; each live K/V position read once per kv
    head, q read and the output written once."""
    t_end = width * page
    pairs = live = 0
    for sl in seq_lens:
        for j in range(m):
            limit = sl + j + 1
            lo = max(limit - window, 0) if window else 0
            pairs += max(min(limit, t_end) - lo, 0)
        lo = max(sl + 1 - window, 0) if window else 0
        live += max(min(sl + m, t_end) - lo, 0)
    flops = 4.0 * H * D * pairs
    nbytes = (live * KV * D * 2 + 2 * len(seq_lens) * m * H * D) * esize
    return flops, nbytes


# (label, dtype, seq_lens, m, window, table width or None: room for all,
# n_heads, n_kv, hd)
VERIFY_CASES = (
    ("spec", "bfloat16", DECODE_SEQ_LENS, 5, 0, None, 32, 8, 128),
    ("spec", "bfloat16", DECODE_SEQ_LENS, 5, 256, None, 32, 8, 128),
    ("spec", "float32", DECODE_SEQ_LENS, 5, 0, None, 32, 8, 128),
    ("spec", "float32", DECODE_SEQ_LENS, 5, 256, None, 32, 8, 128),
    ("chunk", "bfloat16", (0, 1536), 512, 0, None, 32, 8, 128),
    ("past the table", "bfloat16", (100, 2000), 64, 0, 128, 32, 8, 128),
    # Published attention widths, as in DECODE_CASES.
    ("spec Qwen2-7B", "bfloat16", DECODE_SEQ_LENS, 5, 0, None, 28, 4, 128),
    ("spec Gemma-7B", "bfloat16", DECODE_SEQ_LENS, 5, 0, None, 16, 16, 256),
    ("spec Gemma-7B", "float32", DECODE_SEQ_LENS, 5, 256, None, 16, 16,
     256),
    ("spec Gemma-2B", "bfloat16", DECODE_SEQ_LENS, 5, 0, None, 8, 1, 256),
    ("spec Gemma-2B", "float32", DECODE_SEQ_LENS, 5, 0, None, 8, 1, 256),
    ("spec long context", "bfloat16", (32768,), 5, 0, None, 32, 8, 128),
    # Head dims between the instantiated ones, as in FLASH_CASES.
    ("spec phi-2", "bfloat16", DECODE_SEQ_LENS, 5, 0, None, 32, 32, 80),
    ("spec phi-2", "float32", DECODE_SEQ_LENS, 5, 256, None, 32, 32, 80),
    ("spec Phi-3-mini", "bfloat16", DECODE_SEQ_LENS, 5, 0, None, 32, 32,
     96),
    ("spec Phi-3-mini", "float32", DECODE_SEQ_LENS, 5, 0, None, 32, 32,
     96),
    # A head dim inside each of the other instantiations, as in
    # FLASH_CASES.
    *((f"spec hd {hd}", dt, DECODE_SEQ_LENS, 5, win, None, 8, 2, hd)
      for hd in (24, 48, 192)
      for dt, win in (("bfloat16", 256), ("float32", 0))),
)


def verify_args(torch, case, gen):
    """A VERIFY_CASES case's inputs (q, k_pages, v_pages, table,
    seq_lens): a shuffled pool, the table padded with -1 and
    out-of-range ids."""
    P = 16
    _, dt, lens, m, win, width, H, KV, D = case
    need = [-(-(s + m) // P) for s in lens]
    width = width or max(need) + 2
    need = [min(n, width) for n in need]
    n_pages = sum(need) + 64
    perm = torch.randperm(n_pages, generator=torch.Generator()
                          .manual_seed(SEED)).int()
    table = padded_table(torch, need, width, n_pages, perm).cuda()

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            getattr(torch, dt))

    return (rn(len(lens), m, H, D), rn(n_pages, P, KV, D),
            rn(n_pages, P, KV, D), table,
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def verify_readings(torch, kernel, plain, gen):
    """Run the paged verify kernel and its plain version on every
    VERIFY_CASES shape (verify_args); yield (case, args, relative error,
    max abs error)."""
    for case in VERIFY_CASES:
        args = verify_args(torch, case, gen)
        win = case[4]
        out = kernel(*args, window=win)
        torch.cuda.synchronize()
        ref = plain(*args, window=win)
        yield case, args, rel_err(out, ref), abs_err(out, ref)


def phase_verify(torch, pv, plain, gen):
    say("== phase 5: paged verify kernel vs plain ==")
    P = 16
    rows = {}
    for case, args, rel, err in verify_readings(
            torch, pv.paged_flash_verify, plain, gen):
        label, dt, lens, m, win, _, H, KV, D = case
        tol = TOL_REL[dt]

        def kernel():
            return pv.paged_flash_verify(*args, window=win)

        ms = cuda_ms(torch, kernel, 50)
        dev_ms = graph_ms(torch, kernel)
        same = byte_equal_runs(torch, kernel)
        plain_ms = cuda_ms(torch, lambda: plain(*args, window=win), 5,
                           warmup=1)
        flops, nbytes = verify_work(lens, m, args[3].shape[1], P, win, H,
                                    KV, D, args[0].element_size())
        bms, by = bound_ms(flops, nbytes,
                           PEAK_BF16 if dt == "bfloat16" else PEAK_F32)
        say(f"verify {label} {dt} B={len(lens)} m={m} H={H} KV={KV} hd={D} "
            f"window={win}: rel "
            f"err {rel:.3e} (tol {tol:g}) max|err| {err:.3e} kernel_ms "
            f"{ms:.4f} graph_ms {dev_ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
            f"{bms:.5f} ({by}); "
            f"{split_desc(torch, args[0], args[1], args[3], m, win)}; two "
            f"launches byte-equal: {same}")
        check(rel <= tol, f"paged verify disagrees ({label}): {rel} > {tol}")
        check(same, f"paged verify differs between two launches ({label})")
        rows.setdefault((label, dt), dict(err=err, ms=ms, graph_ms=dev_ms,
                                          plain_ms=plain_ms, bound_ms=bms,
                                          bound_by=by))
    return rows


# ---------------------------------------------------------------------------
# phase 6: serving at Llama-3.1-8B width
# ---------------------------------------------------------------------------

ROUND1 = (2048, 2048, 1536, 1536, 1024, 1024, 512, 512)
NEW_TOKENS = 64
TURN_NEW = 128     # next-turn requests: prompt + output + these tokens
B_PROMPT = 2048    # engine B's cold prompts
EXTEND_NEW = 256   # engine B: round-1 prompts extended by these tokens
HTTP_PROMPT, HTTP_NEW = 512, 16
# Teacher-forced check: a generated token's logit in one dense prefill of
# prompt + output may trail that row's maximum by at most delta =
# DELTA_FACTOR x the bf16 logit noise between the kernel and plain
# attention paths, measured in this run as the largest |logit|
# difference over one dense prefill of a finished request (0.30 on an
# H100 at 8B width). A sound engine emits the argmax t of logits that
# differ from the dense ones by at most that noise, so the dense maximum
# a leads t by at most |noise at a| + |noise at t|: twice the noise.
# Sound requests read a gap of 0.16 there; a page-table row shifted by
# one page reads 3.4.
DELTA_FACTOR = 2.0


class CountingModel:
    """The port's llama module, counting the model calls the engine
    makes (each runs one attention kernel per layer)."""

    COUNTED = ("prefill", "prefill_with_prefix", "decode_step",
               "verify_step")

    def __init__(self, module):
        self.module = module
        self.calls = collections.Counter()

    def __getattr__(self, name):
        fn = getattr(self.module, name)
        if name not in self.COUNTED:
            return fn

        def counted(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return counted


class ContinuationProposer:
    """Proposes the recorded continuation of a prompt while the context
    still follows it (the regenerate requests of round 2)."""

    def __init__(self):
        self.known = {}  # prompt length -> {prompt tuple: continuation}

    def add(self, prompt, continuation):
        self.known.setdefault(len(prompt), {})[tuple(prompt)] = list(
            continuation)

    def __call__(self, context, k):
        for n, table in self.known.items():
            cont = table.get(tuple(context[:n]))
            if cont is not None and context[n:] == cont[:len(context) - n]:
                return cont[len(context) - n:len(context) - n + k]
        return []


def run_leg(torch, eng, name, reqs, report, verbose=True):
    """Serve ``reqs`` to completion on ``eng``; print (unless not
    ``verbose``) and record the leg's numbers. Returns {request_id:
    tokens}."""
    times = collections.defaultdict(list)

    def on_token(rid, _tok):
        times[rid].append(time.perf_counter())

    for r in reqs:
        r.on_token = on_token
    before = dict(eng.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {r.request_id: done[r.request_id] for r in reqs}
    d = {k: eng.stats[k] - before[k] for k in eng.stats}
    ttft = [(times[r.request_id][0] - t0) * 1e3 for r in reqs]
    itl = [(t[-1] - t[0]) / (len(t) - 1) * 1e3 for t in times.values()
           if len(t) > 1]
    n_prompt = sum(len(r.prompt) for r in reqs)
    n_gen = sum(len(v) for v in out.values())
    leg = dict(requests=len(reqs), prompt_tokens=n_prompt,
               generated_tokens=n_gen, wall_s=wall, gen_tok_s=n_gen / wall,
               ttft_ms_p50=statistics.median(ttft), ttft_ms_max=max(ttft),
               itl_ms_mean=statistics.mean(itl) if itl else None,
               **{k: d[k] for k in ("prefix_hit_pages", "restored_pages",
                                    "offloaded_pages", "spec_proposed",
                                    "spec_accepted", "preemptions",
                                    "chunk_steps", "burst_steps")})
    if not verbose:
        report[name] = leg
        return out
    say(f"serving {name}: {len(reqs)} requests, {n_prompt} prompt + "
        f"{n_gen} generated tokens in {wall:.2f} s, {n_gen / wall:.1f} "
        f"generated tok/s; TTFT p50 {leg['ttft_ms_p50']:.1f} max "
        f"{leg['ttft_ms_max']:.1f} ms; mean inter-token "
        f"{leg['itl_ms_mean'] or 0:.2f} ms; prefix_hit_pages "
        f"{d['prefix_hit_pages']} restored_pages {d['restored_pages']} "
        f"offloaded_pages {d['offloaded_pages']} spec "
        f"{d['spec_accepted']}/{d['spec_proposed']} preemptions "
        f"{d['preemptions']} chunk_steps {d['chunk_steps']} burst_steps "
        f"{d['burst_steps']}")
    report[name] = leg
    return out


def http_leg(torch, ServingHTTPServer, eng, prompts, report):
    """4 concurrent /generate requests through the HTTP front end over
    ``eng``: 2 streaming, 2 not."""
    web = ServingHTTPServer(eng)
    port = web.start()
    results = [None] * len(prompts)

    def client(i):
        body = json.dumps({"prompt": prompts[i], "max_new_tokens": HTTP_NEW,
                           "stream": i % 2 == 0}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            status = resp.status
            if i % 2:
                results[i] = (status, None, json.loads(resp.read()))
                return
            streamed, final = [], None
            for line in resp:
                line = line.decode().strip()
                if line.startswith("data: "):
                    ev = json.loads(line[6:])
                    if ev.get("done"):
                        final = ev
                    else:
                        streamed.append(ev["token"])
            results[i] = (status, streamed, final)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=60).read())
    finally:
        web.shutdown()
    for i, res in enumerate(results):
        check(res is not None and res[0] == 200, f"HTTP request {i}: {res}")
        status, streamed, final = res
        check(final is not None and len(final["tokens"]) == HTTP_NEW,
              f"HTTP request {i} returned {final}")
        if streamed is not None:
            check(streamed == final["tokens"],
                  f"HTTP request {i}: streamed tokens differ from the list")
    check(stats["requests_done"] == len(prompts) and stats["engine_ok"],
          f"HTTP /stats: {stats}")
    leg = dict(requests=len(prompts), wall_s=wall,
               ttft_ms_mean=stats.get("ttft_ms_mean"),
               ttft_ms_max=stats.get("ttft_ms_max"),
               tok_s_mean=stats.get("tok_s_mean"))
    say(f"serving http: {len(prompts)} concurrent /generate (2 streaming) "
        f"answered 200 in {wall:.2f} s; TTFT mean {leg['ttft_ms_mean']} max "
        f"{leg['ttft_ms_max']} ms; tok/s per request {leg['tok_s_mean']}; "
        f"/stats counts {stats['requests_done']}")
    report["http"] = leg
    return {i: results[i][2]["tokens"] for i in range(len(prompts))}


def layer_checked_step(torch, llama, pv, plain, eng, window):
    """One eng.step() whose verify attention runs the kernel and the
    plain version side by side in every layer on that layer's own
    inputs; returns the per-layer relative errors over the rows that have
    a position to attend."""
    rels = []

    def both(q, kp, vp, pt, sl, window=0):
        out = pv.paged_flash_verify(q, kp, vp, pt, sl, window=window)
        ref = plain(q, kp, vp, pt, sl, window=window)
        m = q.shape[1]
        t_end = pt.shape[1] * kp.shape[1]
        limit = sl.long()[:, None] + torch.arange(m, device=q.device) + 1
        rows = (limit - window < t_end) if window else \
            torch.ones_like(limit, dtype=torch.bool)
        rels.append(rel_err(out[rows], ref[rows]))
        return out

    saved = llama.verify_attention
    llama.verify_attention = both
    try:
        while not rels and (eng.queue or any(eng.slots)):
            eng.step()
    finally:
        llama.verify_attention = saved
    return rels


def teacher_forced_gaps(torch, llama, params, cfg, pairs):
    """For each (prompt, generated tokens): one dense prefill over prompt
    + output; the gap between each generated token's logit and its row's
    maximum. Returns (largest gap, exact-argmax share)."""
    worst, exact, total = 0.0, 0, 0
    for prompt, out in pairs:
        toks = torch.tensor([list(prompt) + list(out)], dtype=torch.int32,
                            device="cuda")
        with torch.no_grad():
            logits, _ = llama.prefill(params, cfg, toks)
        rows = logits[0, len(prompt) - 1:len(prompt) - 1 + len(out)]
        tok = torch.tensor(out, device="cuda").long()
        gap = rows.max(dim=-1).values - rows.gather(1, tok[:, None])[:, 0]
        worst = max(worst, gap.max().item())
        exact += int((rows.argmax(dim=-1) == tok).sum())
        total += len(out)
        del logits
    return worst, exact / max(total, 1)


def logit_noise(torch, llama, plain_prefill, params, cfg, tokens,
                model=None):
    """Largest |logit| difference between the dense prefill through the
    flash kernel and through the plain attention, on ``tokens``.
    ``model`` (default llama) runs the prefill; every family attends
    through llama's flash_prefill."""
    model = model or llama
    with torch.no_grad():
        kernel_logits, _ = model.prefill(params, cfg, tokens)
        saved = llama.flash_prefill
        llama.flash_prefill = plain_prefill
        try:
            plain_logits, _ = model.prefill(params, cfg, tokens)
        finally:
            llama.flash_prefill = saved
    return (kernel_logits - plain_logits).abs().max().item()


def plain_hit_gap(torch, llama, model, params, cfg, prompt, new_tail):
    """Phase 4's prefix-hit comparison with the plain attention in every
    prefill (prompt, then new_tail over its KV, against the whole
    prompt + new_tail): (argmax agreement, relative L2) of the tail's
    logits."""
    from infinistore_tpu_torch.ops.paged_attention import prefill_attention

    saved = llama.flash_prefill
    llama.flash_prefill = prefill_attention
    try:
        with torch.no_grad():
            _, kvs = model.prefill(params, cfg, prompt)
            tail, _ = model.prefill_with_prefix(params, cfg, new_tail, kvs)
            del kvs
            full, _ = model.prefill(params, cfg,
                                    torch.cat([prompt, new_tail], dim=1))
    finally:
        llama.flash_prefill = saved
    ref, got = full[0, prompt.shape[1]:], tail[0]
    return ((ref.argmax(-1) == got.argmax(-1)).float().mean().item(),
            ((got - ref).norm() / ref.norm()).item())


def shifted_row_engine(serving, *a, **kw):
    """An engine whose first slot's page-table row is shifted by one page
    after admission: a planted bookkeeping fault."""
    class Faulty(serving.ServingEngine):
        def _do_admit_paged(self, slot_idx, *args, **kwargs):
            super()._do_admit_paged(slot_idx, *args, **kwargs)
            if slot_idx == 0:
                row = self.page_table[0]
                row[1:] = row[:-1].copy()
                self._pages_rev += 1
    return Faulty(*a, **kw)


def start_store(InfiniStoreServer, ServerConfig, cfg, n_tokens,
                min_alloc_kb=None, **server_kw):
    """A store server whose pool holds ``n_tokens`` tokens of KV at
    ``cfg``'s geometry and dtype (growing if it must), after checking
    /dev/shm. Blocks are allocated in units of ``min_alloc_kb`` KB
    (default: one page of ``cfg``'s dtype); ``server_kw`` go to its
    ServerConfig."""
    token_bytes = 2 * cfg.n_layers * cfg.kv_page_bytes() // cfg.page_size
    pool_bytes = n_tokens * token_bytes
    shm_free = shutil.disk_usage("/dev/shm").free
    say(f"store: {token_bytes // 1024} KiB of KV per token, pool "
        f"{pool_bytes / 2**30:.2f} GiB for {n_tokens} tokens, /dev/shm "
        f"free {shm_free / 2**30:.1f} GiB")
    check(shm_free > 1.5 * pool_bytes, "not enough /dev/shm for the pool")
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=pool_bytes / 2**30,
        minimal_allocate_size=min_alloc_kb or cfg.kv_page_bytes() // 1024,
        auto_increase=True, extend_size=1, **server_kw,
    ))
    srv.start()
    return srv


GRAPH_BATCH, GRAPH_STEPS = 32, 4


def decode_graph_check(torch, llama, pd, kw, params, cfg):
    """llama.DecodeGraph against the eager decode step on the same
    inputs, read apart from the launch counters (a replay adds its
    capture's launches to them, whatever it ran): GRAPH_STEPS steps at
    batch GRAPH_BATCH over lengths 64-1024 and one idle slot on scratch
    page 0, each fed the eager step's argmax. Each replayed step's
    logits bit-equal to the eager step's (a replay that skipped or
    misplaced a kernel would differ), the pools equal after the run, the
    eager step launching the KV-write kernel once a layer, as a replay
    does, and a profiler started
    after the capture seeing each replay's K2 (paged_split_kernel) and
    KV write (kv_write_kernel) under their own names, L of each a step.
    Returns
    the readings."""
    from torch.profiler import ProfilerActivity, profile

    B, n, P, L = GRAPH_BATCH, GRAPH_STEPS, cfg.page_size, cfg.n_layers
    gen = torch.Generator().manual_seed(SEED + 66)
    lens = torch.randint(64, 1025, (B,), generator=gen, dtype=torch.int32)
    lens[-1] = 0
    need = [-(-(int(s) + n) // P) for s in lens[:-1]]
    table = torch.zeros(B, max(need), dtype=torch.int32)
    nxt = 1
    for i, m in enumerate(need):
        table[i, :m] = torch.arange(nxt, nxt + m, dtype=torch.int32)
        nxt += m
    shape = (L, nxt, P, cfg.n_kv_heads, cfg.head_dim)
    dgen = torch.Generator(device="cuda").manual_seed(SEED + 66)
    k_e, v_e = (torch.randn(shape, dtype=cfg.torch_dtype, device="cuda",
                            generator=dgen) for _ in range(2))
    k_g, v_g = k_e.clone(), v_e.clone()
    lens, table = lens.cuda(), table.cuda()
    toks = [torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                          dtype=torch.int32).cuda()]
    eager = []
    kw0 = kw.launches
    for s in range(n):
        logits, _, _ = llama.decode_step(params, cfg, toks[s], lens + s,
                                         k_e, v_e, table)
        eager.append(logits)
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
    eager_kv = kw.launches - kw0
    graph = llama.DecodeGraph()
    logits, _, _ = llama.decode_step(params, cfg, toks[0], lens, k_g, v_g,
                                     table, graph=graph)
    same = [torch.equal(logits, eager[0])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in range(1, n):
            logits, _, _ = llama.decode_step(params, cfg, toks[s], lens + s,
                                             k_g, v_g, table, graph=graph)
            same.append(torch.equal(logits, eager[s]))
        torch.cuda.synchronize()
    seen = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # K2's split kernel (its merge kernel is paged_split_merge_*).
            for key, frag in (("paged_split", "paged_split_kernel"),
                              ("kv_write", "kv_write_kernel")):
                seen[key] += frag in e.name
    pools = torch.equal(k_g, k_e) and torch.equal(v_g, v_e)
    out = dict(batch=B, steps=n, logits_bit_equal=sum(same),
               pools_equal=pools, eager_kv_write_launches=eager_kv,
               replays_profiled=n - 1, kernels_seen=dict(seen),
               counters=dict(graph.counters))
    say(f"decode graph vs eager step at batch {B}, {n} steps: logits "
        f"bit-equal in {sum(same)}, pools equal {pools}, eager step's "
        f"kv_write launches {eager_kv}; in {n - 1} profiled replays the "
        f"trace holds {dict(seen)} (want {L * (n - 1)} of each); "
        f"{dict(graph.counters)}")
    check(all(same), "a replayed decode step's logits differ from the "
          "eager step's")
    check(pools, "the pools differ after replayed and eager steps")
    check(eager_kv == L * n, f"the eager decode steps launched the "
          f"KV-write kernel {eager_kv} times, not {L * n}")
    check(seen["paged_split"] == L * (n - 1)
          and seen["kv_write"] == L * (n - 1),
          f"the profiler saw {dict(seen)} in {n - 1} replays")
    check(graph.counters == {"decode_graph_captures": 1,
                             "decode_graph_replays": n},
          f"decode graph counters {graph.counters}")
    del graph, k_e, v_e, k_g, v_g, eager, logits
    torch.cuda.empty_cache()
    return out


def phase_serving(torch, np, params, report):
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch import serving
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_verify as pv
    from infinistore_tpu_torch.ops import paged_kv_write as kw
    from infinistore_tpu_torch.ops.paged_attention import (
        multi_token_paged_attention, prefill_attention)
    from infinistore_tpu_torch.serving_http import ServingHTTPServer

    say("== phase 6: serving at Llama-3.1-8B width, bf16 ==")
    cfg = llama.LLAMA31_8B
    L, P = cfg.n_layers, cfg.page_size
    rng = np.random.default_rng(SEED + 6)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    r1_prompts = [toks(n) for n in ROUND1]
    turn_new = {i: toks(TURN_NEW) for i in (1, 3, 5, 7)}
    b_cold = [toks(B_PROMPT) for _ in range(4)]
    b_ext = {i: toks(EXTEND_NEW) for i in (0, 2, 4, 6)}
    http_prompts = [toks(HTTP_PROMPT) for _ in range(4)]
    # Tokens the store must hold: the distinct full pages every finished
    # or preempted sequence offloads (repeats deduplicate), a quarter
    # more for spare; the pool grows if that is short.
    n_tokens = int(1.25 * (
        sum(ROUND1) + 8 * NEW_TOKENS                  # round 1
        + 4 * (TURN_NEW + 2 * NEW_TOKENS) + 4 * NEW_TOKENS  # round 2
        + 4 * (B_PROMPT + EXTEND_NEW + 2 * NEW_TOKENS)  # engine B
        + 4 * (HTTP_PROMPT + HTTP_NEW) + 2048))       # HTTP, checks
    srv = start_store(InfiniStoreServer, ServerConfig, cfg, n_tokens)
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    check(conn.shm_connected, "SHM path not active")
    store = tcuda.CudaKVStore(conn, "cuda")
    model = CountingModel(llama)
    proposer = ContinuationProposer()
    try:
        eng_a = serving.ServingEngine(
            params, cfg, serving.ServingConfig(
                max_slots=8, spec_k=4, max_pages_per_seq=160,
                total_pages=8 * 160 + 1),
            store=store, proposer=proposer, model=model)
        eng_b = serving.ServingEngine(
            params, cfg, serving.ServingConfig(
                max_slots=4, prefill_chunk=512, host_steps=4,
                max_pages_per_seq=160, total_pages=4 * B_PROMPT // P + 9),
            store=store, model=model)
        say(f"engine A: 8 slots, spec_k 4, {eng_a.sc.total_pages} pool "
            f"pages; engine B: 4 slots, chunk 512, host_steps 4, "
            f"{eng_b.sc.total_pages} pool pages (room for its 4 cold "
            f"prompts and 8 pages more)")

        fa.reset_launches()
        pd.reset_launches()
        pv.reset_launches()
        kw.reset_launches()
        model.calls.clear()
        finished = []  # (prompt, tokens) of every finished request

        # -- round 1: 8 cold requests --
        reqs = [serving.Request(f"r1_{i}", p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(r1_prompts)]
        out1 = run_leg(torch, eng_a, "round1", reqs, report)
        finished += [(r.prompt, out1[r.request_id]) for r in reqs]
        r1_out = [out1[f"r1_{i}"] for i in range(len(ROUND1))]

        # -- round 2: 4 regenerate + 4 next-turn requests --
        reqs = []
        for i, p in enumerate(r1_prompts):
            if i % 2 == 0:
                proposer.add(p, r1_out[i])
                reqs.append(serving.Request(f"regen_{i}", p,
                                            max_new_tokens=NEW_TOKENS))
            else:
                reqs.append(serving.Request(
                    f"turn_{i}", p + r1_out[i] + turn_new[i],
                    max_new_tokens=NEW_TOKENS))
        out2 = run_leg(torch, eng_a, "round2", reqs, report)
        finished += [(r.prompt, out2[r.request_id]) for r in reqs]

        # -- engine B: chunked prefill, bursts, preemption --
        reqs = [serving.Request(f"b_cold_{i}", p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(b_cold)]
        reqs += [serving.Request(f"b_ext_{i}", r1_prompts[i] + b_ext[i],
                                 max_new_tokens=NEW_TOKENS)
                 for i in (0, 2, 4, 6)]
        outb = run_leg(torch, eng_b, "engineB", reqs, report)
        finished += [(r.prompt, outb[r.request_id]) for r in reqs]

        # -- the HTTP front end over engine A --
        outh = http_leg(torch, ServingHTTPServer, eng_a, http_prompts,
                        report)
        finished += [(http_prompts[i], outh[i]) for i in outh]
        torch.cuda.synchronize()

        calls = dict(model.calls)
        k1, k2, k3 = fa.launches, pd.launches, pv.launches
        kv = kw.launches
        n_pf = calls.get("prefill", 0) + calls.get("prefill_with_prefix", 0)
        n_dec = calls.get("decode_step", 0)
        say(f"serving launches: flash_prefill {k1} (= {L} x {n_pf} "
            f"prefills), paged_decode {k2} (= {L} x {n_dec} decode "
            f"steps), kv_write {kv} (the same, every step replayed), "
            f"paged_verify {k3} (= {L} x {calls.get('verify_step', 0)} "
            f"verify steps)")
        check(k1 == L * n_pf and k1 > 0, "flash prefill launch count")
        check(k2 == L * n_dec and k2 > 0, "paged decode launch count")
        check(kv == L * n_dec, "kv_write launch count")
        check(k3 == L * calls.get("verify_step", 0) and k3 > 0,
              "paged verify launch count")
        report["launches"] = {"flash_prefill": k1, "paged_decode": k2,
                              "paged_verify": k3, "kv_write": kv}
        tot = {k: eng_a.stats[k] + eng_b.stats[k] for k in eng_a.stats}
        say(f"engine stats (A + B): {json.dumps(tot)}")
        # One decode graph an engine, replayed on every decode step.
        check(tot["decode_graph_captures"] == 2
              and tot["decode_graph_replays"] == n_dec,
              f"decode graphs: {tot['decode_graph_captures']} captures, "
              f"{tot['decode_graph_replays']} replays of {n_dec} steps")
        for key, lo in (("prefix_hit_pages", 1), ("spec_proposed", 1),
                        ("chunk_steps", 1), ("burst_steps", 1),
                        ("preemptions", 1)):
            check(tot[key] >= lo, f"serving never exercised {key}")

        # ---- checks outside the counted run ----
        # What the replays computed, read apart from the counters.
        report["decode_graph"] = decode_graph_check(torch, llama, pd, kw,
                                                    params, cfg)
        # K3 against its plain version in every layer, on the engines'
        # own inputs: one speculative step (engine A, a proposer that
        # always drafts) and one 512-token chunk step (engine B).
        eng_a.proposer = lambda ctx, k: [ctx[-1]] * k
        eng_a.submit(serving.Request("check_spec", r1_prompts[6],
                                     max_new_tokens=8))
        spec_rel = layer_checked_step(torch, llama, pv,
                                      multi_token_paged_attention, eng_a,
                                      cfg.window)
        eng_a.run()
        eng_b.submit(serving.Request("check_chunk", toks(1024),
                                     max_new_tokens=4))
        chunk_rel = layer_checked_step(torch, llama, pv,
                                       multi_token_paged_attention, eng_b,
                                       cfg.window)
        eng_b.run()
        for name, rels in (("speculative", spec_rel), ("chunk", chunk_rel)):
            worst = max(rels)
            say(f"{name} step, K3 vs plain attention in each of {len(rels)} "
                f"layers: worst rel err {worst:.3e} (layer "
                f"{rels.index(worst)}, tol {TOL_REL['bfloat16']:g})")
            check(len(rels) == L and worst <= TOL_REL["bfloat16"],
                  f"paged verify kernel vs plain on the {name} step")

        # Teacher-forced check of every finished request.
        noise_seq = finished[0]
        noise = logit_noise(
            torch, llama, prefill_attention, params, cfg,
            torch.tensor([noise_seq[0] + noise_seq[1]], dtype=torch.int32,
                         device="cuda"))
        delta = DELTA_FACTOR * noise
        t0 = time.perf_counter()
        worst, exact = teacher_forced_gaps(torch, llama, params, cfg,
                                           finished)
        say(f"teacher-forced check of {len(finished)} finished requests "
            f"({time.perf_counter() - t0:.1f} s): largest gap to the dense "
            f"row maximum {worst:.4f}, exact argmax share {exact:.4f}; "
            f"delta {delta:.4f} = {DELTA_FACTOR:g} x logit noise "
            f"{noise:.4f} (flash kernel vs plain attention, dense prefill "
            f"of {len(noise_seq[0]) + len(noise_seq[1])} tokens)")
        check(worst <= delta, f"teacher-forced gap {worst} > delta {delta}")
        # The check bites: a page-table row shifted by one page.
        faulty = shifted_row_engine(
            serving, params, cfg, serving.ServingConfig(
                max_slots=2, max_pages_per_seq=40, total_pages=81))
        fp = r1_prompts[6]
        fout = faulty.run([serving.Request("fault", fp, max_new_tokens=16)])
        fgap, fexact = teacher_forced_gaps(torch, llama, params, cfg,
                                           [(fp, fout["fault"])])
        say(f"planted fault (slot 0's page-table row shifted by one page): "
            f"largest gap {fgap:.4f} ({fgap / delta:.1f} x delta), exact "
            f"argmax share {fexact:.4f}")
        check(fgap > 2 * delta, "the teacher-forced check missed a "
              "shifted page-table row")
        report["teacher_forced"] = dict(
            requests=len(finished), worst_gap=worst, exact_share=exact,
            delta=delta, logit_noise=noise, fault_gap=fgap)
        del eng_a, eng_b, faulty
    finally:
        store.close()
        conn.close()
        srv.stop()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6d: the sharded store tier at Llama-3.1-8B width
# ---------------------------------------------------------------------------

SHARDS = 3
SHARD_PROMPTS = (2048, 1536, 1024, 512)  # engine A's cold requests
SHARD_NEW = 32
SHARD_DEAD = 1                           # the shard stopped mid-service
# BASELINE.json config 2: 16 MB in 4 KB blocks (4096 keys).
BENCH_SHAPE = dict(size_mb=16, block_size_kb=4, steps=32)


def shard_fleet(InfiniStoreServer, ServerConfig, cfg, n_tokens):
    """SHARDS port servers, each pool sized for ``n_tokens`` of KV."""
    fleet = []
    try:
        for _ in range(SHARDS):
            fleet.append(start_store(InfiniStoreServer, ServerConfig, cfg,
                                     n_tokens))
    except BaseException:
        for srv in fleet:
            srv.stop()
        raise
    return fleet


def pinned_alloc_s(torch, nbytes):
    """Seconds to get one pinned host buffer of ``nbytes``."""
    t0 = time.perf_counter()
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dt = time.perf_counter() - t0
    del buf
    return dt


def sharded_pages(torch, llama, tcuda, params, cfg, store, fleet, prompt,
                  main_report, report):
    """(b): one prompt's KV pages, every layer, through CudaKVStore over
    the sharded connection: offload, two restores byte-equal, spread
    over every shard, GB/s beside phase 4's SHM numbers, and the share
    of a restore spent allocating its pinned staging buffer."""
    P, L = cfg.page_size, cfg.n_layers
    n = prompt.shape[1]
    sid = f"shard_{uuid.uuid4()}"
    with torch.no_grad():
        _, kvs = llama.prefill(params, cfg, prompt)
    keys, pages = [], []
    for li, (k, v) in enumerate(kvs):
        kp, vp = llama.kv_to_pages(cfg, k, v)
        keys += llama.page_keys(sid, li, "k", n // P)
        keys += llama.page_keys(sid, li, "v", n // P)
        pages += [kp[0], vp[0]]
    del kvs
    pages = torch.cat(pages)
    nbytes = pages.numel() * pages.element_size()
    tcuda.reset_copy_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.put_kv_pages(keys, pages, sync=True)
    t_off = time.perf_counter() - t0
    lens = [srv.kvmap_len() for srv in fleet]
    check(sum(lens) == len(keys) and all(n_k > 0 for n_k in lens),
          f"pages not spread over every shard: kvmap_len {lens}")
    restores = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = store.get_kv_pages(keys, cfg.kv_page_shape(), cfg.torch_dtype)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        check(torch.equal(back.view(torch.int16), pages.view(torch.int16)),
              "sharded restore differs from the pages put")
        del back
    # The staged read asks for a fresh pinned buffer of the whole
    # restore on every call, which PyTorch's caching host allocator
    # serves: that request alone as the restores found it (warm), and
    # after the allocator's cache is emptied (cold: cudaHostAlloc).
    pin_s = [pinned_alloc_s(torch, nbytes)]
    empty_host_cache = (getattr(torch._C, "_host_emptyCache", None)
                        or getattr(torch._C, "_accelerator_emptyHostCache",
                                   None))
    if empty_host_cache is not None:
        empty_host_cache()
        pin_s.append(pinned_alloc_s(torch, nbytes))
    counters = dict(tcuda.copy_counters)
    say(f"sharded pages: {len(keys)} pages ({nbytes / 2**20:.0f} MiB, "
        f"{n} tokens x {L} layers x k/v) over {SHARDS} shards "
        f"(kvmap_len {lens}), STREAM staged; offload {t_off * 1e3:.2f} ms "
        f"{nbytes / t_off / 1e9:.2f} GB/s (phase 4, SHM: "
        f"{main_report.get(f'offload_{n}_GBps', 0):.2f}); restore "
        f"{restores[0] * 1e3:.2f}, {restores[1] * 1e3:.2f} ms, "
        f"{nbytes / restores[0] / 1e9:.2f}, {nbytes / restores[1] / 1e9:.2f} "
        f"GB/s (phase 4, SHM: {main_report.get('restore_GBps', 0):.2f}), "
        f"byte-equal; pinned staging buffer warm {pin_s[0] * 1e3:.3f} ms "
        f"({pin_s[0] / restores[1]:.5f} of a restore), cold "
        f"{pin_s[1] * 1e3 if len(pin_s) > 1 else 'not measured'} ms; "
        f"copies {json.dumps(counters)}")
    report["pages"] = dict(
        pages=len(keys), bytes=nbytes, kvmap_len=lens,
        offload_GBps=nbytes / t_off / 1e9,
        restore_GBps=[nbytes / t / 1e9 for t in restores],
        shm_offload_GBps=main_report.get(f"offload_{n}_GBps"),
        shm_restore_GBps=main_report.get("restore_GBps"),
        pinned_alloc_ms_warm_cold=[t * 1e3 for t in pin_s],
        pinned_alloc_share=pin_s[0] / restores[1], copies=counters)
    return sid, keys, pages


def shard_engine_legs(torch, np, serving, llama, params, cfg, store, conn,
                      fleet, report):
    """(c) and (d): engine A's configuration over the sharded store: 4
    cold requests, 4 regenerated through prefix hits across shards,
    then shard SHARD_DEAD stopped and the same 4 regenerated again.
    Launches counted over the three legs; every request teacher-forced
    by phase 6's rule."""
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_verify as pv
    from infinistore_tpu_torch.ops import paged_kv_write as kw
    from infinistore_tpu_torch.ops.paged_attention import prefill_attention

    L = cfg.n_layers
    rng = np.random.default_rng(SEED + 64)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in SHARD_PROMPTS]
    model = CountingModel(llama)
    proposer = ContinuationProposer()
    eng = serving.ServingEngine(
        params, cfg, serving.ServingConfig(
            max_slots=8, spec_k=4, max_pages_per_seq=160,
            total_pages=8 * 160 + 1),
        store=store, proposer=proposer, model=model)
    fa.reset_launches()
    pd.reset_launches()
    pv.reset_launches()
    kw.reset_launches()
    finished = []
    cold = [serving.Request(f"s_cold_{i}", p, max_new_tokens=SHARD_NEW)
            for i, p in enumerate(prompts)]
    out = run_leg(torch, eng, "cold", cold, report)
    finished += [(r.prompt, out[r.request_id]) for r in cold]
    for r in cold:
        proposer.add(r.prompt, out[r.request_id])

    def regen(tag):
        return [serving.Request(f"s_{tag}_{i}", p, max_new_tokens=SHARD_NEW)
                for i, p in enumerate(prompts)]

    hit = regen("hit")
    out = run_leg(torch, eng, "hit", hit, report)
    finished += [(r.prompt, out[r.request_id]) for r in hit]
    check(report["hit"]["prefix_hit_pages"] > 0,
          "regenerated requests found no prefix across the shards")
    fleet[SHARD_DEAD].stop()
    errors = eng.stats["store_errors"]
    dead = regen("dead")
    out = run_leg(torch, eng, "after_kill", dead, report)
    finished += [(r.prompt, out[r.request_id]) for r in dead]
    torch.cuda.synchronize()
    calls = dict(model.calls)
    k1, k2, k3 = fa.launches, pd.launches, pv.launches
    n_pf = calls.get("prefill", 0) + calls.get("prefill_with_prefix", 0)
    health = {k: v for k, v in conn.health.items()}
    say(f"sharded serving launches: flash_prefill {k1} (= {L} x {n_pf} "
        f"prefills), paged_decode {k2} (= {L} x "
        f"{calls.get('decode_step', 0)} decode steps), paged_verify {k3} "
        f"(= {L} x {calls.get('verify_step', 0)} verify steps); after "
        f"shard {SHARD_DEAD} stopped: health {json.dumps(health)}, "
        f"degraded {conn.degraded}, engine store_errors "
        f"{eng.stats['store_errors'] - errors}, restore_misses "
        f"{eng.stats['restore_misses']}")
    check(k1 == L * n_pf and k1 > 0, "flash prefill launch count")
    check(k2 == L * calls.get("decode_step", 0) and k2 > 0,
          "paged decode launch count")
    check(kw.launches == k2 and eng.stats["decode_graph_replays"]
          == calls.get("decode_step", 0),
          f"sharded serving: kv_write {kw.launches} launches, "
          f"{eng.stats['decode_graph_replays']} decode graph replays")
    check(k3 == L * calls.get("verify_step", 0) and k3 > 0,
          "paged verify launch count")
    report["launches"] = {"flash_prefill": k1, "paged_decode": k2,
                          "paged_verify": k3, "kv_write": kw.launches}
    report["health"] = health
    report["store_errors_after_kill"] = eng.stats["store_errors"] - errors
    report["restore_misses"] = eng.stats["restore_misses"]
    check(all(len(toks) == SHARD_NEW for _, toks in finished),
          "a request over the sharded store did not finish")
    check(conn.degraded[SHARD_DEAD] and health["shard_failures"] >= 1,
          "the stopped shard was not marked down")
    check(report["after_kill"]["prefix_hit_pages"]
          < report["hit"]["prefix_hit_pages"],
          "hit pages did not fall after the shard stopped")
    check(eng.stats["store_errors"] == errors,
          "a dead shard surfaced as a store error")
    noise = logit_noise(
        torch, llama, prefill_attention, params, cfg,
        torch.tensor([finished[0][0] + finished[0][1]], dtype=torch.int32,
                     device="cuda"))
    delta = DELTA_FACTOR * noise
    worst, exact = teacher_forced_gaps(torch, llama, params, cfg, finished)
    say(f"sharded teacher-forced check of {len(finished)} requests: "
        f"largest gap {worst:.4f}, exact argmax share {exact:.4f}; delta "
        f"{delta:.4f} = {DELTA_FACTOR:g} x logit noise {noise:.4f}")
    check(worst <= delta, f"teacher-forced gap {worst} > delta {delta}")
    report["teacher_forced"] = dict(requests=len(finished), worst_gap=worst,
                                    exact_share=exact, delta=delta)
    del eng


def shm_restore_window(torch, llama, tcuda, profile_window, params, cfg,
                       srv, store, conn, sid, keys, pages, report):
    """(e): a prefix-hit restore of the (b) prefix from one SHM server,
    as phase 4 restores it (restore + the new tail's prefill), inside
    profile_window with the store's spans and the torch timeline merged;
    then the same restore split into pin, H2D copies and release."""
    P, n_pages = cfg.page_size, pages.shape[0] // (2 * cfg.n_layers)
    store.put_kv_pages(keys, pages, sync=True)
    rng = torch.Generator(device="cuda").manual_seed(SEED + 65)
    tail_tokens = torch.randint(0, cfg.vocab_size, (1, HIT_NEW),
                                device="cuda", generator=rng,
                                dtype=torch.int32)

    def hit():
        with torch.no_grad():
            prefix_kvs = llama.restore_prefix_kvs(store, cfg, sid, n_pages)
            tail, _ = llama.prefill_with_prefix(params, cfg, tail_tokens,
                                                prefix_kvs)
        torch.cuda.synchronize()
        return tail

    hit()  # warms the shapes, as phase 4's first hit does
    with tempfile.TemporaryDirectory() as trace_dir:
        with profile_window(srv, trace_dir=trace_dir, trace=True) as w:
            t0 = time.perf_counter()
            hit()
            t_hit = time.perf_counter() - t0
        with gzip.open(w.trace_path, "rt") as f:
            doc = json.load(f)
    spans = collections.defaultdict(float)
    for ev in w.store_trace["traceEvents"]:
        if ev.get("ph") == "X":
            spans[ev["name"]] += ev.get("dur", 0) / 1e3
    merged = doc["traceEvents"]
    # Cross-check of the measured offset: Kineto stamps wall-clock µs
    # less the file's baseTimeNanoseconds.
    wall_minus_mono = (time.time_ns() - time.monotonic_ns()) / 1e3
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    n_store = sum(1 for e in merged if e.get("pid") == 1
                  and e.get("ph") == "X")
    kern = [e for e in merged if e.get("cat") == "kernel"]
    copies = [e for e in merged if e.get("cat") == "gpu_memcpy"]
    say(f"profile_window around a {n_pages * P}-token prefix hit on one SHM "
        f"server ({t_hit * 1e3:.2f} ms): op_deltas "
        f"{json.dumps(w.op_deltas)}; store span ms by op "
        f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}; merged "
        f"file: {n_store} store spans, {len(kern)} CUDA kernel events "
        f"({sum(e.get('dur', 0) for e in kern) / 1e3:.2f} ms), "
        f"{len(copies)} memcpy events "
        f"({sum(e.get('dur', 0) for e in copies) / 1e3:.2f} ms); torch "
        f"clock - store clock {w.clock_offset_us:.1f} us +- "
        f"{w.clock_offset_err_us:.1f} (wall - monotonic - base "
        f"{wall_minus_mono - base_us:.1f})")
    check(n_store > 0 and len(kern) > 0,
          "the merged trace lacks store spans or CUDA kernel events")
    check(w.op_deltas.get("PIN", 0) >= 1, "no PIN in the window")
    # The restore split: pin RPC, H2D copies (synchronized), release.
    page_bytes = pages[0].numel() * pages.element_size()
    out = torch.empty(len(keys) * page_bytes, dtype=torch.uint8,
                      device="cuda")
    t0 = time.perf_counter()
    lease, blocks = conn.pin(keys)
    t1 = time.perf_counter()
    store._copy_from_pool(out, blocks, page_bytes)
    t2 = time.perf_counter()
    conn.release(lease)
    t3 = time.perf_counter()
    check(torch.equal(out, tcuda._as_bytes(pages)),
          "split SHM restore differs from the pages put")
    split = dict(pin_ms=(t1 - t0) * 1e3, copy_ms=(t2 - t1) * 1e3,
                 release_ms=(t3 - t2) * 1e3,
                 copy_GBps=out.numel() / (t2 - t1) / 1e9)
    say(f"SHM restore of {len(keys)} pages split: pin {split['pin_ms']:.2f} "
        f"ms, H2D copies + sync {split['copy_ms']:.2f} ms "
        f"({split['copy_GBps']:.2f} GB/s), release "
        f"{split['release_ms']:.2f} ms")
    report["profile"] = dict(
        hit_ms=t_hit * 1e3, op_deltas=w.op_deltas,
        store_span_ms=dict(spans), store_spans=n_store,
        kernel_events=len(kern), memcpy_events=len(copies),
        clock_offset_us=w.clock_offset_us,
        clock_offset_err_us=w.clock_offset_err_us,
        wall_offset_us=wall_minus_mono - base_us, split=split)


def phase_sharded(torch, np, params, main_report, report):
    """Phase 6d: the sharded store tier at Llama-3.1-8B width, on the
    bf16 model phases 4 and 6 use."""
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM, TYPE_STREAM)
    from infinistore_tpu_torch import benchmark, serving, warmup
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch.example import client
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.sharded import ShardedConnection
    from infinistore_tpu_torch.utils import profile_window

    say(f"== phase 6d: the sharded store ({SHARDS} shards) at Llama-3.1-8B "
        f"width ==")
    cfg = llama.LLAMA31_8B
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, PROMPTS[0])),
                             dtype=torch.int32, device="cuda")
    # Every shard's pool holds the whole leg's KV: the pages of (b), the
    # cold requests' prompts and outputs, a quarter more for spare.
    n_tokens = int(1.25 * (PROMPTS[0] + sum(SHARD_PROMPTS)
                           + 2 * len(SHARD_PROMPTS) * SHARD_NEW))
    fleet = shard_fleet(InfiniStoreServer, ServerConfig, cfg, n_tokens)
    conn = ShardedConnection([ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=TYPE_STREAM) for srv in fleet])
    store = srv = sconn = sstore = None
    try:
        conn.connect()
        check(not conn.shm_connected, "a sharded connection took SHM")
        store = tcuda.CudaKVStore(conn, "cuda")
        sid, keys, pages = sharded_pages(torch, llama, tcuda, params, cfg,
                                         store, fleet, prompt, main_report,
                                         report)
        shard_engine_legs(torch, np, serving, llama, params, cfg, store,
                          conn, fleet, report)
        # (e)-(g) on one SHM server of their own.
        srv = start_store(InfiniStoreServer, ServerConfig, cfg,
                          2 * PROMPTS[0], min_alloc_kb=4, trace=True)
        sconn = InfinityConnection(ClientConfig(
            host_addr="127.0.0.1", service_port=srv.service_port,
            connection_type=TYPE_SHM))
        sconn.connect()
        check(sconn.shm_connected, "SHM path not active")
        sstore = tcuda.CudaKVStore(sconn, "cuda")
        shm_restore_window(torch, llama, tcuda, profile_window, params, cfg,
                           srv, sstore, sconn, sid, keys, pages, report)
        del pages
        sstore.close()
        sconn.close()
        srv.stop()
        sstore = sconn = None
        # (f) and (g) on a server without tracing, as users run one.
        srv = InfiniStoreServer(ServerConfig(
            service_port=0, prealloc_size=0.25, minimal_allocate_size=4))
        srv.start()
        bench = {}
        for path, ctype in (("shm", TYPE_SHM), ("stream", TYPE_STREAM)):
            bench[path] = benchmark.run(service_port=srv.service_port,
                                        connection_type=ctype,
                                        **BENCH_SHAPE)
            say(f"benchmark ({path}, {BENCH_SHAPE['size_mb']} MB in "
                f"{BENCH_SHAPE['block_size_kb']} KB blocks, verified): put "
                f"{bench[path]['put_GBps']} GB/s, get "
                f"{bench[path]['get_GBps']} GB/s, p50 read "
                f"{bench[path]['p50_read_latency_us']} us")
        report["benchmark"] = bench
        check(warmup.warm_up(srv.service_port, prime_cuda=True),
              "warm_up(prime_cuda=True) failed")
        for ctype in (TYPE_SHM, TYPE_STREAM):
            client.run("127.0.0.1", srv.service_port, ctype, "cuda")
        say("warmup (CUDA primed) and example/client.py on cuda, SHM and "
            "STREAM: OK")
    finally:
        if sstore is not None:
            sstore.close()
        if sconn is not None:
            sconn.close()
        if srv is not None:
            srv.stop()
        if store is not None:
            store.close()
        conn.close()
        for s in fleet:
            s.stop()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6b: int8 at Llama-3.1-8B width
# ---------------------------------------------------------------------------

INT8_PROMPT = 2048
INT8_ROUND = (2048, 1536, 1024, 512)
INT8_NEW = 32
INT8_DECODE_STEPS = 8
# Rows of activations each int8 leaf is checked on (int8_leaf_errors).
LEAF_ROWS = 64


def int8_wire_and_k4(torch, params, cfg, store, prompt, report):
    """Prefill ``prompt``, put every layer's KV int8 on SHM and take it
    back raw; then one decode step whose attention is K4 over those int8
    pages in all layers (counted), K2 over the bf16 pages and K4's plain
    version beside it. Returns the K4 launches of that step."""
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops import kv_quant
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_decode_q as pq

    L, P = cfg.n_layers, cfg.page_size
    n = prompt.shape[1]
    n_pages = n // P
    shape = cfg.kv_page_shape()
    block = kv_quant.packed_page_bytes(shape)
    sid = f"int8_{uuid.uuid4()}"
    with torch.no_grad():
        logits, kvs = llama.prefill(params, cfg, prompt)
    pages = [llama.kv_to_pages(cfg, k, v) for k, v in kvs]
    del kvs
    tcuda.reset_copy_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for li, (kp, vp) in enumerate(pages):
        store.put_kv_pages_quantized(llama.page_keys(sid, li, "k", n_pages),
                                     kp[0])
        store.put_kv_pages_quantized(llama.page_keys(sid, li, "v", n_pages),
                                     vp[0])
    t_off = time.perf_counter() - t0
    put = dict(tcuda.copy_counters)
    wire = 2 * L * n_pages * block
    check(put["staging_copies"] == 0, f"int8 SHM put staged: {put}")
    check(block == 16896 and put["d2h_bytes"] == wire,
          f"int8 pages: {block} B a page, {put['d2h_bytes']} B written "
          f"(want 16896 and {wire})")
    tcuda.reset_copy_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q8 = [tuple(store.get_kv_pages_quantized_raw(
        llama.page_keys(sid, li, kind, n_pages), shape)
        for kind in ("k", "v")) for li in range(L)]
    torch.cuda.synchronize()
    t_rs = time.perf_counter() - t0
    got = dict(tcuda.copy_counters)
    check(got["h2d_bytes"] == wire, f"int8 restore moved {got['h2d_bytes']} B")
    for li in (0, L - 1):
        want = kv_quant.quantize_kv_pages(pages[li][0][0])
        check(all(torch.equal(a, b) for a, b in zip(q8[li][0], want)),
              f"layer {li}: int8 pages differ after the store round trip")
    # The same pages in bf16, put and restored beside them.
    sid16 = f"bf16_{uuid.uuid4()}"
    for li, (kp, vp) in enumerate(pages):
        store.put_kv_pages(llama.page_keys(sid16, li, "k", n_pages), kp[0])
        store.put_kv_pages(llama.page_keys(sid16, li, "v", n_pages), vp[0])
    tcuda.reset_copy_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back16 = [store.get_kv_pages(llama.page_keys(sid16, li, kind, n_pages),
                                 shape, cfg.torch_dtype)
              for li in range(L) for kind in ("k", "v")]
    torch.cuda.synchronize()
    t_rs16 = time.perf_counter() - t0
    got16 = dict(tcuda.copy_counters)
    bf16 = 2 * L * n_pages * cfg.kv_page_bytes()
    check(got16["h2d_bytes"] == bf16
          and torch.equal(back16[-1], pages[-1][1][0]),
          f"bf16 restore moved {got16['h2d_bytes']} B")
    del back16
    say(f"int8 wire: {n} tokens x {L} layers, {block} B a page ("
        f"{block / cfg.kv_page_bytes():.3f} of bf16's "
        f"{cfg.kv_page_bytes()}); offload {wire / 2**20:.0f} MiB in "
        f"{t_off * 1e3:.2f} ms, {wire / t_off / 1e9:.2f} GB/s ("
        f"{n / t_off:.0f} tok/s; bf16 {bf16 / 2**20:.0f} MiB); restore raw "
        f"in {t_rs * 1e3:.2f} ms, {wire / t_rs / 1e9:.2f} GB/s ("
        f"{n / t_rs:.0f} tok/s), {got['h2d_copies']} H2D copies for "
        f"{2 * L * n_pages} pages ({got['h2d_gap_bytes']} gap bytes copied "
        f"along); bf16 restore of the same pages in {t_rs16 * 1e3:.2f} ms, "
        f"{bf16 / t_rs16 / 1e9:.2f} GB/s ({n / t_rs16:.0f} tok/s), "
        f"{got16['h2d_copies']} H2D copies; staging copies 0")
    report["wire"] = dict(page_bytes=block, bf16_page_bytes=cfg.kv_page_bytes(),
                          offload_ms=t_off * 1e3,
                          offload_GBps=wire / t_off / 1e9,
                          restore_ms=t_rs * 1e3,
                          restore_GBps=wire / t_rs / 1e9,
                          restore_copies=got["h2d_copies"],
                          restore_gap_bytes=got["h2d_gap_bytes"],
                          bf16_restore_ms=t_rs16 * 1e3,
                          bf16_restore_GBps=bf16 / t_rs16 / 1e9,
                          bf16_restore_copies=got16["h2d_copies"])

    # One decode step over the pages, at shuffled pool ids: attention is
    # K4 over the int8 pages, with K2 over the bf16 pages and K4's plain
    # version run beside it on each layer's own q.
    n_pool = n_pages + 8
    perm = torch.randperm(n_pool, generator=torch.Generator().manual_seed(
        SEED + 61)).int()
    table_cpu = padded_table(torch, [n_pages + 1], n_pages + 3, n_pool, perm)
    table = table_cpu.cuda()
    ids = table_cpu[0, :n_pages].long().cuda()
    new_page = int(table_cpu[0, n_pages])
    pool = (L, n_pool, *shape)
    k_pool = torch.zeros(pool, dtype=cfg.torch_dtype, device="cuda")
    v_pool = torch.zeros_like(k_pool)
    kq_pool = torch.zeros(pool, dtype=torch.int8, device="cuda")
    vq_pool = torch.zeros_like(kq_pool)
    ks_pool = torch.zeros(pool[:-1], dtype=torch.float32, device="cuda")
    vs_pool = torch.zeros_like(ks_pool)
    for li, ((kp, vp), ((kq, ks), (vq, vs))) in enumerate(zip(pages, q8)):
        k_pool[li, ids], v_pool[li, ids] = kp[0], vp[0]
        kq_pool[li, ids], ks_pool[li, ids] = kq, ks
        vq_pool[li, ids], vs_pool[li, ids] = vq, vs
    del pages, q8
    rel4, quant = [], []

    def attend(q, kp, vp, pt, sl, window=0):
        li = len(rel4)
        # The step's own token went into kp/vp: quantize its page too.
        kq_pool[li, new_page], ks_pool[li, new_page] = [
            t[0] for t in kv_quant.quantize_kv_pages(kp[new_page][None])]
        vq_pool[li, new_page], vs_pool[li, new_page] = [
            t[0] for t in kv_quant.quantize_kv_pages(vp[new_page][None])]
        q8_args = (q, kq_pool[li], ks_pool[li], vq_pool[li], vs_pool[li],
                   pt, sl)
        out = pq.decode_attention_quantized(*q8_args, window=window)
        ref = pq.paged_decode_quantized_plain(*q8_args, window=window)
        bf16_out = pd.paged_flash_decode(q, kp, vp, pt, sl, window=window)
        rel4.append(rel_err(out, ref))
        quant.append(rel_err(out, bf16_out))
        return out

    token = torch.argmax(logits[0, -1:], dim=-1).to(torch.int32)
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")
    saved = llama.decode_attention
    llama.decode_attention = attend
    pq.reset_launches()
    try:
        step_logits, _, _ = llama.decode_step(params, cfg, token, lens,
                                              k_pool, v_pool, table)
        torch.cuda.synchronize()
    finally:
        llama.decode_attention = saved
    launches = pq.launches
    worst = max(rel4)
    say(f"int8 decode step over the restored pages: K4 launched {launches} "
        f"times (= {L} layers); K4 vs plain worst rel err {worst:.3e} "
        f"(layer {rel4.index(worst)}, tol {TOL_REL['bfloat16']:g}); K4 "
        f"over int8 vs K2 over bf16 (the quantizer's error) mean "
        f"{statistics.mean(quant):.3e} max {max(quant):.3e}")
    check(launches == L and len(rel4) == L, f"K4 launches {launches}")
    check(worst <= TOL_REL["bfloat16"], "K4 vs plain on the restored pages")
    check(bool(torch.isfinite(step_logits).all()), "int8 step logits")
    report["k4_step"] = dict(launches=launches, worst_rel=worst,
                             quant_rel_mean=statistics.mean(quant),
                             quant_rel_max=max(quant))
    return launches


def int8_leaf_errors(torch, llama, qparams, gen):
    """Each int8 leaf kind at full width against float32 on the int8
    values times their scales: layer 0's seven matmul leaves and lm_head
    through llama._matmul on LEAF_ROWS random bf16 rows, the embedding
    through llama._embed. Returns {leaf: per-row relative L2 error}."""
    errs = {}
    layer = qparams["layers"][0]
    for name, w in [(k, layer[k]) for k in llama._QUANT_LEAVES] + [
            ("lm_head", qparams["lm_head"])]:
        h = torch.randn((LEAF_ROWS, w["int8"].shape[0]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        ref = h.float() @ (w["int8"].float() * w["scale"].float())
        errs[name] = rel_err(llama._matmul(h, w), ref)
    e = qparams["embed"]
    toks = torch.randint(0, e["int8"].shape[0], (1, LEAF_ROWS),
                         generator=gen, device="cuda")
    ref = e["int8"][toks[0]].float() * e["scale"][toks[0]].float()[:, None]
    errs["embed"] = rel_err(llama._embed(qparams, toks)[0], ref)
    return errs


def logit_agreement(got, ref):
    """(argmax agreement, global relative L2) of two logits tensors."""
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    return agree, ((got - ref).norm() / ref.norm()).item()


def int8_weights(torch, params, cfg, prompt, gen, report):
    """quantize_params of the 8B tree; each int8 leaf kind held to float32
    (the check); prefill with the int8 tree against the bf16 tree (the
    quantizer's effect, reported) and decode at batch 4 with both trees.
    Returns the int8 tree."""
    from infinistore_tpu_torch.models import llama

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = llama.quantize_params(params, cfg)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    q_bytes, d_bytes = llama.param_bytes(qparams), llama.param_bytes(params)
    leaf_errs = int8_leaf_errors(torch, llama, qparams, gen)
    prefill_ms = {}
    with torch.no_grad():
        for name, p in (("bf16", params), ("int8", qparams)):
            llama.prefill(p, cfg, prompt)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, kvs = llama.prefill(p, cfg, prompt)
            torch.cuda.synchronize()
            prefill_ms[name] = (time.perf_counter() - t0) * 1e3
            if name == "bf16":
                dense, dense_kvs = lg, kvs
        gap = ((lg - dense).abs().max() / dense.abs().max()).item()
        agree, rel = logit_agreement(lg, dense)
        del lg, kvs
    # Decode at batch 4: four rows over the prompt's pages, each writing
    # its new tokens into pages of its own; bf16 and int8 in turns.
    P = cfg.page_size
    n_pages = prompt.shape[1] // P
    rows = 4
    own = -(-INT8_DECODE_STEPS // P)
    n_pool = n_pages + rows * own + 1
    k_pool = torch.zeros((cfg.n_layers, n_pool, *cfg.kv_page_shape()),
                         dtype=cfg.torch_dtype, device="cuda")
    v_pool = torch.zeros_like(k_pool)
    for li, (k, v) in enumerate(dense_kvs):
        kp, vp = llama.kv_to_pages(cfg, k, v)
        k_pool[li, 1:n_pages + 1], v_pool[li, 1:n_pages + 1] = kp[0], vp[0]
    del dense_kvs, kp, vp
    table = torch.tensor(
        [list(range(1, n_pages + 1))
         + list(range(n_pages + 1 + r * own, n_pages + 1 + (r + 1) * own))
         for r in range(rows)], dtype=torch.int32, device="cuda")
    first = torch.argmax(dense[0, -1]).repeat(rows).to(torch.int32)
    del dense
    trees = {"bf16": params, "int8": qparams}
    step_ms = {"bf16": [], "int8": []}
    with torch.no_grad():
        for name in ("bf16", "int8", "int8", "bf16"):
            p = trees[name]
            tok = first
            lens = torch.full((rows,), prompt.shape[1], dtype=torch.int32,
                              device="cuda")
            llama.decode_step(p, cfg, tok, lens, k_pool, v_pool, table)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(INT8_DECODE_STEPS):
                lg, _, _ = llama.decode_step(p, cfg, tok, lens, k_pool,
                                             v_pool, table)
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
                lens = lens + 1
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0)
                                 / INT8_DECODE_STEPS * 1e3)
    decode_ms = {k: statistics.mean(v) for k, v in step_ms.items()}
    del k_pool, v_pool
    say(f"int8 weights: quantize_params in {t_q:.2f} s, {q_bytes / 1e9:.3f}"
        f" GB ({q_bytes / d_bytes:.3f} of bf16's {d_bytes / 1e9:.3f} GB); "
        f"prefill {prompt.shape[1]} tokens {prefill_ms['int8']:.2f} ms "
        f"(bf16 {prefill_ms['bf16']:.2f}); decode batch 4 ms/step int8 "
        f"{step_ms['int8']} bf16 {step_ms['bf16']} (in turns)")
    worst = max(leaf_errs, key=leaf_errs.get)
    say(f"int8 leaves vs float32 (int8 x scale) at full width: worst rel "
        f"err {leaf_errs[worst]:.3e} ({worst}; tol "
        f"{TOL_REL['bfloat16']:g}); int8 prefill vs the bf16 tree (the "
        f"quantizer's effect over {cfg.n_layers} layers): argmax "
        f"agreement {agree:.4f}, rel L2 {rel:.3e}, largest gap {gap:.4f} of "
        f"the largest |logit|")
    check(leaf_errs[worst] <= TOL_REL["bfloat16"],
          f"int8 leaf {worst} disagrees with float32: {leaf_errs}")
    report["weights"] = dict(quantize_s=t_q, bytes=q_bytes,
                             bf16_bytes=d_bytes, prefill_ms=prefill_ms,
                             decode_ms_per_step=decode_ms,
                             leaf_rel=leaf_errs, bf16_agree=agree,
                             bf16_rel=rel, bf16_max_gap=gap)
    return qparams


def int8_serving(torch, np, qparams, cfg, store, report):
    """An engine on the int8 tree with quantized_store=True: 4 cold
    requests, then 4 that regenerate them through int8 prefix hits; every
    finished request teacher-forced through one dense prefill, delta
    measured in the run, and the planted page-table fault."""
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch import serving
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops import kv_quant

    L, P = cfg.n_layers, cfg.page_size
    rng = np.random.default_rng(SEED + 62)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in INT8_ROUND]
    proposer = ContinuationProposer()
    eng = serving.ServingEngine(
        qparams, cfg, serving.ServingConfig(
            max_slots=8, spec_k=4, max_pages_per_seq=160,
            total_pages=8 * 160 + 1, quantized_store=True),
        store=store, proposer=proposer)
    check(eng._ns.endswith("/q8"), f"int8 engine namespace {eng._ns}")
    tcuda.reset_copy_counters()
    out1 = run_leg(torch, eng, "int8_cold", [
        serving.Request(f"q_{i}", p, max_new_tokens=INT8_NEW)
        for i, p in enumerate(prompts)], report)
    for i, p in enumerate(prompts):
        proposer.add(p, out1[f"q_{i}"])
    out2 = run_leg(torch, eng, "int8_regen", [
        serving.Request(f"qr_{i}", p, max_new_tokens=INT8_NEW)
        for i, p in enumerate(prompts)], report)
    torch.cuda.synchronize()
    counters = dict(tcuda.copy_counters)
    block = kv_quant.packed_page_bytes(cfg.kv_page_shape())
    offloaded = eng.stats["offloaded_pages"] * 2 * L
    say(f"int8 serving: {eng.stats['prefix_hit_pages']} hit pages, "
        f"{eng.stats['restored_pages']} restored, "
        f"{eng.stats['offloaded_pages']} offloaded ({offloaded * block / 2**20:.1f}"
        f" MiB on the int8 wire, {offloaded * cfg.kv_page_bytes() / 2**20:.1f}"
        f" MiB as bf16: {block / cfg.kv_page_bytes():.3f}); copies "
        f"{counters}")
    check(eng.stats["prefix_hit_pages"] > 0 and eng.stats["restored_pages"]
          > 0, "the int8 engine never restored a prefix")
    check(counters["staging_copies"] == 0, "int8 serving staged copies")
    check(counters["d2h_bytes"] % block == 0 and counters["h2d_bytes"]
          % block == 0 and 0 < counters["d2h_bytes"] <= offloaded * block,
          f"int8 serving moved other than whole {block}-byte pages")
    report["int8_serving"] = dict(
        hit_pages=eng.stats["prefix_hit_pages"],
        restored_pages=eng.stats["restored_pages"],
        offloaded_pages=eng.stats["offloaded_pages"],
        offloaded_MiB=offloaded * block / 2**20,
        offloaded_bf16_MiB=offloaded * cfg.kv_page_bytes() / 2**20,
        d2h_bytes=counters["d2h_bytes"], h2d_bytes=counters["h2d_bytes"])

    # delta: the logit gap between a dense prefill and prefill_with_prefix
    # over int8-restored pages of the same tokens (the int8 wire's noise
    # and the kernels' together).
    seq = prompts[0] + out1["q_0"]
    toks = torch.tensor([seq], dtype=torch.int32, device="cuda")
    n_pre = INT8_ROUND[0]
    sid = f"int8_noise_{uuid.uuid4()}"
    with torch.no_grad():
        dense, kvs = llama.prefill(qparams, cfg, toks)
        for li, (k, v) in enumerate(kvs):
            kp, vp = llama.kv_to_pages(cfg, k[:, :n_pre], v[:, :n_pre])
            store.put_kv_pages_quantized(
                llama.page_keys(sid, li, "k", n_pre // P), kp[0])
            store.put_kv_pages_quantized(
                llama.page_keys(sid, li, "v", n_pre // P), vp[0])
        del kvs, kp, vp
        kr, vr = llama.restore_prefix_pages(
            store, cfg, lambda li, kind: llama.page_keys(sid, li, kind,
                                                         n_pre // P),
            n_pre // P, getter=store.get_kv_pages_quantized)
        prefix = [llama.pages_to_kv(cfg, kr[li][None], vr[li][None], n_pre)
                  for li in range(L)]
        tail, _ = llama.prefill_with_prefix(qparams, cfg, toks[:, n_pre:],
                                            prefix)
    noise = (tail[0] - dense[0, n_pre:]).abs().max().item()
    delta = DELTA_FACTOR * noise
    del dense, tail, prefix, kr, vr
    finished = [(p, out1[f"q_{i}"]) for i, p in enumerate(prompts)]
    finished += [(p, out2[f"qr_{i}"]) for i, p in enumerate(prompts)]
    worst, exact = teacher_forced_gaps(torch, llama, qparams, cfg, finished)
    say(f"int8 teacher-forced check of {len(finished)} requests: largest "
        f"gap {worst:.4f}, exact argmax share {exact:.4f}; delta "
        f"{delta:.4f} = {DELTA_FACTOR:g} x {noise:.4f} (dense prefill vs "
        f"prefill_with_prefix over {n_pre} int8-restored tokens)")
    check(worst <= delta, f"int8 teacher-forced gap {worst} > {delta}")
    faulty = shifted_row_engine(
        serving, qparams, cfg, serving.ServingConfig(
            max_slots=2, max_pages_per_seq=40, total_pages=81))
    fp = prompts[-1]
    fout = faulty.run([serving.Request("fault", fp, max_new_tokens=16)])
    fgap, fexact = teacher_forced_gaps(torch, llama, qparams, cfg,
                                       [(fp, fout["fault"])])
    say(f"int8 planted fault (page-table row shifted by one page): gap "
        f"{fgap:.4f} ({fgap / delta:.1f} x delta), exact argmax share "
        f"{fexact:.4f}")
    check(fgap > delta, "the int8 teacher-forced check missed a shifted "
          "page-table row")
    report["int8_teacher_forced"] = dict(
        requests=len(finished), worst_gap=worst, exact_share=exact,
        delta=delta, noise=noise, fault_gap=fgap)
    del eng, faulty


def phase_int8(torch, np, params, report):
    """The int8 slice at Llama-3.1-8B width, on the bf16 model already
    loaded: the wire and K4 on real KV, int8 weights, and serving with
    both. Returns K4's launches on the decode step over int8 pages."""
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch.models import llama

    say("== phase 6b: int8 pages, K4 and int8 weights at Llama-3.1-8B "
        "width ==")
    cfg = llama.LLAMA31_8B
    rng = np.random.default_rng(SEED + 60)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, INT8_PROMPT)),
                             dtype=torch.int32, device="cuda")
    # Room (counted in bf16 pages) for the wire check and its bf16 twin,
    # the delta prefix and both serving rounds. A 16896-byte int8 page takes 20 KB in the
    # store's smallest allocation unit (4 KB, a power of two).
    n_tokens = 3 * INT8_PROMPT + 2 * sum(INT8_ROUND) + 8 * INT8_NEW
    srv = start_store(InfiniStoreServer, ServerConfig, cfg, n_tokens,
                      min_alloc_kb=4)
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    check(conn.shm_connected, "SHM path not active")
    store = tcuda.CudaKVStore(conn, "cuda")
    try:
        launches = int8_wire_and_k4(torch, params, cfg, store, prompt,
                                    report)
        qparams = int8_weights(torch, params, cfg, prompt, torch.Generator(
            device="cuda").manual_seed(SEED + 63), report)
        int8_serving(torch, np, qparams, cfg, store, report)
        del qparams
    finally:
        store.close()
        conn.close()
        srv.stop()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6c: MoE at Mixtral-8x7B width
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1's config.json: the fields the bridge reads.
MIXTRAL_8X7B = dict(
    model_type="mixtral", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, num_local_experts=8, num_experts_per_tok=2,
    rope_theta=1e6, max_position_embeddings=32768, rms_norm_eps=1e-5,
    sliding_window=None, hidden_act="silu", rope_scaling=None,
    tie_word_embeddings=False)
MOE_LAYERS = 16       # 32 layers of bf16 weights take 93.4 GB of the 80
MOE_SMALL_LAYERS = 2  # the bridge's round trip and training
MOE_BRIDGE_TOKENS = 256
MOE_B_PROMPTS = (2048, 1536, 1024, 512)  # engine B, chunked
MOE_REGEN = (0, 2, 4, 6)                 # round-1 requests regenerated
MOE_CHECK_PROMPT = 1024  # the chunk step held to the plain attention
MOE_DIFF_SHOWN = 5
MOE_FAULT_PROMPT = 6  # round 1's request whose slot the fault shifts


def mixtral_config(hf, **cut):
    """MIXTRAL_8X7B (with ``cut`` applied) through the port's bridge, as
    an attribute namespace like a transformers config: bf16, page 16."""
    ns = type("HFConfig", (), {**MIXTRAL_8X7B, **cut})
    return ns, hf.moe_config_from_hf(ns, page_size=16, dtype="bfloat16")


def moe_to_hf(params, cfg):
    """The inverse of ``hf.moe_params_from_hf``: the tree as an HF-named
    Mixtral state dict on its device ([out, in] projections, per-expert
    w1 / w3 / w2)."""
    t = lambda w: w.T.contiguous()  # noqa: E731
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_ln"],
          "lm_head.weight": t(params["lm_head"])}
    for li, layer in enumerate(params["layers"]):
        p = f"model.layers.{li}."
        m = p + "block_sparse_moe."
        sd[p + "input_layernorm.weight"] = layer["ln1"]
        sd[p + "post_attention_layernorm.weight"] = layer["ln2"]
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "o_proj")):
            sd[p + f"self_attn.{theirs}.weight"] = t(layer[ours])
        sd[m + "gate.weight"] = t(layer["router"])
        for ours, theirs in (("e_gate", "w1"), ("e_up", "w3"),
                             ("e_down", "w2")):
            for e in range(cfg.n_experts):
                sd[m + f"experts.{e}.{theirs}.weight"] = t(layer[ours][e])
    return sd


def moe_bridge(torch, np, hf, moe, llama, report):
    """At full width and 2 layers: a port tree -> HF state dict ->
    ``load_hf_moe``; every leaf and one prefill's logits equal."""
    t0 = time.perf_counter()
    ns, cfg = mixtral_config(hf, num_hidden_layers=MOE_SMALL_LAYERS)
    params = moe.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 11), cfg, "cuda")
    sd = moe_to_hf(params, cfg)
    cfg2, back = hf.load_hf_moe(sd, ns, page_size=16, dtype="bfloat16",
                                device="cuda")
    del sd
    check(cfg2 == cfg, f"bridge config {cfg2} != {cfg}")
    mine, theirs = llama.param_leaves(params), llama.param_leaves(back)
    check(len(mine) == len(theirs) and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(mine, theirs)), "bridge round trip changed a leaf")
    check(back["layers"][0]["router"].dtype == torch.float32,
          "the bridge's router is not float32")
    tokens = torch.as_tensor(np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (1, MOE_BRIDGE_TOKENS)), dtype=torch.int32,
        device="cuda")
    with torch.no_grad():
        la, _ = moe.prefill(params, cfg, tokens)
        lb, _ = moe.prefill(back, cfg, tokens)
    check(torch.equal(la, lb), "bridged tree's logits differ")
    torch.cuda.synchronize()
    say(f"bridge: {MOE_SMALL_LAYERS} layers at full width, "
        f"{llama.param_bytes(params) / 1e9:.2f} GB: port tree -> HF "
        f"Mixtral state dict -> load_hf_moe: {len(mine)} leaves equal, "
        f"{MOE_BRIDGE_TOKENS}-token prefill logits equal ("
        f"{time.perf_counter() - t0:.1f} s)")
    report["bridge"] = dict(leaves=len(mine), equal=True)
    del params, back, la, lb


class RoutingTape:
    """Routing recorded by context and replayed: while active it wraps
    ``moe._route``. A model call run through :meth:`run` names each of its
    routed tokens as (sequence, position, request id), or None for
    padding, through a function read only at :meth:`commit` (a served
    request's sequence is final then). Recorded, each layer's top-k
    choice is kept under the token's request and context (the sequence up
    to and including it; the latest record wins, as spec decoding
    rewrites rejected positions), and under the context alone for the
    first request that routed it (a request that restored those pages
    from the store did not). Replayed for one request, every token with
    a record routes to the recorded experts, the others by the router.
    The bf16 paths of one model differ in rounding, and a token whose two
    best experts are nearly tied flips between them and takes other
    experts' outputs: replaying one path's routing in the other holds
    them to each other on everything else."""

    def __init__(self, torch, moe):
        self.torch, self.moe = torch, moe
        self.calls, self.table, self.prefix = [], {}, {}
        self.rows = None
        # Every pass while active: its selected and dropped pairs, summed
        # on the device (no sync per layer).
        self.selected, self.dropped = [], []

    def __enter__(self):
        self.saved = self.moe._route
        self.moe._route = self._route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.saved

    def run(self, rows, fn, replay=None):
        """Run model call ``fn`` with its tokens named by ``rows``;
        replay the routing recorded for request ``replay`` (its records,
        then anyone's) instead of recording, if given."""
        self.rows, self.replay, self.experts, self.keys = (
            rows, replay, [], None)
        try:
            return fn()
        finally:
            if replay is None:
                self.calls.append((rows, self.experts))
            self.rows = None

    def key(self, seq, pos):
        """The context of position ``pos`` of ``seq``: a chained hash of
        seq[:pos + 1], computed once per sequence."""
        hs = self.prefix.get(seq)
        if hs is None:
            h, hs = 0, []
            for t in seq:
                h = hash((h, t))
                hs.append(h)
            self.prefix[seq] = hs
        return hs[pos]

    def totals(self):
        """(passes, selected pairs, dropped pairs) while active so far."""
        return (len(self.selected),
                int(self.torch.stack(self.selected).sum()),
                int(self.torch.stack(self.dropped).sum()))

    def _route(self, layer, h, cfg, valid=None, choice=None, par=None):
        if self.rows is None or self.replay is None:
            r = self.saved(layer, h, cfg, valid, choice, par)
            self.selected.append(r.selected.sum())
            self.dropped.append((r.selected & ~r.kept).sum())
            if self.rows is not None:
                self.experts.append(r.expert)
            return r
        li = len(self.experts)
        self.experts.append(None)
        if self.keys is None:
            self.keys = [None if row is None else self.key(*row[:2])
                         for row in self.rows()]
        own = self.saved(layer, h, cfg, valid).expert
        forced = own.cpu().numpy().copy()
        for t, k in enumerate(self.keys):
            rec = None if k is None else self.lookup(self.replay, k, li)
            if rec is not None:
                forced[t] = rec
        return self.saved(layer, h, cfg, valid,
                          self.torch.as_tensor(forced, device=h.device))

    def commit(self):
        """File every recorded call's choices under their contexts."""
        for rows, experts in self.calls:
            host = [e.cpu().numpy() for e in experts]
            for t, row in enumerate(rows()):
                if row is not None:
                    seq, pos, rid = row
                    k = self.key(seq, pos)
                    for li, e in enumerate(host):
                        self.table[(rid, k, li)] = e[t]
                        self.table.setdefault((None, k, li), e[t])
        self.calls = []

    def lookup(self, rid, key, li):
        rec = self.table.get((rid, key, li))
        return self.table.get((None, key, li)) if rec is None else rec

    def choices(self, rid, seq, pos, n_layers):
        k = self.key(seq, pos)
        return [self.lookup(rid, k, li) for li in range(n_layers)]


class RoutingCheck:
    """While active, ``moe._route`` is wrapped: every routing made under a
    mesh context (``TensorParallel`` or ``ExpertParallel``) keeps, per
    routed token, a checksum of the bits of its router input h and its
    top-k experts, in call order. It syncs nothing while it records.
    Ranks that made the same calls compare their records with
    :meth:`agreement`."""

    def __init__(self, torch, moe):
        self.torch, self.moe = torch, moe
        self.rows, self.experts, self.par = [], [], None

    def __enter__(self):
        self.saved = self.moe._route
        self.moe._route = self._route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.saved

    def _route(self, layer, h, cfg, valid=None, choice=None, par=None):
        r = self.saved(layer, h, cfg, valid, choice, par)
        if par is not None:
            torch = self.torch
            bits = h.detach().contiguous().view(
                {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                    h.element_size()])
            w = torch.arange(1, h.shape[-1] + 1, device=h.device) % 251 + 1
            self.rows.append((bits.to(torch.int64) * w).sum(dim=-1))
            self.experts.append(r.expert.detach())
            self.par = par
        return r

    def agreement(self):
        """The share of the routed tokens that every rank of the mesh's
        inner axis (tp or ep) routed alike: the same router input, to the
        bit, and the same experts. 1.0 when the ranks agree; a rank whose
        residual stream parted from the others' reads below it. Every
        rank of the axis calls it."""
        torch, par = self.torch, self.par
        if par is None or par.tp == 1:
            return 1.0
        mine = torch.cat([torch.cat([r[:, None], e], dim=1)
                          for r, e in zip(self.rows, self.experts)])
        parts = [torch.empty_like(mine) for _ in range(par.tp)]
        torch.distributed.all_gather(parts, mine, group=par.tp_group)
        same = torch.stack([(p == parts[0]).all(dim=1)
                            for p in parts]).all(0)
        return same.double().mean().item()


class TapedModel(CountingModel):
    """The MoE module for an engine, counting its calls (as
    CountingModel) and running each through ``tape`` with its tokens
    named: the admitted request's (set by :func:`taped`), or each slot's
    row at its position. Sequences resolve through ``final``
    (request id -> generated tokens) at commit."""

    def __init__(self, module, tape, final):
        super().__init__(module)
        self.tape, self.final = tape, final
        self.engine = self.admitting = None

    def _row(self, work, pos):
        rid = work.req.request_id
        return (tuple(work.prompt) + tuple(self.final[rid]), pos, rid)

    def __getattr__(self, name):
        fn = super().__getattr__(name)
        if name not in self.COUNTED:
            return fn
        return lambda *a, **kw: self.tape.run(self._rows(name, *a, **kw),
                                              lambda: fn(*a, **kw))

    def _rows(self, name, params, cfg, tokens, *a, **kw):
        if name in ("prefill", "prefill_with_prefix"):
            start = 0
            if name == "prefill_with_prefix":
                start = a[0][0][0].shape[1] + kw.get("pos0", 0)
            work, n = self.admitting, tokens.shape[1]
            return lambda: [self._row(work, start + j) for j in range(n)]
        works = [None if s is None else s.work for s in self.engine.slots]
        lens = a[0].clone()
        m = 1 if tokens.dim() == 1 else tokens.shape[1]
        valid = a[4] if len(a) > 4 else kw.get("valid_len")
        valid = None if valid is None else valid.clone()

        def rows():
            ls = lens.tolist()
            vs = [m] * len(ls) if valid is None else valid.tolist()
            return [self._row(w, ls[i] + j)
                    if w is not None and j < vs[i] and (m > 1 or ls[i] > 0)
                    else None
                    for i, w in enumerate(works) for j in range(m)]
        return rows


def taped(eng, model):
    """Point ``model`` (a TapedModel) at ``eng``'s slots and admissions."""
    model.engine = eng
    admit = eng._do_admit_paged

    def do_admit(slot_idx, work, *a, **kw):
        model.admitting = work
        return admit(slot_idx, work, *a, **kw)
    eng._do_admit_paged = do_admit
    return eng


class PinnedPrefill:
    """``prefill`` of ``moe`` routed as ``tape`` recorded request ``rid``
    (teacher_forced_gaps' model)."""

    def __init__(self, tape, moe, rid):
        self.tape, self.moe, self.rid = tape, moe, rid

    def prefill(self, params, cfg, toks):
        seq = tuple(toks[0].tolist())
        return self.tape.run(
            lambda: [(seq, p, self.rid) for p in range(len(seq))],
            lambda: self.moe.prefill(params, cfg, toks), replay=self.rid)


def moe_teacher_forced(torch, serving, llama, moe, plain_prefill, params,
                       cfg, finished, rids, tape, fault_prompt,
                       served_noise=0.0):
    """Every finished request teacher-forced through one dense prefill,
    by phase 6's rule (delta = DELTA_FACTOR x the kernel-vs-plain logit
    noise) twice: as phase 6 runs it, and with each dense pass routed as
    the engine routed the request's tokens (``tape``) and the noise
    measured between two passes routed alike. A bf16 MoE at random
    weights flips nearly-tied experts between any two paths, so the
    first reads the flips (with the (layer, token) pairs whose top-2
    differs) and the second, the check, holds the paged path (pages,
    kernels, page tables) to the dense one. A planted page-table fault
    must read above twice the pinned delta. ``served_noise``, the logit
    noise of the engine's own arithmetic against one process's (a tp
    engine's: phase 12), adds to the kernel noise before the factor."""
    L = cfg.n_layers

    def noise(pinned):
        seq = list(finished[0][0]) + list(finished[0][1])
        toks = torch.tensor([seq], dtype=torch.int32, device="cuda")
        if not pinned:
            return logit_noise(torch, llama, plain_prefill, params, cfg,
                               toks, model=moe)
        own = RoutingTape(torch, moe)
        rows = lambda: [(tuple(seq), p, "n") for p in range(len(seq))]  # noqa
        with torch.no_grad(), own:
            kernel, _ = own.run(rows, lambda: moe.prefill(params, cfg, toks))
            own.commit()
            saved = llama.flash_prefill
            llama.flash_prefill = plain_prefill
            try:
                plain, _ = PinnedPrefill(own, moe, "n").prefill(params, cfg,
                                                                toks)
            finally:
                llama.flash_prefill = saved
        return (kernel - plain).abs().max().item()

    class Recorded:  # a dense prefill recorded into ``dense``
        def prefill(self, params, cfg, toks):
            seq = tuple(toks[0].tolist())
            return dense.run(
                lambda: [(seq, p, self.rid) for p in range(len(seq))],
                lambda: moe.prefill(params, cfg, toks))

    dense = RoutingTape(torch, moe)
    out = {}
    free = []
    with dense:
        for rid, pair in zip(rids, finished):
            rec = Recorded()
            rec.rid = rid
            free.append(teacher_forced_gaps(torch, rec, params, cfg, [pair]))
    dense.commit()
    with tape:
        pinned = [teacher_forced_gaps(torch, PinnedPrefill(tape, moe, rid),
                                      params, cfg, [pair])
                  for rid, pair in zip(rids, finished)]
    diffs = []
    for r, (rid, (prompt, gen)) in enumerate(zip(rids, finished)):
        seq = tuple(prompt) + tuple(gen)
        for pos in range(len(prompt) - 1, len(seq) - 1):
            a = tape.choices(rid, seq, pos, L)
            b = dense.choices(rid, seq, pos, L)
            check(all(x is not None for x in a),
                  f"request {r}: no engine routing at position {pos}")
            diffs += [(r, li, pos, sorted(x.tolist()), sorted(y.tolist()))
                      for li, (x, y) in enumerate(zip(a, b))
                      if sorted(x.tolist()) != sorted(y.tolist())]
    n_pairs = L * sum(len(g) for _, g in finished)
    for name, gaps, pinned_run in (("as phase 6", free, False),
                                   ("routed as served", pinned, True)):
        nz = noise(pinned_run)
        delta = DELTA_FACTOR * (nz + served_noise)
        worst = max(g for g, _ in gaps)
        exact = statistics.mean(e for _, e in gaps)
        say(f"teacher-forced, {name}: {len(finished)} requests, largest "
            f"gap {worst:.4f}, exact argmax share {exact:.4f}; delta "
            f"{delta:.4f} = {DELTA_FACTOR:g} x (logit noise {nz:.4f} + "
            f"served noise {served_noise:.4f}); per "
            f"request " + " ".join(f"{g:.3f}" for g, _ in gaps))
        out["pinned" if pinned_run else "unpinned"] = dict(
            worst_gap=worst, exact_share=exact, delta=delta,
            logit_noise=nz)
    worst_r = max(range(len(free)), key=lambda i: free[i][0])
    shown = [d for d in diffs if d[0] == worst_r][:MOE_DIFF_SHOWN]
    say(f"routing, engine vs dense pass: top-2 differs at {len(diffs)} of "
        f"{n_pairs} (layer, token) pairs of the generated tokens' rows"
        + "".join(f"; request {r} layer {li} token {pos}: served {a} "
                  f"dense {b}" for r, li, pos, a, b in shown))
    out["routing_diffs"] = len(diffs)
    out["routing_pairs"] = n_pairs
    delta = out["pinned"]["delta"]
    check(out["pinned"]["worst_gap"] <= delta,
          f"teacher-forced gap {out['pinned']['worst_gap']} > delta {delta}")

    # The check bites: slot 0's page-table row shifted by one page.
    ftape, ffinal = RoutingTape(torch, moe), {}
    fmodel = TapedModel(moe, ftape, ffinal)
    faulty = taped(shifted_row_engine(
        serving, params, cfg, serving.ServingConfig(
            max_slots=2, max_pages_per_seq=40, total_pages=81),
        model=fmodel), fmodel)
    with ftape:
        fout = faulty.run([serving.Request("fault", fault_prompt,
                                           max_new_tokens=16)])
    ffinal.update(fout)
    ftape.commit()
    with ftape:
        fgap, fexact = teacher_forced_gaps(
            torch, PinnedPrefill(ftape, moe, "fault"), params, cfg,
            [(fault_prompt, fout["fault"])])
    ratio = fgap / delta if delta > 0 else float("inf")
    say(f"planted fault (slot 0's page-table row shifted by one page), "
        f"routed as served: largest gap {fgap:.4f} ({ratio:.1f} x delta), "
        f"exact argmax share {fexact:.4f}")
    check(fgap > 2 * delta, "the teacher-forced check missed a shifted "
          "page-table row")
    out["fault_gap"] = fgap
    return out


def phase_moe(torch, np, report):
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch import serving
    from infinistore_tpu_torch.models import hf, llama, moe
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_verify as pv
    from infinistore_tpu_torch.ops import paged_kv_write as kw
    from infinistore_tpu_torch.ops.paged_attention import (
        multi_token_paged_attention, prefill_attention)

    say(f"== phase 6c: MoE at Mixtral-8x7B width (mistralai/Mixtral-8x7B-"
        f"v0.1 config.json), {MOE_LAYERS} of 32 layers, bf16 ==")
    moe_bridge(torch, np, hf, moe, llama, report)
    torch.cuda.empty_cache()

    _, full = mixtral_config(hf)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    L, P = cfg.n_layers, cfg.page_size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = moe.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 12), cfg, "cuda")
    torch.cuda.synchronize()
    w_bytes = llama.param_bytes(params)
    per_layer = llama.param_bytes(params["layers"][0])
    full_bytes = w_bytes + (full.n_layers - L) * per_layer
    say(f"model: {sum(t.numel() for t in llama.param_leaves(params)) / 1e9:.2f}"
        f" B params, {w_bytes / 1e9:.2f} GB bf16 (router float32) in "
        f"{time.perf_counter() - t0:.1f} s; cut from 32 to {L} layers: 32 "
        f"would take {full_bytes / 1e9:.1f} GB of the card's 80; "
        f"capacity_factor {cfg.capacity_factor:g} (E / top_k: C = T, no "
        f"drop); {cfg.n_experts} experts, top {cfg.top_k}, d_ff "
        f"{cfg.d_ff}")
    report["config"] = dict(layers=L, of=full.n_layers,
                            weight_GB=w_bytes / 1e9,
                            full_depth_GB=full_bytes / 1e9,
                            capacity_factor=cfg.capacity_factor)
    tape = RoutingTape(torch, moe)
    try:
        # -- the main path, as phase 4 runs it --
        say(f"-- main path at Mixtral-8x7B width, {L} layers --")
        main = {}
        with tape:
            phase_main(torch, np, main, params, cfg, moe)
        launches = main["launches"]
        say(f"main path launches per model call: flash_prefill "
            f"{launches['flash_prefill']}, paged_decode "
            f"{launches['paged_decode']} ({L} a call)")
        # Decode at batch 4 runs every expert (C = 8 slots each), so a
        # step reads every weight but the embedding table, plus the KV
        # of the mean step's lengths.
        token_kv = 2 * L * cfg.kv_page_bytes() // P
        step_bytes = (w_bytes - llama.param_bytes(params["embed"])
                      + sum(n + (DECODE_STEPS + 1) / 2 for n in PROMPTS)
                      * token_kv)
        decode_bound = step_bytes / HBM_BPS * 1e3
        say(f"decode {main['decode_ms_per_step']:.2f} ms/step at batch "
            f"{len(PROMPTS)} against its byte bound {decode_bound:.2f} ms "
            f"({step_bytes / 1e9:.2f} GB a step at {HBM_BPS / 1e12:g} TB/s)"
            f"; prefix hit {main['prefix_hit_ms']:.2f} ms against the full "
            f"{PROMPTS[0] + HIT_NEW}-token prefill "
            f"{main['full_prefill_ms']:.2f} ms")
        main["decode_bound_ms"] = decode_bound
        main["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        report["main"] = {k: v for k, v in main.items() if k != "k2"}

        # Each expert's share of routed pairs on a 2048-token prefill.
        prompt = torch.as_tensor(np.random.default_rng(SEED + 12).integers(
            0, cfg.vocab_size, (1, PROMPTS[0])), dtype=torch.int32,
            device="cuda")
        with torch.no_grad(), RoutingTape(torch, moe) as shares:
            shares.run(lambda: [], lambda: moe.prefill(params, cfg, prompt))
        counts = torch.stack([torch.bincount(e.reshape(-1),
                                             minlength=cfg.n_experts)
                              for e in shares.calls[0][1]]).float()
        share = (counts.sum(0) / counts.sum()).tolist()
        per_layer_max = (counts.max(1).values / counts.sum(1)).max().item()
        say(f"expert shares of routed pairs, {PROMPTS[0]}-token prefill, "
            f"all {L} layers: " + " ".join(f"{x:.4f}" for x in share)
            + f"; largest share in one layer {per_layer_max:.4f} (uniform "
            f"{1 / cfg.n_experts:.4f})")
        report["expert_share"] = dict(all_layers=share,
                                      max_in_a_layer=per_layer_max)

        # -- serving --
        say(f"-- serving at Mixtral-8x7B width, {L} layers --")
        rng = np.random.default_rng(SEED + 13)

        def toks(n):
            return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

        r1_prompts = [toks(n) for n in ROUND1]
        b_prompts = [toks(n) for n in MOE_B_PROMPTS]
        n_tokens = int(1.25 * (sum(ROUND1) + 8 * NEW_TOKENS
                               + 4 * NEW_TOKENS + sum(MOE_B_PROMPTS)
                               + 4 * NEW_TOKENS + 2048))
        srv = start_store(InfiniStoreServer, ServerConfig, cfg, n_tokens)
        conn = InfinityConnection(ClientConfig(
            host_addr="127.0.0.1", service_port=srv.service_port,
            connection_type=TYPE_SHM))
        conn.connect()
        check(conn.shm_connected, "SHM path not active")
        store = tcuda.CudaKVStore(conn, "cuda")
        final = {}
        model_a, model_b = (TapedModel(moe, tape, final) for _ in range(2))
        proposer = ContinuationProposer()
        serve = {}
        pages = -(-(max(ROUND1) + NEW_TOKENS + 8) // P)
        try:
            eng_a = taped(serving.ServingEngine(
                params, cfg, serving.ServingConfig(
                    max_slots=8, spec_k=4, max_pages_per_seq=pages,
                    total_pages=8 * pages + 1),
                store=store, proposer=proposer, model=model_a), model_a)
            eng_b = taped(serving.ServingEngine(
                params, cfg, serving.ServingConfig(
                    max_slots=4, prefill_chunk=512, host_steps=4,
                    max_pages_per_seq=pages, total_pages=4 * pages + 1),
                store=store, model=model_b), model_b)
            fa.reset_launches()
            pd.reset_launches()
            pv.reset_launches()
            kw.reset_launches()
            finished, rids = [], []
            with tape:
                reqs = [serving.Request(f"r1_{i}", p,
                                        max_new_tokens=NEW_TOKENS)
                        for i, p in enumerate(r1_prompts)]
                out1 = run_leg(torch, eng_a, "round1", reqs, serve)
                finished += [(r.prompt, out1[r.request_id]) for r in reqs]
                rids += [r.request_id for r in reqs]
                reqs = []
                for i in MOE_REGEN:
                    proposer.add(r1_prompts[i], out1[f"r1_{i}"])
                    reqs.append(serving.Request(f"regen_{i}", r1_prompts[i],
                                                max_new_tokens=NEW_TOKENS))
                out2 = run_leg(torch, eng_a, "regenerate", reqs, serve)
                finished += [(r.prompt, out2[r.request_id]) for r in reqs]
                rids += [r.request_id for r in reqs]
                reqs = [serving.Request(f"b_{i}", p,
                                        max_new_tokens=NEW_TOKENS)
                        for i, p in enumerate(b_prompts)]
                outb = run_leg(torch, eng_b, "chunked", reqs, serve)
                finished += [(r.prompt, outb[r.request_id]) for r in reqs]
                rids += [r.request_id for r in reqs]
            torch.cuda.synchronize()
            calls = dict(model_a.calls + model_b.calls)
            k1, k2, k3 = fa.launches, pd.launches, pv.launches
            n_pf = (calls.get("prefill", 0)
                    + calls.get("prefill_with_prefix", 0))
            say(f"serving launches: flash_prefill {k1} (= {L} x {n_pf} "
                f"prefills), paged_decode {k2} (= {L} x "
                f"{calls.get('decode_step', 0)} decode steps), paged_verify "
                f"{k3} (= {L} x {calls.get('verify_step', 0)} verify "
                f"steps)")
            check(k1 == L * n_pf and k1 > 0, "MoE flash prefill launches")
            check(k2 == L * calls.get("decode_step", 0) and k2 > 0,
                  "MoE paged decode launches")
            check(k3 == L * calls.get("verify_step", 0) and k3 > 0,
                  "MoE paged verify launches")
            serve["launches"] = {"flash_prefill": k1, "paged_decode": k2,
                                 "paged_verify": k3}
            tot = {k: eng_a.stats[k] + eng_b.stats[k] for k in eng_a.stats}
            # The routed decode step stays eager (no graph) and writes its
            # KV with the kernel, once a layer a step, as K2 attends.
            check(kw.launches == k2 and tot["decode_graph_captures"] == 0
                  and tot["decode_graph_replays"] == 0,
                  f"MoE serving: kv_write {kw.launches} launches against "
                  f"K2's {k2}, {tot['decode_graph_replays']} replays")
            for key in ("prefix_hit_pages", "spec_accepted", "chunk_steps",
                        "burst_steps"):
                check(tot[key] > 0, f"MoE serving never exercised {key}")
            passes, selected, dropped = tape.totals()
            say(f"routing over the main path and serving: {passes} passes, "
                f"{selected} selected (token, expert) pairs, {dropped} "
                f"dropped")
            check(dropped == 0, f"{dropped} pairs dropped at C = T")
            report["routing"] = dict(passes=passes, selected=selected,
                                     dropped=dropped)
            for out in (out1, out2, outb):
                final.update(out)
            tape.commit()

            # ---- checks outside the counted run ----
            eng_b.submit(serving.Request("check_chunk",
                                         toks(MOE_CHECK_PROMPT),
                                         max_new_tokens=4))
            chunk_rel = layer_checked_step(
                torch, llama, pv, multi_token_paged_attention, eng_b,
                cfg.window)
            eng_b.run()
            worst = max(chunk_rel)
            say(f"chunk step, K3 vs plain attention in each of "
                f"{len(chunk_rel)} layers: worst rel err {worst:.3e} (tol "
                f"{TOL_REL['bfloat16']:g})")
            check(len(chunk_rel) == L and worst <= TOL_REL["bfloat16"],
                  "MoE chunk step: paged verify kernel vs plain")
            serve["teacher_forced"] = moe_teacher_forced(
                torch, serving, llama, moe, prefill_attention, params, cfg,
                finished, rids, tape, r1_prompts[MOE_FAULT_PROMPT])
            report["serving"] = serve
            del eng_a, eng_b
        finally:
            store.close()
            conn.close()
            srv.stop()
        report["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        say(f"peak allocated {report['peak_GiB']:.2f} GiB")
    finally:
        del params


def phase_moe_train(torch, np, report):
    """Phase 6c's training: 4 AdamW steps at Mixtral-8x7B width, 2
    layers, bf16, on one 2049-token batch: the loss falls, every leaf
    gets a finite grad, and K1, K5 and K6 launch once per layer per
    step."""
    from infinistore_tpu_torch.models import hf, llama, moe
    from infinistore_tpu_torch.ops import flash_attention as fa

    _, cfg = mixtral_config(hf, num_hidden_layers=MOE_SMALL_LAYERS)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    params = moe.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 14), cfg, "cuda")
    opt = llama.adamw(params, TRAIN_LR)
    leaves = llama.param_leaves(params)
    tokens = train_batch(torch, np, cfg, SEED + 14)
    steps = []
    fa.reset_launches()
    for i in range(TRAIN_STEPS):
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = moe.train_step(params, opt, cfg, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = [a - b for a, b in zip(
            (fa.launches, fa.dq_launches, fa.dkv_launches), before)]
        steps.append(dict(loss=loss.item(), wall_ms=wall * 1e3,
                          launches=launched))
        check(launched == [L] * 3, f"MoE step {i + 1} launched K1/K5/K6 "
              f"{launched} times, not {L} each")
        check(np.isfinite(steps[-1]["loss"]), f"MoE step {i + 1} loss")
        if i == 0:
            missing = [j for j, t in enumerate(leaves)
                       if t.grad is None
                       or not bool(torch.isfinite(t.grad).all())]
            check(not missing, f"MoE step 1: leaves {missing} have no "
                  "finite grad")
            router = params["layers"][0]["router"].grad
            check(router.dtype == torch.float32
                  and router.abs().max().item() > 0,
                  "the float32 router got no grad")
    losses = [s["loss"] for s in steps]
    check(losses[-1] < losses[0], f"MoE loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"MoE training, {L} layers at full width, bf16: losses "
        f"{[round(x, 5) for x in losses]}; wall ms "
        f"{[round(s['wall_ms'], 1) for s in steps]}; every leaf (router "
        f"float32) has a finite grad; K1/K5/K6 {L} each a step; peak "
        f"{peak:.2f} GiB")
    report["train"] = dict(losses=losses,
                           wall_ms=[s["wall_ms"] for s in steps],
                           peak_GiB=peak)
    del params, opt, leaves, loss
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: exact parity at float32
# ---------------------------------------------------------------------------

F32_LAYERS = 4
F32_PROMPTS = (2048, 1536, 1024, 512)
F32_NEW = 32


def phase_f32(torch, np, report):
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch import serving
    from infinistore_tpu_torch.models import llama

    say(f"== phase 7: exact parity at float32, Llama-3.1-8B widths, "
        f"{F32_LAYERS} layers ==")
    cfg = dataclasses.replace(llama.LLAMA31_8B, n_layers=F32_LAYERS,
                              dtype="float32")
    t0 = time.perf_counter()
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 7), cfg, "cuda")
    torch.cuda.synchronize()
    say(f"model: {F32_LAYERS} layers float32 in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 7)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in F32_PROMPTS]
    ample = dict(max_slots=4, max_pages_per_seq=160, total_pages=4 * 160 + 1)

    def requests(ps, tag):
        return [serving.Request(f"{tag}{i}", p, max_new_tokens=F32_NEW)
                for i, p in enumerate(ps)]

    def served(eng, reqs, name):
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        say(f"f32 {name}: {len(reqs)} requests in "
            f"{time.perf_counter() - t0:.2f} s; stats "
            f"{json.dumps({k: v for k, v in eng.stats.items() if v})}")
        return [out[r.request_id] for r in reqs]

    ref = served(serving.ServingEngine(
        params, cfg, serving.ServingConfig(**ample)), requests(prompts, "r"),
        "reference (plain, store-less)")
    srv = start_store(InfiniStoreServer, ServerConfig, cfg,
                      2 * sum(F32_PROMPTS) * 2)
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=srv.service_port,
        connection_type=TYPE_SHM))
    conn.connect()
    store = tcuda.CudaKVStore(conn, "cuda")
    try:
        oracle = ContinuationProposer()
        for p, o in zip(prompts, ref):
            oracle.add(p, o)
        spec_eng = serving.ServingEngine(
            params, cfg, serving.ServingConfig(spec_k=4, **ample),
            proposer=oracle)
        spec = served(spec_eng, requests(prompts, "s"), "spec_k 4")
        check(spec == ref, "f32 speculative tokens differ from the plain "
              "engine's")
        check(spec_eng.stats["spec_accepted"] > 0, "f32 spec accepted none")

        need = sum(-(-n // cfg.page_size) for n in F32_PROMPTS)
        chunk_eng = serving.ServingEngine(
            params, cfg, serving.ServingConfig(
                max_slots=4, prefill_chunk=256, host_steps=4,
                max_pages_per_seq=160, total_pages=need + 5),
            store=store)
        chunk = served(chunk_eng, requests(prompts, "c"),
                       "chunk 256 + host_steps 4 + store, tight pool")
        check(chunk == ref, "f32 chunked/multi-step/preempted tokens differ "
              "from the plain engine's")
        check(chunk_eng.stats["preemptions"] >= 1 and
              chunk_eng.stats["chunk_steps"] > 0 and
              chunk_eng.stats["burst_steps"] > 0,
              "f32 chunk leg did not preempt, chunk and burst")

        turn2 = [p + o + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                       64)]
                 for p, o in zip(prompts, ref)]
        ref2 = served(serving.ServingEngine(
            params, cfg, serving.ServingConfig(**ample)),
            requests(turn2, "t"), "round 2 reference (store-less)")
        hit_eng = serving.ServingEngine(
            params, cfg, serving.ServingConfig(**ample), store=store)
        hit = served(hit_eng, requests(turn2, "h"), "round 2 with the store")
        check(hit == ref2, "f32 store-backed round 2 tokens differ from the "
              "plain engine's")
        check(hit_eng.stats["prefix_hit_pages"] > 0, "f32 round 2 never hit")
        say("f32 parity: speculative, chunked + multi-step + preempting "
            "through the store, and a store-backed second round all give "
            "the plain engine's tokens exactly")
        report["f32"] = dict(
            spec_accepted=spec_eng.stats["spec_accepted"],
            preemptions=chunk_eng.stats["preemptions"],
            prefix_hit_pages=hit_eng.stats["prefix_hit_pages"])
    finally:
        store.close()
        conn.close()
        srv.stop()
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: flash backward
# ---------------------------------------------------------------------------

# (dtype, s_q, s_kv, causal, window, hd, n_heads, n_kv); batch 1.
_BWD_SHAPES = (
    (2048, 2048, True, 0, 128, 32, 8),    # the training shape
    (512, 2048, True, 0, 128, 32, 8),     # 512 queries over a 1536 prefix
    (512, 2048, True, 256, 128, 32, 8),   # ... with a window: dead kv rows
    (1000, 1000, False, 0, 128, 32, 8),   # not causal, ragged
    (1000, 1000, True, 0, 64, 32, 8),     # ragged, hd 64
    (300, 700, True, 128, 32, 32, 8),     # ragged prefix + window, hd 32
    # Published attention widths, as in FLASH_CASES: Qwen2-7B (group 7),
    # Gemma-7B and Gemma-2B (hd 256).
    (2048, 2048, True, 0, 128, 28, 4),
    (2048, 2048, True, 0, 256, 16, 16),
    (2048, 2048, True, 0, 256, 8, 1),
    # phi-2 (hd 80) and Phi-3-mini (hd 96), as in FLASH_CASES.
    (2048, 2048, True, 0, 80, 32, 32),
    (2048, 2048, True, 0, 96, 32, 32),
    # A head dim inside each of the other instantiations, as in
    # FLASH_CASES; at hd 136 and 192 one of K6's column halves holds
    # fewer than its 64 columns or none.
    *((512, 1000, True, win, hd, 8, 2)
      for hd, win in ((24, 0), (48, 128), (136, 0), (192, 128))),
    # Gemma-2B's heads over a cached prefix under a window (K6's splits
    # with dead kv rows), and hd 136 at group 8 (one split a head).
    (512, 2048, True, 256, 256, 8, 1),
    (1000, 1000, True, 0, 136, 8, 1),
)
BWD_CASES = tuple((dt, *shape) for dt in ("bfloat16", "float32")
                  for shape in _BWD_SHAPES)
# Backward kernels against their plain versions: the largest per-row
# relative L2 error (grad_rel_err) over each of lse, dq, dk and dv. On an
# H100 the sound kernels read at most 6.7e-3 (bf16) and 2.6e-6 (f32);
# kernels with a planted fault (a kv tile skipped, the q-tile range one
# tile late, one head of the group, the window floor a tile high, lse
# without log(l)) read 0.58 and more (tools/torch_kernel_faults.py).
TOL_BWD = {"bfloat16": 1.5e-2, "float32": 1e-5}


def bwd_readings(torch, fa, gen):
    """Run K1 with lse, K5 and K6 and their plain versions on every
    BWD_CASES shape, the backward of both given the plain forward's o and
    lse; yield (case, args, {name: relative error}, {name: max abs
    error}), args being (q, k, v, do, lse, dvec, causal, window)."""
    for case in BWD_CASES:
        dt, sq, skv, causal, win, D, H, KV = case

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                getattr(torch, dt))

        q, k, v = rn(1, sq, H, D), rn(1, skv, KV, D), rn(1, skv, KV, D)
        do = rn(1, sq, H, D)
        _, lse_k = fa.flash_prefill_attention(q, k, v, causal=causal,
                                              window=win, with_lse=True)
        o, lse = fa.flash_forward_lse_plain(q, k, v, causal, win)
        dvec = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, dvec, causal, win)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        ref = dict(lse=lse, dq=fa.flash_bwd_dq_plain(*args))
        ref["dk"], ref["dv"] = fa.flash_bwd_dkv_plain(*args)
        got = dict(lse=lse_k, dq=dq, dk=dk, dv=dv)
        yield (case, args,
               {n: grad_rel_err(got[n], ref[n], n in ("dk", "dv"))
                for n in got},
               {n: abs_err(got[n], ref[n]) for n in got})


def bwd_tiles(fa, case, sm_count):
    """K5's bf16 schedule at a phase-8 case (and K6's at hd <= 128; its
    capacity-256 walk has a line of its own), summed over the heads: a
    short description for the phase's line."""
    _, sq, skv, causal, win, hd, n_heads, n_kv = case
    cons = fa.k5_consumers(1, sq, n_heads, hd, sm_count)
    k5 = fa.k5_schedule(sq, skv, causal, win, cons)
    live = sum(st != "dead" for _, t in k5 for _, sts in t for st in sts)
    text = (f"; K5 {len(k5) * n_heads} CTAs of {cons} consumer(s), "
            f"{live * n_heads} live consumer tiles")
    if hd > 128:
        return text
    k6 = fa.k6_schedule(sq, skv, n_heads // n_kv, causal, win)
    stages = [len(t) for _, t in k6]
    return (text + f"; K6 {len(k6) * n_kv} CTAs, {sum(stages) * n_kv} "
            f"stages (at most {max(stages)} in a CTA), "
            f"{stages.count(0) * n_kv} dead kv tiles")


def sdpa_bwd_rounds(torch, fa, args, rounds=5, iters=10):
    """Yardstick only, never called by the port: one backward of
    PyTorch's SDPA on the same inputs, pinned to its flash backend (kv
    heads repeated outside the timed call, so its dk and dv are per q
    head), timed in turns with K5, K6 and the D = rowsum(dO * O) pass
    that FlashAttention runs before them: together those three do the
    work of that one call. Returns ({name: [ms of each round]}, backend
    that ran)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, do, lse, dvec, causal, win = args
    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.transpose(1, 2).repeat_interleave(group, dim=1).detach()
              .requires_grad_() for x in (k, v))
    dot = do.transpose(1, 2)
    backend = "flash"
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)
    except RuntimeError as e:
        backend = f"default (flash refused: {e})"
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
    o = fa.flash_prefill_attention(q, k, v, causal=causal, window=win)
    timed = {
        "sdpa": lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                            retain_graph=True),
        "dq": lambda: fa.flash_bwd_dq(*args),
        "dkv": lambda: fa.flash_bwd_dkv(*args),
        "dvec": lambda: (do.float() * o.float()).sum(-1).transpose(
            1, 2).contiguous(),
    }
    times = {name: [] for name in timed}
    for r in range(rounds):
        names = list(timed) if r % 2 == 0 else list(reversed(timed))
        for name in names:
            times[name].append(cuda_ms(torch, timed[name], iters))
    del out
    return times, backend


def phase_bwd(torch, fa, gen):
    say("== phase 8: flash backward kernels (and K1's lse) vs plain ==")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for case, args, rel, err in bwd_readings(torch, fa, gen):
        dt, sq, skv, causal, win, D, H, KV = case
        q, k, v, do, lse, dvec = args[:6]
        tol = TOL_BWD[dt]
        first = (sq, skv, causal, win, D, H, KV) == _BWD_SHAPES[0]
        iters = 10 if first else 2
        ms_dq = cuda_ms(torch, lambda: fa.flash_bwd_dq(*args), iters)
        ms_dkv = cuda_ms(torch, lambda: fa.flash_bwd_dkv(*args), iters)
        plain_dq = cuda_ms(torch, lambda: fa.flash_bwd_dq_plain(*args), 2,
                           warmup=1)
        plain_dkv = cuda_ms(torch, lambda: fa.flash_bwd_dkv_plain(*args), 2,
                            warmup=1)
        pairs = causal_pairs(sq, skv, win) if causal else sq * skv
        prod = 2.0 * H * D * pairs  # FLOP of one product over the pairs
        esize = q.element_size()
        peak = PEAK_BF16 if dt == "bfloat16" else PEAK_F32
        rows_bytes = 2 * lse.numel() * 4  # lse and D, f32
        dq_bound = bound_ms(3 * prod, (2 * q.numel() + 2 * k.numel()
                                       + do.numel()) * esize + rows_bytes,
                            peak)
        dkv_bound = bound_ms(4 * prod, (q.numel() + do.numel()
                                        + 4 * k.numel()) * esize
                             + rows_bytes, peak)
        lib_ms = lse_ms = None
        yard = ""
        if first:
            lse_ms = cuda_ms(torch, lambda: fa.flash_prefill_attention(
                q, k, v, causal=causal, window=win, with_lse=True), iters)
        if first and dt == "bfloat16":
            times, backend = sdpa_bwd_rounds(torch, fa, args)
            med = {n: statistics.median(t) for n, t in times.items()}
            spread = {n: max(t) - min(t) for n, t in times.items()}
            ms_dq, ms_dkv, lib_ms = med["dq"], med["dkv"], med["sdpa"]
            ours = [a + b + c for a, b, c in zip(
                times["dq"], times["dkv"], times["dvec"])]
            yard = ("; in turns over " + str(len(times["sdpa"]))
                    + " rounds, median (max - min): " + ", ".join(
                        f"{n} {med[n]:.4f} ({spread[n]:.4f})"
                        for n in times)
                    + f"; K5 + K6 + D {statistics.median(ours):.4f} "
                    f"({max(ours) - min(ours):.4f}) against one SDPA "
                    f"backward ({backend} backend) {lib_ms:.4f} ms: "
                    f"{statistics.median(ours) / lib_ms:.2f}x")
            rows["sdpa_rounds"] = dict(times, backend=backend)
        elif dt == "bfloat16" and D == 256 and not win and sq == skv:
            # The published hd-256 widths (Gemma-7B, Gemma-2B): K5 and K6
            # in turns with one SDPA backward (a yardstick only), medians
            # of 3 rounds; the kernels line carries them.
            times, backend = sdpa_bwd_rounds(torch, fa, args, rounds=3,
                                             iters=5)
            med = {n: statistics.median(t) for n, t in times.items()}
            ms_dq, ms_dkv, lib_ms = med["dq"], med["dkv"], med["sdpa"]
            yard = (f"; in turns over 3 rounds, median: " + ", ".join(
                f"{n} {med[n]:.4f}" for n in times)
                + f" (one SDPA backward, {backend} backend)")
            rows[f"sdpa_bwd_hd256_H{H}_KV{KV}"] = dict(
                sdpa=lib_ms, backend=backend)
            name = "gemma-7b" if KV == H else "gemma-2b"
            rows.setdefault("hd256", {})[name] = dict(
                dq=dict(err=err["dq"], ms=ms_dq, plain_ms=plain_dq,
                        bound_ms=dq_bound[0], bound_by=dq_bound[1],
                        library_ms=lib_ms),
                dkv=dict(err=max(err["dk"], err["dv"]), ms=ms_dkv,
                         plain_ms=plain_dkv, bound_ms=dkv_bound[0],
                         bound_by=dkv_bound[1], library_ms=lib_ms,
                         splits=fa.k6_splits(1, skv, KV, H // KV, D,
                                             q.dtype, sms)))
        worst = max(rel.values())
        if dt == "bfloat16" and D > 128:
            k6 = fa.k6_wide_schedule(
                sq, skv, H // KV, fa.k6_splits(1, skv, KV, H // KV, D,
                                               q.dtype, sms), causal, win)
            yard += (f"; K6 at capacity 256: {len(k6) * KV} CTAs "
                     f"({fa.k6_splits(1, skv, KV, H // KV, D, q.dtype, sms)}"
                     f" split(s) of the group), "
                     f"{sum(len(t) for _, _, t in k6) * KV} stages")
            if D == 256 and KV == 1:
                # Two launches are byte-equal (the splits are added in
                # split order).
                again = fa.flash_bwd_dkv(*args)
                first_dkv = fa.flash_bwd_dkv(*args)
                check(all(torch.equal(a.view(torch.int16),
                                      b.view(torch.int16))
                          for a, b in zip(again, first_dkv)),
                      f"K6 launches differ ({case})")
                yard += "; two launches byte-equal"
        say(f"bwd {dt} Sq={sq} Skv={skv} causal={causal} window={win} "
            f"hd={D} H={H} KV={KV}: rel err lse {rel['lse']:.3e} dq "
            f"{rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol "
            f"{tol:g}); dq kernel_ms {ms_dq:.4f} plain_ms {plain_dq:.4f} "
            f"bound_ms {dq_bound[0]:.4f} ({dq_bound[1]}); dkv kernel_ms "
            f"{ms_dkv:.4f} plain_ms {plain_dkv:.4f} bound_ms "
            f"{dkv_bound[0]:.4f} ({dkv_bound[1]})"
            + (f"; K1 with lse {lse_ms:.4f} ms" if lse_ms else "") + yard
            + (bwd_tiles(fa, case, sms) if dt == "bfloat16" else ""))
        check(worst <= tol, f"flash backward disagrees ({case}): {rel}")
        if first:
            rows[dt] = dict(
                dq=dict(err=err["dq"], ms=ms_dq, plain_ms=plain_dq,
                        bound_ms=dq_bound[0], bound_by=dq_bound[1],
                        library_ms=lib_ms),
                dkv=dict(err=max(err["dk"], err["dv"]), ms=ms_dkv,
                         plain_ms=plain_dkv, bound_ms=dkv_bound[0],
                         bound_by=dkv_bound[1], library_ms=lib_ms),
                k1_lse_ms=lse_ms, rel=rel)
        del args, q, k, v, do, lse, dvec
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 9: training at Llama-3.1-8B width
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 16   # 32 layers of bf16 params, grads and AdamW moments
                    # (64 GB) and their activations do not fit in 80 GB
TRAIN_TOKENS = 2049  # one batch: 2048 positions and their targets
TRAIN_STEPS = 4
TRAIN_LR = 1e-3
PARITY_LAYERS = 2
# Kernel vs plain leaves, relative L2 of each leaf's grad at 2 layers.
# float32 differs only in summation order (an H100 reads 7.0e-6). In
# bf16 every rounding difference of the attention kernels (at most
# 6.7e-3 per call in phase 8) flows through both layers into every
# grad: the limit is 7.5x that phase-8 reading (an H100 reads 2.0e-2).
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def train_batch(torch, np, cfg, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, TRAIN_TOKENS)),
                           dtype=torch.int32, device="cuda")


def leaf_rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def phase_train(torch, np, fa, report):
    from infinistore_tpu_torch.models import llama

    say(f"== phase 9: training at Llama-3.1-8B width, {TRAIN_LAYERS} "
        f"layers, bf16 ==")
    cfg = dataclasses.replace(llama.LLAMA31_8B, n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 9), cfg, "cuda")
    opt = llama.adamw(params, TRAIN_LR)
    leaves = llama.param_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    torch.cuda.synchronize()
    say(f"model: {n_params / 1e9:.2f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s; AdamW lr {TRAIN_LR}")
    tokens = train_batch(torch, np, cfg, SEED + 9)

    ev = {n: torch.cuda.Event(enable_timing=True)
          for n in ("f0", "f1", "o0", "o1")}

    def timed_loss(p, c, t):
        ev["f0"].record()
        value = llama.loss_fn(p, c, t)
        ev["f1"].record()
        return value

    hooks = [opt.register_step_pre_hook(lambda *_: ev["o0"].record()),
             opt.register_step_post_hook(lambda *_: ev["o1"].record())]
    steps = []
    fa.reset_launches()
    try:
        for i in range(TRAIN_STEPS):
            before = (fa.launches, fa.dq_launches, fa.dkv_launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = llama.train_step(params, opt, cfg, tokens, loss=timed_loss)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = [a - b for a, b in zip(
                (fa.launches, fa.dq_launches, fa.dkv_launches), before)]
            step = dict(loss=loss.item(), wall_ms=wall * 1e3,
                        fwd_ms=ev["f0"].elapsed_time(ev["f1"]),
                        bwd_ms=ev["f1"].elapsed_time(ev["o0"]),
                        opt_ms=ev["o0"].elapsed_time(ev["o1"]),
                        tok_s=(TRAIN_TOKENS - 1) / wall, launches=launched)
            steps.append(step)
            say(f"step {i + 1}: loss {step['loss']:.5f}; wall "
                f"{step['wall_ms']:.1f} ms ({step['tok_s']:.0f} tok/s): "
                f"forward {step['fwd_ms']:.1f} ms, backward "
                f"{step['bwd_ms']:.1f} ms, optimizer {step['opt_ms']:.1f} "
                f"ms; launches K1/K5/K6 {launched}")
            check(launched == [TRAIN_LAYERS] * 3,
                  f"step {i + 1} launched K1/K5/K6 {launched} times, not "
                  f"{TRAIN_LAYERS} each")
            check(np.isfinite(step["loss"]), f"step {i + 1}: loss "
                  f"{step['loss']}")
            if i == 0:
                missing = [j for j, t in enumerate(leaves)
                           if t.grad is None
                           or not bool(torch.isfinite(t.grad).all())]
                check(not missing, f"step 1: leaves {missing} have no "
                      "finite grad")
                wqkv = [params["layers"][li][w].grad.norm().item()
                        for li in (0, TRAIN_LAYERS - 1)
                        for w in ("wq", "wk", "wv")]
                say(f"step 1: all {len(leaves)} leaves have a finite grad; "
                    f"|grad| of wq/wk/wv in layers 0 and "
                    f"{TRAIN_LAYERS - 1}: "
                    + " ".join(f"{g:.3e}" for g in wqkv))
                check(all(g > 0 for g in wqkv), "wq/wk/wv grads are zero")
    finally:
        for h in hooks:
            h.remove()
    launches = {"flash_prefill": fa.launches, "flash_bwd_dq":
                fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"loss did not fall: {[s['loss'] for s in steps]}")
    steady = steps[1:]
    summary = {k: statistics.mean(s[k] for s in steady)
               for k in ("wall_ms", "fwd_ms", "bwd_ms", "opt_ms", "tok_s")}
    say(f"training: losses {[round(s['loss'], 5) for s in steps]}; steps "
        f"2-{TRAIN_STEPS} mean wall {summary['wall_ms']:.1f} ms "
        f"({summary['tok_s']:.0f} tok/s), forward {summary['fwd_ms']:.1f}, "
        f"backward {summary['bwd_ms']:.1f}, optimizer "
        f"{summary['opt_ms']:.1f} ms; peak allocated "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    report["train"] = dict(steps=steps, steady=summary,
                           peak_GiB=peak / 2**30, launches=launches)
    del params, opt, leaves, loss
    torch.cuda.empty_cache()

    # ---- checks outside the counted run: kernels vs plain leaves ----
    def plain_prefill(q, k, v, causal=True, window=0):
        return fa.FlashAttention.apply(q, k, v, causal, window,
                                       fa.PLAIN_LEAVES)

    parity = {}
    for dt in ("float32", "bfloat16"):
        pcfg = dataclasses.replace(llama.LLAMA31_8B, n_layers=PARITY_LAYERS,
                                   dtype=dt)
        params = llama.init_params(
            torch.Generator(device="cuda").manual_seed(SEED + 10), pcfg,
            "cuda")
        leaves = llama.trainable(params)
        tokens = train_batch(torch, np, pcfg, SEED + 10)
        loss_k = llama.loss_fn(params, pcfg, tokens)
        grads_k = torch.autograd.grad(loss_k, leaves)
        saved = llama.flash_prefill
        llama.flash_prefill = plain_prefill
        try:
            loss_p = llama.loss_fn(params, pcfg, tokens)
            grads_p = torch.autograd.grad(loss_p, leaves)
        finally:
            llama.flash_prefill = saved
        rels = [leaf_rel(a, b) for a, b in zip(grads_k, grads_p)]
        worst = max(rels)
        loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        say(f"parity {dt}, {PARITY_LAYERS} layers: loss {loss_k.item():.6f}"
            f" (kernels) vs {loss_p.item():.6f} (plain), rel "
            f"{loss_rel:.3e}; worst leaf grad rel L2 {worst:.3e} (leaf "
            f"{rels.index(worst)} of {len(rels)}, tol {TRAIN_TOL[dt]:g})")
        check(worst <= TRAIN_TOL[dt] and loss_rel <= TRAIN_TOL[dt],
              f"{dt} training grads, kernels vs plain leaves: {worst}")
        parity[dt] = dict(loss_rel=loss_rel, worst_leaf_rel=worst)
        del params, leaves, grads_k, grads_p, loss_k, loss_p
        torch.cuda.empty_cache()
    report["train"]["parity"] = parity


# ---------------------------------------------------------------------------
# phase 10: tensor parallel
# ---------------------------------------------------------------------------

TP_SLICES = (2, 8)   # (a): K2 / K4 cut into tp head slices, one process
TP_RANKS = 2         # (b)-(d): two ranks time-sharing the card over gloo
TP_PROMPTS = (2048, 1536, 1024, 512)
TP_NEW = 32
TP_NOISE_TOKENS = 1024
FSDP_LAYERS = 2
FSDP_ROWS, FSDP_TOKENS = 2, 257  # one row per dp rank
# The gloo all-reduce timed at the row-parallel outputs' shapes: a
# batch-4 decode step and a 2048-token prefill.
COLLECTIVE_SHAPES = {"decode": (4, 1, 4096), "prefill": (1, 2048, 4096)}
COLLECTIVE_CALLS = 20
# The tp engine's offloaded pages against the single-process engine's
# under the same keys, relative L2 per page (bf16). Layer 0's pages are
# byte-equal (the same columns of the same products); every later layer
# sits behind row-parallel all-reduces that regroup bf16 sums, and the
# difference grows with depth: the worst page of a sound run reads 0.047
# (layer 31) on an H100. Two faults are planted on the tp pages and read
# against the same bound, both per page, at their weakest: rank 1's half
# of the kv heads taken from the previous layer's page (a stale shard)
# and the kv heads rolled by one (heads out of order). The bound sits
# between the sound worst and the weaker fault's weakest page (PERF.md
# section 6 has both readings).
TP_PAGE_TOL = 0.1
# The tp model's own logit noise (its dense prefill against the
# single-process one) may be at most this multiple of the kernel's
# (flash against plain attention); it is checked, not added to delta.
TP_NOISE_FACTOR = 2.0


def f32_engine_modes(page):
    """The f32 engines' modes of phases 10 and 12 (ServingConfig kwargs):
    plain, speculative (an oracle proposer drafts), and 256-token chunks
    with 4-step bursts in a pool that forces preemption."""
    ample = dict(max_slots=4, max_pages_per_seq=160, total_pages=4 * 160 + 1)
    need = sum(-(-n // page) for n in F32_PROMPTS)
    return {"plain": ample, "spec": dict(ample, spec_k=4),
            "chunk": dict(max_slots=4, prefill_chunk=256, host_steps=4,
                          max_pages_per_seq=160, total_pages=need + 5)}


def tp_decode_slices(torch, pd, pq, gen, report):
    """(a) decode_attention_tp / decode_attention_quantized_tp at
    Llama-3.1-8B's heads (32 q, 8 kv, hd 128; phase 3's main-path
    batch), every tp slice in this process: each slice's K2 / K4 launch
    against the full launch and the plain version, one launch per
    slice, and each slice's kernel time beside the full launch's."""
    from infinistore_tpu_torch.ops.paged_attention import (
        paged_decode_attention)

    say("(a) TP decode: K2 and K4 on tp head slices in one process")
    tol = TOL_REL["bfloat16"]
    case = DecodeCase("main path", "bfloat16", 0, MAIN_DECODE_LENS, 32, 8,
                      128)
    qcase = ("main path", "bfloat16", MAIN_DECODE_LENS, 0, 128, 4, 8)
    out = {}
    for name, mod, wrapper, kernel, plain, args, n_pages in (
            ("paged_decode", pd, pd.decode_attention_tp,
             pd.paged_flash_decode, paged_decode_attention,
             decode_args(torch, case, gen), 2),
            ("paged_decode_q", pq, pq.decode_attention_quantized_tp,
             pq.paged_flash_decode_quantized,
             pq.paged_decode_quantized_plain,
             decode_q_args(torch, qcase, gen), 4)):
        full = kernel(*args)
        ref = plain(*args)
        full_ms = cuda_ms(torch, lambda: kernel(*args), 50)
        for tp in TP_SLICES:
            mod.reset_launches()
            got = wrapper(tp, *args)
            torch.cuda.synchronize()
            launches = mod.launches
            H, KV = args[0].shape[1], args[1].shape[2]
            hq, hk = H // tp, KV // tp
            vs_full, vs_plain, slice_ms = [], [], []
            for r in range(tp):
                rows = slice(r * hq, (r + 1) * hq)
                vs_full.append(rel_err(got[:, rows], full[:, rows]))
                vs_plain.append(rel_err(got[:, rows], ref[:, rows]))
            # The rank-local launch alone, on slice 0's own tensors.
            q0 = args[0][:, :hq].contiguous()
            pages0 = [a[:, :, :hk].contiguous() for a in args[1:1 + n_pages]]
            rest = args[1 + n_pages:]
            slice_ms = cuda_ms(torch, lambda: kernel(q0, *pages0, *rest), 50)
            say(f"  {name} tp {tp}: {launches} launches ({H // tp} q / "
                f"{hk} kv heads each); worst slice rel err vs the full "
                f"launch {max(vs_full):.3e}, vs plain {max(vs_plain):.3e} "
                f"(tol {tol:g}); one slice's launch {slice_ms:.4f} ms, the "
                f"full launch {full_ms:.4f} ms")
            check(launches == tp, f"{name} tp {tp}: {launches} launches, "
                  f"not one per slice")
            check(max(vs_full) <= tol and max(vs_plain) <= tol,
                  f"{name} tp {tp} slices disagree")
            out[f"{name}_tp{tp}"] = dict(
                launches=launches, worst_vs_full=max(vs_full),
                worst_vs_plain=max(vs_plain), slice_ms=slice_ms,
                full_ms=full_ms)
    report["decode_slices"] = out


def tp_collective_ms(torch, ctx):
    """Host ms per gloo all-reduce (TensorParallel.reduce) at the
    row-parallel outputs' decode and prefill shapes."""
    out = {}
    for name, shape in COLLECTIVE_SHAPES.items():
        x = torch.randn(shape, device="cuda").to(torch.bfloat16)
        for _ in range(3):
            ctx.reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_CALLS):
            ctx.reduce(x)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / COLLECTIVE_CALLS * 1e3
    return out


def recording_store(tcuda, conn):
    """A CudaKVStore on the card that records the keys it puts."""
    class Recording(tcuda.CudaKVStore):
        def __init__(self, conn):
            super().__init__(conn, "cuda")
            self.put_keys = []

        def put_kv_pages(self, keys, pages, sync=False):
            self.put_keys.extend(keys)
            return super().put_kv_pages(keys, pages, sync=sync)
    return Recording(conn)


def tp_page_check(torch, cfg, tp_store, one_store, common, leg,
                  same_tokens, n_requests):
    """The tp engine's offloaded pages (in ``tp_store``) against the
    single-process engine's (``one_store``) under the keys ``common``:
    layer 0 byte-equal, every layer within TP_PAGE_TOL, and the two
    planted faults (rank 1's kv heads from the previous layer's page,
    the heads rolled by one) at their weakest page beyond twice it.
    Prints and checks; returns the readings."""
    L = cfg.n_layers
    worst = collections.defaultdict(float)
    equal = collections.Counter()
    stale = rolled = float("inf")
    half = cfg.n_kv_heads // TP_RANKS

    def layer_of(key):
        return int(key.split("/L")[1].split("/")[0])

    def rel(x, y):  # relative L2 of each page of a batch
        x, y = x.float().flatten(1), y.float().flatten(1)
        return ((x - y).norm(dim=1)
                / y.norm(dim=1).clamp_min(1e-30)).tolist()

    def fetch(store, keys):
        return store.get_kv_pages(keys, cfg.kv_page_shape(), cfg.torch_dtype)

    for s in range(0, len(common), 1024):
        keys = common[s:s + 1024]
        layers = [layer_of(k) for k in keys]
        a, b = fetch(tp_store, keys), fetch(one_store, keys)
        same = (a.view(torch.int16) == b.view(torch.int16)).flatten(
            1).all(dim=1).tolist()
        for li, eq, r in zip(layers, same, rel(a, b)):
            equal[li] += bool(eq)
            worst[li] = max(worst[li], r)
        rolled = min(rolled, min(rel(a.roll(1, dims=-2), b)))
        deep = [i for i, li in enumerate(layers) if li > 0]
        if deep:
            prev = fetch(tp_store, [keys[i].replace(
                f"/L{layers[i]}/", f"/L{layers[i] - 1}/", 1) for i in deep])
            bad = a[deep].clone()
            bad[..., half:, :] = prev[..., half:, :]
            stale = min(stale, min(rel(bad, b[deep])))
        del a, b
    per_layer = len(common) // L
    say(f"{leg} offloaded pages under the same keys: {len(common)} pages "
        f"({same_tokens} of {n_requests} requests gave the single-process "
        f"tokens); byte-equal per layer {[equal[li] for li in range(L)]} of "
        f"{per_layer}; worst rel L2 layer 0 {worst[0]:.3e}, layer {L - 1} "
        f"{worst[L - 1]:.3e}, all {max(worst.values()):.3e} (tol "
        f"{TP_PAGE_TOL:g}); planted faults at their weakest page: rank 1's "
        f"heads from the previous layer {stale:.3f}, kv heads rolled by one "
        f"{rolled:.3f}")
    check(equal[0] == per_layer, f"{leg} tp layer-0 pages are not "
          f"byte-equal to the single-process engine's")
    check(max(worst.values()) <= TP_PAGE_TOL,
          f"{leg} tp pages differ from the single-process engine's")
    check(stale > 2 * TP_PAGE_TOL, f"{leg} the page check missed rank 1's "
          f"heads taken from the previous layer")
    check(rolled > 2 * TP_PAGE_TOL, f"{leg} the page check missed kv heads "
          f"out of order")
    return dict(common=len(common), byte_equal_per_layer=[
        equal[li] for li in range(L)], per_layer=per_layer,
        worst_rel_per_layer=[worst[li] for li in range(L)],
        same_token_requests=same_tokens,
        fault_rel=dict(stale_shard=stale, rolled_heads=rolled))


def tp_rank(rank, dev, store_port, f32_modes, f32_ref):
    """One rank of phase 10's legs (b)-(d); runs in a process of its own,
    the two ranks sharing the card over gloo. Returns what the parent
    checks: tokens, leg readings, launch counts, rank 0's put keys."""
    import numpy as np
    import torch

    from infinistore_tpu_torch import (ClientConfig, InfinityConnection,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch import serving
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_verify as pv
    from infinistore_tpu_torch.ops import paged_kv_write as kw
    from infinistore_tpu_torch.parallel import mesh as pmesh

    lead = rank == 0
    out = {}

    def stage(msg):
        say(f"  [rank {rank}] {msg} ({time.perf_counter() - t_rank:.1f} s)")

    t_rank = time.perf_counter()
    mesh = pmesh.make_mesh(pmesh.MeshConfig(dp=1, tp=TP_RANKS), "cuda",
                           backend="gloo")
    ctx = pmesh.TensorParallel(mesh)
    out["collective_ms"] = tp_collective_ms(torch, ctx)
    stage("collectives timed")

    # ---- (b) the tp engine at full Llama-3.1-8B width, bf16 ----
    cfg = llama.LLAMA31_8B
    L = cfg.n_layers
    rng = np.random.default_rng(SEED + 10)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in TP_PROMPTS]
    full = llama.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 10), cfg, "cuda")
    shards = pmesh.shard_params(mesh, full)
    if not lead:  # rank 0 keeps the whole tree for the noise reading
        full = None
        gc.collect()
        torch.cuda.empty_cache()
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=store_port,
        connection_type=TYPE_SHM))
    conn.connect()
    check(conn.shm_connected, "SHM path not active")

    store = recording_store(tcuda, conn)
    model = CountingModel(llama)
    stage("8B tree built, store connected")
    try:
        eng = serving.ServingEngine(
            shards, cfg, serving.ServingConfig(
                max_slots=4, max_pages_per_seq=160, total_pages=4 * 160 + 1),
            store=store, model=model, mesh=mesh)
        # The tp arithmetic's logit noise: a dense prefill through the tp
        # model against the single-process one, on a fixed sequence.
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, TP_NOISE_TOKENS)),
                               dtype=torch.int32, device="cuda")
        with torch.no_grad():
            tp_logits, _ = llama.prefill(eng.params, cfg, toks, tp=ctx)
            if lead:
                one_logits, _ = llama.prefill(full, cfg, toks)
                out["tp_logit_noise"] = (
                    tp_logits - one_logits).abs().max().item()
                del one_logits
        del tp_logits, full, shards
        gc.collect()
        torch.cuda.empty_cache()
        out["memory_GiB"] = torch.cuda.memory_allocated() / 2**30
        stage(f"engine on its shard ({out['memory_GiB']:.1f} GiB), "
              f"logit noise measured")

        fa.reset_launches()
        pd.reset_launches()
        pv.reset_launches()
        kw.reset_launches()
        model.calls.clear()
        legs = {}
        cold = run_leg(torch, eng, "tp_cold", [
            serving.Request(f"c{i}", p, max_new_tokens=TP_NEW)
            for i, p in enumerate(prompts)], legs, verbose=False)
        cold_keys = list(store.put_keys)
        stage("cold leg served")
        regen = run_leg(torch, eng, "tp_regen", [
            serving.Request(f"g{i}", p, max_new_tokens=TP_NEW)
            for i, p in enumerate(prompts)], legs, verbose=False)
        torch.cuda.synchronize()
        out.update(legs=legs, cold=cold, regen=regen, cold_keys=cold_keys,
                   prompts=prompts, calls=dict(model.calls),
                   launches={"flash_prefill": fa.launches,
                             "paged_decode": pd.launches,
                             "paged_verify": pv.launches,
                             "kv_write": kw.launches},
                   stats=dict(eng.stats), pool_heads=eng.k_pages.shape[3])
        del eng
    finally:
        store.close()
        conn.close()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) exact tokens at float32, 4 layers ----
    fcfg = dataclasses.replace(llama.LLAMA31_8B, n_layers=F32_LAYERS,
                               dtype="float32")
    fparams = llama.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 7), fcfg, "cuda")
    frng = np.random.default_rng(SEED + 7)
    fprompts = [[int(t) for t in frng.integers(0, fcfg.vocab_size, n)]
                for n in F32_PROMPTS]
    oracle = ContinuationProposer()
    for p, o in zip(fprompts, f32_ref):
        oracle.add(p, o)
    fshards = pmesh.shard_params(mesh, fparams)
    del fparams
    f32 = {}
    fa.reset_launches()
    pd.reset_launches()
    pv.reset_launches()
    kw.reset_launches()
    for name, sc in f32_modes.items():
        eng = serving.ServingEngine(fshards, fcfg,
                                    serving.ServingConfig(**sc), mesh=mesh,
                                    proposer=oracle)
        done = eng.run([serving.Request(f"f{i}", p, max_new_tokens=F32_NEW)
                        for i, p in enumerate(fprompts)])
        f32[name] = ([done[f"f{i}"] for i in range(len(fprompts))],
                     dict(eng.stats))
        del eng
    out["f32"] = f32
    stage("f32 engines served")
    out["f32_launches"] = {"flash_prefill": fa.launches,
                           "paged_decode": pd.launches,
                           "paged_verify": pv.launches,
                           "kv_write": kw.launches}
    del fshards
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) FSDP training: dp = 2 on the same two ranks ----
    dmesh = pmesh.make_mesh(pmesh.MeshConfig(dp=TP_RANKS, tp=1), "cuda",
                            backend="gloo")
    dctx = pmesh.TensorParallel(dmesh)
    tcfg = dataclasses.replace(llama.LLAMA31_8B, n_layers=FSDP_LAYERS,
                               dtype="float32")
    tfull = llama.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 12), tcfg, "cuda")
    tokens = torch.as_tensor(np.random.default_rng(SEED + 12).integers(
        0, tcfg.vocab_size, (FSDP_ROWS, FSDP_TOKENS)), dtype=torch.int32,
        device="cuda")
    sharded = pmesh.shard_params(dmesh, tfull,
                                 pmesh.fsdp_param_shardings(dmesh, tfull))
    opt = llama.adamw(sharded, TRAIN_LR)
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = llama.train_step(sharded, opt, tcfg, pmesh.local_shard(
        dmesh, tokens, pmesh.data_sharding(dmesh)), tp=dctx).item()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launched = (fa.launches, fa.dq_launches, fa.dkv_launches)
    grads = [pmesh.full_tensor(leaf.grad)
             for leaf in llama.param_leaves(sharded)]
    del opt, sharded
    gc.collect()
    fsdp = dict(loss=loss, step_ms=step_ms, launches=launched)
    if lead:
        # The single-process step's loss and grads on the whole batch.
        leaves = llama.trainable(tfull)
        ref = llama.loss_fn(tfull, tcfg, tokens)
        ref_grads = torch.autograd.grad(ref, leaves)
        rels = [leaf_rel(a, b) for a, b in zip(grads, ref_grads)]
        fsdp.update(ref_loss=ref.item(), worst_leaf_rel=max(rels),
                    worst_leaf=rels.index(max(rels)), n_leaves=len(rels))
    out["fsdp"] = fsdp
    stage("FSDP step checked")
    return out


def phase_tp(torch, np, pd, pq, gen, report):
    """Phase 10 (see the module docstring)."""
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch import serving
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops.paged_attention import prefill_attention
    from infinistore_tpu_torch.parallel.launch import run_ranks

    say("== phase 10: tensor parallel ==")
    tp_decode_slices(torch, pd, pq, gen, report)

    cfg = llama.LLAMA31_8B
    L, P = cfg.n_layers, cfg.page_size
    n_tokens = int(1.25 * 2 * (sum(TP_PROMPTS) + len(TP_PROMPTS) * TP_NEW))
    srv_tp = start_store(InfiniStoreServer, ServerConfig, cfg, n_tokens)
    srv_one = start_store(InfiniStoreServer, ServerConfig, cfg, n_tokens)
    ample = dict(max_slots=4, max_pages_per_seq=160, total_pages=4 * 160 + 1)
    f32_modes = f32_engine_modes(P)
    try:
        # (c)'s reference: the single-process f32 engine's tokens (the
        # tp ranks' speculative leg drafts them, as phase 7's does).
        fcfg = dataclasses.replace(cfg, n_layers=F32_LAYERS, dtype="float32")
        fparams = llama.init_params(
            torch.Generator(device="cuda").manual_seed(SEED + 7), fcfg,
            "cuda")
        frng = np.random.default_rng(SEED + 7)
        fprompts = [[int(t) for t in frng.integers(0, fcfg.vocab_size, n)]
                    for n in F32_PROMPTS]
        ref = serving.ServingEngine(fparams, fcfg, serving.ServingConfig(
            **ample)).run([serving.Request(f"f{i}", p, max_new_tokens=F32_NEW)
                           for i, p in enumerate(fprompts)])
        f32_ref = [ref[f"f{i}"] for i in range(len(fprompts))]
        del fparams, ref
        gc.collect()
        torch.cuda.empty_cache()

        say(f"(b)-(d): {TP_RANKS} ranks in processes of their own, "
            f"time-sharing the one card over gloo")
        t0 = time.perf_counter()
        ranks = run_ranks(tp_rank, TP_RANKS,
                          (srv_tp.service_port, f32_modes, f32_ref),
                          device="cuda", backend="gloo", timeout=900)
        say(f"ranks done in {time.perf_counter() - t0:.1f} s")
        lead = ranks[0]
        for r in ranks[1:]:
            check(r["cold"] == lead["cold"] and r["regen"] == lead["regen"],
                  "tp ranks emitted different tokens")
            check(not r["cold_keys"], "a tp rank other than 0 put pages")
        cms = lead["collective_ms"]
        say(f"(b) gloo all-reduce, host ms per call (two ranks time-sharing "
            f"one card, staged through host memory): decode "
            f"{COLLECTIVE_SHAPES['decode']} {cms['decode']:.3f} ms, prefill "
            f"{COLLECTIVE_SHAPES['prefill']} {cms['prefill']:.3f} ms")
        for name in ("tp_cold", "tp_regen"):
            leg = lead["legs"][name]
            say(f"(b) {name} (tp = 2, two ranks time-sharing one card): "
                f"{leg['requests']} requests, TTFT p50 "
                f"{leg['ttft_ms_p50']:.1f} max {leg['ttft_ms_max']:.1f} ms, "
                f"decode {leg['itl_ms_mean']:.2f} ms/step (mean "
                f"inter-token), {leg['gen_tok_s']:.1f} generated tok/s; "
                f"prefix_hit_pages {leg['prefix_hit_pages']} offloaded "
                f"{leg['offloaded_pages']}")
        check(lead["legs"]["tp_regen"]["prefix_hit_pages"] > 0,
              "the tp regenerate leg never hit")
        check(lead["stats"]["store_errors"] == 0, "tp engine store errors")
        check(lead["pool_heads"] == cfg.n_kv_heads // TP_RANKS,
              "tp pool heads")
        calls = lead["calls"]
        n_pf = calls.get("prefill", 0) + calls.get("prefill_with_prefix", 0)
        per_rank = [r["launches"] for r in ranks]
        say(f"(b) launches per rank: {per_rank} over {L} layers x "
            f"{n_pf} prefills, {calls.get('decode_step', 0)} decode steps, "
            f"{calls.get('verify_step', 0)} verify steps")
        for r in ranks:
            k = r["launches"]
            check(k["flash_prefill"] == L * n_pf and n_pf > 0,
                  "tp flash prefill launch count")
            check(k["paged_decode"] == L * calls.get("decode_step", 0)
                  and k["paged_decode"] > 0, "tp paged decode launch count")
            check(k["paged_verify"] == L * calls.get("verify_step", 0),
                  "tp paged verify launch count")
            check(k["kv_write"] == L * calls.get("decode_step", 0),
                  f"tp kv_write launch count {k['kv_write']}")

        # The single-process engine on the same cold requests, its own
        # store; then the same keys' pages from both stores.
        params = llama.init_params(
            torch.Generator(device="cuda").manual_seed(SEED + 10), cfg,
            "cuda")
        conns = {}
        for name, srv in (("tp", srv_tp), ("one", srv_one)):
            c = InfinityConnection(ClientConfig(
                host_addr="127.0.0.1", service_port=srv.service_port,
                connection_type=TYPE_SHM))
            c.connect()
            conns[name] = (c, recording_store(tcuda, c))
        try:
            one_legs = {}
            one = serving.ServingEngine(
                params, cfg, serving.ServingConfig(**ample),
                store=conns["one"][1])
            one_out = run_leg(torch, one, "one_cold", [
                serving.Request(f"c{i}", p, max_new_tokens=TP_NEW)
                for i, p in enumerate(lead["prompts"])], one_legs)
            del one
            put_one = set(conns["one"][1].put_keys)
            common = [k for k in lead["cold_keys"] if k in put_one]
            check(len(common) >= L * 2 * sum(n // P for n in TP_PROMPTS),
                  "the tp engine's prompt pages are not under the "
                  "single-process engine's keys")
            same_tokens = sum(lead["cold"][f"c{i}"] == one_out[f"c{i}"]
                              for i in range(len(TP_PROMPTS)))
            report["pages"] = tp_page_check(
                torch, cfg, conns["tp"][1], conns["one"][1], common,
                "(b)", same_tokens, len(TP_PROMPTS))
            report["one_cold"] = one_legs["one_cold"]
        finally:
            for c, st in conns.values():
                st.close()
                c.close()

        # Teacher-forced check of every tp request, by phase 6's rule;
        # the tp model's own logit noise is held to the kernel's.
        finished = [(p, lead[leg][f"{tag}{i}"])
                    for leg, tag in (("cold", "c"), ("regen", "g"))
                    for i, p in enumerate(lead["prompts"])]
        noise = logit_noise(
            torch, llama, prefill_attention, params, cfg,
            torch.tensor([finished[0][0] + finished[0][1]],
                         dtype=torch.int32, device="cuda"))
        delta = DELTA_FACTOR * noise
        tp_noise = lead["tp_logit_noise"]
        gap, exact = teacher_forced_gaps(torch, llama, params, cfg, finished)
        say(f"(b) teacher-forced check of {len(finished)} tp requests: "
            f"largest gap {gap:.4f}, exact argmax share {exact:.4f}; delta "
            f"{delta:.4f} = {DELTA_FACTOR:g} x kernel noise {noise:.4f}; "
            f"tp logit noise {tp_noise:.4f} (at most "
            f"{TP_NOISE_FACTOR:g} x the kernel noise)")
        check(gap <= delta, f"tp teacher-forced gap {gap} > delta {delta}")
        check(tp_noise <= TP_NOISE_FACTOR * noise,
              f"tp logit noise {tp_noise} > {TP_NOISE_FACTOR:g} x kernel "
              f"noise {noise}")
        report["tp_engine"] = dict(
            legs=lead["legs"], collective_ms=cms, launches=per_rank,
            teacher_forced=dict(worst_gap=gap, exact_share=exact,
                                delta=delta, kernel_noise=noise,
                                tp_noise=tp_noise),
            rank_memory_GiB=[r["memory_GiB"] for r in ranks])
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the f32 tp engines against the single-process engine.
        for name in f32_modes:
            toks, stats = lead["f32"][name]
            same = toks == f32_ref
            say(f"(c) f32 tp engine, {name}: "
                f"{'the single-process tokens' if same else 'DIFFERENT'}"
                f"; stats {json.dumps({k: v for k, v in stats.items() if v})}")
            check(all(r["f32"][name][0] == f32_ref for r in ranks),
                  f"f32 tp {name} tokens differ from the single-process "
                  f"engine's")
        check(lead["f32"]["spec"][1]["spec_accepted"] > 0,
              "f32 tp spec accepted nothing")
        check(lead["f32"]["chunk"][1]["chunk_steps"] > 0,
              "f32 tp chunk leg never chunked")
        ck = lead["f32_launches"]
        check(ck["paged_verify"] > 0, "K3 launch count in the f32 tp "
              "engines: 0")
        # Each decode step writes its KV once a layer, as K2 attends.
        for r in ranks:
            fk = r["f32_launches"]
            check(fk["kv_write"] == fk["paged_decode"] > 0,
                  f"f32 tp kv_write launches {fk['kv_write']} against K2's "
                  f"{fk['paged_decode']}")
        report["f32"] = {name: lead["f32"][name][1] for name in f32_modes}

        # (d) FSDP.
        fs = lead["fsdp"]
        fsdp_err = abs(fs["loss"] - fs["ref_loss"])
        say(f"(d) FSDP at dp = {TP_RANKS} over gloo, {FSDP_LAYERS} layers "
            f"f32: loss {fs['loss']:.6f} vs single-process "
            f"{fs['ref_loss']:.6f} (fsdp_err {fsdp_err:.1e}); worst leaf "
            f"grad rel L2 {fs['worst_leaf_rel']:.3e} (leaf "
            f"{fs['worst_leaf']} of {fs['n_leaves']}, tol "
            f"{TRAIN_TOL['float32']:g}); step {fs['step_ms']:.1f} ms; "
            f"launches K1/K5/K6 per rank "
            f"{[r['fsdp']['launches'] for r in ranks]}")
        check(fsdp_err <= TRAIN_TOL["float32"] * abs(fs["ref_loss"]),
              f"fsdp loss differs: {fsdp_err}")
        check(fs["worst_leaf_rel"] <= TRAIN_TOL["float32"],
              f"fsdp grads differ: {fs['worst_leaf_rel']}")
        for r in ranks:
            check(list(r["fsdp"]["launches"]) == [FSDP_LAYERS] * 3,
                  "fsdp step launches")
        report["fsdp"] = dict(fs, fsdp_err=fsdp_err)
        # Rank 0's launches on this phase's path, per kernel: the bf16
        # and f32 engines, the FSDP step, the K4 slices of (a).
        eng_b, eng_c = lead["launches"], lead["f32_launches"]
        k1, k5, k6 = fs["launches"]
        report["tp_launches"] = {
            "flash_prefill": eng_b["flash_prefill"]
            + eng_c["flash_prefill"] + k1,
            "paged_decode": eng_b["paged_decode"] + eng_c["paged_decode"],
            "paged_verify": eng_b["paged_verify"] + eng_c["paged_verify"],
            "kv_write": eng_b["kv_write"] + eng_c["kv_write"],
            "paged_decode_q": sum(
                v["launches"] for k, v in report["decode_slices"].items()
                if k.startswith("paged_decode_q")),
            "flash_bwd_dq": k5, "flash_bwd_dkv": k6}
    finally:
        srv_tp.stop()
        srv_one.stop()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: the parallel set
# ---------------------------------------------------------------------------

PAR_RANKS = 2  # two ranks time-sharing the card over gloo
# Each leg's size (the rank function takes them as an argument):
# (a) one sequence over sp = 2 (16384-token blocks) and a shorter one
# checked against the plain attention; (b) S = PAR_RANKS stages of
# pp_layers decoder layers, pp_micro microbatches of 1 x pp_tokens;
# (c) Mixtral-8x7B cut to ep_layers layers, ep = PAR_RANKS (4 experts a
# rank), one ep_tokens prefill and one AdamW step on ep_tokens + 1;
# (d) one pool_tokens prompt's K and V pages over every layer.
PAR_SIZES = dict(sp_tokens=32768, sp_check_tokens=4096, pp_layers=2,
                 pp_micro=4, pp_tokens=2048, ep_layers=2, ep_tokens=2048,
                 pool_tokens=2048, repeats=3)
# The tiny float32 MoE of (c)'s exact check.
PAR_TINY_MOE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=128, n_experts=4, top_k=2,
                    max_seq=256, page_size=8, dtype="float32")
PAR_TOL_GRAD = TRAIN_TOL["bfloat16"]  # pp and ep leaf grads, bf16
PAR_EP_LOSS = 1e-3                    # ep loss, bf16, relative
PAR_EP_LOSS_F32 = 1e-5                # ep loss, tiny f32, relative


def par_ms(torch, dev, fn, iters):
    """Mean ms of fn() over iters calls (after one warm call): CUDA events
    on the card; the host clock on the CPU, where the rank code is
    rehearsed."""
    fn()
    if dev.type == "cuda":
        return cuda_ms(torch, fn, iters, warmup=0)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def par_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def par_free(torch, dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def par_launches(fa):
    return [fa.launches, fa.dq_launches, fa.dkv_launches]


def par_sp(torch, dev, sizes, out):
    """(a) The ring over sp = PAR_RANKS at Llama-3.1-8B's attention."""
    import torch.distributed as dist

    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops.paged_attention import prefill_attention
    from infinistore_tpu_torch.ops.ring_attention import (make_sp_mesh,
                                                          ring_attention)
    from infinistore_tpu_torch.parallel import transport

    cfg = sizes["llama"]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mesh = make_sp_mesh(PAR_RANKS, dev.type, "gloo")
    group = mesh.get_group()
    rank, n = dist.get_rank(group), PAR_RANKS
    nxt, prv = (rank + 1) % n, (rank - 1) % n
    k1 = (fa.flash_prefill_attention if dev.type == "cuda"
          else prefill_attention)

    def qkv(s, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(1, s, h, D, generator=g, device=dev).to(dtype)
                for h in (H, KV, KV)]

    def block(t, s):
        blk = s // n
        return t[:, rank * blk:(rank + 1) * blk].contiguous()

    S = sizes["sp_tokens"]
    q, k, v = qkv(S, torch.bfloat16, SEED + 11)
    ql, kl, vl = (block(t, S) for t in (q, k, v))
    ring_attention(ql, kl, vl, mesh)  # warm: pinned buffers, the build
    par_sync(torch, dev)
    ring_ms = []
    for _ in range(sizes["repeats"]):
        fa.reset_launches()
        transport.reset_counters()
        dist.barrier(group)
        t0 = time.perf_counter()
        ring = ring_attention(ql, kl, vl, mesh)
        par_sync(torch, dev)
        ring_ms.append((time.perf_counter() - t0) * 1e3)
        launched = fa.launches
    moved = dict(transport.counters)
    # Rank 0's block is the diagonal alone, which is the first rows of
    # the same causal launch: only a rank that merges earlier blocks
    # (their non-causal lse) holds the ring to the one launch.
    one = k1(q, k, v, causal=True)
    err = rel_err(ring, block(one, S)) if rank > 0 else None
    one_ms = par_ms(torch, dev, lambda: k1(q, k, v, causal=True), 3)
    block_ms = par_ms(torch, dev, lambda: k1(ql, kl, vl, causal=False), 3)
    del one, q, k, v
    bk, bv = torch.empty_like(kl), torch.empty_like(vl)
    rotated = 2 * kl.numel() * kl.element_size()
    rot_ms = []
    for _ in range(sizes["repeats"]):
        dist.barrier(group)
        t0 = time.perf_counter()
        transport.exchange([(kl, nxt), (vl, nxt)], [(bk, prv), (bv, prv)],
                           group).wait()
        par_sync(torch, dev)
        rot_ms.append((time.perf_counter() - t0) * 1e3)
    del ring, ql, kl, vl, bk, bv
    # The ring against the plain attention over the whole sequence.
    S2 = sizes["sp_check_tokens"]
    check_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv(S2, dtype, SEED + 12)
        got = ring_attention(block(q, S2), block(k, S2), block(v, S2), mesh)
        ref = prefill_attention(q, k, v, causal=True)
        check_err[str(dtype).split(".")[-1]] = rel_err(got, block(ref, S2))
        del q, k, v, got, ref
    par_free(torch, dev)
    out["sp"] = dict(
        tokens=S, block=S // n, ring_ms=ring_ms, launches=launched,
        blocks_computed=rank + 1, err_vs_one_k1=err, one_k1_ms=one_ms,
        k1_block_ms=block_ms, rotated_bytes_per_step=rotated,
        rotation_ms=rot_ms, staged_bytes=moved["staged_bytes"],
        check_tokens=S2, check_err=check_err)


def par_pp(torch, dev, sizes, out):
    """(b) GPipe over pp = PAR_RANKS, each stage pp_layers Llama-3.1-8B
    decoder layers, against the same layers in one process."""
    import torch.distributed as dist

    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.parallel import mesh as pmesh
    from infinistore_tpu_torch.parallel import pipeline as pp
    from infinistore_tpu_torch.parallel import transport

    S, per = PAR_RANKS, sizes["pp_layers"]
    cfg = dataclasses.replace(sizes["llama"], n_layers=S * per)
    full = llama.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 12), cfg, dev)
    layers = full["layers"]
    del full
    mesh = pp.make_pp_mesh(S, dev.type, "gloo")
    group = mesh.get_group()
    rank = dist.get_rank(group)
    stacked = pp.stack_stage_params(
        [{"layers": layers[s * per:(s + 1) * per]} for s in range(S)])
    with torch.no_grad():
        stages = pmesh.tree_map(
            lambda _, t, pl: pmesh.distribute(mesh, t, pl), stacked,
            pp.stage_shardings(stacked))
    del stacked
    M, T = sizes["pp_micro"], sizes["pp_tokens"]
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    x = torch.randn(M, 1, T, cfg.d_model, generator=g,
                    device=dev).to(cfg.torch_dtype)
    w = torch.randn(M, 1, T, cfg.d_model, generator=g, device=dev)
    positions = torch.arange(T, device=dev)[None]

    def stage_fn(p, h):
        for layer in p["layers"]:
            h, _ = llama.decoder_layer(layer, h, cfg, positions)
        return h

    with torch.no_grad():
        pp.pipeline_apply(stage_fn, stages, x, mesh)  # warm
        par_sync(torch, dev)
        fa.reset_launches()
        transport.reset_counters()
        dist.barrier(group)
        t0 = time.perf_counter()
        y = pp.pipeline_apply(stage_fn, stages, x, mesh)
        par_sync(torch, dev)
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd_launches = par_launches(fa)
        moved = dict(transport.counters)
    # One backward through the schedule.
    leaves = llama.trainable(stages)
    fa.reset_launches()
    dist.barrier(group)
    t0 = time.perf_counter()
    yg = pp.pipeline_apply(stage_fn, stages, x, mesh)
    (yg.float() * w).sum().backward()
    par_sync(torch, dev)
    train_ms = (time.perf_counter() - t0) * 1e3
    train_launches = par_launches(fa)
    mine = [t.grad.to_local()[0].clone() for t in leaves]
    del yg, leaves, stages
    par_free(torch, dev)
    # A hop alone: one activation from stage 0 to stage 1.
    act = x[0]
    buf = torch.empty_like(act)
    hop_ms = []
    for _ in range(sizes["repeats"]):
        dist.barrier(group)
        t0 = time.perf_counter()
        transport.exchange([(act, 1)] if rank == 0 else [],
                           [(buf, 0)] if rank == 1 else [], group).wait()
        par_sync(torch, dev)
        hop_ms.append((time.perf_counter() - t0) * 1e3)
    # The same layers applied in turn in this process.
    ref_params = {"layers": layers}
    with torch.no_grad():
        ref = torch.stack([stage_fn(ref_params, x[m]) for m in range(M)])
    byte_equal = bool(torch.equal(y, ref))
    fwd_err = rel_err(y, ref)
    del y, ref
    ref_leaves = llama.trainable(ref_params)
    ref_y = torch.stack([stage_fn(ref_params, x[m]) for m in range(M)])
    (ref_y.float() * w).sum().backward()
    del ref_y
    own = llama.param_leaves(
        {"layers": layers[rank * per:(rank + 1) * per]})
    rels = [leaf_rel(a, b.grad) for a, b in zip(mine, own)]
    del mine, ref_leaves, layers, own
    par_free(torch, dev)
    out["pp"] = dict(
        stages=S, layers_per_stage=per, micro=M, tokens=T, fwd_ms=fwd_ms,
        fwd_train_bwd_ms=train_ms, bubble=(S - 1) / (M + S - 1),
        ticks=pp.n_ticks(S, M), hop_bytes=act.numel() * act.element_size(),
        hop_ms=hop_ms, fwd_exchanges=moved["exchanges"],
        fwd_staged_bytes=moved["staged_bytes"], byte_equal=byte_equal,
        fwd_err=fwd_err, worst_leaf_rel=max(rels), n_leaves=len(rels),
        fwd_launches=fwd_launches, train_launches=train_launches)


def par_ep(torch, dev, sizes, out):
    """(c) Expert parallelism at Mixtral-8x7B width, ep = PAR_RANKS, dp = 1,
    against the single-process model; then the tiny f32 check."""
    import numpy as np
    import torch.distributed as dist

    from infinistore_tpu_torch.models import hf, llama, moe
    from infinistore_tpu_torch.ops import flash_attention as fa

    mesh = moe.make_ep_mesh(1, PAR_RANKS, dev.type, "gloo")
    ctx = moe.ExpertParallel(mesh)
    tape, route = [], moe._route

    def taped(*a, **kw):
        r = route(*a, **kw)
        tape.append(r.expert.clone())
        return r

    moe._route = taped

    def run(cfg, params, tokens, train, ep):
        """prefill logits (timed, warm first), the routing, and the
        loss and leaf grads of one step."""
        with torch.no_grad():
            moe.prefill(params, cfg, tokens, ep=ep)
            par_sync(torch, dev)
            tape.clear()
            fa.reset_launches()
            t0 = time.perf_counter()
            logits, _ = moe.prefill(params, cfg, tokens, ep=ep)
            par_sync(torch, dev)
            ms = (time.perf_counter() - t0) * 1e3
        routing = torch.stack(tape)
        got = dict(logits=logits, routing=routing, prefill_ms=ms,
                   prefill_launches=par_launches(fa))
        leaves = llama.param_leaves(params)
        fa.reset_launches()
        if ep is None:
            llama.trainable(params)
            loss = moe.loss_fn(params, cfg, train)
            grads = torch.autograd.grad(loss, leaves)
        else:
            opt = llama.adamw(params, TRAIN_LR)
            loss = moe.train_step(params, opt, cfg, train, ep=ep)
            grads = [t.grad.to_local() for t in leaves]
            del opt
        got.update(loss=loss.item(), grads=grads,
                   step_launches=par_launches(fa))
        return got

    def shard(params):
        with torch.no_grad():
            return moe.shard_params(mesh, params)

    rank = mesh.get_local_rank("ep")
    ns = type("HFConfig", (), sizes["mixtral"])
    cfg = hf.moe_config_from_hf(ns, page_size=16, dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    full = moe.init_params(g, cfg, dev)
    rng = np.random.default_rng(SEED + 14)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, sizes["ep_tokens"] + 1)),
                             dtype=torch.int32, device=dev)
    leaf_names = [n for n, _ in _named_leaves(full)]
    one = run(cfg, full, tokens[:, :-1], tokens, None)
    keep_one = dict(logits=one["logits"], routing=one["routing"],
                    loss=one["loss"], prefill_ms=one["prefill_ms"])
    one_grads = [gr.detach() for gr in one["grads"]]
    del one
    for t in llama.param_leaves(full):
        t.requires_grad_(False)
    par_free(torch, dev)
    sharded = shard(full)
    del full
    par_free(torch, dev)
    ep_run = run(cfg, sharded, tokens[:, :-1], tokens, ctx)
    lo = rank * (cfg.n_experts // PAR_RANKS)
    hi = lo + cfg.n_experts // PAR_RANKS
    rels = []
    for name, a, b in zip(leaf_names, ep_run["grads"], one_grads):
        if name in ("e_gate", "e_up", "e_down"):
            b = b[lo:hi]
        rels.append(leaf_rel(a, b))
    expert_bytes = sum(
        t.to_local().numel() * t.to_local().element_size()
        for la in sharded["layers"] for n, t in la.items()
        if n in ("e_gate", "e_up", "e_down"))
    x = torch.randn(sizes["ep_tokens"], cfg.d_model, device=dev)
    reduce_ms = []
    for _ in range(sizes["repeats"]):
        dist.barrier(ctx.ep_group)
        t0 = time.perf_counter()
        ctx.reduce(x)
        par_sync(torch, dev)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    reading = dict(
        layers=cfg.n_layers, experts=cfg.n_experts, tokens=sizes["ep_tokens"],
        row_err=rel_err(ep_run["logits"], keep_one["logits"]),
        routing_agreement=(ep_run["routing"] == keep_one["routing"])
        .float().mean().item(),
        prefill_ms=ep_run["prefill_ms"],
        single_prefill_ms=keep_one["prefill_ms"],
        loss=ep_run["loss"], single_loss=keep_one["loss"],
        loss_rel=abs(ep_run["loss"] - keep_one["loss"])
        / abs(keep_one["loss"]),
        worst_leaf_rel=max(rels), worst_leaf=leaf_names[rels.index(
            max(rels))], n_leaves=len(rels),
        combine_allreduce_ms=reduce_ms, expert_bytes=expert_bytes,
        prefill_launches=ep_run["prefill_launches"],
        step_launches=ep_run["step_launches"])
    del sharded, ep_run, one_grads, keep_one, x
    par_free(torch, dev)
    # The same at a tiny float32 width: the loss to 1e-5, the routing
    # identical.
    tcfg = moe.MoEConfig(**PAR_TINY_MOE)
    tfull = moe.init_params(torch.Generator(device=dev).manual_seed(
        SEED + 15), tcfg, dev)
    ttok = torch.as_tensor(np.random.default_rng(SEED + 15).integers(
        0, tcfg.vocab_size, (1, 129)), dtype=torch.int32, device=dev)
    tone = run(tcfg, tfull, ttok[:, :-1], ttok, None)
    for t in llama.param_leaves(tfull):
        t.requires_grad_(False)
    tep = run(tcfg, shard(tfull), ttok[:, :-1], ttok, ctx)
    reading["f32"] = dict(
        loss=tep["loss"], single_loss=tone["loss"],
        loss_rel=abs(tep["loss"] - tone["loss"]) / abs(tone["loss"]),
        routing_equal=bool(torch.equal(tep["routing"], tone["routing"])))
    moe._route = route
    out["ep"] = reading


def _named_leaves(tree, name=None):
    """(leaf name, leaf) in ``llama.param_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, name)
    else:
        yield name, tree


def par_pool(torch, dev, sizes, store_port, out):
    """(d) The device KV pool: one prompt's pages at 8B width handed from
    rank 0 to rank 1, then the same count tiered through the store."""
    import torch.distributed as dist

    from infinistore_tpu_torch import (ClientConfig, InfinityConnection,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.parallel import transport
    from infinistore_tpu_torch.parallel.ici_handoff import (IciKVPool,
                                                            make_pool_mesh)

    cfg = sizes["llama"]
    page = cfg.kv_page_shape()
    n_pages = sizes["pool_tokens"] // cfg.page_size
    keys = [k for li in range(cfg.n_layers) for kind in ("k", "v")
            for k in llama.page_keys("pool", li, kind, n_pages)]
    N = len(keys)
    mesh = make_pool_mesh(PAR_RANKS, dev.type, "gloo")
    group = mesh.get_group()
    rank = dist.get_rank(group)
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    pages = torch.randn(N, *page, generator=g, device=dev).to(
        cfg.torch_dtype)
    nbytes = pages.numel() * pages.element_size()
    pool = IciKVPool(mesh, page, cfg.torch_dtype, slots_per_device=N)
    pool.put(keys, pages if rank == 0 else None, device=0)

    def timed(fn):
        dist.barrier(group)
        par_sync(torch, dev)
        t0 = time.perf_counter()
        r = fn()
        par_sync(torch, dev)
        return r, time.perf_counter() - t0

    transport.reset_counters()
    _, hand_s = timed(lambda: pool.handoff({k: 1 for k in keys}))
    moved = dict(transport.counters)
    rounds = pool.rounds
    got = pool.get(keys)
    hand_ok = (bool(torch.equal(got, pages))
               and pool.match_last_index(keys) == N - 1
               and all(pool.device_of(k) == 1 for k in keys))
    del got
    pool.drop(keys)
    # Tiering: the same count of pages held only in the store.
    tkeys = [f"tier/{k}" for k in keys]
    conn = InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=store_port,
        connection_type=TYPE_SHM))
    conn.connect()
    store = tcuda.CudaKVStore(conn, dev)
    try:
        if rank == 0:
            store.put_kv_pages(tkeys, pages, sync=True)
        dist.barrier(group)
        miss = pool.match_last_index(tkeys)
        fetched, fetch_s = timed(
            lambda: pool.fetch_from_store(store, tkeys, device=0))
        _, tier_hand_s = timed(lambda: pool.handoff({k: 1 for k in tkeys}))
        got = pool.get(tkeys)
        tier_ok = bool(torch.equal(got, pages))
        del got
        # Evicting what the store holds would only free the slots (first
        # writer wins): delete the store's copies so the eviction writes.
        if rank == 0:
            conn.delete_keys(tkeys)
        dist.barrier(group)
        evicted, evict_s = timed(lambda: pool.evict_to_store(store, tkeys))
        back = store.get_kv_pages(tkeys, page, cfg.torch_dtype)
        evict_ok = (bool(torch.equal(back, pages))
                    and pool.match_last_index(tkeys) == -1
                    and pool.free_slots(1) == N)
        del back
    finally:
        store.close()
        conn.close()
    del pool, pages
    par_free(torch, dev)
    out["pool"] = dict(
        pages=N, page_bytes=nbytes // N, bytes=nbytes,
        handoff_s=hand_s, handoff_GBps=nbytes / hand_s / 1e9,
        rounds=rounds, handoff_staged_bytes=moved["staged_bytes"],
        handoff_ok=hand_ok, miss=miss, fetched=fetched, fetch_s=fetch_s,
        fetch_GBps=nbytes / fetch_s / 1e9, tier_handoff_s=tier_hand_s,
        tier_ok=tier_ok, evicted=evicted, evict_s=evict_s,
        evict_GBps=nbytes / evict_s / 1e9, evict_ok=evict_ok)


def par_rank(rank, dev, store_port, sizes):
    """One rank of phase 11's legs (a)-(d), in a process of its own, the
    ranks sharing the card over gloo (every transfer staged through
    host memory). Returns the readings and launch counts the parent
    checks."""
    import torch

    from infinistore_tpu_torch.ops import paged_kv_write as kw

    out = {"rank": rank}
    t_rank = time.perf_counter()
    kw.reset_launches()
    for name, leg in (("sp", lambda: par_sp(torch, dev, sizes, out)),
                      ("pp", lambda: par_pp(torch, dev, sizes, out)),
                      ("ep", lambda: par_ep(torch, dev, sizes, out)),
                      ("pool", lambda: par_pool(torch, dev, sizes,
                                                store_port, out))):
        t0 = time.perf_counter()
        leg()
        out[name]["leg_s"] = time.perf_counter() - t0
        say(f"  [rank {rank}] {name} done "
            f"({time.perf_counter() - t_rank:.1f} s)")
    out["kv_write"] = kw.launches
    return out


def par_checks(ranks, sizes, report, on_card=True):
    """The checks of legs (a)-(d) over every rank's readings; fills
    ``report``."""
    n = len(ranks)
    for r in ranks:
        rk = r["rank"]
        sp, pp, ep, pool = r["sp"], r["pp"], r["ep"], r["pool"]
        check(rk == 0 or sp["err_vs_one_k1"] <= TOL_REL["bfloat16"],
              f"rank {rk}: ring vs one K1 {sp['err_vs_one_k1']}")
        for dt, e in sp["check_err"].items():
            check(e <= TOL_REL[dt], f"rank {rk}: ring vs plain ({dt}) {e}")
        check(sp["launches"] == sp["blocks_computed"],
              f"rank {rk}: the ring launched K1 {sp['launches']} times for "
              f"{sp['blocks_computed']} blocks")
        # No leg makes a decode step, so none writes KV rows.
        check(r["kv_write"] == 0,
              f"rank {rk}: kv_write launched {r['kv_write']} times")
        check(pp["fwd_err"] <= TOL_REL["bfloat16"],
              f"rank {rk}: pipeline output {pp['fwd_err']}")
        check(pp["worst_leaf_rel"] <= PAR_TOL_GRAD,
              f"rank {rk}: pipeline grads {pp['worst_leaf_rel']}")
        runs = sizes["pp_layers"] * sizes["pp_micro"]
        check(pp["fwd_launches"] == [runs, 0, 0],
              f"rank {rk}: pipeline forward launches {pp['fwd_launches']}")
        check(pp["train_launches"] == [runs] * 3,
              f"rank {rk}: pipeline backward launches "
              f"{pp['train_launches']}")
        L = ep["layers"]
        check(ep["row_err"] <= TOL_REL["bfloat16"],
              f"rank {rk}: ep prefill rows {ep['row_err']}")
        check(ep["loss_rel"] <= PAR_EP_LOSS, f"rank {rk}: ep loss "
              f"{ep['loss']} vs {ep['single_loss']}")
        check(ep["worst_leaf_rel"] <= PAR_TOL_GRAD,
              f"rank {rk}: ep grads {ep['worst_leaf_rel']} "
              f"({ep['worst_leaf']})")
        check(ep["prefill_launches"] == [L, 0, 0] and
              ep["step_launches"] == [L] * 3,
              f"rank {rk}: ep launches {ep['prefill_launches']} "
              f"{ep['step_launches']}")
        check(ep["f32"]["loss_rel"] <= PAR_EP_LOSS_F32
              and ep["f32"]["routing_equal"],
              f"rank {rk}: tiny f32 ep {ep['f32']}")
        check(pool["handoff_ok"] and pool["rounds"] == 1,
              f"rank {rk}: pool handoff (rounds {pool['rounds']})")
        check(pool["miss"] == -1 and pool["fetched"] == pool["pages"]
              and pool["tier_ok"] and pool["evicted"] == pool["pages"]
              and pool["evict_ok"], f"rank {rk}: pool tiering {pool}")
    lead = ranks[0]
    report.update(
        ranks=n, transport="gloo, staged through pinned host memory "
        "(two ranks time-sharing one card: not a multi-GPU reading)",
        **{leg: [r[leg] for r in ranks] for leg in ("sp", "pp", "ep",
                                                     "pool")})
    # Per rank, the launches of K1, K5 and K6 on this phase's path: the
    # ring, the pipeline's forward and training pass, the ep prefill and
    # step.
    report["launches"] = [
        [r["sp"]["launches"] + r["pp"]["fwd_launches"][0]
         + r["pp"]["train_launches"][0] + r["ep"]["prefill_launches"][0]
         + r["ep"]["step_launches"][0],
         r["pp"]["train_launches"][1] + r["ep"]["step_launches"][1],
         r["pp"]["train_launches"][2] + r["ep"]["step_launches"][2]]
        for r in ranks]
    sp, pp, ep, pool = lead["sp"], lead["pp"], lead["ep"], lead["pool"]
    say(f"(a) sp = {n}: {sp['tokens']} tokens, blocks of {sp['block']}: "
        f"ring {[round(x, 2) for x in sp['ring_ms']]} ms (rank 0), "
        f"one K1 over the whole {sp['one_k1_ms']:.3f} ms, K1 per block "
        f"{sp['k1_block_ms']:.3f} ms, {sp['rotated_bytes_per_step']} B "
        f"rotated a step in {[round(x, 2) for x in sp['rotation_ms']]} ms; "
        f"vs one K1 (rank {n - 1}, {n} blocks merged) "
        f"{ranks[-1]['sp']['err_vs_one_k1']:.2e}, vs plain at "
        f"{sp['check_tokens']} {sp['check_err']}")
    say(f"(b) pp = {n} x {pp['layers_per_stage']} layers, {pp['micro']} "
        f"microbatches of {pp['tokens']}: forward {pp['fwd_ms']:.1f} ms, "
        f"forward + backward {pp['fwd_train_bwd_ms']:.1f} ms, bubble "
        f"{pp['bubble']:.2f}, hop {pp['hop_bytes']} B in "
        f"{[round(x, 2) for x in pp['hop_ms']]} ms; byte-equal "
        f"{pp['byte_equal']} (rel {pp['fwd_err']:.2e}), worst leaf grad "
        f"{pp['worst_leaf_rel']:.2e}")
    say(f"(c) ep = {n}, {ep['layers']} Mixtral layers: prefill "
        f"{ep['prefill_ms']:.1f} ms (one process {ep['single_prefill_ms']:.1f}"
        f"), rows {ep['row_err']:.2e}, routing agreement "
        f"{ep['routing_agreement']:.4f}, loss {ep['loss']:.5f} vs "
        f"{ep['single_loss']:.5f}, worst leaf grad "
        f"{ep['worst_leaf_rel']:.2e}, combine all-reduce "
        f"{[round(x, 2) for x in ep['combine_allreduce_ms']]} ms, "
        f"{ep['expert_bytes'] / 2**30:.2f} GiB of experts a rank; "
        f"f32 {ep['f32']}")
    say(f"(d) pool: {pool['pages']} pages ({pool['bytes'] / 2**20:.0f} "
        f"MiB): handoff {pool['handoff_GBps']:.2f} GB/s in "
        f"{pool['rounds']} round, fetch {pool['fetch_GBps']:.2f} GB/s, "
        f"evict {pool['evict_GBps']:.2f} GB/s, all byte-equal")


def phase_parallel(torch, np, report):
    """Phase 11 (see the module docstring)."""
    from infinistore_tpu_torch import (InfiniStoreServer, ServerConfig,
                                       graft_entry)
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.parallel.launch import run_ranks

    say("== phase 11: the parallel set (sp, pp, ep, the device KV pool, "
        "the dry run) ==")
    cfg = llama.LLAMA31_8B
    sizes = dict(PAR_SIZES, llama=cfg,
                 mixtral=dict(MIXTRAL_8X7B,
                              num_hidden_layers=PAR_SIZES["ep_layers"]))
    srv = start_store(InfiniStoreServer, ServerConfig, cfg,
                      2 * PAR_SIZES["pool_tokens"])
    try:
        say(f"(a)-(d): {PAR_RANKS} ranks in processes of their own, "
            f"time-sharing the one card over gloo")
        t0 = time.perf_counter()
        ranks = run_ranks(par_rank, PAR_RANKS, (srv.service_port, sizes),
                          device="cuda", backend="gloo", timeout=900)
        say(f"ranks done in {time.perf_counter() - t0:.1f} s")
    finally:
        srv.stop()
    par_checks(ranks, sizes, report)
    say("(e) the dry run on the card:")
    t0 = time.perf_counter()
    r = graft_entry.dryrun_multichip(PAR_RANKS, "cuda", "gloo")
    report["dryrun"] = dict(line=r["line"], s=time.perf_counter() - t0)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: int8 and MoE on a mesh
# ---------------------------------------------------------------------------

MESH_RANKS = 2  # two ranks time-sharing the card over gloo
# (a) Llama-3.1-8B with int8 weights at tp = 2, full width and depth;
# (b) Mixtral-8x7B width at tp = 2, bf16, cut to 8 of 32 layers: the
# experts have no tp rule, so each rank holds them all (2.82 GB a layer):
# two ranks at 8 layers take ~45 GB; (c) the same width at ep = 2 (4
# experts a rank), 16 of 32 layers (phase 6c's depth, 22.5 GB a rank);
# (d) float32, 2 layers: the int8 tree at 8B width, and a Mixtral-width
# tree with d_ff cut to MESH_F32_FF so that its tp training step (params,
# grads and AdamW moments in f32) stays a few GB a rank.
MESH_TP_MOE_LAYERS = 8
MESH_EP_LAYERS = MOE_LAYERS
MESH_F32_LAYERS = 2
MESH_F32_FF = 1024
MESH_TRAIN_TOKENS = 257
MESH_FAULT_PROMPT = 3  # (b): the 512-token request, the planted fault's
MESH_SEEDS = dict(int8=SEED + 20, tp_moe=SEED + 21, ep_moe=SEED + 22,
                  f32=SEED + 23)
MESH_KERNELS = ("flash_prefill", "paged_decode", "paged_verify",
                "paged_decode_q", "flash_bwd_dq", "flash_bwd_dkv",
                "kv_write")


def mesh_prompts(np, vocab, seed, lengths=TP_PROMPTS):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def mesh_configs(hf, llama):
    """The four legs' configurations (see MESH_TP_MOE_LAYERS)."""
    _, mixtral = mixtral_config(hf)
    _, small = mixtral_config(hf, num_hidden_layers=MESH_F32_LAYERS,
                              intermediate_size=MESH_F32_FF)
    return dict(
        int8=llama.LLAMA31_8B,
        tp_moe=dataclasses.replace(mixtral, n_layers=MESH_TP_MOE_LAYERS),
        ep_moe=dataclasses.replace(mixtral, n_layers=MESH_EP_LAYERS),
        f32_int8=dataclasses.replace(llama.LLAMA31_8B,
                                     n_layers=MESH_F32_LAYERS,
                                     dtype="float32"),
        f32_moe=dataclasses.replace(small, dtype="float32"))


def mesh_sc(prompts, n_new, page):
    """A 4-slot engine with a page-table row for the longest request and
    a pool for every slot's."""
    pages = -(-(max(len(p) for p in prompts) + n_new + 8) // page)
    return dict(max_slots=4, max_pages_per_seq=pages,
                total_pages=4 * pages + 1)


def local_bytes(llama, tree):
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in llama.param_leaves(tree))


def ep_combine_ms(torch, ctx, d_model):
    """Host ms per gloo all-reduce of the ep combine (float32 [T,
    d_model]) at a batch-4 decode step's T and a 2048-token prefill's."""
    out = {}
    for name, T in (("decode", 4), ("prefill", 2048)):
        x = torch.randn(T, d_model, device="cuda")
        for _ in range(3):
            ctx.reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_CALLS):
            ctx.reduce(x)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / COLLECTIVE_CALLS * 1e3
    return out


def mesh_rank(rank, dev, ports, n_new):
    """One rank of phase 12's legs (a)-(d), in a process of its own, the
    ranks sharing the card over gloo (every collective staged through
    host memory). Only the calls on the mesh count their kernel
    launches: the single-process references that rank 0 computes for
    (d) do not. Returns what the parent checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from infinistore_tpu_torch import (ClientConfig, InfinityConnection,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch import serving
    from infinistore_tpu_torch.models import hf, llama, moe
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_decode_q as pq
    from infinistore_tpu_torch.ops import paged_flash_verify as pv
    from infinistore_tpu_torch.ops import paged_kv_write as kw
    from infinistore_tpu_torch.parallel import mesh as pmesh

    lead = rank == 0
    t_rank = time.perf_counter()
    counters = dict(zip(MESH_KERNELS, (
        (fa, "launches"), (pd, "launches"), (pv, "launches"),
        (pq, "launches"), (fa, "dq_launches"), (fa, "dkv_launches"),
        (kw, "launches"))))
    launched = collections.Counter()

    def counts():
        return {k: getattr(m, a) for k, (m, a) in counters.items()}

    def on_mesh(fn):
        """Run a call on the mesh, adding its launches to ``launched``."""
        before = counts()
        r = fn()
        torch.cuda.synchronize()
        after = counts()
        launched.update({k: after[k] - before[k] for k in after})
        return r

    def stage(msg):
        say(f"  [rank {rank}] {msg} ({time.perf_counter() - t_rank:.1f} s)")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def connect(port):
        conn = InfinityConnection(ClientConfig(
            host_addr="127.0.0.1", service_port=port,
            connection_type=TYPE_SHM))
        conn.connect()
        check(conn.shm_connected, "SHM path not active")
        return conn, recording_store(tcuda, conn)

    def from_lead(obj):
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def requests(prompts, tag, n=n_new):
        return [serving.Request(f"{tag}{i}", p, max_new_tokens=n)
                for i, p in enumerate(prompts)]

    for m in (fa, pd, pv, pq, kw):
        m.reset_launches()
    cfgs = mesh_configs(hf, llama)
    tmesh = pmesh.make_mesh(pmesh.MeshConfig(dp=1, tp=MESH_RANKS), "cuda",
                            backend="gloo")
    tctx = pmesh.TensorParallel(tmesh)
    emesh = moe.make_ep_mesh(1, MESH_RANKS, "cuda", "gloo")
    ectx = moe.ExpertParallel(emesh)
    out = {"rank": rank}

    # ---- (a) Llama-3.1-8B, int8 weights, tp = 2 ----
    cfg = cfgs["int8"]
    prompts = mesh_prompts(np, cfg.vocab_size, MESH_SEEDS["int8"])
    full = llama.init_params_quantized(gen(MESH_SEEDS["int8"]), cfg, "cuda")
    whole_bytes = llama.param_bytes(full)
    shards = pmesh.shard_params(tmesh, full)
    del full
    free()
    a = dict(weight_bytes=local_bytes(llama, shards),
             whole_bytes=whole_bytes)
    conn, store = connect(ports["a_tp"])
    model = CountingModel(llama)
    try:
        eng = serving.ServingEngine(
            shards, cfg, serving.ServingConfig(
                **mesh_sc(prompts, n_new, cfg.page_size)),
            store=store, model=model, mesh=tmesh)
        a["memory_GiB"] = torch.cuda.memory_allocated() / 2**30
        legs = {}
        a["cold"] = on_mesh(lambda: run_leg(
            torch, eng, "int8_cold", requests(prompts, "c"), legs,
            verbose=False))
        a["cold_keys"] = list(store.put_keys)
        a["hit"] = on_mesh(lambda: run_leg(
            torch, eng, "int8_hit", requests(prompts, "g"), legs,
            verbose=False))
        a.update(legs=legs, calls=dict(model.calls), stats=dict(eng.stats),
                 pool_heads=eng.k_pages.shape[3], namespace=eng._ns)
        del eng
    finally:
        store.close()
        conn.close()
    del shards
    free()
    out["a"] = a
    stage("(a) int8 tp engine served")

    # ---- (b) Mixtral width, tp = 2, bf16 ----
    cfg = cfgs["tp_moe"]
    prompts = mesh_prompts(np, cfg.vocab_size, MESH_SEEDS["tp_moe"])
    tree = moe.init_params(gen(MESH_SEEDS["tp_moe"]), cfg, "cuda",
                           place=lambda la: pmesh.shard_params(tmesh, la))
    tree.update(pmesh.shard_params(tmesh, {k: tree[k] for k in (
        "embed", "lm_head", "final_ln")}))
    free()
    b = dict(weight_bytes=local_bytes(llama, tree))
    tape, final = RoutingTape(torch, moe), {}
    model = TapedModel(moe, tape, final)
    eng = taped(serving.ServingEngine(
        tree, cfg, serving.ServingConfig(**mesh_sc(prompts, n_new,
                                                   cfg.page_size)),
        model=model, mesh=tmesh), model)
    b["memory_GiB"] = torch.cuda.memory_allocated() / 2**30
    legs = {}
    with tape, RoutingCheck(torch, moe) as rec:
        done = on_mesh(lambda: run_leg(torch, eng, "tp_moe_cold",
                                       requests(prompts, "m"), legs,
                                       verbose=False))
    b["routing_agreement"] = rec.agreement()
    b["routed_passes"] = len(rec.rows)
    del rec
    final.update(done)
    tape.commit()
    # The tp model's dense logits on a fixed sequence, its routing
    # recorded: the parent replays it in one process (the served noise).
    toks = torch.as_tensor(np.random.default_rng(MESH_SEEDS["tp_moe"] + 1)
                           .integers(0, cfg.vocab_size, (1, TP_NOISE_TOKENS)),
                           dtype=torch.int32, device="cuda")
    seq = tuple(toks[0].tolist())
    ntape = RoutingTape(torch, moe)
    with torch.no_grad(), ntape:
        nlogits, _ = ntape.run(
            lambda: [(seq, p, "noise") for p in range(len(seq))],
            lambda: moe.prefill(eng.params, cfg, toks, tp=tctx))
    ntape.commit()
    if lead:
        b.update(noise_tokens=list(seq), noise_logits=nlogits.cpu(),
                 noise_table={k: v for k, v in ntape.table.items()
                              if k[0] is not None})
    del nlogits, ntape
    b.update(legs=legs, calls=dict(model.calls), done=done,
             prompts=prompts, pool_heads=eng.k_pages.shape[3],
             table={k: v for k, v in tape.table.items()
                    if k[0] is not None} if lead else None)
    del eng, model, tape, tree
    free()
    out["b"] = b
    stage("(b) MoE tp engine served")

    # ---- (c) Mixtral width, ep = 2, bf16 ----
    cfg = cfgs["ep_moe"]
    prompts = mesh_prompts(np, cfg.vocab_size, MESH_SEEDS["ep_moe"])
    tree = moe.init_params(gen(MESH_SEEDS["ep_moe"]), cfg, "cuda",
                           place=lambda la: moe.shard_params(emesh, la))
    tree.update(moe.shard_params(emesh, {k: tree[k] for k in (
        "embed", "lm_head", "final_ln")}))
    free()
    c = dict(weight_bytes=local_bytes(llama, tree))
    conn, store = connect(ports["c_ep"])
    model = CountingModel(moe)
    try:
        eng = serving.ServingEngine(
            tree, cfg, serving.ServingConfig(
                **mesh_sc(prompts, n_new, cfg.page_size)),
            store=store, model=model, mesh=emesh)
        c["memory_GiB"] = torch.cuda.memory_allocated() / 2**30
        legs = {}
        with RoutingCheck(torch, moe) as rec:
            c["cold"] = on_mesh(lambda: run_leg(
                torch, eng, "ep_moe_cold", requests(prompts, "e"), legs,
                verbose=False))
        c["routing_agreement"] = rec.agreement()
        del rec
        c.update(legs=legs, calls=dict(model.calls),
                 put_keys=list(store.put_keys), stats=dict(eng.stats),
                 pool_heads=eng.k_pages.shape[3], namespace=eng._ns,
                 combine_ms=ep_combine_ms(torch, ectx, cfg.d_model))
        del eng
    finally:
        store.close()
        conn.close()
    del tree
    free()
    out["c"] = c
    stage("(c) MoE ep engine served")

    # ---- (d) float32, 2 layers: tokens against one process, training ----
    d = {}
    modes = f32_engine_modes(cfgs["f32_int8"].page_size)

    def engines(shards, cfg, module, mesh, ref, prompts):
        oracle = ContinuationProposer()
        for p, o in zip(prompts, ref):
            oracle.add(p, o)
        got = {}
        for name, sc in modes.items():
            eng = serving.ServingEngine(shards, cfg,
                                        serving.ServingConfig(**sc),
                                        model=module, mesh=mesh,
                                        proposer=oracle)
            done = on_mesh(lambda: eng.run(requests(prompts, "f", F32_NEW)))
            got[name] = ([done[f"f{i}"] for i in range(len(prompts))],
                         dict(eng.stats))
            del eng
        return got

    def reference(params, cfg, module, prompts):
        """The single-process engine's tokens (rank 0), on every rank."""
        ref = None
        if lead:
            done = serving.ServingEngine(
                params, cfg, serving.ServingConfig(**modes["plain"]),
                model=module).run(requests(prompts, "f", F32_NEW))
            ref = [done[f"f{i}"] for i in range(len(prompts))]
        return from_lead(ref)

    cfg = cfgs["f32_int8"]
    prompts = mesh_prompts(np, cfg.vocab_size, MESH_SEEDS["f32"],
                           F32_PROMPTS)
    q = llama.init_params_quantized(gen(MESH_SEEDS["f32"]), cfg, "cuda")
    d["int8_ref"] = reference(q, cfg, llama, prompts)
    qsh = pmesh.shard_params(tmesh, q)
    del q
    d["int8_tp"] = engines(qsh, cfg, llama, tmesh, d["int8_ref"], prompts)
    del qsh
    free()
    stage("(d) f32 int8 tp engines served")

    cfg = cfgs["f32_moe"]
    prompts = mesh_prompts(np, cfg.vocab_size, MESH_SEEDS["f32"] + 1,
                           F32_PROMPTS)
    mtree = moe.init_params(gen(MESH_SEEDS["f32"] + 1), cfg, "cuda")
    d["moe_ref"] = reference(mtree, cfg, moe, prompts)
    msh = pmesh.shard_params(tmesh, mtree)
    d["moe_tp"] = engines(msh, cfg, moe, tmesh, d["moe_ref"], prompts)
    esh = moe.shard_params(emesh, mtree)
    d["moe_ep"] = engines(esh, cfg, moe, emesh, d["moe_ref"], prompts)
    del esh
    free()
    stage("(d) f32 MoE tp and ep engines served")

    # The MoE tp training step against one process's loss and grads.
    tokens = torch.as_tensor(np.random.default_rng(MESH_SEEDS["f32"] + 2)
                             .integers(0, cfg.vocab_size,
                                       (1, MESH_TRAIN_TOKENS)),
                             dtype=torch.int32, device="cuda")
    opt = llama.adamw(msh, TRAIN_LR)
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = on_mesh(lambda: moe.train_step(msh, opt, cfg, tokens,
                                          tp=tctx).item())
    step_ms = (time.perf_counter() - t0) * 1e3
    step_launches = {k: v - before[k] for k, v in counts().items()}
    grads = [pmesh.full_tensor(leaf.grad) for leaf in llama.param_leaves(msh)]
    del opt, msh
    train = dict(loss=loss, step_ms=step_ms, launches=step_launches)
    if lead:
        leaves = llama.trainable(mtree)
        ref = moe.loss_fn(mtree, cfg, tokens)
        ref_grads = torch.autograd.grad(ref, leaves)
        names = [n for n, _ in _named_leaves(mtree)]
        rels = [leaf_rel(x, y) for x, y in zip(grads, ref_grads)]
        worst = rels.index(max(rels))
        train.update(ref_loss=ref.item(), worst_leaf_rel=rels[worst],
                     worst_leaf=names[worst], n_leaves=len(rels))
        del ref_grads
    del mtree, grads
    free()
    d["train"] = train
    out["d"] = d
    stage("(d) MoE tp training step")
    out["launches"] = dict(launched)
    return out


def phase_mesh(torch, np, report):
    """Phase 12 (see the module docstring)."""
    from infinistore_tpu_torch import (ClientConfig, InfiniStoreServer,
                                       InfinityConnection, ServerConfig,
                                       TYPE_SHM)
    from infinistore_tpu_torch import cuda as tcuda
    from infinistore_tpu_torch import serving
    from infinistore_tpu_torch.models import hf, llama, moe
    from infinistore_tpu_torch.ops.paged_attention import prefill_attention
    from infinistore_tpu_torch.parallel.launch import run_ranks

    say("== phase 12: int8 and MoE on a mesh ==")
    cfgs = mesh_configs(hf, llama)
    n_new = TP_NEW
    n_tokens = int(1.25 * 2 * (sum(TP_PROMPTS) + len(TP_PROMPTS) * n_new))
    servers, conns = {}, {}

    def connect(name):
        c = InfinityConnection(ClientConfig(
            host_addr="127.0.0.1", service_port=servers[name].service_port,
            connection_type=TYPE_SHM))
        c.connect()
        conns[name] = (c, recording_store(tcuda, c))
        return conns[name][1]

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def requests(prompts, tag):
        return [serving.Request(f"{tag}{i}", p, max_new_tokens=n_new)
                for i, p in enumerate(prompts)]

    reduced = {
        "b_layers": f"{MESH_TP_MOE_LAYERS} of 32: the replicated experts "
                    f"take 2.82 GB a layer a rank, and two ranks share "
                    f"the card's 80 GB",
        "c_layers": f"{MESH_EP_LAYERS} of 32 (phase 6c's depth): 22.5 GB a "
                    f"rank, and the single-process reference (47 GB) runs "
                    f"before the ranks",
        "d": f"{MESH_F32_LAYERS} layers in float32; the MoE tree's d_ff "
             f"14336 -> {MESH_F32_FF}: its tp training step keeps params, "
             f"grads and AdamW moments in float32 on both ranks"}
    report["reduced"] = reduced
    try:
        for name, leg in (("a_tp", "int8"), ("a_one", "int8"),
                          ("c_ep", "ep_moe"), ("c_one", "ep_moe")):
            servers[name] = start_store(InfiniStoreServer, ServerConfig,
                                        cfgs[leg], n_tokens)
        # (c)'s single-process reference first: at 16 layers its tree
        # (47 GB) cannot sit beside the two ranks' shards.
        cfg = cfgs["ep_moe"]
        c_prompts = mesh_prompts(np, cfg.vocab_size, MESH_SEEDS["ep_moe"])
        params = moe.init_params(gen(MESH_SEEDS["ep_moe"]), cfg, "cuda")
        one_store = connect("c_one")
        legs = {}
        one = serving.ServingEngine(
            params, cfg, serving.ServingConfig(
                **mesh_sc(c_prompts, n_new, cfg.page_size)),
            store=one_store, model=moe)
        c_one = run_leg(torch, one, "ep_one_cold", requests(c_prompts, "e"),
                        legs, verbose=False)
        c_one_ns = one._ns
        del one, params
        gc.collect()
        torch.cuda.empty_cache()
        report["c_single"] = legs["ep_one_cold"]

        say(f"(a)-(d): {MESH_RANKS} ranks in processes of their own, "
            f"time-sharing the one card over gloo")
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank, MESH_RANKS, (
            {k: srv.service_port for k, srv in servers.items()}, n_new),
            device="cuda", backend="gloo", timeout=900)
        say(f"ranks done in {time.perf_counter() - t0:.1f} s")
        lead = ranks[0]
        mesh_checks(ranks, cfgs, report)

        # (a) the single-process int8 engine's pages under the same keys.
        cfg = cfgs["int8"]
        a = lead["a"]
        params = llama.init_params_quantized(gen(MESH_SEEDS["int8"]), cfg,
                                             "cuda")
        one_store = connect("a_one")
        a_prompts = mesh_prompts(np, cfg.vocab_size, MESH_SEEDS["int8"])
        one = serving.ServingEngine(
            params, cfg, serving.ServingConfig(
                **mesh_sc(a_prompts, n_new, cfg.page_size)), store=one_store)
        one_out = one.run(requests(a_prompts, "c"))
        check(one._ns == a["namespace"], "the int8 tp engine's key "
              "namespace is not the single-process engine's")
        del one, params
        gc.collect()
        torch.cuda.empty_cache()
        put_one = set(one_store.put_keys)
        common = [k for k in a["cold_keys"] if k in put_one]
        check(len(common) >= cfg.n_layers * 2 * sum(
            n // cfg.page_size for n in TP_PROMPTS),
            "(a) the int8 tp engine's prompt pages are not under the "
            "single-process engine's keys")
        same = sum(a["cold"][f"c{i}"] == one_out[f"c{i}"]
                   for i in range(len(TP_PROMPTS)))
        report["a"]["pages"] = tp_page_check(
            torch, cfg, connect("a_tp"), one_store, common, "(a)", same,
            len(TP_PROMPTS))

        # (b) every served request teacher-forced as phase 6c checks it,
        # the dense pass routed as rank 0's engine routed.
        cfg = cfgs["tp_moe"]
        b = lead["b"]
        params = moe.init_params(gen(MESH_SEEDS["tp_moe"]), cfg, "cuda")
        ntape = RoutingTape(torch, moe)
        ntape.table = b["noise_table"]
        toks = torch.tensor([b["noise_tokens"]], dtype=torch.int32,
                            device="cuda")
        with torch.no_grad(), ntape:
            one, _ = PinnedPrefill(ntape, moe, "noise").prefill(params, cfg,
                                                                toks)
        tp_noise = (one - b["noise_logits"].to(one.device)).abs().max().item()
        del one, ntape
        tape = RoutingTape(torch, moe)
        tape.table = b["table"]
        rids = sorted(b["done"])
        finished = [(b["prompts"][int(r[1:])], b["done"][r]) for r in rids]
        tf = moe_teacher_forced(
            torch, serving, llama, moe, prefill_attention, params, cfg,
            finished, rids, tape, b["prompts"][MESH_FAULT_PROMPT],
            served_noise=tp_noise)
        kernel_noise = tf["pinned"]["logit_noise"]
        say(f"(b) the tp model's logit noise against one process (dense "
            f"prefill of {TP_NOISE_TOKENS} tokens, routed alike) "
            f"{tp_noise:.4f}, at most {TP_NOISE_FACTOR:g} x the kernel "
            f"noise {kernel_noise:.4f}")
        check(tp_noise <= TP_NOISE_FACTOR * kernel_noise,
              f"(b) tp logit noise {tp_noise} > {TP_NOISE_FACTOR:g} x "
              f"kernel noise {kernel_noise}")
        report["b"]["teacher_forced"] = dict(tf, tp_noise=tp_noise)
        del params, tape
        gc.collect()
        torch.cuda.empty_cache()

        # (c) tokens and every layer's pages against one process.
        c = lead["c"]
        check(c["cold"] == c_one, "(c) the ep engine's tokens differ from "
              "the single-process engine's")
        check(c["namespace"] == c_one_ns, "(c) ep key namespace")
        keys = c["put_keys"]
        one_keys = set(conns["c_one"][1].put_keys)
        check(keys and all(k in one_keys for k in keys),
              "(c) ep pages not under the single-process engine's keys")
        ep_store = connect("c_ep")
        cfg = cfgs["ep_moe"]
        unequal = 0
        for s in range(0, len(keys), 1024):
            part = keys[s:s + 1024]
            x = ep_store.get_kv_pages(part, cfg.kv_page_shape(),
                                      cfg.torch_dtype)
            y = conns["c_one"][1].get_kv_pages(part, cfg.kv_page_shape(),
                                               cfg.torch_dtype)
            unequal += int((x.view(torch.int16) != y.view(torch.int16))
                           .flatten(1).any(dim=1).sum())
            del x, y
        say(f"(c) ep offloaded {len(keys)} pages over {cfg.n_layers} "
            f"layers: {len(keys) - unequal} byte-equal to the single-process "
            f"engine's; tokens {'equal' if c['cold'] == c_one else 'DIFFER'}")
        check(unequal == 0, f"(c) {unequal} ep pages differ from the "
              f"single-process engine's")
        report["c"].update(pages=len(keys), pages_unequal=unequal)
    finally:
        for c, st in conns.values():
            st.close()
            c.close()
        for srv in servers.values():
            srv.stop()
    torch.cuda.empty_cache()


def mesh_checks(ranks, cfgs, report):
    """The checks of phase 12 that read the ranks' results alone; fills
    ``report``."""
    lead = ranks[0]
    for leg in ("a", "b", "c"):
        for r in ranks[1:]:
            if leg != "b":
                check(r[leg]["cold"] == lead[leg]["cold"],
                      f"({leg}) ranks emitted different tokens")
            else:
                check(r[leg]["done"] == lead[leg]["done"],
                      "(b) ranks emitted different tokens")
    a, b, c, d = lead["a"], lead["b"], lead["c"], lead["d"]
    check(all(not r["a"]["cold_keys"] for r in ranks[1:]),
          "(a) a tp rank other than 0 put pages")
    check(all(not r["c"]["put_keys"] for r in ranks[1:]),
          "(c) an ep rank other than 0 put pages")
    check(a["legs"]["int8_hit"]["prefix_hit_pages"] > 0,
          "(a) the int8 hit leg never hit")
    check(a["stats"]["store_errors"] == 0 and c["stats"]["store_errors"] == 0,
          "store errors on the mesh")
    check(a["pool_heads"] == cfgs["int8"].n_kv_heads // MESH_RANKS
          and b["pool_heads"] == cfgs["tp_moe"].n_kv_heads // MESH_RANKS
          and c["pool_heads"] == cfgs["ep_moe"].n_kv_heads,
          "pool heads on the mesh")
    for leg, name, key in (("a", "int8_cold", "a"), ("a", "int8_hit", "a"),
                           ("b", "tp_moe_cold", "b"),
                           ("c", "ep_moe_cold", "c")):
        x = lead[leg]["legs"][name]
        say(f"({key}) {name} (two ranks time-sharing one card, gloo staged "
            f"through host memory): {x['requests']} requests, TTFT p50 "
            f"{x['ttft_ms_p50']:.1f} max {x['ttft_ms_max']:.1f} ms, decode "
            f"{x['itl_ms_mean']:.2f} ms/step, {x['gen_tok_s']:.1f} "
            f"generated tok/s; prefix_hit_pages {x['prefix_hit_pages']} "
            f"offloaded {x['offloaded_pages']}")
    say(f"(a) int8 weights per rank {[r['a']['weight_bytes'] / 1e9 for r in ranks]}"
        f" GB (whole tree {a['whole_bytes'] / 1e9:.2f} GB); allocated per "
        f"rank {[round(r['a']['memory_GiB'], 2) for r in ranks]} GiB")
    check(all(r["a"]["weight_bytes"] < 0.55 * a["whole_bytes"]
              for r in ranks), "(a) a rank holds more than its half of the "
          "int8 weights")
    agree = [r["b"]["routing_agreement"] for r in ranks]
    say(f"(b) MoE tp: routing agreement {agree} over "
        f"{b['routed_passes']} routed passes; weights per rank "
        f"{[round(r['b']['weight_bytes'] / 1e9, 2) for r in ranks]} GB")
    check(all(x == 1.0 for x in agree), f"(b) routing agreement {agree}")
    eagree = [r["c"]["routing_agreement"] for r in ranks]
    say(f"(c) MoE ep: routing agreement {eagree}; experts a rank "
        f"{cfgs['ep_moe'].n_experts // MESH_RANKS}, weights per rank "
        f"{[round(r['c']['weight_bytes'] / 1e9, 2) for r in ranks]} GB; "
        f"combine all-reduce (f32, gloo) {c['combine_ms']} ms; single "
        f"process TTFT p50 {report['c_single']['ttft_ms_p50']:.1f} ms, "
        f"decode {report['c_single']['itl_ms_mean']:.2f} ms/step")
    check(all(x == 1.0 for x in eagree), f"(c) routing agreement {eagree}")
    for leg in ("int8_tp", "moe_tp", "moe_ep"):
        ref = d["moe_ref" if leg.startswith("moe") else "int8_ref"]
        for mode, (toks, stats) in d[leg].items():
            same = toks == ref
            say(f"(d) f32 {leg} {mode}: "
                f"{'the single-process tokens' if same else 'DIFFERENT'}; "
                f"spec {stats['spec_accepted']}/{stats['spec_proposed']}, "
                f"chunk_steps {stats['chunk_steps']}, preemptions "
                f"{stats['preemptions']}")
            check(all(r["d"][leg][mode][0] == ref for r in ranks),
                  f"(d) f32 {leg} {mode} tokens differ from one process's")
        check(d[leg]["spec"][1]["spec_accepted"] > 0
              and d[leg]["chunk"][1]["chunk_steps"] > 0,
              f"(d) {leg}: spec accepted nothing or chunk never chunked")
    tr = d["train"]
    loss_rel = abs(tr["loss"] - tr["ref_loss"]) / abs(tr["ref_loss"])
    say(f"(d) MoE tp train_step, f32: loss {tr['loss']:.6f} vs one process "
        f"{tr['ref_loss']:.6f} (rel {loss_rel:.1e}); worst leaf grad rel L2 "
        f"{tr['worst_leaf_rel']:.3e} ({tr['worst_leaf']}, {tr['n_leaves']} "
        f"leaves, tol {TRAIN_TOL['float32']:g}); step {tr['step_ms']:.1f} "
        f"ms; launches per rank {[r['d']['train']['launches'] for r in ranks]}")
    check(loss_rel <= TRAIN_TOL["float32"], f"(d) MoE tp loss {loss_rel}")
    check(tr["worst_leaf_rel"] <= TRAIN_TOL["float32"],
          f"(d) MoE tp grads {tr['worst_leaf_rel']} ({tr['worst_leaf']})")
    per_rank = [r["launches"] for r in ranks]
    say(f"launches per rank on phase 12's path: {per_rank}")
    for r, k in enumerate(per_rank):
        for name in ("flash_prefill", "paged_decode", "paged_verify",
                     "flash_bwd_dq", "flash_bwd_dkv"):
            check(k.get(name, 0) > 0, f"rank {r}: {name} never launched on "
                  f"phase 12's path")
        # Each decode step of every leg writes its KV once a layer, as K2
        # attends (only decode steps launch either).
        check(k.get("kv_write", 0) == k["paged_decode"],
              f"rank {r}: kv_write launches {k.get('kv_write', 0)} against "
              f"K2's {k['paged_decode']} on phase 12's path")
    n_layers = cfgs["f32_moe"].n_layers
    for r in ranks:
        k = r["d"]["train"]["launches"]
        check([k["flash_prefill"], k["flash_bwd_dq"], k["flash_bwd_dkv"]]
              == [n_layers] * 3, f"(d) MoE tp step launches {k}")
    report.update(
        ranks=MESH_RANKS, transport="gloo, staged through host memory (two "
        "ranks time-sharing one card: not a multi-GPU reading)",
        launches=per_rank,
        a=dict(legs=a["legs"], weight_bytes=[r["a"]["weight_bytes"]
                                             for r in ranks],
               whole_bytes=a["whole_bytes"],
               memory_GiB=[r["a"]["memory_GiB"] for r in ranks]),
        b=dict(legs=b["legs"], routing_agreement=agree,
               routed_passes=b["routed_passes"],
               weight_bytes=[r["b"]["weight_bytes"] for r in ranks],
               memory_GiB=[r["b"]["memory_GiB"] for r in ranks]),
        c=dict(legs=c["legs"], routing_agreement=eagree,
               combine_ms=[r["c"]["combine_ms"] for r in ranks],
               weight_bytes=[r["c"]["weight_bytes"] for r in ranks],
               memory_GiB=[r["c"]["memory_GiB"] for r in ranks]),
        d=dict(train={k: v for k, v in tr.items()},
               stats={leg: {m: v[1] for m, v in d[leg].items()}
                      for leg in ("int8_tp", "moe_tp", "moe_ep")}))


# ---------------------------------------------------------------------------
# phase 13: Gemma-1 on the card
# ---------------------------------------------------------------------------

# google/gemma-7b's config.json: the fields the bridge reads (its
# hidden_act "gelu" is the exact erf GELU, as both packages' bridges map
# it).
GEMMA_7B = dict(
    model_type="gemma", vocab_size=256000, hidden_size=3072,
    intermediate_size=24576, num_hidden_layers=28, num_attention_heads=16,
    num_key_value_heads=16, head_dim=256, hidden_act="gelu",
    max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
    rope_scaling=None)
# google/gemma-2b's: 2048 wide, 18 layers, 8 q heads over one kv head.
GEMMA_2B = dict(GEMMA_7B, hidden_size=2048, intermediate_size=16384,
                num_hidden_layers=18, num_attention_heads=8,
                num_key_value_heads=1)
GEMMA_TRAIN_STEPS = 2
# The kernel-vs-plain grad check runs at phase 9's PARITY_LAYERS, where
# TRAIN_TOL was set: bf16 rounding differences between the two paths
# grow with depth (the 18-layer gap is printed beside it as a reading,
# and each path's gap to an f32 reference is held by gemma_f32_gaps).
GEMMA_SEEDS = dict(serve=SEED + 13, train=SEED + 14, parity=SEED + 15)
# K1 at hd 256 (MHA and group 8), K2 and the KV write at hd 256, K5 and
# K6 at hd 256.
GEMMA_KERNELS = ("flash_prefill", "paged_decode", "flash_bwd_dq",
                 "flash_bwd_dkv", "kv_write")


def gemma_config(hf, fields, **cut):
    """A gemma config.json (``fields``, with ``cut`` applied) through the
    port's bridge, as an attribute namespace like a transformers config:
    bf16, page 16."""
    ns = type("HFConfig", (), {**fields, **cut})
    return hf.config_from_hf(ns, page_size=16, dtype="bfloat16")


def gemma_f32_gaps(torch, llama, cfg, params, tokens, plain_prefill,
                   grads_k, grads_p):
    """The bf16 kernel path's and the bf16 plain path's leaf grads
    (``grads_k``, ``grads_p``, of ``params`` at ``cfg``) against an f32
    reference: the same weights widened to f32 through the plain leaves.
    The kernels round where the plain leaves round, so the kernel path is
    held to at most DELTA_FACTOR times the plain path's worst leaf error
    (the rule the Gemma prefix hit keeps against the plain attention's
    gap). Returns the readings."""
    from infinistore_tpu_torch.parallel import mesh as pmesh

    p32 = pmesh.tree_map(lambda _, t: t.detach().float(), params)
    c32 = dataclasses.replace(cfg, dtype="float32")
    leaves32 = llama.trainable(p32)
    saved = llama.flash_prefill
    llama.flash_prefill = plain_prefill
    try:
        grads_f = torch.autograd.grad(llama.loss_fn(p32, c32, tokens),
                                      leaves32)
    finally:
        llama.flash_prefill = saved
    rel_k = [leaf_rel(a, b) for a, b in zip(grads_k, grads_f)]
    rel_p = [leaf_rel(a, b) for a, b in zip(grads_p, grads_f)]
    out = dict(kernel_vs_f32=max(rel_k), plain_vs_f32=max(rel_p),
               kernel_leaf=rel_k.index(max(rel_k)),
               plain_leaf=rel_p.index(max(rel_p)))
    say(f"gemma-2b, {cfg.n_layers} layers, leaf grads against an f32 "
        f"plain reference: bf16 kernels worst rel L2 "
        f"{out['kernel_vs_f32']:.3e} (leaf {out['kernel_leaf']}), bf16 "
        f"plain leaves {out['plain_vs_f32']:.3e} (leaf {out['plain_leaf']})"
        f"; kernels / plain {out['kernel_vs_f32'] / out['plain_vs_f32']:.3f}"
        f" (at most {DELTA_FACTOR:g})")
    check(out["kernel_vs_f32"] <= DELTA_FACTOR * out["plain_vs_f32"],
          f"gemma-2b grads at {cfg.n_layers} layers: the kernels sit "
          f"further from f32 than {DELTA_FACTOR:g}x the plain leaves "
          f"({out})")
    del p32, leaves32, grads_f
    return out


def phase_gemma(torch, np, report):
    from infinistore_tpu_torch.models import hf, llama
    from infinistore_tpu_torch.ops import flash_attention as fa

    say("== phase 13: Gemma-1 on the card: google/gemma-7b serving, "
        "google/gemma-2b training ==")
    reduced = {}

    # -- (a) phase 4's main path at google/gemma-7b's widths --
    cfg = gemma_config(hf, GEMMA_7B)
    check(cfg.head_dim == 256 and cfg.norm_plus_one and cfg.act ==
          "gelu_exact", f"gemma-7b config: {cfg}")
    t0 = time.perf_counter()
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(GEMMA_SEEDS["serve"]),
        cfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in llama.param_leaves(params))
    say(f"gemma-7b: {n_params / 1e9:.2f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
        f"act {cfg.act}")
    serve = {}
    # Gemma's bf16 products round differently at the suffix's 256 rows
    # and the whole prompt's 2304, and its random model carries that to
    # the logits: the hit is held to the plain attention's own gap.
    phase_main(torch, np, serve, params, cfg, llama, hit_vs_plain=True)
    serve_launches = serve.pop("launches")
    serve_k2 = serve.pop("k2")
    serve.update(params_B=n_params / 1e9, layers=cfg.n_layers,
                 k2_hd256=serve_k2)
    report["serve"] = serve
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) training at google/gemma-2b's widths, all 18 layers --
    tcfg = gemma_config(hf, GEMMA_2B)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(GEMMA_SEEDS["train"]),
        tcfg, "cuda")
    opt = llama.adamw(params, TRAIN_LR)
    leaves = llama.param_leaves(params)
    torch.cuda.synchronize()
    say(f"gemma-2b: {sum(t.numel() for t in leaves) / 1e9:.2f} B params "
        f"bf16 in {time.perf_counter() - t0:.1f} s; {tcfg.n_layers} "
        f"layers, {tcfg.n_heads} / {tcfg.n_kv_heads} heads (group "
        f"{tcfg.n_heads // tcfg.n_kv_heads}), head_dim {tcfg.head_dim}; "
        f"AdamW lr {TRAIN_LR}")
    tokens = train_batch(torch, np, tcfg, GEMMA_SEEDS["train"])
    fa.reset_launches()
    steps = []
    for i in range(GEMMA_TRAIN_STEPS):
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = llama.train_step(params, opt, tcfg, tokens).item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = [a - b for a, b in zip(
            (fa.launches, fa.dq_launches, fa.dkv_launches), before)]
        steps.append(dict(loss=loss, wall_ms=wall * 1e3, launches=launched))
        say(f"gemma-2b step {i + 1}: loss {loss:.5f}; wall "
            f"{wall * 1e3:.1f} ms ({(TRAIN_TOKENS - 1) / wall:.0f} tok/s); "
            f"launches K1/K5/K6 {launched}")
        check(np.isfinite(loss), f"gemma-2b step {i + 1}: loss {loss}")
        check(launched == [tcfg.n_layers] * 3,
              f"gemma-2b step {i + 1} launched K1/K5/K6 {launched} times, "
              f"not {tcfg.n_layers} each")
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"gemma-2b loss did not fall: {[s['loss'] for s in steps]}")
    train_launches = {"flash_prefill": fa.launches,
                      "flash_bwd_dq": fa.dq_launches,
                      "flash_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, opt, leaves, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # -- checks outside the counted run: the kernels against the same
    # Function on its plain leaves, the loss and every leaf's grad on
    # fresh weights, checked at PARITY_LAYERS and read at all 18 --
    def plain_prefill(q, k, v, causal=True, window=0):
        return fa.FlashAttention.apply(q, k, v, causal, window,
                                       fa.PLAIN_LEAVES)

    parity = {}
    for layers in (tcfg.n_layers, PARITY_LAYERS):
        pcfg = dataclasses.replace(tcfg, n_layers=layers)
        params = llama.init_params(
            torch.Generator(device="cuda").manual_seed(
                GEMMA_SEEDS["parity"]), pcfg, "cuda")
        leaves = llama.trainable(params)
        tokens = train_batch(torch, np, pcfg, GEMMA_SEEDS["parity"])
        loss_k = llama.loss_fn(params, pcfg, tokens)
        grads_k = torch.autograd.grad(loss_k, leaves)
        saved = llama.flash_prefill
        llama.flash_prefill = plain_prefill
        try:
            loss_p = llama.loss_fn(params, pcfg, tokens)
            grads_p = torch.autograd.grad(loss_p, leaves)
        finally:
            llama.flash_prefill = saved
        rels = [leaf_rel(a, b) for a, b in zip(grads_k, grads_p)]
        worst = max(rels)
        loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        tol = TRAIN_TOL["bfloat16"]
        checked = layers == PARITY_LAYERS
        say(f"gemma-2b parity, {layers} layers, bf16: loss "
            f"{loss_k.item():.6f} (kernels) vs {loss_p.item():.6f} (plain), "
            f"rel {loss_rel:.3e}; worst leaf grad rel L2 {worst:.3e} (leaf "
            f"{rels.index(worst)} of {len(rels)}"
            + (f", tol {tol:g})" if checked else ", a reading)"))
        if checked:
            check(worst <= tol and loss_rel <= tol,
                  f"gemma-2b grads, kernels vs plain leaves: {worst}")
        parity[layers] = dict(loss_rel=loss_rel, worst_leaf_rel=worst)
        if not checked:
            parity[layers].update(gemma_f32_gaps(
                torch, llama, pcfg, params, tokens, plain_prefill, grads_k,
                grads_p))
        del params, leaves, grads_k, grads_p, loss_k, loss_p
        gc.collect()
        torch.cuda.empty_cache()
    reduced["parity_layers"] = (
        f"{PARITY_LAYERS} of {tcfg.n_layers} checked against TRAIN_TOL "
        f"(phase 9's depth, where it was set); all {tcfg.n_layers} read, "
        f"and held against an f32 reference")
    report["train"] = dict(steps=steps, peak_GiB=peak, parity=parity)

    launches = dict.fromkeys(GEMMA_KERNELS, 0)
    launches["flash_prefill"] = (serve_launches["flash_prefill"]
                                 + train_launches["flash_prefill"])
    launches["paged_decode"] = serve_launches["paged_decode"]
    launches["kv_write"] = serve_launches["kv_write"]
    launches["flash_bwd_dq"] = train_launches["flash_bwd_dq"]
    launches["flash_bwd_dkv"] = train_launches["flash_bwd_dkv"]
    say(f"launches on phase 13's path, all at hd 256: {launches} (serving "
        f"{serve_launches}, training {train_launches})")
    for name in GEMMA_KERNELS:
        check(launches[name] > 0, f"{name} never launched on phase 13's "
              "path")
    report.update(launches=launches, reduced=reduced)


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
    from infinistore_tpu_torch.models import llama
    from infinistore_tpu_torch.ops import _kernels
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_decode_q as pq
    from infinistore_tpu_torch.ops import paged_flash_verify as pv
    from infinistore_tpu_torch.ops import paged_kv_write as kvw_mod
    from infinistore_tpu_torch.ops.paged_attention import (
        multi_token_paged_attention, paged_decode_attention,
        prefill_attention)

    t_start = time.perf_counter()
    card = card_line()
    say(f"== phase 1: device and build ==\ncard: {card}")
    disable_tf32()
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        say(f"-- {name}: {phase_s[name]:.1f} s")
        return out

    try:
        timed("build", build_all, _native, _kernels)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        k1 = timed("flash", phase_flash, torch, fa, prefill_attention, gen)
        timed("decode", phase_decode, torch, pd, paged_decode_attention,
              gen)
        k4 = timed("decode int8", phase_decode_q, torch, pq, pd, gen)
        kvw = timed("kv write", phase_kv_write, torch, kvw_mod)
        t0 = time.perf_counter()
        params = llama.init_params(
            torch.Generator(device="cuda").manual_seed(SEED),
            llama.LLAMA31_8B, "cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in
                       [params["embed"], params["lm_head"],
                        params["final_ln"]]
                       + [w for la in params["layers"] for w in la.values()])
        say(f"model: {n_params / 1e9:.2f} B params bf16 in "
            f"{time.perf_counter() - t0:.1f} s")
        report = {}
        timed("main path", phase_main, torch, np, report, params)
        k3 = timed("verify", phase_verify, torch, pv,
                   multi_token_paged_attention, gen)
        serve_report = {}
        timed("serving", phase_serving, torch, np, params, serve_report)
        shard_report = {}
        timed("sharded", phase_sharded, torch, np, params, report,
              shard_report)
        int8_report = {}
        k4_launches = timed("int8", phase_int8, torch, np, params,
                            int8_report)
        del params
        torch.cuda.empty_cache()
        moe_report = {}
        timed("moe", phase_moe, torch, np, moe_report)
        # The engines and their taped models hold the 16-layer tree in
        # reference cycles: collect them before the next tree.
        gc.collect()
        torch.cuda.empty_cache()
        timed("moe training", phase_moe_train, torch, np, moe_report)
        timed("f32 parity", phase_f32, torch, np, serve_report)
        bwd = timed("backward", phase_bwd, torch, fa, gen)
        train_report = {}
        timed("training", phase_train, torch, np, fa, train_report)
        tp_report = {}
        timed("tensor parallel", phase_tp, torch, np, pd, pq, gen,
              tp_report)
        par_report = {}
        timed("parallel set", phase_parallel, torch, np, par_report)
        mesh_report = {}
        timed("int8 and MoE on a mesh", phase_mesh, torch, np, mesh_report)
        gemma_report = {}
        timed("gemma", phase_gemma, torch, np, gemma_report)
    except SmokeError as e:
        say(f"FAIL: {e}")
        return 1
    k2 = report["k2"]
    k3 = k3[("spec", "bfloat16")]
    kernels = [
        {"name": "flash_prefill", "route": "cuda",
         "source": "infinistore_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "infinistore_tpu/ops/pallas_flash_attention.py:44",
         "launches": report["launches"]["flash_prefill"],
         "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "hd256": k1["hd256"]},
        {"name": "paged_decode", "route": "cuda",
         "source": "infinistore_tpu_torch/csrc/paged_split.cu",
         "replaces": "infinistore_tpu/ops/pallas_paged_attention.py:34",
         "launches": report["launches"]["paged_decode"],
         "max_abs_err": k2["err"], "ms": k2["ms"],
         "graph_ms": k2["graph_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "paged_verify", "route": "cuda",
         "source": "infinistore_tpu_torch/csrc/paged_split.cu",
         "replaces": "infinistore_tpu/ops/pallas_paged_attention.py:364",
         "launches": serve_report["launches"]["paged_verify"],
         "max_abs_err": k3["err"], "ms": k3["ms"],
         "graph_ms": k3["graph_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
    ]
    k4 = k4["main path"]
    kernels.append({
        "name": "paged_decode_q", "route": "cuda",
        "source": "infinistore_tpu_torch/csrc/paged_split_q.cu",
        "replaces": "infinistore_tpu/ops/pallas_paged_attention.py:69",
        "launches": k4_launches, "max_abs_err": k4["err"], "ms": k4["ms"],
        "graph_ms": k4["graph_ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": None})
    train_launches = train_report["train"]["launches"]
    for name, key, src, line in (
            ("flash_bwd_dq", "dq", "flash_bwd_dq.cu", 403),
            ("flash_bwd_dkv", "dkv", "flash_bwd_dkv.cu", 448)):
        row = bwd["bfloat16"][key]
        # library_ms: one SDPA backward, which does the work of both.
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"infinistore_tpu_torch/csrc/{src}",
            "replaces": f"infinistore_tpu/ops/pallas_flash_attention.py:"
                        f"{line}",
            "launches": train_launches[name], "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            # Phase 8's Gemma-7B and Gemma-2B widths (library_ms: one
            # SDPA backward).
            "hd256": {w: r[key] for w, r in bwd["hd256"].items()}})
    # The decode step's KV write replaces no TPU kernel (the JAX package
    # writes with XLA's scatter); its launches are phase 6's.
    kernels.append({
        "name": "kv_write", "route": "cuda",
        "source": "infinistore_tpu_torch/csrc/kv_write.cu",
        "replaces": "infinistore_tpu/ops/paged_attention.py:26 (XLA "
                    "scatter, mode=drop)",
        "launches": serve_report["launches"]["kv_write"],
        "max_abs_err": kvw["err"], "ms": kvw["ms"],
        "graph_ms": kvw["graph_ms"], "plain_ms": kvw["plain_ms"],
        "bound_ms": kvw["bound_ms"], "bound_by": kvw["bound_by"],
        "library_ms": None, "rows": kvw["rows"]})
    par_counts = dict(zip(("flash_prefill", "flash_bwd_dq",
                           "flash_bwd_dkv"),
                          zip(*par_report["launches"])))
    for row in kernels:
        row["tp_launches"] = tp_report["tp_launches"][row["name"]]
        # Per rank, on phase 11's path (K2-K4 and the KV write are not
        # on it).
        row["parallel_launches"] = list(par_counts.get(
            row["name"], [0] * PAR_RANKS))
        # Per rank, on phase 12's path (K4 is not on it).
        row["mesh_launches"] = [r.get(row["name"], 0)
                                for r in mesh_report["launches"]]
        # On phase 13's path, every launch at hd 256 (K3 and K4 are not
        # on it).
        row["gemma_launches"] = gemma_report["launches"].get(row["name"],
                                                             0)
    main_path = {k: v for k, v in report.items()
                 if k not in ("k2", "launches")}
    say("main path: " + json.dumps(main_path))
    say("serving: " + json.dumps(serve_report))
    say("sharded: " + json.dumps(shard_report))
    say("int8: " + json.dumps(int8_report))
    say("moe: " + json.dumps(moe_report))
    say("training: " + json.dumps(train_report))
    say("tensor parallel: " + json.dumps(tp_report))
    say("parallel set: " + json.dumps(par_report))
    say("mesh: " + json.dumps(mesh_report))
    say("gemma: " + json.dumps(gemma_report))
    say("backward at the training shape: " + json.dumps(
        {dt: ({"k1_lse_ms": r["k1_lse_ms"], "rel": r["rel"]}
              if dt in ("bfloat16", "float32") else r)
         for dt, r in bwd.items()}))
    say("phase seconds: " + json.dumps(phase_s))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
