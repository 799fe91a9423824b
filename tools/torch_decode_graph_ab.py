#!/usr/bin/env python3
"""The decode step replayed as one CUDA graph (``llama.DecodeGraph``)
against the eager step, on the card.

    python3 tools/torch_decode_graph_ab.py
        [--workload mistral-7b-v0.1.batch-unique] [--seed 1]
        [--batch 32] [--steps 200] [--timing-steps 50] [--out FILE]

At the cell's configuration (its published widths, weights drawn from
``--seed``), in four parts, each printed as it ends and, with ``--out``,
all written to that file as JSON:

1. ``kv_write``: the fixed-shape KV write kernel (``ops.paged_kv_write``)
   against its plain version at the cell's row width, byte for byte:
   rows past the table, idle rows on scratch page 0, the pool's last
   page, table ids outside the pool, at batch 1 and ``--batch``.
2. ``equal``: ``--batch`` sequences of mixed lengths (256-3072, over
   random KV) decode ``--steps`` greedy steps twice, eagerly and through
   a graph, each over its own copy of the pools: the logits must be
   bit-equal at every step, hence the tokens, and the pools equal at the
   end. Where they are not, ``diagnose`` names the first layer whose
   written k or v row differs (or the final norm and logits).
3. ``timing``: engine steps (``serving._decode_fused``, then the tokens'
   copy to the host, as the engine's loop) in turns eager, graph, graph,
   eager, ``--timing-steps`` each: CUDA events over each turn, and the
   host's dispatch and wait per step; ``graph_device_ms``: graph steps
   queued back to back with the tokens kept on the card (the card's own
   step time); ``graph_host_us``: the host's time for each part of a
   replayed call (key check, input copies, replay, argmax and advance).
4. ``profiler``: after the graph was captured, as in a traced benchmark
   run (``harness.trace``: warm, then profile), three replayed steps: the
   kernels inside the replays must reach the profiler under their own
   names (``paged_split`` for K2, ``kv_write``), and the launch counters
   must count each replay as its capture's launches. The same three
   steps then run eagerly under the profiler: device ms a step by kind
   (K2, the GEMMs, the rest), replayed against eager.

Exits 1 if any check fails.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "perfbench"), REPO]

import torch  # noqa: E402

from harness import catalog, trace  # noqa: E402
from harness.model import geometry, make_weights, program_config  # noqa
from infinistore_tpu_torch import serving  # noqa: E402
from infinistore_tpu_torch.ops import paged_flash_decode as pd  # noqa
from infinistore_tpu_torch.ops import paged_kv_write  # noqa: E402

FAILED = []


def check(ok, what):
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILED.append(what)


def sync():
    torch.cuda.synchronize()


def kv_write_cases(cfg, batch, device):
    """The kernel against kv_write_plain, byte for byte."""
    n_pages, page, width = 40, cfg.page_size, 4
    out = {}
    for b in (1, batch):
        for name in ("past_table", "inactive", "last_page",
                     "ids_outside_pool", "mixed"):
            gen = torch.Generator().manual_seed(len(out))
            table = torch.randint(1, n_pages, (b, width), generator=gen)
            lens = torch.randint(0, width * page, (b,), generator=gen)
            if name == "past_table":
                lens[::2] = width * page + torch.arange(0, b, 2)
            elif name == "inactive":
                table[1::2], lens[1::2] = 0, 0
            elif name == "last_page":
                table[:, -1], lens[:] = n_pages - 1, width * page - 1
            elif name == "ids_outside_pool":
                table[0::3], table[1::3] = -1, n_pages
                table[2::3] = -n_pages - 1
            idx = lens // page
            target = table.gather(1, idx.clamp(max=width - 1)[:, None])[:, 0]
            target = torch.where(idx < width, target, n_pages)
            slot = lens % page
            shape = (n_pages, page, cfg.n_kv_heads, cfg.head_dim)
            pools = [torch.randn(shape, generator=gen).to(cfg.torch_dtype)
                     for _ in range(2)]
            rows = [torch.randn(b, 1, *shape[2:], generator=gen).to(
                cfg.torch_dtype) for _ in range(2)]
            want = [p.clone() for p in pools]
            paged_kv_write.kv_write_plain(*want, *rows, target, slot)
            got = [p.to(device) for p in pools]
            before = paged_kv_write.launches
            paged_kv_write.write_kv_rows(
                *got, *(r.to(device) for r in rows), target.to(device),
                slot.to(device))
            sync()
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            label = f"{name}, batch {b}"
            out[label] = same
            check(same and paged_kv_write.launches == before + 1,
                  f"kv_write kernel = plain version ({label})")
    return out


def mixed_state(cfg, batch, seed, extra, device):
    """Tokens, lengths, a page table and random pools for ``batch``
    sequences of 256-3072 tokens with room for ``extra`` more each."""
    gen = torch.Generator().manual_seed(seed)
    page = cfg.page_size
    lens = torch.randint(256, 3073, (batch,), generator=gen)
    need = [-(-(int(n) + extra + 1) // page) for n in lens]
    width = max(need)
    table = torch.zeros(batch, width, dtype=torch.int32)
    nxt = 1  # page 0 is the engine's scratch page
    for i, n in enumerate(need):
        table[i, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    shape = (cfg.n_layers, nxt, page, cfg.n_kv_heads, cfg.head_dim)
    dgen = torch.Generator(device=device).manual_seed(seed)
    k = torch.empty(shape, dtype=cfg.torch_dtype, device=device)
    v = torch.empty_like(k)
    k.normal_(generator=dgen)
    v.normal_(generator=dgen)
    token = torch.randint(0, cfg.vocab_size, (batch,), generator=gen)
    return (token.to(torch.int32).to(device), lens.to(torch.int32).to(device),
            table.to(device), k, v)


def diagnose(model, params, cfg, graph, token, lens, table, pools_e,
             pools_g):
    """One step from the eager side's state, eagerly and through the
    graph (its pools overwritten with the eager side's first): the first
    layer whose written k or v row differs, or the head."""
    pools_g[0].copy_(pools_e[0])
    pools_g[1].copy_(pools_e[1])
    le, _, _ = model.decode_step(params, cfg, token, lens, *pools_e, table)
    lg, _, _ = model.decode_step(params, cfg, token, lens, *pools_g, table,
                                 graph=graph)
    sync()
    for li in range(cfg.n_layers):
        for kind in (0, 1):
            if not torch.equal(pools_e[kind][li], pools_g[kind][li]):
                where = ("the embedding, layer 0's norm or its k/v "
                         "projection or RoPE" if li == 0 else
                         f"layer {li - 1}'s attention (K2), output "
                         f"projection or MLP, or layer {li}'s norm, k/v "
                         "projection or RoPE")
                return {"layer": li, "kind": "kv"[kind], "op": where}
    if not torch.equal(le, lg):
        return {"layer": None, "op": "the last layer's attention, output "
                "projection or MLP, the final norm or the logits GEMM",
                "max_abs": (le - lg).abs().max().item()}
    return {"op": None}


def equal_run(model, params, cfg, batch, seed, steps, device):
    token, lens, table, k, v = mixed_state(cfg, batch, seed, steps, device)
    pools_e = (k, v)
    pools_g = (k.clone(), v.clone())
    graph = model.DecodeGraph()
    tok_e = tok_g = token
    first_diff, token_diffs, worst = None, 0, 0.0
    for step in range(steps):
        le, _, _ = model.decode_step(params, cfg, tok_e, lens, *pools_e,
                                     table)
        lg, _, _ = model.decode_step(params, cfg, tok_g, lens, *pools_g,
                                     table, graph=graph)
        if not torch.equal(le, lg):
            first_diff = step if first_diff is None else first_diff
            worst = max(worst, (le - lg).abs().max().item())
        tok_e = torch.argmax(le, dim=-1).to(torch.int32)
        tok_g = torch.argmax(lg, dim=-1).to(torch.int32)
        token_diffs += int((tok_e != tok_g).sum())
        lens = lens + 1
    sync()
    pools_same = all(torch.equal(a, b) for a, b in zip(pools_e, pools_g))
    out = {"batch": batch, "steps": steps,
           "lens": [int(x) for x in (lens - steps).tolist()],
           "logits_bit_equal_steps": steps if first_diff is None
           else first_diff, "first_differing_step": first_diff,
           "max_abs_logit_diff": worst, "token_diffs": token_diffs,
           "pools_equal": pools_same, "counters": dict(graph.counters)}
    check(first_diff is None, f"logits bit-equal, graph vs eager, over "
          f"{steps} steps at batch {batch}")
    check(token_diffs == 0, "tokens equal, graph vs eager")
    check(pools_same, "pools equal after the run, graph vs eager")
    check(graph.counters == {"decode_graph_captures": 1,
                             "decode_graph_replays": steps},
          f"one capture, {steps} replays: {graph.counters}")
    if first_diff is not None or not pools_same:
        out["diagnose"] = diagnose(model, params, cfg, graph, tok_e, lens,
                                   table, pools_e, pools_g)
    del pools_e, pools_g
    return out


def timing_run(model, params, cfg, batch, seed, steps, device):
    """Engine steps in turns eager, graph, graph, eager."""
    token, lens, table, k, v = mixed_state(cfg, batch, seed + 1, 4 * steps
                                           + 64, device)
    graph = model.DecodeGraph()
    kw = {"graph": graph}
    serving._decode_fused(params, cfg, token, lens, k, v, table, model=model,
                          **kw)  # capture outside the turns
    serving._decode_fused(params, cfg, token, lens, k, v, table, model=model)
    sync()
    turns = []
    for mode in ("eager", "graph", "graph", "eager"):
        mkw = kw if mode == "graph" else {}
        dispatch, wait = [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            t1 = time.perf_counter()
            _, nxt, lens = serving._decode_fused(
                params, cfg, token, lens, k, v, table, model=model, **mkw)
            t2 = time.perf_counter()
            nxt.cpu()  # the engine's wait for the step's tokens
            t3 = time.perf_counter()
            dispatch.append(1e3 * (t2 - t1))
            wait.append(1e3 * (t3 - t2))
            token = nxt
        end.record()
        sync()
        host_ms = 1e3 * (time.perf_counter() - t0) / steps
        dispatch.sort()
        wait.sort()
        turns.append({"mode": mode, "event_ms": start.elapsed_time(end)
                      / steps, "host_ms": host_ms,
                      "dispatch_ms_median": dispatch[len(dispatch) // 2],
                      "wait_ms_median": wait[len(wait) // 2]})
        print(json.dumps(turns[-1]), flush=True)
    # The card's own step: graph steps queued back to back.
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        _, token, lens = serving._decode_fused(
            params, cfg, token, lens, k, v, table, model=model, **kw)
    end.record()
    sync()
    return {"turns": turns,
            "graph_device_ms": start.elapsed_time(end) / steps,
            "graph_host_us": graph_host_us(graph, params, cfg, token, lens,
                                           k, v, table, steps)}


def graph_host_us(graph, params, cfg, token, lens, k, v, table, n):
    """The host's µs a call for each part of a replayed step: the key
    check, the three input copies, the replay, the argmax and advance
    (each part timed alone over ``n`` calls, the card drained after)."""
    inputs = (token, lens, table)
    parts = {
        "key_check": lambda: graph._key_of(params, cfg, inputs, k, v),
        "input_copies": lambda: [s.copy_(x) for s, x in
                                 zip(graph._inputs, inputs)],
        "replay": graph._graph.replay,
        "argmax_advance": lambda: (
            torch.argmax(graph._logits, dim=-1).to(torch.int32),
            lens + (lens > 0).to(lens.dtype)),
    }
    out = {}
    for name, fn in parts.items():
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / n
        sync()
    return out


def profiler_run(model, params, cfg, batch, seed, device):
    """Kernels inside replays, seen by a profiler started after capture,
    as the benchmark's traced run starts it."""
    token, lens, table, k, v = mixed_state(cfg, batch, seed + 2, 8, device)
    graph = model.DecodeGraph()
    model.decode_step(params, cfg, token, lens, k, v, table, graph=graph)
    sync()
    trace.warm()
    k2_before, kw_before = pd.launches, paged_kv_write.launches
    by_mode = {}
    for mode in ("graph", "eager"):
        # The same three steps (same lengths) replayed, then eager.
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        for i in range(3):
            model.decode_step(params, cfg, token, lens + i, k, v, table,
                              **({"graph": graph} if mode == "graph"
                                 else {}))
        sync()
        prof.stop()
        if mode == "graph":
            summary = trace.reduce(prof.events(), 0.0, 1.0)
            launches = {"paged_decode": pd.launches - k2_before,
                        "kv_write": paged_kv_write.launches - kw_before}
            events = list(prof.events())
        ms = {}
        for e in prof.events():
            if trace._device_event(e):
                key = ("K2 paged_split" if "paged_split" in e.name
                       else "GEMM" if "nvjet" in e.name or "gemm" in e.name
                       or "splitKreduce" in e.name else "other")
                ms[key] = ms.get(key, 0.0) + (e.time_range.end
                                              - e.time_range.start) / 3e3
        by_mode[mode] = ms
    print(json.dumps({"device_ms_a_step_by_kind": by_mode}), flush=True)
    names = [n for n, _ in summary.device_ops]
    every = {}
    for e in events:
        if trace._device_event(e):
            every[e.name] = every.get(e.name, 0) + 1
    k2_kernels = sum(n for name, n in every.items() if "paged_split" in name)
    kv_kernels = sum(n for name, n in every.items() if "kv_write" in name)
    L = cfg.n_layers
    out = {"device_ops": summary.device_ops,
           "k2_device_s": summary.kernel_s["k2"],
           "k2_kernels_seen": k2_kernels, "kv_write_kernels_seen": kv_kernels,
           "launches_counted": launches,
           "device_ms_a_step_by_kind": by_mode}
    check(summary.kernel_s["k2"] > 0 and k2_kernels >= 3 * L,
          f"K2 inside replays reaches the profiler: {k2_kernels} kernels "
          f"named paged_split, {summary.kernel_s['k2']:.6f} s")
    check(kv_kernels == 3 * L, f"kv_write inside replays reaches the "
          f"profiler: {kv_kernels} kernels")
    check(out["launches_counted"] == {"paged_decode": 3 * L,
                                      "kv_write": 3 * L},
          f"launch counters count replays: {out['launches_counted']}")
    print(json.dumps({"device_ops_top": names}), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="mistral-7b-v0.1.batch-unique")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--timing-steps", type=int, default=50)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    entry = catalog.workload(catalog.benchmark(), args.workload)
    conf = catalog.config(entry["config"])
    g = geometry(conf)
    model, cfg = program_config(conf)
    if not hasattr(model, "DecodeGraph"):
        print(f"{args.workload}: its model family has no DecodeGraph",
              file=sys.stderr)
        return 2
    result = {"device": torch.cuda.get_device_name(device),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "workload": args.workload, "seed": args.seed}
    print(json.dumps(result), flush=True)
    result["kv_write"] = kv_write_cases(cfg, args.batch, device)
    if FAILED:
        return 1
    params = make_weights(g, args.seed, device)
    result["equal"] = equal_run(model, params, cfg, args.batch, args.seed,
                                args.steps, device)
    print(json.dumps(result["equal"]), flush=True)
    torch.cuda.empty_cache()
    result["timing"] = timing_run(model, params, cfg, args.batch, args.seed,
                                  args.timing_steps, device)
    print(json.dumps({k: result["timing"][k] for k in
                      ("graph_device_ms", "graph_host_us")}), flush=True)
    torch.cuda.empty_cache()
    result["profiler"] = profiler_run(model, params, cfg, args.batch,
                                      args.seed, device)
    result["failed"] = FAILED
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
