#!/usr/bin/env python3
"""Where a benchmark cell's time goes, read from the program's own spans
(``ServingEngine.stats``) and from one ``profile_window`` file.

    python3 tools/torch_span_gaps.py --workload <cell> --seed <n>
        [--seconds 51] [--top 10] [--keep DIR]

Runs the cell as ``perfbench/run.py --trace 1`` does, with the traced
stretch recorded by ``utils.profiling.profile_window`` over the
in-process store server (its span rings on: ``ISTPU_TRACE=1``), so
one file holds the engine's and the store client's spans, the kernels
and the server's spans on the torch clock. Prints one JSON line:

- ``spans``: each span's seconds and count over the window (the window
  deltas of ``ServingEngine.stats``), and its share of the window;
- ``offload``: the program's ``engine.offload`` seconds beside the
  benchmark's own timers around ``put_kv_pages`` and ``conn.sync()``;
- ``gaps``: the ``--top`` longest stretches of the traced file in which
  no kernel or copy ran on the card, each with the innermost program
  span and the innermost benchmark span the step's thread was in, the
  innermost span of any other thread (``behind``: the write-behind
  thread's offload) and the server spans;
- ``device_ops``: the device rows by time, and any that carries a
  program span's name (there should be none).

``--keep DIR`` keeps the merged file there (gzip JSON, tens of MB).
Needs a CUDA card for device rows; on the CPU every gap list is empty.
"""

import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import time

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "perfbench"), REPO]
# The in-process server's span rings record from its start.
os.environ["ISTPU_TRACE"] = "1"

import torch  # noqa: E402

from harness import run_cell, trace  # noqa: E402
from infinistore_tpu_torch.utils import profile_window  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def program_span(name):
    return (name.startswith(("engine.", "store."))
            and name not in trace.SPANS)


class _Servers(run_cell.Store):
    """The harness's store, remembered so the window can drain its
    server's span rings."""

    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Servers.made.append(self.server)


class _Window(trace.Tracer):
    """The harness's traced stretch, recorded by ``profile_window``."""

    trace_dir = None
    window = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._cm = None

    def __call__(self, now):
        if self._cm is None and now >= self.start:
            self._sync()
            self._cm = profile_window(_Servers.made[-1],
                                      trace_dir=_Window.trace_dir,
                                      trace=True)
            _Window.window = self._cm.__enter__()
            self.lo = self.clock.now()
        elif (self.hi is None and self._cm is not None
              and now >= self.start + self.length):
            self._stop()

    def _stop(self):
        self._sync()
        self.hi = self.clock.now()
        self._cm.__exit__(None, None, None)

    def close(self):
        if self._cm is not None and self.hi is None:
            self._stop()

    def summary(self):
        return None


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(spans, t):
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else None


def read_file(path, top):
    """Device rows, the longest idle gaps and what the host was in."""
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]

    def iv(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    # The thread that runs engine.step; any other host thread's spans
    # (the write-behind thread's) are reported apart.
    step = {e.get("tid") for e in events if e.get("name") == "engine.step"}
    spans = [e for e in events
             if e.get("cat") == "cpu_op" and program_span(e["name"])]
    prog = [(e["name"], *iv(e)) for e in spans if e.get("tid") in step]
    behind = [(e["name"], *iv(e)) for e in spans
              if e.get("tid") not in step]
    bench = [(e["name"], *iv(e)) for e in events
             if e.get("name") in trace.SPANS and e.get("pid") != 1
             and e.get("tid") in step]
    server = [(e["name"], *iv(e)) for e in events if e.get("pid") == 1]
    merged = _union(iv(e) for e in dev)
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:]) if b[0] > a[1]),
                  reverse=True)[:top]
    out = []
    for g, a, b in gaps:
        mid = (a + b) / 2
        out.append({
            "ms": g / 1e3, "program": _innermost(prog, mid) or "no span",
            "benchmark": _innermost(bench, mid) or "no span",
            "behind": _innermost(behind, mid) or "no span",
            "server": sorted({n for n, s, e in server if s < b and e > a})})
    window = (merged[-1][1] - merged[0][0]) if merged else 0.0
    busy = sum(e - s for s, e in merged)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": window / 1e6, "busy_s": busy / 1e6,
            "gaps": out,
            "device_ops": [[n, v / 1e6] for n, v in ops[:top]],
            "program_names_on_device": sorted(
                n for n in by_name if program_span(n)),
            "program_spans": len(prog), "behind_spans": len(behind),
            "server_spans": len(server)}


def span_totals(stats, seconds):
    out = {}
    for key in sorted(stats):
        if key.endswith("_ns") and stats.get(key[:-3] + "_n"):
            out[key[:-3]] = {"s": stats[key] / 1e9,
                             "n": stats[key[:-3] + "_n"],
                             "share": stats[key] / 1e9 / seconds}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--keep")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="span_gaps.")
    _Window.trace_dir = tmp
    run_cell.Store = _Servers
    trace.Tracer = _Window
    seen = {}

    def after(weights, g, record, routes_of):
        put, _, n_put = record.window_calls(record.puts)
        sync, _, _ = record.window_calls(record.syncs)
        seen["offload"] = {
            "program_engine_offload_s": record.stats.get("offload_ns",
                                                         0) / 1e9,
            "program_offloads": record.stats.get("offload_n", 0),
            "benchmark_put_sync_s": put + sync, "benchmark_puts": n_put}
        seen["spans"] = span_totals(record.stats, record.seconds)
        return None

    try:
        result, _ = run_cell.run(args.workload, args.seed, args.seconds,
                                 True, args.device, T_START, after=after)
        w = _Window.window
        line = {"workload": args.workload, "seed": args.seed,
                "correct": result["correct"],
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                "device": result["device"].get("kind"),
                "power_limit": result["device"].get("power_limit"),
                "clock_offset_err_us": w.clock_offset_err_us,
                **seen, **read_file(w.trace_path, args.top)}
        if args.keep:
            os.makedirs(args.keep, exist_ok=True)
            shutil.copy(w.trace_path, os.path.join(
                args.keep, f"{args.workload}.{args.seed}.trace.json.gz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("no CUDA card: device rows will be empty", file=sys.stderr)
    sys.exit(main())
