#!/usr/bin/env python3
"""What the program's spans (``utils.profiling.Span``) cost with no
profiler running, on the host that drives the card.

    python3 tools/torch_span_cost.py [--workload mistral-7b-v0.1.batch-unique]
        [--seed 1] [--steps 100] [--rounds 8] [--uses 1000000]

Two readings, printed as one JSON line:

- ``ns_per_use``: a span's enter and exit, timed over ``--uses`` uses in
  a loop, beside the same loop over a context manager that does nothing
  (``null``), with and without arguments (``of(rid=, pages=, nbytes=)``);
- ``step_ms``: the benchmark cell's engine (its configuration and
  engine sizes, weights drawn from ``--seed``, no store) decoding a full
  batch of slots for ``--rounds`` x ``--steps`` steps, every other step
  with ``Span.__enter__`` / ``__exit__`` replaced by ones that do
  nothing: the host time of each step, by mode (mean and quartiles). A
  decode step uses three spans (``engine.decode`` and its two
  children); the ``step_*`` counters stay on in both.
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "perfbench"), REPO]

import torch  # noqa: E402

from harness import catalog  # noqa: E402
from harness.model import geometry, make_weights, program_config  # noqa
from infinistore_tpu_torch import serving  # noqa: E402
from infinistore_tpu_torch.utils.profiling import Span  # noqa: E402


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


def _loop_ns(ctx, uses, with_args):
    if with_args:
        t0 = time.perf_counter_ns()
        for i in range(uses):
            with ctx.of(rid="r1", pages=128, nbytes=1 << 20):
                pass
        return (time.perf_counter_ns() - t0) / uses
    t0 = time.perf_counter_ns()
    for _ in range(uses):
        with ctx:
            pass
    return (time.perf_counter_ns() - t0) / uses


def per_use(uses):
    stats = {}
    span = Span(stats, "cost.span", "cost")
    null = _Null()
    null.of = lambda **kw: null
    out = {}
    for label, ctx in (("null", null), ("span", span)):
        out[label] = _loop_ns(ctx, uses, False)
        out[label + "_args"] = _loop_ns(ctx, uses, True)
    assert stats["cost_n"] == 2 * uses
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_ab(workload, seed, steps, rounds, device):
    entry = catalog.workload(catalog.benchmark(), workload)
    conf = catalog.config(entry["config"])
    cell = catalog.cell(workload)
    g = geometry(conf)
    module, cfg = program_config(conf)
    weights = make_weights(g, seed, device)
    sc = serving.ServingConfig(model_id=f"cost-{seed}", **cell["engine"])
    eng = serving.ServingEngine(weights, cfg, sc, model=module,
                                device=device)
    page = cfg.page_size
    prompt_len = 4 * page
    budget = sc.max_pages_per_seq * page - prompt_len
    need = (rounds + 1) * steps + 1
    if need > budget:
        raise SystemExit(f"{need} steps exceed a sequence's {budget}")
    gen = torch.Generator().manual_seed(seed)
    for i in range(sc.max_slots):
        prompt = torch.randint(0, g["vocab"], (prompt_len,),
                               generator=gen).tolist()
        eng.submit(serving.Request(f"c{i}", prompt, max_new_tokens=need))
    for _ in range(steps):  # warm-up: admissions and the first steps
        eng.step()
    live = (Span.__enter__, Span.__exit__)

    def null_enter(self):
        return self

    def null_exit(self, exc_type, exc, tb):
        return False

    # Every other step with the spans nulled: drifts (contexts growing,
    # the host's other load) fall on both alike. A step ends reading its
    # tokens, so the host clock around it holds the card's work.
    times = {"on": [], "off": []}
    try:
        for i in range(rounds * steps):
            mode = "on" if i % 2 == 0 else "off"
            Span.__enter__, Span.__exit__ = (
                live if mode == "on" else (null_enter, null_exit))
            t0 = time.perf_counter_ns()
            eng.step()
            times[mode].append((time.perf_counter_ns() - t0) / 1e6)
    finally:
        Span.__enter__, Span.__exit__ = live
    _sync(device)
    out = {}
    for m, v in times.items():
        q = statistics.quantiles(v, n=4)
        out[m] = {"steps": len(v), "mean": statistics.fmean(v),
                  "q1": q[0], "median": q[1], "q3": q[2]}
    out["on_minus_off_ms"] = {
        k: out["on"][k] - out["off"][k] for k in ("mean", "median")}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="mistral-7b-v0.1.batch-unique")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--uses", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    device = torch.device(args.device)
    line = {"device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "ns_per_use": per_use(args.uses),
            "step_ms": step_ab(args.workload, args.seed, args.steps,
                               args.rounds, device)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
