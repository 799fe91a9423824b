"""One run of one cell: set-up, the window, the metrics, the check.

:func:`run` takes the device as given (``run.py`` looks for the card
first), so the CPU tests drive the same path at a tiny size.
"""

import gc
import subprocess
import sys
import time

import torch

from . import catalog, judge, stats, trace
from .driver import Clock, Driver
from .model import ModelSpy, family, geometry, make_weights, program_config
from .record import Run
from .store import Store, StoreSpy
from .traffic import build

# Top-level module names that may not be loaded: JAX, and the JAX
# package the port was made from (compared whole: the port's own name
# only begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "infinistore_tpu")


def forbidden_modules():
    """Forbidden top-level names among the loaded modules."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class ForbiddenModule(RuntimeError):
    pass


def _check_modules(when):
    found = forbidden_modules()
    if found:
        raise ForbiddenModule(f"{', '.join(found)} loaded {when}")


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _device_info(device, peak):
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak),
                "power_limit": _power_limit()}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traffic_readings(record, lag, sample):
    """What the result line carries beside the metrics: how late the
    generator ran, the drain, the check's sample, the spread of the
    latencies (every quartile of TTFT and of the token gaps), and the
    device pool's pages in use over the window's engine steps (its peak
    and mean, beside the pages it has)."""
    seconds = record.seconds
    pages = [n for t, n in record.pages if t < seconds]
    ttft = sorted(stats.ttfts(record.turns, seconds, record.drain_end)[0])
    gaps = sorted(stats.gaps(record.turns, seconds))

    def at(values, q):
        return 1e3 * stats.percentile(values, q) if values else None

    return {
        "generator_lag_p90_ms": at(lag, 90), "generator_lag_max_ms":
        1e3 * lag[-1] if lag else None,
        "drain_s": record.drain_end - seconds, "sample": sample,
        "ttft_ms": {q: at(ttft, q) for q in (50, 75, 90, 100)},
        "gap_ms": {q: at(gaps, q) for q in (50, 75, 90, 95, 99)},
        "pages": {"peak": max(pages, default=0),
                  "mean": sum(pages) / len(pages) if pages else 0.0,
                  "usable": record.pages_usable}}


def run(name, seed, seconds, traced, device, t_start, bench=None,
        root=catalog.ROOT, params_hook=None, overrides=None, after=None):
    """Run cell ``name``; returns (result dict, check lines). ``t_start``
    is the process's start on the host clock (``time.perf_counter``).
    For ``control.py`` and ``sweep.py`` only: ``params_hook(weights,
    module, cfg)`` returns the tree the engine serves in place of the
    drawn one; ``overrides`` update the cell's mix parameters;
    ``after(weights, geometry, record, routes_of)`` is called once the check is
    done and its return goes into the result as ``"after"``."""
    from infinistore_tpu_torch import serving

    device = torch.device(device)
    _free(device)
    bench = bench or catalog.benchmark()
    entry = catalog.workload(bench, name)
    cell = catalog.cell(name, root)
    conf = catalog.config(entry["config"], root)
    mix = catalog.traffic(entry["traffic"], root)
    g = geometry(conf, root)
    module, cfg = program_config(conf, root)
    route_attr = family(g).route_attr

    weights = make_weights(g, seed, device)
    served = weights if params_hook is None else params_hook(
        weights, module, cfg)
    store = Store(device, cfg.kv_page_bytes(), **cell["store"])
    spy_model = None
    try:
        spy_store = StoreSpy(store.kv)
        spy_model = ModelSpy(module, route_attr, g["routed"])
        engine = serving.ServingEngine(
            served, cfg, serving.ServingConfig(
                model_id=f"{entry['config']}-{seed}", **cell["engine"]),
            store=spy_store, model=spy_model, device=device)
        spy_model.engine = engine
        traffic = build(mix, {**cell.get("traffic", {}), **(overrides or {})},
                        seed, seconds, g["vocab"], root)
        clock = Clock()
        driver = Driver(engine, traffic, serving.Request, clock)
        driver.settle(traffic.warmup())
        tracer = None
        if traced:
            trace.warm()
            # The stretch ends a second before the window does, where
            # the load is highest; stopping the profiler stalls the loop.
            tracer = trace.Tracer(max(0.0, seconds - 1.0 - trace.SECONDS),
                                  trace.SECONDS, clock)
        _check_modules("after set-up")
        # What set-up built stays: the collector skips it in the window.
        gc.freeze()
        _sync(device)
        clock.start()
        setup_s = clock.t0 - t_start
        stats0 = dict(engine.stats)
        stats1 = driver.window(seconds, mix["kind"] == "sessions",
                               () if tracer is None else (tracer,))
        drain_end = clock.now()
        if tracer is not None:
            tracer.close()
        _sync(device)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        rel = clock.rel
        record = Run(
            seconds=seconds, drain_end=drain_end, setup_s=setup_s,
            turns=traffic.turns,
            stats={k: stats1[k] - stats0[k] for k in stats0},
            gets=[(rel(s), rel(e), b) for s, e, b in spy_store.gets],
            puts=[(rel(s), rel(e), b) for s, e, b in spy_store.puts],
            syncs=[(rel(s), rel(e), b) for s, e, b in spy_store.syncs],
            steps=[(rel(s), rel(e)) for s, e in driver.steps],
            calls=[(rel(c[0]),) + tuple(c[1:]) for c in spy_model.calls],
            queue=driver.queue, pages=driver.pages,
            pages_usable=engine.sc.total_pages - 1, geometry=g,
            batch_rows=engine.sc.max_slots)
        if tracer is not None:
            record.trace = tracer.summary()
        lag = sorted(driver.lag)
        routes_of = spy_model.routes if route_attr else None
    finally:
        if spy_model is not None:
            spy_model.close()
            spy_model.engine = None
        # The engine and the spies hold each other: collect the cycle.
        engine = served = driver = spy_model = spy_store = None
        gc.unfreeze()
        store.close()
        _free(device)
    _check_modules("after the window")

    metrics = {}
    for m in catalog.metrics(bench, name, traced):
        value = catalog.reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted, failed = traffic.attempted(seconds)
    t_check = time.perf_counter()
    correct, compared, size = judge.judge(weights, g, record.turns, seed,
                                          cell["check"]["limits"], routes_of)
    _sync(device)
    size["check_s"] = time.perf_counter() - t_check
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": _device_info(device, peak)}
    if record.trace is not None:
        result["device"]["busy_s"] = record.trace.busy_s
        result["device"]["window_s"] = record.trace.window_s
        result["breakdown"] = {"device_ops": record.trace.device_ops,
                               "idle_gaps": record.trace.idle_gaps}
    result["traffic"] = _traffic_readings(record, lag, size)
    if after is not None:
        result["after"] = after(weights, g, record, routes_of)
    result["check"] = compared
    lines = [f"check {k}: {v['value']} limit {v['limit']}"
             for k, v in compared.items()]
    return result, lines

