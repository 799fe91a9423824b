"""The traced run's profile: ``torch.profiler`` over a short steady
stretch of the window, reduced to device busy time, device time by
kernel, and the idle gaps named by what the host was doing.

Copied from ``tools/torch_profile_step.py`` (its ``device_us`` and the
rule that a range annotation is no device work); the union of busy
intervals is this module's own, since that tool sums device totals and
so counts overlapping work twice.
"""

import torch
from torch.profiler import ProfilerActivity, profile

# The host spans the benchmark records (harness.store, harness.model,
# harness.driver), innermost first when they nest.
SPANS = ("store.get", "store.put", "store.sync", "model.prefill",
         "model.decode", "engine.step")
# Kernel-name fragments of the kernels that have rooflines.
KERNELS = {"k1": ("flash_prefill",), "k2": ("paged_split",)}
TOP = 10
# Seconds of the window the traced run profiles: some hundreds of engine
# steps, and a trace far under a GiB.
SECONDS = 4.0


class Summary:
    """A traced stretch: ``lo``/``hi`` (window seconds), ``window_s``,
    ``busy_s``, ``kernel_s`` (device seconds by KERNELS key),
    ``device_ops`` and ``idle_gaps`` ([name, seconds], longest first)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def warm():
    """Start and stop the profiler once (CUPTI's set-up), so the
    window's stretch does not pay it."""
    with profile(activities=_activities()):
        if torch.cuda.is_available():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()


class Tracer:
    """A driver hook: profiles from window second ``start`` for
    ``length`` seconds, whole engine steps only (the device is drained
    before the profiler starts and before it stops)."""

    def __init__(self, start, length, clock):
        self.start, self.length, self.clock = start, length, clock
        self.prof = None
        self.lo = self.hi = None

    def _sync(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def __call__(self, now):
        if self.prof is None and now >= self.start:
            self._sync()
            self.prof = profile(activities=_activities())
            self.prof.start()
            self.lo = self.clock.now()
        elif self.hi is None and self.prof is not None \
                and now >= self.start + self.length:
            self._sync()
            self.hi = self.clock.now()
            self.prof.stop()

    def close(self):
        """Stop a profile the window's end cut short."""
        if self.prof is not None and self.hi is None:
            self._sync()
            self.hi = self.clock.now()
            self.prof.stop()

    def summary(self):
        if self.prof is None:
            return None
        return reduce(self.prof.events(), self.lo, self.hi)


def _device_event(e):
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.name and e.name not in SPANS)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_span(spans, t):
    """The innermost benchmark span running on the host at time t."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "driver loop"


def reduce(events, lo, hi):
    """A Summary from profiler events (times in microseconds) of the
    stretch [lo, hi) of the window."""
    dev = [e for e in events if _device_event(e)]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name in SPANS]
    merged = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(e - s for s, e in merged)
    by_name = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    kernel_s = {k: sum(v for n, v in by_name.items()
                       if any(f in n for f in frags)) / 1e6
                for k, frags in KERNELS.items()}
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(merged, merged[1:]) if b[0] > a[1]),
                  reverse=True)[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(
        lo=lo, hi=hi, window_s=hi - lo, busy_s=busy_us / 1e6,
        kernel_s=kernel_s,
        device_ops=[[n, v / 1e6] for n, v in ops],
        idle_gaps=[[f"host in {_host_span(spans, mid)}", g / 1e6]
                   for g, mid in gaps])
