"""What a run hands its metric readers, and the arithmetic they share.

Every time here is in seconds from the window's start, on the host
clock. ``Run`` holds:

- ``seconds``: the window's length; ``drain_end``: when the loop ended;
- ``setup_s``: process start to the window's start;
- ``turns``: every request submitted in the window or its drain
  (``harness.traffic.Turn``: due time, token times);
- ``stats``: the engine's ``stats`` counters over the window (the
  difference of its readings at the window's start and end);
- ``gets``, ``puts``, ``syncs``: (start, end, bytes) of the engine's
  calls of ``get_kv_pages``, ``put_kv_pages`` and ``conn.sync``;
- ``steps``: (start, end) of each ``ServingEngine.step()``;
- ``calls``: the model's prefill and decode calls (``ModelSpy``);
- ``queue``, ``pages``: (time, requests waiting) and (time, device
  pages in use) before each engine step; ``pages_usable``: the pages
  the device pool has;
- ``geometry``: the configuration's sizes (``harness.model.geometry``);
- ``trace``: None, or the traced stretch (``harness.trace.Summary``).
"""

from . import work


class Run:
    def __init__(self, **fields):
        self.trace = None
        self.__dict__.update(fields)

    def window_calls(self, spans):
        """(seconds inside, bytes, count) of calls begun in the window."""
        inside = [s for s in spans if 0.0 <= s[0] < self.seconds]
        return (sum(e - s for s, e, _ in inside),
                sum(b for _, _, b in inside), len(inside))

    def step_seconds(self):
        return sum(e - s for s, e in self.steps if 0.0 <= s < self.seconds)


def call_flops(g, call):
    """Model operations of one recorded model call."""
    if call[1] == "prefill":
        return work.prefill_flops(g, call[2], call[3])
    return work.decode_flops(g, call[2])


def mfu(run):
    """The window's model operations over the wall time inside
    ``ServingEngine.step()`` at the bf16 peak, in %."""
    secs = run.step_seconds()
    if secs <= 0:
        return None
    flops = sum(call_flops(run.geometry, c) for c in run.calls
                if 0.0 <= c[0] < run.seconds)
    return 100.0 * flops / (secs * work.PEAK_BF16)


def offload_share(run):
    """Wall time inside ``put_kv_pages`` and ``conn.sync()`` over the
    window, in %."""
    put, _, n_put = run.window_calls(run.puts)
    sync, _, _ = run.window_calls(run.syncs)
    if not n_put:
        return None
    return 100.0 * (put + sync) / run.seconds


def idle_share(run):
    """1 - the device's busy time over the traced stretch, in %."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def _launch_bounds(run, kind):
    """Least seconds of the K1 (prefill) or K2 (decode) launches of the
    traced stretch's model calls, one launch per layer each, at its
    layer group's window and heads (``work.plan``)."""
    g, tr = run.geometry, run.trace
    total = 0.0
    for c in run.calls:
        if not (tr.lo <= c[0] < tr.hi) or c[1] != kind:
            continue
        call = 0.0
        for grp in work.plan(g):
            heads = (grp["window"], grp["n_heads"], grp["n_kv"], grp["hd"])
            if kind == "prefill":
                flops, nbytes = work.k1_work(c[2], c[3] + c[2], *heads)
            else:
                # Every row of the engine's batch is launched: a free
                # slot attends its one scratch token.
                rows = list(c[2]) + [1] * (run.batch_rows - len(c[2]))
                flops, nbytes = work.k2_work(rows, *heads)
            call += grp["count"] * work.bound_s(flops, nbytes)
        total += call
    return total


def roofline(run, kind, kernel):
    """Least time of the traced stretch's launches of ``kernel`` over
    their device time in the trace, in %."""
    if run.trace is None:
        return None
    device = run.trace.kernel_s.get(kernel, 0.0)
    if device <= 0:
        return None
    return 100.0 * _launch_bounds(run, kind) / device
