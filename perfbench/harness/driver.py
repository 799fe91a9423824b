"""The engine loop of a run: submit what the traffic says is due, step
the engine, and stamp every token with the host clock as the engine
hands it over (``Request.on_token``).

The window is ``seconds`` long. An open loop keeps stepping after it
until every turn due in the window has its first token (at most
``HORIZON_S``; its arrivals go on meanwhile, so those turns wait behind
the same load); a closed loop stops at the window's end.
"""

import time

from torch.profiler import record_function

from .traffic import HORIZON_S


class Clock:
    """Seconds since a run's window started, on the host clock."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def start(self):
        self.t0 = time.perf_counter()

    def now(self):
        return time.perf_counter() - self.t0

    def rel(self, t):
        """A perf_counter() reading in window seconds."""
        return t - self.t0


class Driver:
    """Drives ``engine`` with ``traffic``; ``request_cls`` is the
    program's ``serving.Request``."""

    def __init__(self, engine, traffic, request_cls, clock):
        self.engine, self.traffic = engine, traffic
        self.request_cls, self.clock = request_cls, clock
        self.live = {}
        self.steps = []      # (start, end) host seconds of engine.step()
        self.lag = []        # submit time minus due time, window turns
        self.queue = []      # (window seconds, requests waiting) per step
        self.pages = []      # (window seconds, device pages in use) per step

    def _on_token(self, rid, token):
        now = self.clock.now()
        turn = self.live[rid]
        turn.tokens.append(int(token))
        turn.times.append(now)
        if turn.done:
            del self.live[rid]
            self.traffic.finished(turn, now)

    def submit(self, turn):
        turn.submitted = self.clock.now()
        self.live[turn.rid] = turn
        self.engine.submit(self.request_cls(
            request_id=turn.rid, prompt=turn.prompt,
            max_new_tokens=turn.max_new, on_token=self._on_token))

    def step(self):
        t0 = time.perf_counter()
        with record_function("engine.step"):
            self.engine.step()
        self.steps.append((t0, time.perf_counter()))

    def busy(self):
        return bool(self.engine.queue) or any(
            s is not None for s in self.engine.slots)

    def settle(self, turns):
        """Run ``turns`` (set-up's) to their last token, then let the
        engine finish and offload them."""
        for turn in turns:
            self.submit(turn)
        while self.live or self.busy():
            self.engine.step()

    def window(self, seconds, open_loop, hooks=()):
        """Run the window (and an open loop's drain). ``hooks`` are
        called as hook(now) before every step (the traced run's profiler
        switch). Returns the engine stats at the window's end."""
        stats_end = None
        while True:
            now = self.clock.now()
            for turn in self.traffic.poll(now, len(self.engine.queue)):
                self.submit(turn)
                if turn.due < seconds:
                    self.lag.append(turn.submitted - turn.due)
            if now >= seconds:
                if stats_end is None:
                    stats_end = dict(self.engine.stats)
                if (not open_loop or now >= seconds + HORIZON_S
                        or self._window_answered(seconds)):
                    break
            for hook in hooks:
                hook(now)
            if self.busy():
                self.queue.append((now, len(self.engine.queue)))
                self.pages.append((now, self.engine.sc.total_pages - 1
                                   - len(self.engine.free_pages)))
                self.step()
                continue
            nxt = self.traffic.next_due()
            end = seconds if stats_end is None else seconds + HORIZON_S
            wake = end if nxt is None else min(nxt, end)
            time.sleep(max(0.0, min(0.05, wake - self.clock.now())))
        return stats_end

    def _window_answered(self, seconds):
        return all(t.tokens for t in self.traffic.turns if t.due < seconds)
