"""The ``sessions`` kind: an open loop of multi-turn chat sessions.

Sessions start as a Poisson process at ``session_rate_per_s``; every
prompt begins with one shared system prompt of ``system_prompt_tokens``;
a session runs ``turns`` turns, each adding ``user_tokens`` new tokens
and asking for ``output_tokens`` (both log-uniform); the next turn is
due an exponential think time (mean ``think_s_mean``) after the last
token of the one before, and its prompt is the session's whole history.
A session ends before its context would pass ``context_cap``.

Sessions come in blocks of ``BLOCK``, one block every ``BLOCK / rate``
seconds: the run's seed places a block's starts in its span uniformly
(which is how a Poisson process places a given count), and gives them
the block's sessions, whose sizes the mix's ``sizes_seed`` draws, in an
order of its own. So every run offers the load of the rate itself, not
of a lucky draw, and every seed serves the same sessions.
"""

import math

import numpy as np

from harness.traffic import HORIZON_S, WARM, Turn, entropy, log_uniform, order

BLOCK = 8


class Traffic:
    def __init__(self, mix, seed, seconds, vocab):
        self.mix, self.vocab = mix, vocab
        self.seed = entropy(seed)
        rate = float(mix["session_rate_per_s"])
        sys_rng = np.random.default_rng([self.seed, 0])
        self.system = sys_rng.integers(
            0, vocab, mix["system_prompt_tokens"]).tolist()
        # Arrivals up to the drain's horizon.
        self.specs = []
        span = BLOCK / rate
        for block in range(math.ceil((seconds + HORIZON_S) / span)):
            starts = np.sort(np.random.default_rng(
                [self.seed, 4, block]).uniform(0.0, span, BLOCK))
            sizes = [self._sizes(block * BLOCK + i) for i in range(BLOCK)]
            for t, s in zip(block * span + starts,
                            order(self.seed, 5, block, BLOCK)):
                if t <= seconds + HORIZON_S:
                    self.specs.append({"id": len(self.specs),
                                       "arrival": float(t),
                                       "turns": sizes[s]})
        self.pending = [(s["arrival"], s["id"], 0, None) for s in self.specs]
        self.turns = []

    def _sizes(self, i):
        """The i-th drawn session's turns: (user, output, think) each."""
        rng = np.random.default_rng([self.mix["sizes_seed"], 1, i])
        lo, hi = self.mix["turns"]
        n = int(rng.integers(lo, hi + 1))
        turns = []
        ctx = len(self.system)
        for _ in range(n):
            user = log_uniform(rng, *self.mix["user_tokens"])
            out = log_uniform(rng, *self.mix["output_tokens"])
            think = float(rng.exponential(self.mix["think_s_mean"]))
            if ctx + user + out > self.mix["context_cap"]:
                break
            turns.append((user, out, think))
            ctx += user + out
        return turns

    def _user_tokens(self, session, index, n):
        rng = np.random.default_rng([self.seed, 1, session, index])
        return rng.integers(0, self.vocab, n).tolist()

    def warmup(self):
        """Set-up's requests: the system prompt alone (a cold prefill
        whose pages are offloaded for every session to hit), then one
        turn over it (a restore and a suffix prefill)."""
        return [Turn("warm-system", list(self.system), 1, -1.0),
                Turn("warm-hit", self.system
                     + self._user_tokens(WARM, 0, 96), 8, -1.0)]

    def poll(self, now, queued):
        """Turns due by ``now`` (seconds from the window's start)."""
        out, keep = [], []
        for item in self.pending:
            (out if item[0] <= now else keep).append(item)
        self.pending = keep
        new = []
        for due, sid, index, history in sorted(out, key=lambda x: x[:3]):
            spec = self.specs[sid]
            user, n_out, _ = spec["turns"][index]
            base = list(self.system) if history is None else history
            turn = Turn(f"s{sid}t{index}",
                        base + self._user_tokens(sid, index, user), n_out,
                        due, sid, index)
            self.turns.append(turn)
            new.append(turn)
        return new

    def next_due(self):
        return min((p[0] for p in self.pending), default=None)

    def attempted(self, seconds):
        """(turns due in the window, those never answered)."""
        due = [t for t in self.turns if t.due < seconds]
        return len(due), sum(1 for t in due if not t.tokens)

    def finished(self, turn, now):
        """The turn's last token came at ``now``: the session's next turn
        is due a think time later."""
        if turn.session < 0:  # set-up's requests start no session
            return
        spec = self.specs[turn.session]
        nxt = turn.index + 1
        if nxt < len(spec["turns"]):
            think = spec["turns"][turn.index][2]
            self.pending.append((now + think, turn.session, nxt,
                                 turn.prompt + turn.tokens))
