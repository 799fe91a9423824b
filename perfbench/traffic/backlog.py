"""The ``backlog`` kind: a closed loop.

The queue is topped up so that ``waiting`` requests always wait beyond
the running ones; prompts of ``prompt_tokens`` random ids (no two
sharing a first token, so no two share a first page) ask for
``output_tokens`` (both log-uniform), within ``context_cap``.

Requests come in blocks of ``BLOCK``: the mix's ``sizes_seed`` draws a
block's sizes, and the run's seed orders them.
"""

import numpy as np

from harness.traffic import Turn, entropy, log_uniform, order

BLOCK = 32


class Traffic:
    def __init__(self, mix, seed, seconds, vocab):
        self.mix, self.vocab = mix, vocab
        self.seed = entropy(seed)
        # First tokens: a permutation of the vocabulary, so no two
        # prompts of a run share a first page (set-up's takes the last).
        self.firsts = np.random.default_rng([self.seed, 3]).permutation(vocab)
        self.count = 0
        self.turns = []

    def _request(self, rid, sizes, k, first, due):
        n_in = log_uniform(sizes, *self.mix["prompt_tokens"])
        n_out = log_uniform(sizes, *self.mix["output_tokens"])
        n_out = min(n_out, self.mix["context_cap"] - n_in)
        ids = np.random.default_rng([self.seed, 2, k]).integers(
            0, self.vocab, n_in)
        ids[0] = first
        return Turn(rid, ids.tolist(), n_out, due, index=k)

    def warmup(self):
        """Set-up's request: one cold prompt of its own sizes."""
        return [self._request("warm", np.random.default_rng(
            [self.mix["sizes_seed"], 2]), len(self.firsts), self.firsts[-1],
            -1.0)]

    def poll(self, now, queued):
        new = []
        while queued + len(new) < self.mix["waiting"]:
            k = self.count
            block, i = divmod(k, BLOCK)
            drawn = block * BLOCK + int(order(self.seed, 4, block, BLOCK)[i])
            turn = self._request(
                f"r{k}", np.random.default_rng([self.mix["sizes_seed"], 1,
                                                drawn]),
                k, self.firsts[k % (len(self.firsts) - 1)], now)
            self.count += 1
            self.turns.append(turn)
            new.append(turn)
        return new

    def next_due(self):
        return None

    def attempted(self, seconds):
        """(requests begun in the window, 0): a closed loop's waiting
        requests are not due, and none fails."""
        return sum(1 for t in self.turns if t.times
                   and t.times[0] < seconds), 0

    def finished(self, turn, now):
        pass
