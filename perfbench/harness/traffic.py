"""What every traffic generator shares, and :func:`build`, which makes
the traffic of one run from a mix (``traffic/<name>.json``), the cell's
overrides of it, and the generator its ``kind`` names
(``traffic/<kind>.py``, found by ``harness.catalog``).

A generator module defines ``Traffic(mix, seed, seconds, vocab)`` with
``warmup()``, ``poll(now, queued)``, ``next_due()``,
``attempted(seconds)``, ``finished(turn, now)`` and a ``turns`` list
(``traffic/sessions.py`` says what each does).

Every seed gets the same set of sizes, and the same number of arrivals
in each block of time: a mix's ``sizes_seed`` draws the sizes block by
block, and ``--seed`` orders each block (:func:`order`), places its
arrivals, and draws the token ids. So two seeds do the same work, and a
later seed is still a draw that no earlier run has seen.
"""

import math
from dataclasses import dataclass, field

import numpy as np

# Sessions that arrive this long after the window's end are never drawn
# (the drain after the window lasts at most this long).
HORIZON_S = 60.0
# The token stream of set-up's own user turn (no session has this id).
WARM = 1 << 30


def entropy(seed):
    """A run's seed as numpy's non-negative entropy (any whole number)."""
    return int(seed) % (1 << 63)


def order(seed, stream, block, n):
    """The run seed's order of the ``n`` items of block ``block``."""
    return np.random.default_rng([entropy(seed), stream, block]).permutation(n)


def log_uniform(rng, lo, hi):
    """A whole number drawn log-uniformly from [lo, hi]."""
    return int(min(hi, max(lo, round(math.exp(
        rng.uniform(math.log(lo), math.log(hi)))))))


@dataclass
class Turn:
    """One request as the driver sees it: its prompt, its budget, when
    it was due (seconds from the window's start; negative in set-up),
    and the tokens it got with their host times."""
    rid: str
    prompt: list
    max_new: int
    due: float
    session: int = -1
    index: int = 0
    tokens: list = field(default_factory=list)
    times: list = field(default_factory=list)
    submitted: float = None

    @property
    def done(self):
        return len(self.tokens) >= self.max_new


def build(mix, overrides, seed, seconds, vocab, root):
    """The traffic of one run: ``mix`` with the cell's ``overrides``,
    made by the generator of its ``kind`` under benchmark root ``root``."""
    from . import catalog

    mix = {**mix, **(overrides or {})}
    return catalog.generator(mix["kind"], root)(mix, seed, seconds, vocab)
