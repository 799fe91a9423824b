"""Output tokens handed over in the window, over its seconds."""

from harness import stats


def read(run):
    return stats.tokens_in(run.turns, run.seconds) / run.seconds
