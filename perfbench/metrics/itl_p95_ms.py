"""95th percentile of every gap between consecutive output tokens of
every request, over the gaps that end in the window."""

from harness import stats


def read(run):
    values = stats.gaps(run.turns, run.seconds)
    return 1e3 * stats.percentile(values, 95) if values else None
