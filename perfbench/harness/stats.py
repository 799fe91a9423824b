"""End-to-end arithmetic over every request of a window: no chunked
medians, no sampling."""

import math


def percentile(values, q):
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def ttfts(turns, seconds, drain_end):
    """Time to first token, in seconds, of every turn due in the window,
    from its due time. A turn with no first token by ``drain_end`` is
    placed above every answered turn, at the wait it had by then."""
    answered, waiting = [], []
    for t in turns:
        if t.due >= seconds:
            continue
        if t.times:
            answered.append(t.times[0] - t.due)
        else:
            waiting.append(drain_end - t.due)
    top = max(answered, default=0.0)
    return answered + [max(w, top) for w in waiting], len(waiting)


def gaps(turns, seconds):
    """Every gap between consecutive tokens of a request whose later
    token came in the window."""
    out = []
    for t in turns:
        for a, b in zip(t.times, t.times[1:]):
            if 0.0 <= b < seconds:
                out.append(b - a)
    return out


def tokens_in(turns, seconds):
    """Output tokens handed over in the window."""
    return sum(1 for t in turns for x in t.times if 0.0 <= x < seconds)
