"""Percentile and rate arithmetic over every request of a window."""

import pytest

from harness import stats
from harness.traffic import Turn


def _turn(due, times):
    t = Turn("r", [1], max(1, len(times)), due)
    t.times = list(times)
    t.tokens = [0] * len(times)
    return t


def test_nearest_rank_percentile():
    values = list(range(1, 101))
    assert stats.percentile(values, 90) == 90
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_ttft_from_due_time_and_unanswered_on_top():
    turns = [_turn(0.0, [0.5, 0.6]), _turn(1.0, [1.2]), _turn(2.0, []),
             _turn(9.0, [9.1])]  # the last is due after the window
    values, waiting = stats.ttfts(turns, 5.0, drain_end=2.3)
    assert waiting == 1
    assert sorted(values)[:2] == pytest.approx([0.2, 0.5])
    # 0.3 s of waiting so far, but placed above every answered turn.
    assert max(values) == pytest.approx(0.5)
    assert len(values) == 3
    values, _ = stats.ttfts(turns, 5.0, drain_end=4.0)
    assert max(values) == pytest.approx(2.0)


def test_gaps_end_in_the_window():
    turns = [_turn(0.0, [0.1, 0.3, 0.6, 1.2]), _turn(0.0, [0.9, 1.05])]
    assert sorted(stats.gaps(turns, 1.0)) == pytest.approx([0.2, 0.3])
    assert stats.tokens_in(turns, 1.0) == 4


def test_tokens_in_counts_every_request():
    turns = [_turn(0.0, [0.1 * i for i in range(10)]),
             _turn(0.0, [0.95, 1.5])]
    assert stats.tokens_in(turns, 1.0) == 11
