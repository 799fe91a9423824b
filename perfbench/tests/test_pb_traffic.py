"""The traffic generators keep to their mixes and to their seeds."""

import json
import os
from collections import Counter

from harness import catalog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Sessions = catalog.generator("sessions")
Backlog = catalog.generator("backlog")


def _mix(name):
    with open(os.path.join(ROOT, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _drive(tr, seconds, finish_after=0.5):
    """Poll the traffic as a driver would, answering every turn at once
    (all its tokens, ``finish_after`` seconds after it was due)."""
    t = 0.0
    while t < seconds:
        for turn in tr.poll(t, 0):
            turn.tokens = [7] * turn.max_new
            turn.times = [turn.due + finish_after] * turn.max_new
            tr.finished(turn, turn.due + finish_after)
        t += 0.25
    return tr.turns


def test_sessions_same_seed_same_requests():
    mix = _mix("chat-sessions")
    a = _drive(Sessions(mix, 2**31 + 5, 40, 32000), 40)
    b = _drive(Sessions(mix, 2**31 + 5, 40, 32000), 40)
    assert [(t.rid, t.prompt, t.max_new, t.due) for t in a] == \
        [(t.rid, t.prompt, t.max_new, t.due) for t in b]


def test_sessions_seed_orders_the_same_sessions():
    """Two seeds draw the same sessions, the same number in each block's
    span, in their own orders and at their own times, with their own
    ids."""
    mix = _mix("chat-sessions")
    block = catalog._module(ROOT, "traffic", "sessions").BLOCK
    span = block / mix["session_rate_per_s"]
    a = Sessions(mix, 1, 50, 32000)
    b = Sessions(mix, 2, 50, 32000)
    whole = len(a.specs) // block * block
    assert whole >= 4 * block
    assert Counter(str(s["turns"]) for s in a.specs[:whole]) == \
        Counter(str(s["turns"]) for s in b.specs[:whole])
    assert [s["turns"] for s in a.specs] != [s["turns"] for s in b.specs]
    for tr in (a, b):
        assert [int(s["arrival"] // span) for s in tr.specs[:whole]] == \
            [i // block for i in range(whole)]
    assert [s["arrival"] for s in a.specs] != [s["arrival"] for s in b.specs]
    ta, tb = _drive(a, 40), _drive(b, 40)
    assert ta[0].prompt != tb[0].prompt


def test_sessions_keep_to_the_mix():
    mix = _mix("chat-sessions")
    tr = Sessions(mix, 99, 50, 32000)
    turns = _drive(tr, 50)
    assert len(turns) > 20
    system = tr.system
    assert len(system) == mix["system_prompt_tokens"]
    by_session = {}
    for t in turns:
        assert t.prompt[:len(system)] == system
        assert len(t.prompt) + t.max_new <= mix["context_cap"]
        lo, hi = mix["output_tokens"]
        assert lo <= t.max_new <= hi
        by_session.setdefault(t.session, []).append(t)
    lo, hi = mix["turns"]
    for sid, ts in by_session.items():
        ts.sort(key=lambda t: t.index)
        assert len(ts) <= hi
        for prev, cur in zip(ts, ts[1:]):
            # The whole history, then the new user tokens.
            history = prev.prompt + prev.tokens
            assert cur.prompt[:len(history)] == history
            new = len(cur.prompt) - len(history)
            assert mix["user_tokens"][0] <= new <= mix["user_tokens"][1]
            assert cur.due >= prev.times[-1]


def test_sessions_arrivals_follow_the_rate():
    mix = {**_mix("chat-sessions"), "session_rate_per_s": 2.0}
    tr = Sessions(mix, 3, 200, 32000)
    arrivals = [s["arrival"] for s in tr.specs
                if s["arrival"] < 200]
    assert 300 < len(arrivals) < 500


def test_backlog_tops_up_and_never_shares_a_first_page():
    mix = _mix("batch-unique")
    tr = Backlog(mix, 2**33 + 1, 50, 32000)
    warm = tr.warmup()
    new = tr.poll(0.0, 0)
    assert len(new) == mix["waiting"]
    assert tr.poll(1.0, mix["waiting"]) == []
    more = tr.poll(2.0, mix["waiting"] - 3)
    assert len(more) == 3
    firsts = [tuple(t.prompt[:16]) for t in warm + tr.turns]
    assert len(set(firsts)) == len(firsts)
    for t in tr.turns:
        lo, hi = mix["prompt_tokens"]
        assert lo <= len(t.prompt) <= hi
        assert mix["output_tokens"][0] <= t.max_new or \
            len(t.prompt) + t.max_new == mix["context_cap"]
        assert len(t.prompt) + t.max_new <= mix["context_cap"]


def test_backlog_seed_orders_the_same_sizes():
    """Two seeds draw the same sizes in each block of requests, in their
    own orders, with their own ids."""
    mix = _mix("batch-unique")
    block = catalog._module(ROOT, "traffic", "backlog").BLOCK
    a = Backlog(mix, 5, 50, 32000)
    b = Backlog(mix, 6, 50, 32000)
    ta, tb = a.poll(0.0, 1 - 4 * block), b.poll(0.0, 1 - 4 * block)
    assert len(ta) == len(tb) == 4 * block + mix["waiting"] - 1
    whole = 4 * block
    sizes = lambda ts: [(len(t.prompt), t.max_new) for t in ts]  # noqa: E731
    for lo in range(0, whole, block):
        assert Counter(sizes(ta[lo:lo + block])) == \
            Counter(sizes(tb[lo:lo + block]))
    assert sizes(ta) != sizes(tb)
    assert all(x.prompt != y.prompt for x, y in zip(ta, tb))
    again = Backlog(mix, 5, 50, 32000).poll(0.0, 1 - 4 * block)
    assert [x.prompt for x in again] == [x.prompt for x in ta]
