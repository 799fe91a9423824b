"""The benchmark's engine loop, end to end on the CPU at a tiny size:
both kinds of traffic, the metrics each cell reports, the check, and
nothing written to /dev/shm."""

import os
import time

import pytest

import tiny
from harness import run_cell


def _shm():
    return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,traced", [
    ("tiny.sessions", False), ("tiny.sessions", True),
    ("tiny-moe.backlog", False), ("tiny-moe.backlog", True)])
def test_a_run_end_to_end(root, cell, traced):
    path, bench = root
    before = _shm()
    result, lines = run_cell.run(cell, 2**32 + 9, 2.5, traced, "cpu",
                                 time.perf_counter(), bench=bench, root=path)
    assert _shm() <= before
    assert result["correct"] is True
    assert result["attempted"] > 0
    assert list(result)[-1] == "check"
    assert lines[0].startswith("check mean_gap: ")
    gap = result["check"]["mean_gap"]
    assert 0 <= gap["value"] <= gap["limit"]
    pages = result["traffic"]["pages"]
    assert 0 < pages["mean"] <= pages["peak"] <= pages["usable"] == 64
    metrics = result["metrics"]
    if traced:
        assert "setup_s" not in metrics
        assert result["device"]["window_s"] > 0
        assert "breakdown" in result
        if cell == "tiny.sessions":
            assert 50 < metrics["engine.hit_share"]["value"] < 100
            assert metrics["store.restore_gbs"]["value"] > 0
            assert metrics["store.offload_share.serve"]["value"] > 0
            assert metrics["model.mfu.serve"]["value"] > 0
        else:
            assert metrics["store.offload_share.batch"]["value"] > 0
            assert metrics["model.mfu.batch"]["value"] > 0
        # No device on the CPU: no busy time, so no device metric.
        assert not any(k.startswith(("device.", "kernel."))
                       for k in metrics)
    else:
        assert metrics["setup_s"]["value"] > 0
        if cell == "tiny.sessions":
            assert set(metrics) == {"itl_p95_ms", "setup_s"}
            assert result["failed"] == 0
        else:
            assert set(metrics) == {"tok_s", "setup_s"}
            assert metrics["tok_s"]["value"] > 0


def test_open_loop_times_turns_from_their_due_time(root):
    path, bench = root
    seen = {}

    def keep(weights, g, record, routes_of):
        seen["turns"] = record.turns
        return None

    run_cell.run("tiny.sessions", 4, 2.0, False, "cpu", time.perf_counter(),
                 bench=bench, root=path, after=keep)
    turns = seen["turns"]
    assert turns
    for t in turns:
        assert t.submitted >= t.due
        if t.times:
            assert t.times[0] >= t.submitted
            assert t.times == sorted(t.times)
