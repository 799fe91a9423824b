"""The readers of the program's own counters (``ServingEngine.stats``
window deltas) on synthetic runs: each reads its ratio, and none when
its count is 0 or when the program has no such counter (a program from
before the counters)."""

import pytest

from harness import catalog
from harness.record import Run

READERS = ("model.decode_dispatch_ms.batch", "model.decode_wait_ms.batch",
           "engine.admit_share.batch", "store.offload_gbs.batch",
           "store.offload_stage_share.batch")
STATS = {"decode_dispatch_ns": 90_000_000, "decode_dispatch_n": 30,
         "decode_wait_ns": 15_000_000, "decode_wait_n": 30,
         "admit_ns": 2_500_000_000, "admit_n": 12,
         "offload_ns": 700_000_000, "offload_n": 4,
         "offload_bytes": 280_000_000, "offload_gather_ns": 7_000_000,
         "store_stage_ns": 28_000_000, "decode_steps": 30}


def _read(name, stats, seconds=50.0):
    return catalog.reader(name)(Run(seconds=seconds, stats=stats))


def test_each_reader_reads_its_ratio():
    assert _read("model.decode_dispatch_ms.batch", STATS) == \
        pytest.approx(3.0)
    assert _read("model.decode_wait_ms.batch", STATS) == pytest.approx(0.5)
    assert _read("engine.admit_share.batch", STATS) == pytest.approx(5.0)
    assert _read("store.offload_gbs.batch", STATS) == pytest.approx(0.4)
    assert _read("store.offload_stage_share.batch", STATS) == \
        pytest.approx(5.0)


@pytest.mark.parametrize("name", READERS)
def test_no_reading_without_a_count(name):
    zero = {k: 0 for k in STATS}
    assert _read(name, zero) is None


@pytest.mark.parametrize("name", READERS)
def test_no_reading_from_a_program_without_the_counters(name):
    assert _read(name, {"decode_steps": 30, "offloaded_pages": 8}) is None


def test_each_reader_is_listed_on_both_batch_cells():
    bench = catalog.benchmark()
    cells = {w["name"] for w in bench["workloads"]
             if w["traffic"] == "batch-unique"}
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = listed[name]
        assert m["source"] == "program_counter" and m["moves"] == "tok_s"
        assert set(m["workloads"]) == cells and len(cells) == 2
