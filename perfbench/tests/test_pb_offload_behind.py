"""The readers of the write-behind counters (``ServingEngine.stats``
window deltas) on synthetic runs: the stall share and the share of
offloads handed to the write-behind thread each read their ratio, and
none without a count or from a program without the counters (one from
before the write-behind thread); each is listed on every batch cell."""

import pytest

from harness import catalog
from harness.record import Run

READERS = ("store.offload_stall_share.batch",
           "store.offload_behind_share.batch")
STATS = {"offload_step_ns": 1_500_000_000, "offload_step_n": 60,
         "offload_behind_n": 57, "offload_n": 60,
         "offload_ns": 30_000_000_000, "offload_room_wait_ns": 0,
         "offload_room_wait_n": 0, "decode_steps": 900}


def _read(name, stats, seconds=50.0):
    return catalog.reader(name)(Run(seconds=seconds, stats=stats))


def test_each_reader_reads_its_ratio():
    assert _read("store.offload_stall_share.batch", STATS) == \
        pytest.approx(3.0)
    assert _read("store.offload_behind_share.batch", STATS) == \
        pytest.approx(95.0)
    every = dict(STATS, offload_behind_n=60)
    assert _read("store.offload_behind_share.batch", every) == \
        pytest.approx(100.0)


@pytest.mark.parametrize("name", READERS)
def test_no_reading_without_a_count(name):
    zero = {k: 0 for k in STATS}
    assert _read(name, zero) is None


@pytest.mark.parametrize("name", READERS)
def test_no_reading_from_a_program_without_the_counters(name):
    # The counters a program from before the write-behind thread has.
    parent = {"offload_ns": 700_000_000, "offload_n": 4,
              "offload_bytes": 280_000_000, "decode_steps": 30}
    assert _read(name, parent) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_listed_on_every_batch_cell(name):
    bench = catalog.benchmark()
    cells = {w["name"] for w in bench["workloads"]
             if w["traffic"] == "batch-unique"}
    m = {m["name"]: m for m in bench["per_layer"]}[name]
    assert m["source"] == "program_counter" and m["moves"] == "tok_s"
    assert m["layer"] == "store" and m["unit"] == "%"
    assert set(m["workloads"]) == cells and len(cells) == 3
