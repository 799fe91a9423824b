"""On the card, at each cell's own size: the control (the reference with
its weights rounded to int8, one precision below the configurations'
bf16, following the program's routing where there is one) fails one of
the cell's numbers on every seed tried, and the program passes them
all. Minutes per cell: ``python3 -m pytest perfbench/tests -m card``."""

import time

import pytest

from harness import catalog, judge, run_cell

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
SECONDS = 20.0


def _readings(weights, g, record, routes_of, seed):
    picked = judge.sample(record.turns, seed, judge.SAMPLE_TOKENS, routes_of)
    served, control, margins = judge.gaps(weights, g, picked, "int8",
                                          routes_of)
    return (judge.summary(served, [m[0] for m in margins]),
            judge.summary(control, [m[1] for m in margins]))


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  catalog.benchmark()["workloads"]])
def test_control_fails_and_program_passes(card, cell):
    check = catalog.cell(cell)["check"]
    for seed in SEEDS:
        result, _ = run_cell.run(
            cell, seed, SECONDS, False, card, time.perf_counter(),
            after=lambda w, g, r, ro, s=seed: _readings(w, g, r, ro, s))
        sound, control = result["after"]
        assert result["correct"] is True
        for name, limit in check["limits"].items():
            assert sound[name] <= limit, (seed, name, sound)
        assert any(control[name] > limit
                   for name, limit in check["limits"].items()), (seed, control)
