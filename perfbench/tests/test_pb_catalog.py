"""A configuration, a mix, a traffic generator, a cell and a per-layer
metric added as new files (and BENCHMARK.json entries) are found without
editing any file the benchmark already has."""

import glob
import json
import os
import time

import tiny
from harness import catalog, run_cell


def test_real_files_match_benchmark_json():
    bench = catalog.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(catalog.REPO, c["file"]))
        assert catalog.config(c["name"])["source"] == c["source"]
    for w in bench["workloads"]:
        catalog.cell(w["name"])
        catalog.config(w["config"])
        assert callable(catalog.generator(
            catalog.traffic(w["traffic"])["kind"]))
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(catalog.reader(m["name"]))


def test_harness_names_no_cell():
    names = set()
    bench = catalog.benchmark()
    for entry in bench["configs"] + bench["workloads"]:
        names.add(entry["name"])
    for w in bench["workloads"]:
        names.add(w["traffic"])
    for path in glob.glob(os.path.join(tiny.ROOT, "harness", "*.py")) + \
            [os.path.join(tiny.ROOT, "run.py")]:
        with open(path) as f:
            text = f.read()
        for name in names:
            assert name not in text, (path, name)


def test_metrics_by_cell():
    bench = {"end_to_end": [
        {"name": "a", "moves": None, "workloads": ["x"]},
        {"name": "setup_s"}],
        "per_layer": [
            {"name": "p", "moves": "a", "workloads": ["x"]},
            {"name": "q", "moves": "a"},
            {"name": "r", "moves": "setup_s"},
            {"name": "s", "moves": "a", "workloads": ["y"]}]}
    names = lambda ms: [m["name"] for m in ms]  # noqa: E731
    assert names(catalog.metrics(bench, "x", False)) == ["a", "setup_s"]
    assert names(catalog.metrics(bench, "y", False)) == ["setup_s"]
    assert names(catalog.metrics(bench, "x", True)) == ["p", "q", "r"]
    assert names(catalog.metrics(bench, "y", True)) == ["r", "s"]


NEW_METRIC = '''"""Decode steps in the window (a test's new metric)."""


def read(run):
    return float(run.stats["decode_steps"])
'''


NEW_KIND = '''"""A closed loop of one fixed size (a test's new kind)."""

from harness.traffic import Turn


class Traffic:
    def __init__(self, mix, seed, seconds, vocab):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.turns = []

    def _turn(self, k, due):
        first = (self.seed + k) % self.vocab
        return Turn(f"f{k}", [first] + [k % self.vocab] * 23,
                    self.mix["output_tokens"], due, index=k)

    def warmup(self):
        return [self._turn(10**6, -1.0)]

    def poll(self, now, queued):
        new = []
        while queued + len(new) < self.mix["waiting"]:
            new.append(self._turn(len(self.turns), now))
            self.turns.append(new[-1])
        return new

    def next_due(self):
        return None

    def attempted(self, seconds):
        return sum(1 for t in self.turns if t.times), 0

    def finished(self, turn, now):
        pass
'''


def test_dropped_in_files_are_found(tmp_path):
    root, bench = tiny.make_root(tmp_path)
    with open(os.path.join(root, "metrics", "engine.decode_steps.py"),
              "w") as f:
        f.write(NEW_METRIC)
    # A new mix and a new cell over an existing configuration.
    mix = dict(tiny.SESSIONS, system_prompt_tokens=32, sizes_seed=77)
    with open(os.path.join(root, "traffic", "short.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "workloads", "tiny.short.json"), "w") as f:
        json.dump(tiny.CELL, f)
    bench["workloads"].append({"name": "tiny.short", "config": "tiny",
                               "traffic": "short", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "engine.decode_steps", "unit": "1",
                               "better": "higher", "source":
                               "program_counter", "layer": "engine",
                               "moves": "itl_p95_ms",
                               "workloads": ["tiny.short"]})
    for m in bench["end_to_end"]:
        if m["name"] == "itl_p95_ms":
            m["workloads"].append("tiny.short")
    result, _ = run_cell.run("tiny.short", 5, 2.0, True, "cpu",
                             time.perf_counter(), bench=bench, root=root)
    assert result["metrics"]["engine.decode_steps"]["value"] > 0
    assert "engine.hit_share" not in result["metrics"]
    result, _ = run_cell.run("tiny.short", 5, 2.0, False, "cpu",
                             time.perf_counter(), bench=bench, root=root)
    assert set(result["metrics"]) == {"itl_p95_ms", "setup_s"}
    # A new kind of traffic: its generator and a mix of it.
    with open(os.path.join(root, "traffic", "fixed.py"), "w") as f:
        f.write(NEW_KIND)
    with open(os.path.join(root, "traffic", "fixed-size.json"), "w") as f:
        json.dump({"kind": "fixed", "waiting": 2, "output_tokens": 5}, f)
    with open(os.path.join(root, "workloads", "tiny.fixed-size.json"),
              "w") as f:
        json.dump(tiny.CELL, f)
    bench["workloads"].append({"name": "tiny.fixed-size", "config": "tiny",
                               "traffic": "fixed-size", "chips": 1,
                               "why": "t"})
    for m in bench["end_to_end"]:
        if m["name"] == "tok_s":
            m["workloads"].append("tiny.fixed-size")
    result, _ = run_cell.run("tiny.fixed-size", 5, 2.0, False, "cpu",
                             time.perf_counter(), bench=bench, root=root)
    assert result["correct"] is True
    assert result["metrics"]["tok_s"]["value"] > 0
    assert set(result["metrics"]) == {"tok_s", "setup_s"}
