"""Everything a cell is made of, found by the names in
``BENCHMARK.json``: nothing here names a configuration, a mix, a cell
or a metric.

- ``configs/<config>.json``: the configuration, and
  ``families/<family>.py`` the model family its ``family`` key names
  (``harness.model``), with the reference ``reference/<name>.py`` that
  family reads;
- ``traffic/<traffic>.json``: the mix, and ``traffic/<kind>.py`` the
  generator its ``kind`` names (``harness.traffic``);
- ``workloads/<cell>.json``: the cell's engine and store sizes, its
  overrides of the mix, its correctness limits;
- ``metrics/<metric>.py``: a metric's reader, ``read(run)`` returning a
  number or None (``harness.record.Run`` says what ``run`` holds).
"""

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(repo=REPO):
    return _json(repo, "BENCHMARK.json")


def workload(bench, name):
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell(name, root=ROOT):
    return _json(root, "workloads", f"{name}.json")


def config(name, root=ROOT):
    return _json(root, "configs", f"{name}.json")


def traffic(name, root=ROOT):
    return _json(root, "traffic", f"{name}.json")


def metrics(bench, name, trace):
    """The metrics a run of cell ``name`` reports: its end-to-end ones
    with ``trace`` 0, its per-layer ones with ``trace`` 1. A metric with
    a ``workloads`` list belongs to those cells; one without, to every
    cell that reports the end-to-end metric it moves."""
    def mine(m):
        return name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if mine(m) or ("workloads" not in m and m["moves"] in moved)]


def _module(root, folder, name):
    path = os.path.join(root, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(name, root=ROOT):
    """The module ``families/<name>.py`` (what it defines is in
    ``harness/model.py``)."""
    return _module(root, "families", name)


def reference(name, root=ROOT):
    """The module ``reference/<name>.py``: a plain reference."""
    return _module(root, "reference", name)


def reader(metric, root=ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module(root, "metrics", metric).read


def generator(kind, root=ROOT):
    """The ``Traffic`` class of ``traffic/<kind>.py``."""
    return _module(root, "traffic", kind).Traffic
