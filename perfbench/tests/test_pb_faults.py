"""The check catches a broken timed path: each run skips the look for a
card and drives the rest of a run at a tiny size on the CPU, with one
fault planted in the program underneath, and ``correct`` comes out
false; the same run without a fault comes out true."""

import time

import pytest
import torch

import control
import tiny
from harness import run_cell
from infinistore_tpu_torch import cuda as tcuda
from infinistore_tpu_torch import serving
from infinistore_tpu_torch.models import llama
from infinistore_tpu_torch.models import moe as pmoe


def token_altered(monkeypatch):
    """Every fourth token the engine hands over is another one."""
    emit = serving.ServingEngine._emit
    count = [0]

    def altered(self, slot, tokens):
        out = []
        for t in tokens:
            count[0] += 1
            out.append((t + 1) % self.cfg.vocab_size
                       if count[0] % 4 == 0 else t)
        return emit(self, slot, out)

    monkeypatch.setattr(serving.ServingEngine, "_emit", altered)


def state_unchanged(monkeypatch):
    """A decode step leaves the KV pages as they were."""
    monkeypatch.setattr(llama, "scatter_rows",
                        lambda pages, new, entries, rows: pages)


def half_batch(monkeypatch):
    """A decode step computes the first half of its live rows and hands
    the other half the first live row's logits."""
    step = llama.decode_step

    def half(params, cfg, token, seq_lens, *args, **kw):
        logits, kp, vp = step(params, cfg, token, seq_lens, *args, **kw)
        live = torch.nonzero(seq_lens > 0)[:, 0]
        logits = logits.clone()
        logits[live[len(live) // 2:]] = logits[live[:1]]
        return logits, kp, vp

    monkeypatch.setattr(llama, "decode_step", half)


def restore_zeroed(monkeypatch):
    """Pages read back from the store are zeros."""
    get = tcuda.CudaKVStore.get_kv_pages
    monkeypatch.setattr(tcuda.CudaKVStore, "get_kv_pages",
                        lambda self, *a, **k: torch.zeros_like(
                            get(self, *a, **k)))


def routing_altered(monkeypatch):
    """Every token goes to the experts next to the ones its router
    chose (the reference follows the choices; their margin shows)."""
    route = pmoe._route

    def altered(layer, h, cfg, valid=None, choice=None, par=None):
        r = route(layer, h, cfg, valid, choice, par)
        return route(layer, h, cfg, valid, (r.expert + 1) % cfg.n_experts,
                     par)

    monkeypatch.setattr(pmoe, "_route", altered)


def routing_partly_altered(monkeypatch):
    """One token in 25 of the middle layer goes to the experts next to
    the ones its router chose (``control.partial_misroute``): the mean
    over every layer dilutes it, the worst layer's mean does not."""
    route = pmoe._route

    def hook(weights, module, cfg):
        monkeypatch.setattr(pmoe, "_route",
                            control.partial_misroute(route, weights))
        return weights

    return hook


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed, params_hook=None):
    path, bench = root
    result, _ = run_cell.run(cell, seed, 2.5, False, "cpu",
                             time.perf_counter(), bench=bench, root=path,
                             params_hook=params_hook)
    return result


@pytest.mark.parametrize("cell", ["tiny.sessions", "tiny-moe.backlog"])
def test_sound_run_is_correct(root, cell):
    assert _run(root, cell, 31)["correct"] is True


@pytest.mark.parametrize("cell,fault", [
    ("tiny.sessions", token_altered), ("tiny.sessions", state_unchanged),
    ("tiny.sessions", half_batch), ("tiny.sessions", restore_zeroed),
    ("tiny-moe.backlog", token_altered), ("tiny-moe.backlog", state_unchanged),
    ("tiny-moe.backlog", half_batch), ("tiny-moe.backlog", routing_altered)])
def test_fault_is_caught(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = _run(root, cell, 31)
    assert result["correct"] is False, result["check"]
    assert any(c["value"] > c["limit"] for c in result["check"].values())


def test_partial_misroute_is_caught_in_its_layer(root, monkeypatch):
    result = _run(root, "tiny-moe.backlog", 31,
                  routing_partly_altered(monkeypatch))
    check = result["check"]
    assert result["correct"] is False, check
    layer = check["route_margin_layer"]
    assert layer["value"] > layer["limit"]
    mean = check["route_margin_mean"]
    assert mean["value"] <= mean["limit"]
