"""The rest of the port's store surface against the port's server:
``warmup.warm_up`` (reference ``infinistore_tpu/warmup.py``), the server's
``--warmup`` flag (``infinistore_tpu/server.py:1705``, ``:1790``),
``benchmark.run`` / ``main`` (``infinistore_tpu/benchmark.py``; its JSON
keys held to the JAX package's own ``benchmark`` run in a subprocess on
the port's store library, on SHM and STREAM) and the example clients
(``infinistore_tpu/example/client.py``, ``client_async.py``), run with
``--device cpu`` as ``tests/test_examples.py`` runs the JAX examples.
Tolerances: bytes exact; keys equal."""

import asyncio
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from infinistore_tpu_torch import (InfiniStoreServer, ServerConfig,
                                   TYPE_SHM, TYPE_STREAM, _native)
from infinistore_tpu_torch import benchmark, warmup
from infinistore_tpu_torch.example import client, client_async

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_server():
    srv = InfiniStoreServer(ServerConfig(
        service_port=0, prealloc_size=0.0625, minimal_allocate_size=16))
    srv.start()
    yield srv
    srv.stop()


def _op_counts(srv):
    return {k: v.get("count", 0)
            for k, v in (srv.stats().get("op_stats") or {}).items()}


# ---- warmup --------------------------------------------------------------


def test_warm_up_round_trips_on_the_host(port_server):
    before = _op_counts(port_server)
    n = port_server.kvmap_len()
    assert warmup.warm_up(port_server.service_port, size_kb=64) is True
    after = _op_counts(port_server)
    assert after.get("ALLOCATE", 0) > before.get("ALLOCATE", 0)
    assert after.get("DELETE", 0) > before.get("DELETE", 0)
    assert port_server.kvmap_len() == n  # its key is gone again


def test_warm_up_prime_cuda_raises_without_a_gpu(port_server, monkeypatch):
    """--prime-cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        warmup.warm_up(port_server.service_port, size_kb=4, prime_cuda=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        warmup.main(["--service-port", str(port_server.service_port),
                     "--size-kb", "4", "--prime-cuda"])


def test_warmup_main_returns_zero(port_server):
    assert warmup.main(["--service-port", str(port_server.service_port),
                        "--size-kb", "16"]) == 0


def test_server_warmup_flag_starts_the_warmup(tmp_path):
    """``python -m infinistore_tpu_torch.server --warmup`` spawns
    ``python -m infinistore_tpu_torch.warmup`` against itself: its
    round trip shows in the server's op counters."""
    pf = tmp_path / "ports.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.server",
         "--service-port", "0", "--manage-port", "0", "--warmup",
         "--port-file", str(pf), "--prealloc-size", "0.03125",
         "--minimal-allocate-size", "16", "--log-level", "error",
         "--no-oom-protect", "--no-slo"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 90
        counts = {}
        while time.monotonic() < deadline:
            assert proc.poll() is None, "server exited"
            if pf.exists():
                ports = json.loads(pf.read_text())
                stats = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{ports['manage_port']}/stats",
                    timeout=10).read())
                counts = {k: v.get("count", 0)
                          for k, v in stats["op_stats"].items()}
                if counts.get("DELETE", 0) >= 1:
                    break
            time.sleep(0.2)
        assert counts.get("ALLOCATE", 0) >= 1, counts
        assert counts.get("DELETE", 0) >= 1, counts
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.poll() is not None


# ---- benchmark -----------------------------------------------------------

BENCH = dict(size_mb=2, block_size_kb=4, steps=8)


@pytest.mark.parametrize("path,ctype", [("shm", TYPE_SHM),
                                        ("stream", TYPE_STREAM)])
def test_benchmark_keys_equal_the_jax_benchmarks(port_server, path, ctype):
    port = benchmark.run(service_port=port_server.service_port,
                         connection_type=ctype, **BENCH)
    env = dict(os.environ)
    env["INFINISTORE_TPU_NATIVE_LIB"] = _native.build_native()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "infinistore_tpu.benchmark",
         "--service-port", str(port_server.service_port),
         "--size", str(BENCH["size_mb"]),
         "--block-size", str(BENCH["block_size_kb"]),
         "--steps", str(BENCH["steps"]), "--path", path, "--json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(port) == set(ref)
    for k in ("path", "size_mb", "block_size_kb", "steps", "iters"):
        assert port[k] == ref[k], k
    assert port["path"] == path.upper()
    for k in ("put_GBps", "get_GBps", "p50_read_latency_us"):
        assert port[k] > 0


def test_benchmark_main_prints_json(port_server, capsys):
    assert benchmark.main(
        ["--service-port", str(port_server.service_port), "--size", "1",
         "--block-size", "4", "--steps", "4", "--path", "stream",
         "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["path"] == "STREAM" and out["size_mb"] == 1


def test_benchmark_detects_corrupt_reads(port_server, monkeypatch):
    """The data-equality check bites: a read that returns other bytes
    fails the run."""
    from infinistore_tpu_torch import lib

    real = lib.InfinityConnection.read_cache

    def corrupt(self, cache, blocks, page_size):
        # Each offset gets its neighbour key's bytes.
        keys = [k for k, _ in blocks]
        shifted = list(zip(keys[1:] + keys[:1], [o for _, o in blocks]))
        return real(self, cache, shifted, page_size)

    monkeypatch.setattr(lib.InfinityConnection, "read_cache", corrupt)
    with pytest.raises(RuntimeError, match="verification"):
        benchmark.run(service_port=port_server.service_port,
                      connection_type=TYPE_STREAM, **BENCH)


# ---- example clients -----------------------------------------------------


@pytest.mark.parametrize("ctype", [TYPE_SHM, TYPE_STREAM])
def test_example_client_runs_on_cpu(port_server, capsys, ctype):
    client.run("127.0.0.1", port_server.service_port, ctype, device="cpu")
    out = capsys.readouterr().out
    assert f"path={'SHM' if ctype == TYPE_SHM else 'STREAM'}" in out
    assert "device array round-trip OK (cpu)" in out


def test_example_client_fails_without_its_device(port_server, monkeypatch):
    """The device round trip is not skipped: on ``cuda`` without a GPU
    the example fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        client.run("127.0.0.1", port_server.service_port, TYPE_STREAM)


def test_example_client_async_runs(port_server, capsys):
    asyncio.run(client_async.run("127.0.0.1", port_server.service_port))
    out = capsys.readouterr().out
    assert "wrote 8 layers concurrently" in out
    assert "verified all layers" in out
