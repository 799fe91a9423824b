"""Start the ranks of a multi-process program on this host.

Nothing tells a program of a cluster here: :func:`run_ranks` spawns one
process per rank, joins them with ``mesh.init_process_group`` at a free
``localhost`` port, runs the same function on every rank and collects
what each returns. A rank that fails, or dies, stops every rank.
"""

import faulthandler
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import init_process_group


def free_port():
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, device, backend, work, results):
    faulthandler.enable()  # a rank that crashes prints its stack
    try:
        fn, args = work.get()
        if str(device) == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dev = init_process_group(rank, world_size, port, device, backend)
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size, args=(), device="cuda", backend=None,
              timeout=600.0):
    """Run ``fn(rank, device, *args)`` in ``world_size`` spawned
    processes joined into one process group (``device`` and ``backend``
    as ``mesh.init_process_group`` takes them; ``fn`` importable by
    name, its arguments and result picklable). Returns the results in
    rank order. Raises with the rank's traceback if a rank fails, and
    if the ranks take longer than ``timeout`` seconds; either way every
    process is stopped before this returns."""
    ctx = multiprocessing.get_context("spawn")
    work, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, device, backend, work,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    # The function and its arguments go through a queue, not the start
    # pipe: a start whose pickle outgrows the pipe waits for the child to
    # import everything, and the ranks would start one after another.
    for _ in procs:
        work.put((fn, args))
    done = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in done]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks took longer "
                                       f"than {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            done[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(done) == world_size else 0)
            if p.is_alive():
                p.terminate()
                p.join()
    return [done[r] for r in range(world_size)]
