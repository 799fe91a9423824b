"""Bytes the engine offloaded over the time inside its offloads (the
program's span engine.offload: gather, put, sync; ServingEngine.stats),
GB/s."""


def read(run):
    if not run.stats.get("offload_n"):
        return None
    return run.stats["offload_bytes"] / run.stats["offload_ns"]
