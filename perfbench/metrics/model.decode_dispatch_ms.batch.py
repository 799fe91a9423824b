"""Host time the engine spends queueing a decode call's kernels (the
program's span engine.decode.dispatch, ServingEngine.stats), ms per
decode call (one step or one burst)."""


def read(run):
    n = run.stats.get("decode_dispatch_n")
    return run.stats["decode_dispatch_ns"] / n / 1e6 if n else None
