"""Share of the offloads' time spent gathering the pages on the card and
staging them to host memory (the program's spans engine.offload.gather
and store.stage over engine.offload; ServingEngine.stats), %."""


def read(run):
    if not run.stats.get("offload_n"):
        return None
    staged = run.stats["offload_gather_ns"] + run.stats["store_stage_ns"]
    return 100.0 * staged / run.stats["offload_ns"]
