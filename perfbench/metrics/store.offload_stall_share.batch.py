"""The step's own time in the engine's offloads (the program's span
engine.offload, counted as offload_step: keys, gather, staging, handing
over to the write-behind thread and any wait for room, or, synchronous,
the put and the ack; ServingEngine.stats) over the window, %. A program
without the counter reports nothing."""


def read(run):
    if not run.stats.get("offload_step_n"):
        return None
    return 100.0 * run.stats["offload_step_ns"] / (run.seconds * 1e9)
