"""Offloads handed to the engine's write-behind thread (the program's
counter offload_behind_n, ServingEngine.stats) over the window's
offloads (offload_n), %. A program without the counter reports
nothing."""


def read(run):
    behind = run.stats.get("offload_behind_n")
    offloads = run.stats.get("offload_n")
    if behind is None or not offloads:
        return None
    return 100.0 * behind / offloads
