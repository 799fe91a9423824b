"""Host time inside admissions (the program's span engine.admit: probe,
restore, prefill; ServingEngine.stats) over the window, %."""


def read(run):
    if not run.stats.get("admit_n"):
        return None
    return 100.0 * run.stats["admit_ns"] / (run.seconds * 1e9)
