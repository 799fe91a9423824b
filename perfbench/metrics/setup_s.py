"""Process start to the window's start: building, weights, the store,
the engine and warming up."""


def read(run):
    return run.setup_s
