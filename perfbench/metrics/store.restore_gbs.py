"""Bytes the engine's page reads returned over the wall time inside
get_kv_pages (which returns once the pages are on the card), GB/s."""


def read(run):
    secs, nbytes, count = run.window_calls(run.gets)
    return nbytes / secs / 1e9 if count and secs > 0 else None
