"""Decode steps replayed as one CUDA graph (the program's counter
decode_graph_replays, ServingEngine.stats) over the window's decode steps
(decode_steps), %. A program without the counter reports nothing."""


def read(run):
    replays = run.stats.get("decode_graph_replays")
    steps = run.stats.get("decode_steps")
    if replays is None or not steps:
        return None
    return 100.0 * replays / steps
