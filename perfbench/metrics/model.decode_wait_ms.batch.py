"""Host time the engine spends blocked on a decode call's next tokens
until the card has finished (the program's span engine.decode.wait,
ServingEngine.stats), ms per decode call."""


def read(run):
    n = run.stats.get("decode_wait_n")
    return run.stats["decode_wait_ns"] / n / 1e6 if n else None
