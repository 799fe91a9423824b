"""Share of the window's prompt tokens served from the store:
prefix-hit pages times the page over those plus the tokens prefilled
(ServingEngine.stats)."""


def read(run):
    hit = run.stats["prefix_hit_pages"] * run.geometry["page"]
    total = hit + run.stats["prefill_tokens"]
    return 100.0 * hit / total if total else None
