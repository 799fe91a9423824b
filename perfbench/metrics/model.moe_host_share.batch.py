"""Host time issuing the routed block (the program's spans moe.route and
moe.experts, ServingEngine.stats) over the host time inside the engine's
steps (step_ns), %. A program without those spans reports nothing."""


def read(run):
    if not run.stats.get("moe_route_n") or not run.stats.get("step_ns"):
        return None
    issued = run.stats["moe_route_ns"] + run.stats["moe_experts_ns"]
    return 100.0 * issued / run.stats["step_ns"]
