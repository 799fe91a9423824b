"""Readings that set a cell's correctness limits (run on the card).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
        [--seconds 20] [--program-int8] [--misroute] [--out FILE]

For each seed, one run of the cell (its traffic, its sizes, a window of
``--seconds``) whose check reads, on the same sample of served tokens:

- ``sound``: the program's served tokens under the plain reference:
  the widest gap, the mean gap, the share off the reference's best and,
  for a routed model, the routing margins (``harness.judge``);
- ``reference_int8``: the same readings of the tokens that the
  reference puts first when its weights are rounded to int8 (one scale
  per output column), the control one precision below the
  configuration's bf16; for a routed model, following the program's
  routing, whose margins it reads under int8.

With ``--program-int8`` each seed also runs the program itself with its
own weight-only int8 path switched on (``llama.quantize_params``); with
``--misroute``, the program with :func:`partial_misroute` planted. Each
of those reads the cell's own check. One JSON line per seed and run goes
to standard output (and to ``--out``).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import judge, run_cell  # noqa: E402
from infinistore_tpu_torch.models import moe  # noqa: E402

# The partial misroute: one token in EVERY, at the middle routed layer.
EVERY = 25


def partial_misroute(route, weights):
    """The routing function ``route`` (the program's ``moe._route``)
    with a fault of a few percent in one layer: at the middle layer of
    ``weights``, one token in ``EVERY`` of each call (a row that moves
    from call to call) goes to the experts next to the ones its router
    chose. The reference follows the choices, so only the routing
    margins can show it."""
    layer_of = {layer["router"].data_ptr(): i
                for i, layer in enumerate(weights["layers"])}
    target = len(weights["layers"]) // 2
    calls = [0]

    def misrouted(layer, h, cfg, valid=None, choice=None, par=None):
        r = route(layer, h, cfg, valid, choice, par)
        if layer_of.get(layer["router"].data_ptr()) != target:
            return r
        calls[0] += 1
        rows = (torch.arange(h.shape[0], device=h.device)
                + calls[0]) % EVERY == 0
        moved = torch.where(rows[:, None], (r.expert + 1) % cfg.n_experts,
                            r.expert)
        return route(layer, h, cfg, valid, moved, par)

    return misrouted


def reference_int8(weights, g, record, routes_of, seed):
    picked = judge.sample(record.turns, seed, judge.SAMPLE_TOKENS, routes_of)
    served, control, margins = judge.gaps(weights, g, picked, "int8",
                                          routes_of)
    return {"sound": judge.summary(served, [m[0] for m in margins]),
            "reference_int8": judge.summary(control,
                                            [m[1] for m in margins]),
            "tokens": sum(len(t.tokens) for t in picked)}


def quantized(weights, module, cfg):
    return module.quantize_params(weights, cfg)


def misrouted(weights, module, cfg):
    """The drawn tree, served with :func:`partial_misroute` planted in
    ``module`` (``main`` puts the router back after the run)."""
    module._route = partial_misroute(module._route, weights)
    return weights


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--program-int8", action="store_true")
    ap.add_argument("--misroute", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        runs = [("sound", None, lambda w, g, r, ro, seed=seed: reference_int8(
            w, g, r, ro, seed))]
        if args.program_int8:
            runs.append(("program_int8", quantized, None))
        if args.misroute:
            runs.append(("misroute", misrouted, None))
        for kind, hook, after in runs:
            route = moe._route
            try:
                result, _ = run_cell.run(
                    args.workload, seed, args.seconds, False, "cuda:0",
                    time.perf_counter(), params_hook=hook, after=after)
            finally:
                moe._route = route
            line = json.dumps({"seed": seed, "run": kind,
                               "check": result["check"],
                               "correct": result["correct"],
                               "after": result.get("after"),
                               "metrics": result["metrics"],
                               "traffic": result["traffic"],
                               "peak": result["device"]["memory_peak_bytes"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
