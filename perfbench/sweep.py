"""The knee of a cell's open loop (run on the card): the cell at each of
several session rates, one window each, in one process.

    python3 perfbench/sweep.py --workload <cell> --rates 0.3,0.5,0.7
        [--seconds 50] [--seed N] [--out FILE]

Prints one JSON line per rate: the end-to-end metrics, the turns due and
unanswered, how long the drain took, and the waiting queue over the
window (its mean in each third and at the end). The knee is the highest
rate whose queue does not grow over the window.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import run_cell  # noqa: E402


def queue_summary(weights, g, record, routes_of):
    series = [q for t, q in record.queue if t < record.seconds]
    third = max(1, len(series) // 3)
    mean = lambda xs: sum(xs) / len(xs) if xs else None  # noqa: E731
    return {"queue_thirds": [mean(series[:third]),
                             mean(series[third:2 * third]),
                             mean(series[2 * third:])],
            "queue_end": series[-1] if series else None,
            "queue_max": max(series, default=None),
            "steps": len(series)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=7001)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        result, _ = run_cell.run(
            args.workload, args.seed + i, args.seconds, False, "cuda:0",
            time.perf_counter(), overrides={"session_rate_per_s": rate},
            after=queue_summary)
        line = json.dumps({"rate": rate, "metrics": result["metrics"],
                           "attempted": result["attempted"],
                           "failed": result["failed"],
                           "correct": result["correct"],
                           "queue": result["after"],
                           "traffic": result["traffic"],
                           "check": result["check"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
