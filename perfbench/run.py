"""The benchmark of infinistore_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the repository's root, on a machine with a CUDA card. It draws
the weights and the traffic from ``--seed``, builds the cell's serving
engine over an in-process store, warms it up, serves the traffic for
``--seconds`` seconds, checks a sample of the served tokens against the
plain reference, and prints one JSON line last: the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics (``--trace 1``). The
numbers compared are also the last lines on standard error. It exits
non-zero, printing no result, without a card, when JAX or the JAX
package is loaded, or when anything fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # A library the port uses must not pull JAX in on its own.
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # PyTorch's compiler caches, should anything reach them, go inside
    # the checkout at fixed paths, not to /tmp/<name>.
    cache = os.path.join(REPO, ".pbcache")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # One process with few threads: the host's cores are the store
    # server's and the engine loop's, not an idle thread pool's.
    os.environ["OMP_NUM_THREADS"] = "1"
    for path in (HERE, REPO):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import catalog, run_cell

    torch.set_num_threads(1)

    bench = catalog.benchmark(REPO)
    chips = catalog.workload(bench, args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    try:
        result, lines = run_cell.run(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda:0", T_START,
                                     bench=bench)
    except run_cell.ForbiddenModule as e:
        print(f"forbidden module: {e}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
