#!/usr/bin/env python3
"""Run chip_smoke.py's phase 11 (the parallel set) alone on one NVIDIA
GPU: build the store library and the kernels, then the phase as the
whole script runs it: two ranks in processes of their own, time-sharing
the card over gloo, run (a) ring attention over sp = 2, (b) GPipe over
pp = 2, (c) expert parallelism at Mixtral-8x7B width and (d) the device
KV pool with its store tiering; then (e) the multi-rank dry run.

    python3 tools/torch_parallel_phase.py [--readings]

With ``--readings`` a failed check in this process prints
``READING-ONLY FAIL: ...`` and the phase goes on, so that one call
reads every number; the exit code is then 1 if any check failed.
Prints the phase's lines, its JSON report (``parallel set: {...}``) and
the card line.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from infinistore_tpu_torch import _native
    from infinistore_tpu_torch._device import disable_tf32
    from infinistore_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        print("FAIL: no GPU")
        return 1
    failed = []
    if "--readings" in sys.argv:
        def check(cond, msg):
            if not cond:
                failed.append(msg)
                print(f"READING-ONLY FAIL: {msg}", flush=True)
        cs.check = check
    card = cs.card_line()
    disable_tf32()
    cs.build_all(_native, _kernels)
    report = {}
    t0 = time.perf_counter()
    try:
        cs.phase_parallel(torch, np, report)
    except cs.SmokeError as e:
        print(f"FAIL: {e}")
        return 1
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    print("parallel set: " + json.dumps(report))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
