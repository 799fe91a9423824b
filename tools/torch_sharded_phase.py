#!/usr/bin/env python3
"""Run chip_smoke.py's phase 6d (the sharded store tier at Llama-3.1-8B
width) alone on one NVIDIA GPU: build the store library and the kernels,
make the bf16 model from the script's seed, then the phase as the whole
script runs it (phase 4's SHM numbers, which it prints beside its own,
read 0 here).

    python3 tools/torch_sharded_phase.py [--readings]

With ``--readings`` a failed check prints ``READING-ONLY FAIL: ...`` and
the phase goes on, so that one call reads every number; the exit code is
then 1 if any check failed. Prints the phase's lines, its JSON report
(``sharded: {...}``) and the card line.
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
    from infinistore_tpu_torch.models import llama
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
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(cs.SEED),
        llama.LLAMA31_8B, "cuda")
    report = {}
    t0 = time.perf_counter()
    try:
        cs.phase_sharded(torch, np, params, {}, report)
    except cs.SmokeError as e:
        print(f"FAIL: {e}")
        return 1
    print(f"phase 6d: {time.perf_counter() - t0:.1f} s")
    print("sharded: " + json.dumps(report))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
