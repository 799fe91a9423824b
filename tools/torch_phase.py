#!/usr/bin/env python3
"""Run one of chip_smoke.py's longer phases alone on one NVIDIA GPU:
build the store library and the kernels, then the phase as the whole
script runs it.

    python3 tools/torch_phase.py PHASE [--readings]

PHASE is one of:

- ``kv_write``: phase 3c, the decode graph's KV write against its plain
  version, byte for byte, and its time.
- ``serving``: phase 6, serving at Llama-3.1-8B width (two engines
  replaying decode graphs, the HTTP front end) and the decode graph
  against the eager step, on the bf16 model made from the script's
  seed.
- ``moe``: phase 6c, the MoE family at Mixtral-8x7B width, and its
  training step.
- ``sharded``: phase 6d, the sharded store tier at Llama-3.1-8B width,
  on the bf16 model made from the script's seed (phase 4's SHM numbers,
  which it prints beside its own, read 0 here).
- ``tp``: phase 10, tensor parallel: (a) K2 / K4 on tp head slices in
  this process; (b)-(d) two ranks in processes of their own,
  time-sharing the card over gloo (the tp = 2 engine at Llama-3.1-8B
  width, its f32 token parity, an FSDP training step).
- ``parallel``: phase 11, the parallel set: two ranks time-sharing the
  card over gloo run (a) ring attention over sp = 2, (b) GPipe over
  pp = 2, (c) expert parallelism at Mixtral-8x7B width and (d) the
  device KV pool with its store tiering; then (e) the multi-rank dry
  run.
- ``mesh``: phase 12, int8 and MoE on a mesh: the single-process
  Mixtral reference of (c), then two ranks time-sharing the card over
  gloo ((a) Llama-3.1-8B with int8 weights at tp = 2; (b) Mixtral width
  at tp = 2; (c) Mixtral width at ep = 2; (d) the float32 engines and
  the MoE tp training step), then the checks that need one process's
  tree.
- ``bwd``: phase 8, the flash backward kernels (K1 with lse, K5 and
  K6) against their plain versions at every BWD_CASES shape, with the
  hd-256 rows timed beside one SDPA backward.
- ``gemma``: phase 13, Gemma-1 at head dim 256: phase 4's main path at
  google/gemma-7b's widths, then 2 training steps at google/gemma-2b's
  widths and their kernel-vs-plain grads.

With ``--readings`` a failed check in this process prints
``READING-ONLY FAIL: ...`` and the phase goes on, so that one call
reads every number; the exit code is then 1 if any check failed (a
check inside a rank still stops the ranks). Prints the phase's lines,
its JSON report (``<label>: {...}``) and the card line.
"""

import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _moe(cs, torch, np, report):
    cs.phase_moe(torch, np, report)
    gc.collect()
    torch.cuda.empty_cache()
    cs.phase_moe_train(torch, np, report)


def _kv_write(cs, torch, np, report):
    from infinistore_tpu_torch.ops import paged_kv_write
    report.update(cs.phase_kv_write(torch, paged_kv_write))


def _serving(cs, torch, np, report):
    from infinistore_tpu_torch.models import llama
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(cs.SEED),
        llama.LLAMA31_8B, "cuda")
    cs.phase_serving(torch, np, params, report)


def _sharded(cs, torch, np, report):
    from infinistore_tpu_torch.models import llama
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(cs.SEED),
        llama.LLAMA31_8B, "cuda")
    cs.phase_sharded(torch, np, params, {}, report)


def _tp(cs, torch, np, report):
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_decode_q as pq
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cs.phase_tp(torch, np, pd, pq, gen, report)


def _bwd(cs, torch, np, report):
    from infinistore_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    report.update(cs.phase_bwd(torch, fa, gen))


# name: (chip_smoke's phase number, the report's label, the runner)
PHASES = {
    "kv_write": ("3c", "kv write", _kv_write),
    "serving": ("6", "serving", _serving),
    "moe": ("6c", "moe", _moe),
    "sharded": ("6d", "sharded", _sharded),
    "tp": ("10", "tensor parallel", _tp),
    "parallel": ("11", "parallel set",
                 lambda cs, torch, np, report: cs.phase_parallel(
                     torch, np, report)),
    "mesh": ("12", "mesh",
             lambda cs, torch, np, report: cs.phase_mesh(torch, np, report)),
    "bwd": ("8", "flash backward", _bwd),
    "gemma": ("13", "gemma",
              lambda cs, torch, np, report: cs.phase_gemma(torch, np,
                                                           report)),
}


def main():
    names = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(names) != 1 or names[0] not in PHASES:
        print(f"usage: torch_phase.py {{{','.join(PHASES)}}} [--readings]")
        return 2
    number, label, run = PHASES[names[0]]

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
        run(cs, torch, np, report)
    except cs.SmokeError as e:
        print(f"FAIL: {e}")
        return 1
    print(f"phase {number}: {time.perf_counter() - t0:.1f} s")
    print(f"{label}: " + json.dumps(report))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
