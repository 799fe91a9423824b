#!/usr/bin/env python3
"""Sweep the split plan's two constants (ops/paged_split.py: SPLIT_WAVES
and SPLIT_MIN_TOKENS) over chip_smoke.py's K2, K3 and K4 cases, on one
NVIDIA GPU.

    python3 tools/torch_split_sweep.py [--waves 1,2,4]
        [--min-tokens 64,128,256] [--decode 1,2,3] [--verify 0,1]
        [--decode-q 4,16] [--iters 20] [--rounds 2]

For every (waves, min tokens) pair the plan's constants are set, its
cache is cleared, and each picked case of phase 3's DECODE_CASES
(``--decode``, by index), phase 5's VERIFY_CASES (``--verify``) and phase
3b's DECODE_Q_CASES (``--decode-q``; none by default) is
launched once against its plain version (chip_smoke's tolerance) and
timed as device time (chip_smoke.graph_ms: --iters launches in one CUDA
graph). The pairs run --rounds times, in order and then reversed, so
that a drift of the card's clock falls on every pair alike. Prints one
line per case with its plan (CTAs, splits) and the mean ms of each pair,
then the card line and a JSON summary as the last line. Exits non-zero
if a pair fails a case's tolerance. The module's constants are restored
at the end; nothing is written.
"""

import argparse
import itertools
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def ints(text):
    return [int(x) for x in text.split(",") if x]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", default="1,2,4")
    ap.add_argument("--min-tokens", default="64,128,256")
    ap.add_argument("--decode", default="1,2,3,4,8,10,12")
    ap.add_argument("--verify", default="0,1,2,3,4,11")
    ap.add_argument("--decode-q", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    from infinistore_tpu_torch._device import disable_tf32
    from infinistore_tpu_torch.ops import _kernels, paged_split
    from infinistore_tpu_torch.ops import paged_attention as pa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops import paged_flash_decode_q as pq
    from infinistore_tpu_torch.ops import paged_flash_verify as pv

    disable_tf32()
    cs = chip_smoke
    pairs = list(itertools.product(ints(args.waves), ints(args.min_tokens)))
    saved = paged_split.SPLIT_WAVES, paged_split.SPLIT_MIN_TOKENS
    sms = _kernels.sm_count(torch.device("cuda", 0))

    # (name, inputs, m, window, dtype, kernel, plain)
    picked = []
    for i in ints(args.decode):
        c = cs.DECODE_CASES[i]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + i)
        picked.append((f"decode {i} {c.label} {c.dtype} w{c.window}",
                       cs.decode_args(torch, c, gen), 1, c.window, c.dtype,
                       pd.paged_flash_decode, pa.paged_decode_attention))
    for i in ints(args.verify):
        c = cs.VERIFY_CASES[i]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + i)
        picked.append((f"verify {i} {c[0]} {c[1]} m{c[3]} w{c[4]}",
                       cs.verify_args(torch, c, gen), c[3], c[4], c[1],
                       pv.paged_flash_verify,
                       pa.multi_token_paged_attention))
    for i in ints(args.decode_q):
        c = cs.DECODE_Q_CASES[i]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + i)
        args_q = cs.decode_q_args(torch, c, gen)
        # The plan reads q, the pages (k_q) and the table.
        picked.append((f"decode_q {i} {c[0]} {c[1]} w{c[3]}", args_q, 1,
                       c[3], c[1], pq.paged_flash_decode_quantized,
                       pq.paged_decode_quantized_plain))

    times = {(name, p): [] for name, *_ in picked for p in pairs}
    plans, ok, worst = {}, True, {}
    try:
        for r in range(args.rounds):
            for waves, min_tokens in (pairs if r % 2 == 0
                                      else list(reversed(pairs))):
                paged_split.SPLIT_WAVES = waves
                paged_split.SPLIT_MIN_TOKENS = min_tokens
                paged_split.split_plan.cache_clear()
                for name, a, m, win, dt, kern, plain in picked:
                    def run():
                        return kern(*a, window=win)

                    key = (name, (waves, min_tokens))
                    if r == 0:
                        rel = cs.rel_err(run(), plain(*a, window=win))
                        worst[key] = rel
                        ok = ok and rel <= cs.TOL_REL[dt]
                        q, kp, table = a[0], a[1], a[-2]
                        n_kv = kp.shape[2]
                        plan = paged_split.plan_of(q, kp, table, win, m,
                                                   sms)
                        plans[key] = (plan.n_splits * plan.row_tiles * n_kv
                                      * q.shape[0], plan.n_splits)
                    times[key].append(cs.graph_ms(torch, run, args.iters))
    finally:
        paged_split.SPLIT_WAVES, paged_split.SPLIT_MIN_TOKENS = saved
        paged_split.split_plan.cache_clear()

    summary = []
    for name, *_ in picked:
        cells = []
        for p in pairs:
            ms = statistics.mean(times[(name, p)])
            ctas, splits = plans[(name, p)]
            cells.append(f"w{p[0]}/t{p[1]} {ms:.4f} ({ctas} CTAs, "
                         f"{splits} splits)")
            summary.append(dict(case=name, waves=p[0], min_tokens=p[1],
                                ms=ms, runs_ms=times[(name, p)], ctas=ctas,
                                n_splits=splits,
                                rel_err=worst[(name, p)]))
        print(f"{name}: " + "; ".join(cells), flush=True)
    print(f"constants in ops/paged_split.py: SPLIT_WAVES {saved[0]}, "
          f"SPLIT_MIN_TOKENS {saved[1]}")
    print(chip_smoke.card_line())
    print(json.dumps({"ok": ok, "cases": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
