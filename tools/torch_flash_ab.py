#!/usr/bin/env python3
"""Time the attention kernels of this checkout against other checkouts',
in turns, on one NVIDIA GPU: the prefill kernel (K1), the backward kernels
(K5 and K6), the paged decode kernel (K2), the paged verify kernel (K3)
or the int8 paged decode kernel (K4).

    python3 tools/torch_flash_ab.py OTHER_ROOT [OTHER_ROOT ...]
        [--kernel prefill|bwd|decode|verify|decode_q] [--iters 20]
        [--rounds 2] [--cases 0,1] [--timing eager|graph]

Each OTHER_ROOT is a checkout of the repository (for example an earlier
commit unpacked with ``git archive`` under the git-ignored
``.archive_check/``), named by its directory's name; this checkout is
"this". Each build is timed in a process of its own that imports that
checkout's package (so the builds may differ in their C entry points),
builds its kernels into its own ``_build/`` and times this checkout's
chip_smoke.py cases on inputs made from the same seed: with ``--kernel
prefill`` phase 2's FLASH_CASES, ``bwd`` phase 8's BWD_CASES (K5 and K6
each timed alone), ``decode`` phase 3's DECODE_CASES, ``verify`` phase
5's VERIFY_CASES, ``decode_q`` phase 3b's DECODE_Q_CASES (or those whose
indices --cases lists). Prefill and the backward are timed with CUDA
events over --iters launches (chip_smoke.cuda_ms: eager, the host's time
per call included); decode, verify and decode_q as device time
(chip_smoke.graph_ms: --iters launches in one CUDA graph), since their
kernels are shorter than the host's time per call. ``--timing`` picks
either for decode, verify and decode_q.
Each case is held to the build's own plain version; a build that
refuses a shape reads "refused". The processes run --rounds times in the
order others, this, this, others reversed. Prints one line per case with
each build's mean kernel ms and relative error, then the card line and a
JSON summary as the last line. Exits non-zero if a build fails a case's
tolerance.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

KERNELS = ("prefill", "bwd", "decode", "verify", "decode_q")


def cases(kernel):
    return {"prefill": chip_smoke.FLASH_CASES, "bwd": chip_smoke.BWD_CASES,
            "decode": chip_smoke.DECODE_CASES,
            "verify": chip_smoke.VERIFY_CASES,
            "decode_q": chip_smoke.DECODE_Q_CASES}[kernel]


def tolerance(kernel, case):
    """chip_smoke.py's tolerance for a case of ``kernel``."""
    if kernel == "bwd":
        return chip_smoke.TOL_BWD[case[0]]
    return chip_smoke.TOL_REL[case.dtype if kernel in ("prefill", "decode")
                              else case[1]]


def timer(kernel, timing):
    """chip_smoke's timer for ``kernel`` under ``--timing``."""
    if timing == "graph" or (timing is None and kernel in (
            "decode", "verify", "decode_q")):
        return chip_smoke.graph_ms
    return chip_smoke.cuda_ms


def measure(torch, kernel, index, case, iters, timing=None):
    """One case with the imported package's kernels: {"ms": ..., "rel":
    ...} (bwd: "ms" is {"dq": ..., "dkv": ...}); raises ValueError or
    RuntimeError where the build refuses the shape."""
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + index)
    cs = chip_smoke
    if kernel == "prefill":
        c = case
        q = torch.randn((c.batch, c.s_q, c.n_heads, c.hd), generator=gen,
                        device="cuda").to(getattr(torch, c.dtype))
        k, v = (torch.randn((c.batch, c.s_kv, c.n_kv, c.hd), generator=gen,
                            device="cuda").to(q.dtype) for _ in range(2))

        def run():
            return fa.flash_prefill_attention(q, k, v, causal=c.causal,
                                              window=c.window)

        ref = pa.prefill_attention(q, k, v, causal=c.causal, window=c.window)
        return {"ms": cs.cuda_ms(torch, run, iters),
                "rel": cs.rel_err(run(), ref)}
    if kernel == "bwd":
        dt, sq, skv, causal, win, hd, n_heads, n_kv = case

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                getattr(torch, dt))

        q, k, v = rn(1, sq, n_heads, hd), rn(1, skv, n_kv, hd), \
            rn(1, skv, n_kv, hd)
        do = rn(1, sq, n_heads, hd)
        o, lse = fa.flash_forward_lse_plain(q, k, v, causal, win)
        dvec = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, dvec, causal, win)
        fns = {"dq": lambda: fa.flash_bwd_dq(*args),
               "dkv": lambda: fa.flash_bwd_dkv(*args)}
        ms = {f: cs.cuda_ms(torch, fn, iters) for f, fn in fns.items()}
        got = {"dq": fns["dq"]()}
        got["dk"], got["dv"] = fns["dkv"]()
        ref = {"dq": fa.flash_bwd_dq_plain(*args)}
        ref["dk"], ref["dv"] = fa.flash_bwd_dkv_plain(*args)
        return {"ms": ms, "rel": max(cs.grad_rel_err(got[n], ref[n],
                                                     n != "dq")
                                     for n in ref)}
    if kernel == "decode_q":
        from infinistore_tpu_torch.ops import paged_flash_decode_q as pq

        args = cs.decode_q_args(torch, case, gen)

        def run():
            return pq.paged_flash_decode_quantized(*args, window=case[3])

        ref = pq.paged_decode_quantized_plain(*args, window=case[3])
        return {"ms": timer(kernel, timing)(torch, run, iters),
                "rel": cs.rel_err(run(), ref)}
    if kernel == "decode":
        from infinistore_tpu_torch.ops import paged_flash_decode as pd

        args = cs.decode_args(torch, case, gen)
        win = case.window

        def run():
            return pd.paged_flash_decode(*args, window=win)

        ref = pa.paged_decode_attention(*args, window=win)
    else:
        from infinistore_tpu_torch.ops import paged_flash_verify as pv

        args = cs.verify_args(torch, case, gen)
        win = case[4]

        def run():
            return pv.paged_flash_verify(*args, window=win)

        ref = pa.multi_token_paged_attention(*args, window=win)
    rel = cs.rel_err(run(), ref)
    return {"ms": timer(kernel, timing)(torch, run, iters), "rel": rel}


def worker(args):
    """Time this process's checkout (args.worker) on the picked cases;
    print {index: result or None} as JSON on the last line."""
    sys.path.insert(0, os.path.abspath(args.worker))
    import torch

    from infinistore_tpu_torch._device import disable_tf32

    disable_tf32()
    picked = {int(i) for i in args.cases.split(",") if i}
    out = {}
    for i, case in enumerate(cases(args.kernel)):
        if picked and i not in picked:
            continue
        try:
            out[i] = measure(torch, args.kernel, i, case, args.iters,
                             args.timing)
        except (ValueError, RuntimeError) as e:  # the build refuses it
            print(f"case {i}: refused: {e}", file=sys.stderr, flush=True)
            out[i] = None
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="*")
    ap.add_argument("--kernel", choices=KERNELS, default="prefill")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default="")
    ap.add_argument("--timing", choices=("eager", "graph"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    roots = {os.path.basename(os.path.abspath(r)): os.path.abspath(r)
             for r in args.other}
    roots["this"] = ROOT
    others = [name for name in roots if name != "this"]
    order = [*others, "this", "this", *reversed(others)]
    runs = {name: [] for name in roots}
    for _ in range(args.rounds):
        for name in order:
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   roots[name], "--kernel", args.kernel, "--iters",
                   str(args.iters), "--cases", args.cases]
            if args.timing:
                cmd += ["--timing", args.timing]
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  cwd=roots[name])
            if done.returncode != 0:
                print(done.stdout[-4000:], done.stderr[-4000:], flush=True)
                print(f"FAIL: the {name} build's process exited "
                      f"{done.returncode}", flush=True)
                return 1
            runs[name].append(json.loads(done.stdout.strip().splitlines()[-1]))
    ok, summary = True, []
    all_cases = cases(args.kernel)
    for key in runs["this"][0]:
        case = all_cases[int(key)]
        tol = tolerance(args.kernel, case)
        line, row = [], dict(case=list(case), ms={}, rel_err={})
        for name in roots:
            res = [r[key] for r in runs[name]]
            if any(r is None for r in res):
                line.append(f"{name} refused")
                row["ms"][name] = None
                continue
            if args.kernel == "bwd":
                ms = {f: statistics.mean(r["ms"][f] for r in res)
                      for f in ("dq", "dkv")}
                text = f"dq {ms['dq']:.4f} dkv {ms['dkv']:.4f}"
            else:
                ms = statistics.mean(r["ms"] for r in res)
                text = f"{ms:.4f}"
            rel = max(r["rel"] for r in res)
            ok = ok and rel <= tol
            row["ms"][name], row["rel_err"][name] = ms, rel
            row.setdefault("runs_ms", {})[name] = [r["ms"] for r in res]
            line.append(f"{name} {text} ms rel err {rel:.3e}")
        print(f"{args.kernel} {key} {tuple(case)} (tol {tol:g}): "
              + "; ".join(line), flush=True)
        summary.append(row)
    print(chip_smoke.card_line())
    print(json.dumps({"ok": ok, "kernel": args.kernel, "cases": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
