#!/usr/bin/env python3
"""Time the flash kernels of this checkout against other checkouts', in
turns, on one NVIDIA GPU: the prefill kernel (K1) or the backward kernels
(K5 and K6).

    python3 tools/torch_flash_ab.py OTHER_ROOT [OTHER_ROOT ...]
        [--kernel prefill|bwd] [--iters 20] [--rounds 2] [--cases 0,1]

Each OTHER_ROOT is a checkout of the repository (for example an earlier
commit unpacked with ``git archive``), named by its directory's name: its
infinistore_tpu_torch/csrc is built with this checkout's flags beside
this checkout's csrc ("this"), into a temporary directory, side by side
(the C entry points istpu_flash_prefill, istpu_flash_bwd_dq and
istpu_flash_bwd_dkv are the same in all). With ``--kernel prefill`` each
of chip_smoke.py's phase-2 FLASH_CASES, with ``--kernel bwd`` each of
its phase-8 BWD_CASES (or those whose indices --cases lists), is then
timed with CUDA events, ``--rounds`` times in the order others, this,
this, others reversed, on the same inputs, and held to the plain version
(K5 and K6 each timed alone; a build that refuses a shape reads none).
Prints one line per case with each build's mean kernel ms and relative
error, then the card line and a JSON summary as the last line. Exits
non-zero if a build fails a case's tolerance.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def build(kernels, native, work, roots):
    """Build each root's csrc into ``work``; {label: library path}."""
    compiles, links, libs = [], [], {}
    for label, root in roots.items():
        src = os.path.join(work, label)
        shutil.copytree(os.path.join(root, "infinistore_tpu_torch", "csrc"),
                        src)
        objs = []
        for name in sorted(os.listdir(src)):
            if name.endswith(".cu"):
                objs.append(os.path.join(src, name[:-3] + ".o"))
                compiles.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                                 src, "-c", os.path.join(src, name), "-o",
                                 objs[-1]])
        libs[label] = os.path.join(src, "libkernels.so")
        links.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", *objs,
                      "-o", libs[label]])
    native.run_parallel(compiles)
    native.run_parallel(links)
    return libs


def prefill_ab(torch, fa, kernels, libs, order, picked, gen, args,
               summary):
    """The --kernel prefill rounds over chip_smoke's FLASH_CASES; appends
    to ``summary``, returns False if a build fails a case's tolerance."""
    from infinistore_tpu_torch.ops.paged_attention import prefill_attention

    ok = True
    kernels._lib = libs["this"]
    for i, (c, (q, k, v), _, _) in enumerate(chip_smoke.flash_readings(
            torch, fa.flash_prefill_attention, prefill_attention, gen)):
        if picked and i not in picked:
            continue
        ref = prefill_attention(q, k, v, causal=c.causal, window=c.window)
        times = {name: [] for name in libs}
        rels = {}
        for _ in range(args.rounds):
            for name in order:
                if times[name] is None:
                    continue
                kernels._lib = libs[name]
                try:
                    times[name].append(chip_smoke.cuda_ms(
                        torch, lambda: fa.flash_prefill_attention(
                            q, k, v, causal=c.causal, window=c.window),
                        args.iters))
                except RuntimeError:  # this build refuses the shape
                    times[name] = None
                    continue
                out = fa.flash_prefill_attention(q, k, v, causal=c.causal,
                                                 window=c.window)
                torch.cuda.synchronize()
                rels[name] = chip_smoke.rel_err(out, ref)
        # flash_readings runs the next case's kernel with the current
        # library: this checkout's, which takes every case.
        kernels._lib = libs["this"]
        ms = {name: statistics.mean(t) if t else None
              for name, t in times.items()}
        tol = chip_smoke.TOL_REL[c.dtype]
        ok = ok and all(r <= tol for r in rels.values())
        label = " ".join(f"{f}={getattr(c, f)}" for f in c._fields)
        print(f"{label} (tol {tol:g}): " + "; ".join(
            f"{name} {ms[name]:.4f} ms rel err {rels[name]:.3e}"
            if ms[name] is not None else f"{name} refused"
            for name in libs), flush=True)
        summary.append(dict(case=c._asdict(), ms=ms, rel_err=rels,
                            runs_ms=times))
    return ok


def bwd_ab(torch, fa, kernels, libs, order, picked, gen, args, summary):
    """The --kernel bwd rounds over chip_smoke's BWD_CASES; appends to
    ``summary``, returns False if a build fails a case's tolerance."""
    ok = True
    for i, case in enumerate(chip_smoke.BWD_CASES):
        if picked and i not in picked:
            continue
        dt, sq, skv, causal, win, hd, n_heads, n_kv = case

        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                getattr(torch, dt))

        q, k, v = (rn(1, sq, n_heads, hd), rn(1, skv, n_kv, hd),
                   rn(1, skv, n_kv, hd))
        do = rn(1, sq, n_heads, hd)
        o, lse = fa.flash_forward_lse_plain(q, k, v, causal, win)
        dvec = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        bargs = (q, k, v, do, lse, dvec, causal, win)
        ref = {"dq": fa.flash_bwd_dq_plain(*bargs)}
        ref["dk"], ref["dv"] = fa.flash_bwd_dkv_plain(*bargs)
        fns = {"dq": lambda: fa.flash_bwd_dq(*bargs),
               "dkv": lambda: fa.flash_bwd_dkv(*bargs)}
        times = {name: {f: [] for f in fns} for name in libs}
        rels = {}
        for _ in range(args.rounds):
            for name in order:
                if times[name] is None:
                    continue
                kernels._lib = libs[name]
                try:
                    for f, fn in fns.items():
                        times[name][f].append(chip_smoke.cuda_ms(
                            torch, fn, args.iters))
                    got = {"dq": fns["dq"]()}
                    got["dk"], got["dv"] = fns["dkv"]()
                    torch.cuda.synchronize()
                except RuntimeError:  # this build refuses the shape
                    times[name] = None
                    continue
                rels[name] = max(chip_smoke.grad_rel_err(
                    got[n], ref[n], n != "dq") for n in ref)
        tol = chip_smoke.TOL_BWD[dt]
        ok = ok and all(r <= tol for r in rels.values())
        ms = {name: ({f: statistics.mean(t) for f, t in tf.items()}
                     if tf else None) for name, tf in times.items()}
        print(f"bwd {case} (tol {tol:g}): " + "; ".join(
            f"{name} " + (f"dq {ms[name]['dq']:.4f} dkv {ms[name]['dkv']:.4f}"
                          f" ms rel err {rels[name]:.3e}" if ms[name]
                          else "refused")
            for name in libs), flush=True)
        summary.append(dict(case=case, ms=ms, rel_err=rels, runs_ms=times))
        del q, k, v, do, o, lse, dvec, bargs, ref
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="+")
    ap.add_argument("--kernel", choices=("prefill", "bwd"),
                    default="prefill")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    from infinistore_tpu_torch import _native
    from infinistore_tpu_torch._device import disable_tf32
    from infinistore_tpu_torch.ops import _kernels
    from infinistore_tpu_torch.ops import flash_attention as fa

    disable_tf32()
    ok, summary = True, []
    with tempfile.TemporaryDirectory() as work:
        roots = {os.path.basename(os.path.abspath(r)): os.path.abspath(r)
                 for r in args.other}
        libs = {name: _kernels.load(path) for name, path in build(
            _kernels, _native, work, {**roots, "this": ROOT}).items()}
        order = [*roots, "this", "this", *reversed(list(roots))]
        picked = {int(i) for i in args.cases.split(",") if i}
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        ab = bwd_ab if args.kernel == "bwd" else prefill_ab
        ok = ab(torch, fa, _kernels, libs, order, picked, gen, args, summary)
    _kernels._lib = None
    print(chip_smoke.card_line())
    print(json.dumps({"ok": ok, "cases": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
