#!/usr/bin/env python3
"""Time the flash prefill kernel (K1) of this checkout against other
checkouts', in turns, on one NVIDIA GPU.

    python3 tools/torch_flash_ab.py OTHER_ROOT [OTHER_ROOT ...]
        [--iters 20] [--rounds 2] [--cases 0,1]

Each OTHER_ROOT is a checkout of the repository (for example an earlier
commit unpacked with ``git archive``), named by its directory's name: its
infinistore_tpu_torch/csrc is built with this checkout's flags beside
this checkout's csrc ("this"), into a temporary directory, side by side
(the C entry point istpu_flash_prefill is the same in all). Each of
chip_smoke.py's phase-2 FLASH_CASES (or those whose indices --cases
lists) is then timed with CUDA events, ``--rounds`` times in the order
others, this, this, others reversed, on the same inputs, and held to the
plain version. Prints one line per case with each build's mean kernel ms
and relative error, then the card line and a JSON summary as the last
line. Exits non-zero if a build fails a case's tolerance.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="+")
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
    from infinistore_tpu_torch.ops.paged_attention import prefill_attention

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
        for i, (c, (q, k, v), _, _) in enumerate(chip_smoke.flash_readings(
                torch, fa.flash_prefill_attention, prefill_attention, gen)):
            if picked and i not in picked:
                continue
            ref = prefill_attention(q, k, v, causal=c.causal, window=c.window)
            times = {name: [] for name in libs}
            rels = {}
            for _ in range(args.rounds):
                for name in order:
                    _kernels._lib = libs[name]
                    times[name].append(chip_smoke.cuda_ms(
                        torch, lambda: fa.flash_prefill_attention(
                            q, k, v, causal=c.causal, window=c.window),
                        args.iters))
                    out = fa.flash_prefill_attention(q, k, v, causal=c.causal,
                                                     window=c.window)
                    torch.cuda.synchronize()
                    rels[name] = chip_smoke.rel_err(out, ref)
            ms = {name: statistics.mean(t) for name, t in times.items()}
            tol = chip_smoke.TOL_REL[c.dtype]
            ok = ok and all(r <= tol for r in rels.values())
            label = " ".join(f"{f}={getattr(c, f)}" for f in c._fields)
            print(f"{label} (tol {tol:g}): " + "; ".join(
                f"{name} {ms[name]:.4f} ms rel err {rels[name]:.3e}"
                for name in libs), flush=True)
            summary.append(dict(case=c._asdict(), ms=ms, rel_err=rels,
                                runs_ms=times))
    _kernels._lib = None
    print(chip_smoke.card_line())
    print(json.dumps({"ok": ok, "cases": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
