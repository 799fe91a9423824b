#!/usr/bin/env python3
"""Plant faults in the port's CUDA kernels; show chip_smoke.py catches them.

    python3 tools/torch_kernel_faults.py

Needs one NVIDIA GPU and nvcc. For the unchanged kernel sources and for
each fault in FAULTS, copies infinistore_tpu_torch/csrc into a temporary
directory, applies the fault (one exact text substitution), builds the
copy with the flags of ops/_kernels.py, loads it in place of the port's
kernels and runs chip_smoke.py's phase 2 and phase 3 cases against the
plain versions. Prints each case's relative error beside its tolerance,
then the card line and a JSON summary as the last line. Exits non-zero
if the unchanged sources fail a case or a faulty build passes them all.
The repository's own sources and build are never touched.
"""

import glob
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# (name, source file, original text, faulty text)
FAULTS = (
    ("flash: skips the last kv tile", "flash_prefill.cu",
     "for (int kt = kt_begin; kt < kt_end; ++kt) {",
     "for (int kt = kt_begin; kt < kt_end - (kt_end - kt_begin > 1); "
     "++kt) {"),
    ("flash: window floor one tile high", "flash_prefill.cu",
     "kt_begin = max(q_start + offset - window + 1, 0) / BK;",
     "kt_begin = max(q_start + offset - window + 1, 0) / BK + 1;"),
    ("decode: skips the last page", "paged_decode.cu",
     "j <= last_page; j += WARPS",
     "j < last_page + (last_page == low / P); j += WARPS"),
    ("decode: stops after 2048 tokens", "paged_decode.cu",
     "j <= last_page; j += WARPS",
     "j <= min(last_page, 2048 / P - 1); j += WARPS"),
    ("decode: window floor one page high", "paged_decode.cu",
     "for (int j = low / P + warp;",
     "for (int j = (low > 0 ? low / P + 1 : 0) + warp;"),
)


def build_variants(kernels, native, work):
    """Build the unchanged sources and every fault; {name: library}."""
    variants = [("none", None, None, None), *FAULTS]
    compiles, links, libs = [], [], {}
    for i, (name, fname, old, new) in enumerate(variants):
        src = os.path.join(work, f"v{i}")
        shutil.copytree(kernels.CSRC, src)
        if fname is not None:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise RuntimeError(f"fault {name!r}: {old!r} is not in "
                                   f"{fname} exactly once")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        objs = []
        for cu in sorted(glob.glob(os.path.join(src, "*.cu"))):
            objs.append(cu[:-3] + ".o")
            compiles.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", src,
                             "-c", cu, "-o", objs[-1]])
        libs[name] = os.path.join(src, "libkernels.so")
        links.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", *objs,
                      "-o", libs[name]])
    native.run_parallel(compiles)
    native.run_parallel(links)
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    from infinistore_tpu_torch import _native
    from infinistore_tpu_torch._device import disable_tf32
    from infinistore_tpu_torch.ops import _kernels
    from infinistore_tpu_torch.ops import flash_attention as fa
    from infinistore_tpu_torch.ops import paged_flash_decode as pd
    from infinistore_tpu_torch.ops.paged_attention import (
        paged_decode_attention, prefill_attention)

    disable_tf32()
    summary, ok = {}, True
    with tempfile.TemporaryDirectory() as work:
        libs = build_variants(_kernels, _native, work)
        for name, path in libs.items():
            _kernels._lib = _kernels.load(path)
            gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
            readings = {}
            for case, _, rel, _ in chip_smoke.flash_readings(
                    torch, fa.flash_prefill_attention, prefill_attention,
                    gen):
                readings["flash " + " ".join(map(str, case))] = (rel, case[0])
            for case, _, rel, _ in chip_smoke.decode_readings(
                    torch, pd.paged_flash_decode, paged_decode_attention,
                    gen):
                readings["decode " + " ".join(map(str, case))] = (rel,
                                                                  case[0])
            caught = []
            for label, (rel, dt) in readings.items():
                tol = chip_smoke.TOL_REL[dt]
                fails = not rel <= tol
                caught.append(fails)
                print(f"{name} | {label}: rel err {rel:.3e} (tol {tol:g}) "
                      f"{'FAILS' if fails else 'passes'}", flush=True)
            if name == "none":
                ok = ok and not any(caught)
            else:
                ok = ok and any(caught)
            summary[name] = {k: v[0] for k, v in readings.items()}
    _kernels._lib = None
    print(chip_smoke.card_line())
    print(json.dumps({"ok": ok, "rel_err": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
