#!/usr/bin/env python3
"""Registers, shared memory and spills of every kernel the port builds.

    python3 tools/torch_ptxas.py

Needs nvcc (the machine with the card). Compiles each
infinistore_tpu_torch/csrc/*.cu with the flags of ops/_kernels.py plus
``-Xptxas -v`` into a temporary directory, side by side, and prints one
line per kernel variant: registers a thread, spill stores and loads and
the stack frame in bytes (an array the compiler could not keep in
registers lives there), and any ptxas note that it serialised a
kernel's wgmma. The split-K paged kernel prints as
``paged_split_kernel<q type, hd, row tile / 16, int8 pages>``: its
instantiations over q's type (paged_split.cu: K2, K3) and over int8
pages (paged_split_q.cu: K4) each. Then,
for each variant of the flash kernels (K1, K5, K6), the count of HGMMA
(wgmma), UTMALDG (TMA load) and SYNCS (mbarrier) instructions in its
SASS (``cuobjdump -sass`` of the built objects): the bf16 ``*_wgmma``
variants must show the first two. Exits non-zero if a source does not
compile or cuobjdump fails.
"""

import glob
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from infinistore_tpu_torch.ops import _kernels  # noqa: E402


def pretty(mangled):
    """name<dtype, ints...> from a mangled kernel template name."""
    m = re.search(r"([a-z][a-z_0-9]*_kernel)I(13__nv_bfloat16|f)?"
                  r"((?:Li\d+E)+)", mangled)
    if not m:
        return mangled
    # An anonymous namespace's hash prefix ends in the name's length.
    name = re.sub(r".*\d(?=[a-z])", "", m.group(1))
    dtype = {None: [], "f": ["f32"]}.get(m.group(2), ["bf16"])
    ints = re.findall(r"Li(\d+)E", m.group(3))
    return f"{name}<{', '.join([*dtype, *ints])}>"


SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS")


FLASH_OBJECTS = ("flash_prefill", "flash_bwd_dq", "flash_bwd_dkv")


def sass_counts(obj):
    """{kernel: {op: count}} for the flash kernels in ``obj``."""
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = "cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                         text=True, check=True).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = pretty(m.group(1))
            if kernel.startswith("flash_"):
                counts[kernel] = dict.fromkeys(SASS_OPS, 0)
            else:
                kernel = None
        elif kernel:
            for op in SASS_OPS:
                counts[kernel][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def main():
    srcs = sorted(glob.glob(os.path.join(_kernels.CSRC, "*.cu")))
    ok = True
    with tempfile.TemporaryDirectory() as work:
        procs = [(src, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             _kernels.CSRC, "-c", src, "-o",
             os.path.join(work, os.path.basename(src) + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in srcs]
        for src, proc in procs:
            out = proc.communicate()[0]
            ok = ok and proc.returncode == 0
            print(f"{os.path.basename(src)}: rc {proc.returncode}")
            kernel = spill = None
            for line in out.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    kernel = pretty(m.group(1))
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if m:
                    spill = m.groups()
                if "C7513" in line:  # ptxas serialised the wgmma pipeline
                    print("  " + line.strip())
                m = re.search(r"Used (\d+) registers", line)
                if m and kernel:
                    stack, st, ld = spill or (0, 0, 0)
                    print(f"  {kernel}: {m.group(1)} registers, spill "
                          f"stores/loads {st}/{ld} bytes, stack frame "
                          f"{stack} bytes")
                    kernel = spill = None
            if proc.returncode:
                print(out)
        for name in FLASH_OBJECTS:
            obj = os.path.join(work, name + ".cu.o")
            if not os.path.exists(obj):
                continue
            for kernel, counts in sass_counts(obj).items():
                print(f"  SASS {kernel}: " + ", ".join(
                    f"{op} {n}" for op, n in counts.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
