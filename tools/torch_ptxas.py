#!/usr/bin/env python3
"""Registers, shared memory and spills of every kernel the port builds.

    python3 tools/torch_ptxas.py

Needs nvcc (the machine with the card). Compiles each
infinistore_tpu_torch/csrc/*.cu with the flags of ops/_kernels.py plus
``-Xptxas -v`` into a temporary directory, side by side, and prints one
line per kernel variant: registers a thread, spill stores and loads in
bytes. Exits non-zero if a source does not compile.
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
    m = re.search(r"([a-z][a-z_]*_kernel)I(13__nv_bfloat16|f)((?:Li\d+E)+)",
                  mangled)
    if not m:
        return mangled
    dtype = "bf16" if m.group(2).startswith("13") else "f32"
    ints = re.findall(r"Li(\d+)E", m.group(3))
    return f"{m.group(1)}<{', '.join([dtype, *ints])}>"


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
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spill = m.groups()
                m = re.search(r"Used (\d+) registers", line)
                if m and kernel:
                    print(f"  {kernel}: {m.group(1)} registers, spill "
                          f"stores/loads {spill[0] if spill else 0}/"
                          f"{spill[1] if spill else 0} bytes")
                    kernel = spill = None
            if proc.returncode:
                print(out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
