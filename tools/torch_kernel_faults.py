#!/usr/bin/env python3
"""Plant faults in the port's CUDA kernels; show chip_smoke.py catches them.

    python3 tools/torch_kernel_faults.py [WORD]

With WORD, only the faults whose name contains it are planted (for
example ``decode_q:`` for K4's own, ``bwd`` for K5's and K6's,
``split:`` for the split-K paged kernel's, which K2, K3 and K4 share),
beside the unchanged sources.

Needs one NVIDIA GPU and nvcc. For the unchanged kernel sources and for
each fault in FAULTS, copies infinistore_tpu_torch/csrc into a temporary
directory, applies the fault (one exact text substitution), builds the
copy with the flags of ops/_kernels.py, loads it in place of the port's
kernels and runs chip_smoke.py's phase 2, 3, 3b (K4) and 5 cases against
the plain versions, and phase 8's backward cases (K1's lse, K5, K6). Prints
each case's relative error beside its tolerance, then the card line and
a JSON summary as the last line. Exits non-zero
if the unchanged sources fail a case or a faulty build passes them all
(a race, such as the early stage release, may read clean on a run).
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

# The tail of K1's consumer loop, from S's landing to the stage's
# release: the softmax and the P V wgmma that reads the stage's V tile.
_FENCE_S = "            hp::fence_regs(s);\n"
_SOFTMAX_PV = (
    "            softmax_tile<BK>(s, pa, m, l, alpha,\n"
    "                             interior_tile<kRows, BK>(row0, kt * BK, "
    "Sq, Skv,\n"
    "                                                      causal, window),\n"
    "                             r_lo, kt * BK, quad, Sq, Skv, causal, "
    "window,\n"
    "                             scale_log2);\n"
    "#pragma unroll\n"
    "            for (int oh = 0; oh < P::OH; ++oh) {\n"
    "#pragma unroll\n"
    "                for (int i = 0; i < P::ON / 2; ++i) {\n"
    "                    o[oh][i] *= alpha[(i >> 1) & 1];\n"
    "                }\n"
    "            }\n"
    "            hp::fence_regs(o);\n"
    "            hp::wgmma_fence();\n"
    "            issue_pv<HD, SW, BK, P::OH, P::ON>(o, pa,\n"
    "                                                tile(stage) + "
    "P::TILE_BYTES);\n"
    "            hp::wgmma_commit();\n"
    "            hp::wgmma_wait<0>();\n"
    "            hp::fence_regs(o);\n")
_RELEASE = "            if (lane == 0) hp::mbar_arrive(&empty[stage]);\n"
# The end of K6's consumer stage, from the dV / dK products' commit to
# the stage's release, and the same with the release before the wait.
_DKV_TAIL = (
    "            hp::wgmma_commit();\n"
    "            hp::wgmma_wait<0>();\n"
    "            hp::fence_regs(dv);\n"
    "            hp::fence_regs(dk);\n"
    "            if (lane == 0) hp::mbar_arrive(&empty[stage]);\n")
_DKV_TAIL_EARLY = (
    "            hp::wgmma_commit();\n"
    "            if (lane == 0) hp::mbar_arrive(&empty[stage]);\n"
    "            hp::wgmma_wait<0>();\n"
    "            hp::fence_regs(dv);\n"
    "            hp::fence_regs(dk);\n")

# K5's live kv tiles of the CTA.
_DQ_TILES = ("kv_tiles<P::BQ, kBK>(q_start, Sq, Skv, causal, window, "
             "kt_begin, kt_end);")

# (name, source file, original text, faulty text)
FAULTS = (
    ("flash: skips the last kv tile", "flash_prefill.cu",
     "kv_tiles<P::BQ, BK>(q_start, Sq, Skv, causal, window, kt_begin, "
     "kt_end);",
     "kv_tiles<P::BQ, BK>(q_start, Sq, Skv, causal, window, kt_begin, "
     "kt_end);\n    kt_end -= (kt_end - kt_begin > 1);"),
    ("flash: window floor one tile high", "flash_tile.cuh",
     "begin = max(q_start + offset - window + 1, 0) / TK;",
     "begin = max(q_start + offset - window + 1, 0) / TK + 1;"),
    ("flash: lse omits log(l)", "flash_prefill.cu",
     "(m[hi] + log2f(l[hi])) * kLn2;",
     "m[hi] * kLn2;"),
    ("flash: the diagonal tile treated as interior", "flash_prefill.cu",
     "interior_tile<kRows, BK>(row0, kt * BK, Sq, Skv,\n"
     "                                                      causal, window),",
     "interior_tile<kRows, BK>(row0, kt * BK, Sq, Skv,\n"
     "                                                      0, window),"),
    # A race: the stage is released once S is computed, before the P V
    # wgmma that reads its V tile, which the next load may overwrite.
    ("flash: a stage released before its P V wgmma completes",
     "flash_prefill.cu",
     _FENCE_S + _SOFTMAX_PV + _RELEASE,
     _FENCE_S + _RELEASE + _SOFTMAX_PV),
    # hd 256: O's second half accumulated over V's first column blocks.
    ("flash: hd-256 P V reads one half of V twice", "flash_prefill.cu",
     "v + h * (ON * 2 / SW) * BK * SW + kk * 16 * SW",
     "v + 0 * h * (ON * 2 / SW) * BK * SW + kk * 16 * SW"),
    ("bwd dq: skips the last live kv tile", "flash_bwd_dq.cu",
     _DQ_TILES, _DQ_TILES + "\n    kt_end -= (kt_end - kt_begin > 1);"),
    # hd 256: the last live kv tile, dQ's second column half, and the
    # column blocks past D (at hd 136 the third block holds 8 real
    # columns and 56 of zero fill).
    ("bwd dq: hd-256 skips the last live kv tile", "flash_bwd_dq.cu",
     _DQ_TILES,
     _DQ_TILES + "\n    kt_end -= (HD > 128 && kt_end - kt_begin > 1);"),
    ("bwd dq: hd-256 dQ's second half accumulated over K's first half",
     "flash_bwd_dq.cu",
     "b + h * (ON * 2 / SW) * kBK * SW + kk * 16 * SW",
     "b + 0 * h * (ON * 2 / SW) * kBK * SW + kk * 16 * SW"),
    ("bwd dq: hd-136 columns past D stored (the last block ends at D)",
     "flash_bwd_dq.cu",
     "hp::tma_store_4d(&dqmap, qc + c * P::BQ * SW, c * SW / 2, h,",
     "hp::tma_store_4d(&dqmap, qc + c * P::BQ * SW, HD > 128 ? "
     "min(c * SW / 2, D - SW / 2) : c * SW / 2, h,"),
    ("bwd dkv: q tiles start one late under a prefix", "flash_tile.cuh",
     "begin = max(k_start - offset, 0) / TQ;",
     "begin = max(k_start - offset, 0) / TQ + (offset > 0);"),
    ("bwd dkv: only the group's first q head", "flash_bwd_dkv.cu",
     "const int stages = members * n_qt;",
     "const int stages = n_qt;"),
    # A race: the stage is released once dV += P^T dO and dK += dS^T Q are
    # issued, before they are waited for; the next load may overwrite the
    # Q and dO tiles they read.
    ("bwd dkv: a stage released before the dK wgmma that reads its Q",
     "flash_bwd_dkv.cu", _DKV_TAIL, _DKV_TAIL_EARLY),
    ("bwd dkv: hd-256 column half written at column 0", "flash_bwd_dkv.cu",
     "* KV + kvh) * D + c0 +",
     "* KV + kvh) * D + 0 * c0 +"),
    # hd 256: each consumer's dK / dV half, and the group's splits.
    ("bwd dkv: hd-256 consumers both read the first column half",
     "flash_bwd_dkv.cu",
     "const int half = c0 * 2 / SW * kBQ * SW;",
     "const int half = 0 * c0 * 2 / SW * kBQ * SW;"),
    ("bwd dkv: hd-256 the last split of the group left out of the sum",
     "flash_bwd_dkv.cu",
     "for (int p = 1; p < splits; ++p) {",
     "for (int p = 1; p < splits - 1; ++p) {"),
    # The split-K paged kernel (K2, K3 and, over int8 pages, K4).
    ("split: the last page of each split skipped", "paged_split.cuh",
     "const int s_hi = min(s_lo + a.pages_per_split * a.P, t_end);",
     "const int s_hi = min(s_lo + (a.pages_per_split - 1) * a.P, t_end);"),
    # An empty split's partial must count for nothing: written as m = 0,
    # l = 1 it joins the merge with its unwritten acc.
    ("split: an empty split merged as m = 0, l = 1", "paged_split.cuh",
     "r0 + i] = make_float2(kNegInf, 0.0f);",
     "r0 + i] = make_float2(0.0f, 1.0f);"),
    ("split: splits merged without rescaling to their common max",
     "paged_split.cuh",
     "const float al = exp2f(M - m_new), f = exp2f(ml[j].x - m_new);",
     "const float al = 1.0f, f = 1.0f;"),
    ("split: decode's length offset off by one", "paged_split.cu",
     "B, 1, H, KV, D, N, P, max_pages, window, -1, 0.0f,",
     "B, 1, H, KV, D, N, P, max_pages, window, 0, 0.0f,"),
    # Columns at or past D (zero) stored over the next row's first ones.
    ("split: a column past D stored", "paged_split.cuh",
     "const int cols = a.D;",
     "const int cols = row + 1 < n_rows ? a.D + 16 : a.D;"),
    # Windowed splits cut only the pages the window spans: counted from
    # page 0 instead of the floor's page, a long sequence's live positions
    # lie past the last split.
    ("split: windowed splits counted from page 0", "paged_split.cuh",
     "a.window > 0 ? max(base + 1 - a.window, 0) / a.P : 0;",
     "a.window > 0 ? 0 * max(base + 1 - a.window, 0) / a.P : 0;"),
    ("split: stops after 2048 positions", "paged_split.cuh",
     "const int t_end = a.max_pages * a.P;",
     "const int t_end = min(a.max_pages * a.P, 2048);"),
    ("split: window floor 16 positions high", "paged_split.cuh",
     "lo = max(window > 0 ? max(limit - window, 0) : 0, s_lo);",
     "lo = max(window > 0 ? max(limit - window + 16, 0) : 0, s_lo);"),
    # pos / P one too low where the multiply-high falls short.
    ("split: a page index left uncorrected", "paged_split.cuh",
     "        if (off >= a.P) {\n            ++page;",
     "        if (off >= 2 * a.P) {\n            ++page;"),
    ("split: causal limit one token too far", "paged_split.cuh",
     "const int limit = base + row / group + 1;",
     "const int limit = base + row / group + 2;"),
    # K4's own: the int8 pages' scales, their widening and P' (a dropped
    # lo of bf16 q's hi + lo hides under the bf16 gate; the CPU tests
    # hold it).
    ("decode_q: length offset off by one", "paged_split_q.cu",
     "B, 1, H, KV, D, N, P, max_pages, window, -1, 0.0f,",
     "B, 1, H, KV, D, N, P, max_pages, window, 0, 0.0f,"),
    ("decode_q: V scaled by K's scales", "paged_split.cuh",
     "(i < TK ? a.ks : a.vs) + off", "(i < TK ? a.ks : a.ks) + off"),
    ("decode_q: one scale per page (token 0's)", "paged_split.cuh",
     "off = pool_row(pos) * a.KV + kvh;",
     "off = pool_row(pos) / a.P * a.P * a.KV + kvh;"),
    ("decode_q: the scale of the wrong kv head", "paged_split.cuh",
     "off = pool_row(pos) * a.KV + kvh;",
     "off = pool_row(pos) * a.KV + (kvh + 1) % a.KV;"),
    ("decode_q: P' rounded to bf16 in the f32 fold", "paged_split.cuh",
     "if constexpr (I8) p[r] *= vscale;",
     "if constexpr (I8) p[r] = __bfloat162float(__float2bfloat16("
     "p[r] * vscale));"),
    ("decode_q: int8 widened to bf16 from the wrong half", "paged_split.cuh",
     "__float_as_uint(f[1]), 0x7632);",
     "__float_as_uint(f[1]), 0x5410);"),
)


def build_variants(kernels, native, work, faults):
    """Build the unchanged sources and each of ``faults``;
    {name: library}."""
    variants = [("none", None, None, None), *faults]
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
    from infinistore_tpu_torch.ops import paged_flash_decode_q as pq
    from infinistore_tpu_torch.ops import paged_flash_verify as pv
    from infinistore_tpu_torch.ops.paged_attention import (
        multi_token_paged_attention, paged_decode_attention,
        prefill_attention)

    disable_tf32()
    summary, ok = {}, True
    with tempfile.TemporaryDirectory() as work:
        word = sys.argv[1] if len(sys.argv) > 1 else ""
        libs = build_variants(_kernels, _native, work,
                              [f for f in FAULTS if word in f[0]])
        for name, path in libs.items():
            _kernels._lib = _kernels.load(path)
            gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
            readings = {}
            for case, _, rel, _ in chip_smoke.flash_readings(
                    torch, fa.flash_prefill_attention, prefill_attention,
                    gen):
                readings["flash " + " ".join(map(str, case))] = (rel, case[0])
            for c, _, rel, _ in chip_smoke.decode_readings(
                    torch, pd.paged_flash_decode, paged_decode_attention,
                    gen):
                label = (f"decode {c.label} {c.dtype} {c.n_heads}/{c.n_kv} "
                         f"hd {c.hd} window {c.window}")
                readings[label] = (rel, c.dtype)
            for case, _, rel, _ in chip_smoke.decode_q_readings(
                    torch, pq.paged_flash_decode_quantized,
                    pq.paged_decode_quantized_plain, gen):
                label = "decode_q " + " ".join(
                    str(c) for c in case if not isinstance(c, tuple))
                readings[label] = (rel, case[1])
            for case, _, rel, _ in chip_smoke.verify_readings(
                    torch, pv.paged_flash_verify,
                    multi_token_paged_attention, gen):
                label = "verify " + " ".join(
                    str(c) for c in case if not isinstance(c, tuple))
                readings[label] = (rel, case[1])
            tols = {label: chip_smoke.TOL_REL[dt]
                    for label, (_, dt) in readings.items()}
            for case, _, rels, _ in chip_smoke.bwd_readings(torch, fa, gen):
                for out, rel in rels.items():
                    label = "bwd " + " ".join(map(str, case)) + " " + out
                    readings[label] = (rel, case[0])
                    tols[label] = chip_smoke.TOL_BWD[case[0]]
            caught = []
            for label, (rel, dt) in readings.items():
                tol = tols[label]
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
