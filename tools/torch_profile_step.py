#!/usr/bin/env python3
"""Where the time goes in infinistore_tpu_torch's prefill and decode step,
on one NVIDIA GPU, at Llama-3.1-8B width (random weights, seed 0).

    python3 tools/torch_profile_step.py [--prompt 2048] [--batch 4]

Profiles one prefill of --prompt tokens and three decode steps at
--batch sequences (lengths --prompt, 3/4, 1/2, 1/4 of it) with
torch.profiler, and prints per step: wall ms, device busy ms (sum of
kernel and copy time), the idle share of the wall time, and the device
time by kernel, largest first.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from infinistore_tpu_torch.models import llama  # noqa: E402


def device_us(evt):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def report(label, prof, wall_s, steps):
    # Kernel and copy rows only: CPU-side ops also carry device totals.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_us(e) for e in rows)
    wall_ms = wall_s * 1e3 / steps
    busy_ms = busy_us / 1e3 / steps
    print(f"{label}: wall {wall_ms:.2f} ms/step, device busy "
          f"{busy_ms:.2f} ms/step, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(rows, key=device_us, reverse=True)[:10]:
        print(f"  {device_us(e) / 1e3 / steps:9.3f} ms  x{e.count // steps:<5d}"
              f" {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no GPU")
        return 1
    cfg = llama.LLAMA31_8B
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(gen, cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, args.prompt),
                           device="cuda", dtype=torch.int32)

    with torch.no_grad():
        for _ in range(2):
            llama.prefill(params, cfg, tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            llama.prefill(params, cfg, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report(f"prefill {args.prompt} tokens", prof, wall, 1)

    lens = [max(1, args.prompt * (4 - i) // 4) for i in range(args.batch)]
    per_seq = -(-(args.prompt + 8) // cfg.page_size)
    n_pages = per_seq * args.batch
    shape = (cfg.n_layers, n_pages, *cfg.kv_page_shape())
    kp = torch.randn(shape, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, device="cuda").to(torch.bfloat16)
    table = torch.randperm(n_pages, device="cuda").int().reshape(
        args.batch, per_seq)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tok = torch.zeros(args.batch, dtype=torch.int32, device="cuda")
    for _ in range(3):
        llama.decode_step(params, cfg, tok, seq_lens, kp, vp, table)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            llama.decode_step(params, cfg, tok, seq_lens, kp, vp, table)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"decode batch {args.batch} lens {lens}", prof, wall, 3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
