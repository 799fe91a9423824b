#!/usr/bin/env python3
"""Where the time goes in infinistore_tpu_torch's prefill, decode and
training step, on one NVIDIA GPU, at Llama-3.1-8B width (random weights,
seed 0).

    python3 tools/torch_profile_step.py [--prompt 2048] [--batch 4]
        [--train-layers 16] [--train-tokens 2048]

Profiles one prefill of --prompt tokens and three decode steps at
--batch sequences (lengths --prompt, 3/4, 1/2, 1/4 of it), then one
training step (llama.train_step's forward, backward and AdamW step, each
in a window of its own) at --train-layers layers on one batch of
--train-tokens positions, with torch.profiler. Prints per window: wall
ms, device busy ms (sum of kernel and copy time), the idle share of the
wall time, the device time of the flash kernels (K1 forward, K5 dQ, K6
dK/dV) and of the matrix products, and the device time by kernel,
largest first. --train-layers 0 skips the training step.
"""

import argparse
import dataclasses
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


# Kernel-name fragments: the port's flash kernels (each a bf16 *_wgmma
# variant and a *_tile variant for f32 and hd 256), and the matrix
# products (cuBLAS's and CUTLASS's kernels).
GROUPS = (("K1 flash_prefill", ("flash_prefill_wgmma_kernel",
                                "flash_prefill_tile_kernel")),
          ("K5 flash_bwd_dq", ("flash_bwd_dq_wgmma_kernel",
                               "flash_bwd_dq_tile_kernel")),
          ("K6 flash_bwd_dkv", ("flash_bwd_dkv_wgmma_kernel",
                                "flash_bwd_dkv_tile_kernel")),
          ("matmuls", ("gemm", "nvjet", "xmma", "cutlass")))


def report(label, prof, wall_s, steps):
    # Kernel and copy rows only: CPU-side ops also carry device totals,
    # and a range annotation (Optimizer.step#AdamW.step) shows up as a
    # device row spanning the kernels it holds.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]
    busy_us = sum(device_us(e) for e in rows)
    wall_ms = wall_s * 1e3 / steps
    busy_ms = busy_us / 1e3 / steps
    print(f"{label}: wall {wall_ms:.2f} ms/step, device busy "
          f"{busy_ms:.2f} ms/step, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for name, keys in GROUPS:
        hit = [e for e in rows if any(k in e.key.lower() for k in keys)]
        if hit:
            ms = sum(device_us(e) for e in hit) / 1e3 / steps
            n = sum(e.count for e in hit) // steps
            print(f"  [{name}] {ms:.3f} ms/step, {n} launches")
    for e in sorted(rows, key=device_us, reverse=True)[:10]:
        print(f"  {device_us(e) / 1e3 / steps:9.3f} ms  x{e.count // steps:<5d}"
              f" {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--train-layers", type=int, default=16)
    ap.add_argument("--train-tokens", type=int, default=2048)
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
    del params, kp, vp
    torch.cuda.empty_cache()
    if args.train_layers:
        profile_train(args)
    return 0


def profiled(fn):
    """Run fn() under torch.profiler; returns (its result, the profile,
    the wall seconds up to a synchronize)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def profile_train(args):
    """llama.train_step's three parts, after two warm-up steps (AdamW's
    state and the libraries' first-call set-up)."""
    cfg = dataclasses.replace(llama.LLAMA31_8B, n_layers=args.train_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(gen, cfg, "cuda")
    opt = llama.adamw(params, 1e-3)
    tokens = torch.randint(0, cfg.vocab_size, (1, args.train_tokens + 1),
                           device="cuda", dtype=torch.int32)
    for _ in range(2):
        llama.train_step(params, opt, cfg, tokens)
    opt.zero_grad(set_to_none=True)
    label = f"train {args.train_layers} layers, {args.train_tokens} tokens"
    loss, prof, wall_f = profiled(lambda: llama.loss_fn(params, cfg, tokens))
    report(f"{label}: forward", prof, wall_f, 1)
    _, prof, wall_b = profiled(loss.backward)
    report(f"{label}: backward", prof, wall_b, 1)
    _, prof, wall_o = profiled(opt.step)
    report(f"{label}: AdamW step", prof, wall_o, 1)
    total = wall_f + wall_b + wall_o
    print(f"{label}: step wall {total * 1e3:.2f} ms under the profiler, "
          f"{args.train_tokens / total:.0f} tok/s")


if __name__ == "__main__":
    sys.exit(main())
