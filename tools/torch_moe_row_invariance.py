#!/usr/bin/env python3
"""Are the MoE layer's products row-invariant on the card: does a row's
result depend on how many rows the product has? (A cached-prefix
prefill routes 256 suffix tokens where the full prefill routes 2304; a
router whose logits move with T routes nearly-tied tokens differently.)

    python3 tools/torch_moe_row_invariance.py

At Mixtral-8x7B's widths, bf16 expert products (torch.bmm over [8, C,
4096] and [8, C, 14336], a block of rows placed at the same slots in C =
8, 256, 512 against 2304 or 4096), bf16 ``h @ W`` (M = 4, 256 against
2304) and the router's product (float32, and float64 rounded to
float32, as ``moe._route`` computes it) each print whether the rows are
bit-equal and their largest difference.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    d, ff, E, T, P = 4096, 14336, 8, 2304, 2048

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=g)
                * scale).bfloat16()

    def same(name, a, b):
        print(f"{name}: bit-equal {torch.equal(a, b)}, max |diff| "
              f"{(a.float() - b.float()).abs().max().item():.3e}")

    h = rnd(T, d)
    router = torch.randn(d, E, device="cuda", generator=g) / 64
    same("router float32, T 256 vs 2304",
         (h.float() @ router)[P:], h[P:].float() @ router)
    f64 = lambda x: (x.double() @ router.double()).float()  # noqa: E731
    same("router float64 -> float32, T 256 vs 2304", f64(h)[P:], f64(h[P:]))
    w_in, w_out = rnd(E, d, ff, scale=1 / 64), rnd(E, ff, d, scale=1 / 64)
    for small, big in ((8, 2304), (256, 2304), (512, 4096)):
        for name, w, width in (("gate/up", w_in, d), ("down", w_out, ff)):
            xs, xb = rnd(E, small, width), rnd(E, big, width)
            xb[:, 100:100 + small] = xs
            same(f"bmm {name}, C {small} vs {big}", torch.bmm(xs, w),
                 torch.bmm(xb, w)[:, 100:100 + small])
    wq = rnd(d, d, scale=1 / 64)
    for m in (4, 256):
        same(f"h @ W bf16, M {m} vs 2304", (h @ wq)[P:P + m], h[P:P + m] @ wq)
    import chip_smoke
    print(chip_smoke.card_line())


if __name__ == "__main__":
    main()
