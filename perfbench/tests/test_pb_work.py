"""Operation and byte counts against hand-worked small shapes, and the
shares the readers make of them."""

import pytest

from harness import record, work
from harness.trace import Summary

G = {"d": 8, "n_heads": 2, "n_kv": 1, "hd": 4, "ff": 16, "layers": 2,
     "vocab": 10, "window": 0, "experts": 0, "top_k": 0, "page": 16}


def test_causal_pairs():
    assert work.causal_pairs(3, 3, 0) == 6          # 1 + 2 + 3
    assert work.causal_pairs(2, 5, 0) == 9          # 4 + 5
    assert work.causal_pairs(3, 3, 2) == 5          # 1 + 2 + 2
    assert work.causal_pairs(1, 10, 4) == 4


def test_k1_and_k2_work():
    # 4 heads over 2 kv heads of 8: 9 pairs; q and out 2x4x8, k and v 5x2x8.
    assert work.k1_work(2, 5, 0, 4, 2, 8) == (
        4 * 4 * 8 * 9, (2 * 2 * 4 * 8 + 2 * 5 * 2 * 8) * 2)
    # rows of 3 and 10 tokens under a window of 4: 3 + 4 tokens.
    assert work.k2_work([3, 10], 4, 4, 2, 8) == (
        4 * 7 * 4 * 8, (7 * 2 * 8 * 2 + 2 * 2 * 4 * 8) * 2)


def test_bound_takes_the_larger_side():
    assert work.bound_s(work.PEAK_BF16, 0) == pytest.approx(1.0)
    assert work.bound_s(0, work.HBM_BPS) == pytest.approx(1.0)
    assert work.bound_s(work.PEAK_BF16, 2 * work.HBM_BPS) == pytest.approx(2.0)


def test_token_flops_dense_and_routed():
    # q 8x8, k and v 8x4, o 8x8; SwiGLU 3 x 8x16.
    assert work.token_flops(G) == 2 * (64 + 64 + 64 + 384)
    moe = {**G, "experts": 4, "top_k": 2}
    # two experts of 3 x 8x16 and the 8x4 router, not the 4 experts held.
    assert work.token_flops(moe) == 2 * (192 + 2 * 384 + 32)


def test_prefill_and_decode_flops():
    # 3 new tokens over 2 cached: 12 pairs; the head for the last row.
    assert work.prefill_flops(G, 3, 2) == (
        2 * (3 * 1152 + 4 * 2 * 4 * 12) + 2 * 8 * 10)
    # two live rows attending 5 and 7 tokens; the head for each row.
    assert work.decode_flops(G, [5, 7]) == (
        2 * (2 * 1152 + 4 * 2 * 4 * 12) + 2 * 2 * 8 * 10)


def _run(**kw):
    fields = dict(seconds=10.0,
                  steps=[(0.0, 2.0), (3.0, 4.0), (11.0, 12.0)],
                  calls=[(0.5, "prefill", 3, 2), (3.5, "decode", [5, 7]),
                         (11.5, "decode", [5])],
                  puts=[(1.0, 1.5, 100), (12.0, 13.0, 5)],
                  syncs=[(1.5, 2.0, 0)], gets=[(0.1, 0.3, 4e8)],
                  geometry=G, batch_rows=4)
    fields.update(kw)
    return record.Run(**fields)


def test_mfu_offload_and_restore_shares():
    run = _run()
    flops = work.prefill_flops(G, 3, 2) + work.decode_flops(G, [5, 7])
    peak_s = 3.0 * work.PEAK_BF16
    assert record.mfu(run) == pytest.approx(100 * flops / peak_s)
    assert record.offload_share(run) == pytest.approx(100 * 1.0 / 10.0)
    assert run.window_calls(run.gets) == (pytest.approx(0.2), 4e8, 1)
    assert record.offload_share(_run(puts=[])) is None


def test_rooflines_and_idle_from_a_trace():
    run = _run()
    assert record.roofline(run, "prefill", "k1") is None
    assert record.idle_share(run) is None
    run.trace = Summary(lo=0.0, hi=5.0, window_s=5.0, busy_s=1.0,
                        kernel_s={"k1": 1e-6, "k2": 0.0})
    f, b = work.k1_work(3, 5, 0, 2, 1, 4)
    assert record.roofline(run, "prefill", "k1") == pytest.approx(
        100 * 2 * work.bound_s(f, b) / 1e-6)
    assert record.roofline(run, "decode", "k2") is None  # no device time
    assert record.idle_share(run) == pytest.approx(80.0)
