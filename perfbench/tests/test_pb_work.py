"""Operation and byte counts against hand-worked small shapes and
against frozen copies of the counts of a stack whose layers are alike,
and the shares the readers make of them."""

import pytest

from harness import catalog, model, record, work
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


# Frozen copies of ``work.prefill_flops``, ``work.decode_flops`` and
# ``record._launch_bounds`` as they were when every layer was alike (one
# window, ``layers`` times one layer).
def frozen_prefill_flops(m, s, prefix):
    pairs = work.causal_pairs(s, prefix + s, m["window"])
    return (m["layers"] * (s * work.token_flops(m)
                           + 4.0 * m["n_heads"] * m["hd"] * pairs)
            + 2.0 * m["d"] * m["vocab"])


def frozen_decode_flops(m, contexts):
    w = m["window"]
    toks = sum(min(c, w) if w else c for c in contexts)
    return (m["layers"] * (len(contexts) * work.token_flops(m)
                           + 4.0 * m["n_heads"] * m["hd"] * toks)
            + 2.0 * m["d"] * m["vocab"] * len(contexts))


def frozen_launch_bounds(run, kind):
    g, tr = run.geometry, run.trace
    total = 0.0
    for c in run.calls:
        if not (tr.lo <= c[0] < tr.hi) or c[1] != kind:
            continue
        if kind == "prefill":
            flops, nbytes = work.k1_work(c[2], c[3] + c[2], g["window"],
                                         g["n_heads"], g["n_kv"], g["hd"])
        else:
            rows = list(c[2]) + [1] * (run.batch_rows - len(c[2]))
            flops, nbytes = work.k2_work(rows, g["window"], g["n_heads"],
                                         g["n_kv"], g["hd"])
        total += g["layers"] * work.bound_s(flops, nbytes)
    return total


PREFILLS = [(1, 0), (16, 0), (256, 0), (1000, 3000), (3072, 0), (4096, 0),
            (17, 4080), (512, 4096), (2048, 6000)]
DECODES = [[1], [4096], [4097], [5, 7], [4095, 4096, 4097, 9000],
           list(range(1, 8193, 256)), list(range(300, 4100, 123))]


def _calls():
    calls = [(0.1 * i, "prefill", s, p) for i, (s, p) in enumerate(PREFILLS)]
    calls += [(5.0 + 0.1 * i, "decode", c) for i, c in enumerate(DECODES)]
    return calls


@pytest.mark.parametrize("name", [c["name"] for c in
                                  catalog.benchmark()["configs"]])
def test_real_geometries_count_as_before(name):
    g = model.geometry(catalog.config(name))
    for s, prefix in PREFILLS:
        assert work.prefill_flops(g, s, prefix) == frozen_prefill_flops(
            g, s, prefix)
    for contexts in DECODES:
        assert work.decode_flops(g, contexts) == frozen_decode_flops(
            g, contexts)
    run = _run(geometry=g, calls=_calls(), batch_rows=32)
    run.trace = Summary(lo=0.0, hi=10.0, window_s=10.0, busy_s=1.0,
                        kernel_s={"k1": 0.5, "k2": 0.25})
    for kind in ("prefill", "decode"):
        assert record._launch_bounds(run, kind) == frozen_launch_bounds(
            run, kind)


# A stack of four layers: a dense one and two routed ones (8 experts of
# 4, top-2, a shared expert of 4) under a window of 2048, then a routed
# one attending every key.
ATTN = 8 * 8 + 2 * 8 * 4 + 8 * 8                   # q, k, v, o
DENSE = 2.0 * (ATTN + 3 * 8 * 16)                  # SwiGLU of 16
ROUTED = 2.0 * (ATTN + 2 * 3 * 8 * 4 + 3 * 8 * 4 + 8 * 8)
MIXED = {**G, "layers": 4, "plan": [
    {"count": 1, "window": 2048, "n_heads": 2, "n_kv": 1, "hd": 4,
     "token_flops": DENSE},
    {"count": 2, "window": 2048, "n_heads": 2, "n_kv": 1, "hd": 4,
     "token_flops": ROUTED},
    {"count": 1, "window": 0, "n_heads": 2, "n_kv": 1, "hd": 4,
     "token_flops": ROUTED}]}


def test_a_mixed_plan_is_the_sum_of_its_layers():
    assert (DENSE, ROUTED) == (1152.0, 1088.0)
    # 3000 new tokens: 2048 * 2049 / 2 + 952 * 2048 pairs under the
    # window, 3000 * 3001 / 2 without.
    win, full = 4047872, 4501500
    assert work.causal_pairs(3000, 3000, 2048) == win
    assert work.prefill_flops(MIXED, 3000, 0) == (
        (3000 * 1152 + 32 * win) + 2 * (3000 * 1088 + 32 * win)
        + (3000 * 1088 + 32 * full) + 2 * 8 * 10)
    # Rows attending 100 and 3000 keys: 2148 under the window, 3100 not.
    assert work.decode_flops(MIXED, [100, 3000]) == (
        (2 * 1152 + 32 * 2148) + 2 * (2 * 1088 + 32 * 2148)
        + (2 * 1088 + 32 * 3100) + 2 * 2 * 8 * 10)
    run = _run(geometry=MIXED, calls=[(0.5, "prefill", 3000, 0),
                                      (1.5, "decode", [100, 3000])],
               batch_rows=3)
    run.trace = Summary(lo=0.0, hi=5.0, window_s=5.0, busy_s=1.0,
                        kernel_s={"k1": 1.0, "k2": 1.0})
    b = work.bound_s
    assert record._launch_bounds(run, "prefill") == pytest.approx(
        3 * b(*work.k1_work(3000, 3000, 2048, 2, 1, 4))
        + b(*work.k1_work(3000, 3000, 0, 2, 1, 4)), rel=1e-12)
    assert record._launch_bounds(run, "decode") == pytest.approx(
        3 * b(*work.k2_work([100, 3000, 1], 2048, 2, 1, 4))
        + b(*work.k2_work([100, 3000, 1], 0, 2, 1, 4)), rel=1e-12)
