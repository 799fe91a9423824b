"""K1's tile schedule (``ops/flash_attention.k1_schedule``, the Python
twin of csrc/flash_prefill.cu's walk and flash_tile.cuh's geometry)
against the JAX package's mask rules, on the CPU: every (query, key)
pair that ``_tile_mask`` keeps lies in a visited tile, no visited tile is
wholly masked, and a tile is interior exactly where its mask is all true
and ``_interior_tile`` says so. At K1's bf16 tiles (one or two 64-row
consumers over 128-key tiles, and over 64-key tiles at capacity 256) and
at the 64 x 64 tiles of the f32 variant, K3, K5 and K6; lengths one
below, at and one above a tile multiple, windows, a cached prefix (s_kv
> s_q) and no causal mask. K6 at capacity 256 splits each kv head's
group of q heads into runs (``k6_splits``): every kept (kv row, q head,
query) pair lies in exactly one split's walk."""

import os
import re

import numpy as np
import pytest

from infinistore_tpu.ops.pallas_flash_attention import (_interior_tile,
                                                       _tile_mask)
from infinistore_tpu_torch.ops import flash_attention as fa

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "infinistore_tpu_torch", "csrc")

# (s_q, s_kv, causal, window)
SHAPES = (
    (127, 127, True, 0), (128, 128, True, 0), (129, 129, True, 0),
    (255, 257, True, 0), (256, 256, True, 0), (257, 385, True, 0),
    (1, 1, True, 0), (17, 2065, True, 0), (256, 2304, True, 0),
    (300, 1000, True, 512), (1000, 1000, True, 0), (1000, 1000, True, 256),
    (129, 129, True, 1), (200, 200, True, 64), (255, 383, True, 100),
    (511, 1024, True, 128), (65, 700, True, 127), (640, 640, True, 129),
    (1000, 1000, False, 0), (129, 63, False, 0), (63, 257, False, 0),
)
# (label, query rows per CTA, keys per tile, rows per consumer, K1's
# head dim or None for the f32 tiles)
TILES = (
    ("k1 two consumers", 2 * fa.K1_ROWS, fa.K1_BK, fa.K1_ROWS, 128),
    ("k1 one consumer", fa.K1_ROWS, fa.K1_BK, fa.K1_ROWS, 128),
    ("64x64", 64, 64, 64, None),
    ("k1 hd256 two consumers", 2 * fa.K1_ROWS, fa.K1_BK_WIDE, fa.K1_ROWS,
     256),
    ("k1 hd256 one consumer", fa.K1_ROWS, fa.K1_BK_WIDE, fa.K1_ROWS, 256),
)


def _full_mask(s_q, s_kv, causal, window, bq, bk):
    """_tile_mask over the whole padded [q tiles x bq, kv tiles x bk]
    matrix (the mask depends only on positions)."""
    shape = (-(-s_q // bq) * bq, -(-s_kv // bk) * bk)
    return np.asarray(_tile_mask(shape, 0, 0, s_q, s_kv, causal, window))


def _walk(s_q, s_kv, causal, window, bq, bk, sub, hd):
    """The schedule at any tile: k1_schedule at K1's tiles (head dim
    ``hd``), else the same walk built from kv_tile_range and
    interior_tile at (bq, bk)."""
    if hd is not None:
        assert (bk, sub) == (fa.k1_bk(hd), fa.K1_ROWS)
        return fa.k1_schedule(s_q, s_kv, causal, window, bq // fa.K1_ROWS,
                              hd)
    n_qt = -(-s_q // bq)
    walk = []
    for rank in range(n_qt):
        q0 = (n_qt - 1 - rank) * bq
        begin, end = fa.kv_tile_range(q0, s_q, s_kv, causal, window, bq, bk)
        walk.append((q0, [(kt * bk, (fa.interior_tile(
            q0, kt * bk, s_q, s_kv, causal, window, bq, bk),))
            for kt in range(begin, end)]))
    return walk


@pytest.mark.parametrize("tiles", TILES, ids=[t[0] for t in TILES])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_schedule_matches_jax_mask(shape, tiles):
    s_q, s_kv, causal, window = shape
    _, bq, bk, sub, hd = tiles
    mask = _full_mask(s_q, s_kv, causal, window, bq, bk)
    walk = _walk(s_q, s_kv, causal, window, bq, bk, sub, hd)
    n_qt = -(-s_q // bq)
    assert sorted(q0 for q0, _ in walk) == [i * bq for i in range(n_qt)]
    for q0, tiles_visited in walk:
        rows = mask[q0:q0 + bq]
        seen = np.zeros(mask.shape[1], bool)
        for k0, interior in tiles_visited:
            block = rows[:, k0:k0 + bk]
            assert block.any(), f"q {q0} kv {k0}: visited but wholly masked"
            seen[k0:k0 + bk] = True
            for c, flag in enumerate(interior):
                r0 = q0 + c * sub
                part = mask[r0:r0 + sub, k0:k0 + bk]
                jax_flag = bool(_interior_tile(r0, k0, sub, bk, s_q, s_kv,
                                               causal, window))
                assert flag == jax_flag == bool(part.all()), (
                    f"q {r0} kv {k0}: interior {flag}, JAX {jax_flag}, "
                    f"mask all true {bool(part.all())}")
        kept_keys = rows.any(axis=0)
        assert not (kept_keys & ~seen).any(), (
            f"q tile {q0}: kept keys outside the visited tiles")


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] and not s[3]],
                         ids=lambda s: "-".join(map(str, s)))
def test_heaviest_q_tiles_first(shape):
    """Causal without a window: live kv tiles never grow along the
    launch order."""
    s_q, s_kv, causal, window = shape
    for consumers in (1, 2):
        for hd in (128, 256):
            counts = [len(t) for _, t in fa.k1_schedule(
                s_q, s_kv, causal, window, consumers, hd)]
            assert counts == sorted(counts, reverse=True)


CONSUMER_SHAPES = [
    (1, 2048, 32, 2),   # 16 x 32 = 512 CTAs of 128 rows
    (1, 256, 32, 1),    # the prefix-hit suffix: 2 x 32 = 64 < 132 SMs
    (2, 1024, 32, 2),
    (1, 17, 32, 1),
    (1, 1000, 16, 1),   # 8 x 16 = 128 < 132
    (1, 1056, 16, 2),   # 9 x 16 = 144
]


@pytest.mark.parametrize("batch,s_q,n_heads,want", CONSUMER_SHAPES)
def test_consumers_by_shape(batch, s_q, n_heads, want):
    """Two consumers (128-row q tiles) unless the grid would leave some of
    an H100's 132 SMs idle."""
    assert fa.k1_consumers(batch, s_q, n_heads, 132) == want


@pytest.mark.parametrize("hd", (64, 128, 136, 192, 256))
@pytest.mark.parametrize("batch,s_q,n_heads,want", CONSUMER_SHAPES)
def test_k5_consumers_by_shape(batch, s_q, n_heads, want, hd):
    """K5 takes K1's rule at hd <= 128 and one consumer at every head dim
    of capacity 256, as its launch_bf16 does."""
    assert fa.k5_consumers(batch, s_q, n_heads, hd, 132) == (
        want if hd <= 128 else 1)
    bf16 = _body("flash_bwd_dq.cu", "int launch_bf16(")
    wide = bf16[bf16.index("if constexpr (HD > 128)"):]
    assert wide.index("launch_wgmma<HD, 1>") < wide.index("}")


def _constant(path, name):
    with open(os.path.join(CSRC, path)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} not in {path}"
    return int(m.group(1))


def test_tile_constants_match_csrc():
    """The Python twin's tile sizes are the kernels' own."""
    assert _constant("flash_prefill.cu", "kRows") == fa.K1_ROWS
    assert _constant("flash_prefill.cu", "kBK") == fa.K1_BK
    assert _constant("flash_prefill.cu", "kBKWide") == fa.K1_BK_WIDE
    assert _constant("flash_tile.cuh", "BQ") == TILES[2][1]
    assert _constant("flash_tile.cuh", "BK") == TILES[2][2]
    assert [fa.k1_bk(hd) for hd in (8, 64, 128, 136, 192, 256)] == [
        fa.K1_BK] * 3 + [fa.K1_BK_WIDE] * 3


def _body(path, signature):
    """The text of the function whose definition starts with
    ``signature`` in csrc/``path``, to its closing brace."""
    with open(os.path.join(CSRC, path)) as f:
        text = f.read()
    start = text.index(signature)
    depth, i = 0, text.index("{", start)
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[start:j + 1]
    raise AssertionError(f"{signature} in {path} has no end")


@pytest.mark.parametrize("path", ["flash_prefill.cu", "flash_bwd_dkv.cu",
                                  "flash_bwd_dq.cu"])
def test_bf16_routes_reach_no_tile_loop(path):
    """K1, K5 and K6 in bf16 go to the wgmma kernel at every capacity, hd
    256 included; their f32 instantiations still take the tile loop."""
    bf16 = _body(path, "int launch_bf16(")
    assert "launch_tile" not in bf16 and "launch_wgmma" in bf16
    assert "launch_tile<float, HD>" in _body(path, "int launch_f32(")



# ---- K5 and K6 (flash backward): the bf16 kernels' walks ----

from infinistore_tpu.ops.pallas_flash_attention import (  # noqa: E402
    _make_row_maps)

BWD_SHAPES = (
    (128, 128, True, 0), (129, 129, True, 0), (200, 200, True, 0),
    (128, 320, True, 0), (96, 300, True, 40), (256, 256, True, 48),
    (1000, 1000, True, 0), (512, 2048, True, 256), (300, 700, True, 128),
    (17, 2065, True, 0), (1000, 1000, False, 0), (63, 257, False, 0),
)
GROUPS = (1, 4, 7)


def _live(flag):
    return flag != "dead"


@pytest.mark.parametrize("consumers", (1, 2))
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_k5_schedule_matches_jax_rules(shape, consumers):
    """K5's walk: q tiles heaviest first; each CTA visits exactly the kv
    tiles that _bwd_dq_kernel's live rule keeps for its rows (none past
    the last real row's diagonal); a consumer is "dead" on a tile its 64
    rows see none of, else interior exactly where _interior_tile says so
    and the mask is all true; every kept pair lies in a visited tile."""
    s_q, s_kv, causal, window = shape
    rows, bk = fa.K5_ROWS, fa.K5_BK
    bq = consumers * rows
    walk = fa.k5_schedule(s_q, s_kv, causal, window, consumers)
    n_qt = -(-s_q // bq)
    assert [q0 for q0, _ in walk] == [(n_qt - 1 - i) * bq
                                      for i in range(n_qt)]
    mask = _full_mask(s_q, s_kv, causal, window, bq, bk)
    offset = s_kv - s_q
    for q0, tiles in walk:
        real = mask[q0:min(q0 + bq, s_q)]
        want = [k0 for k0 in range(0, s_kv, bk) if real[:, k0:k0 + bk].any()]
        assert [k0 for k0, _ in tiles] == want, f"q tile {q0}"
        for k0, states in tiles:
            # _bwd_dq_kernel's live rule holds for every visited tile.
            if causal:
                assert k0 <= q0 + bq - 1 + offset
                if window:
                    assert k0 + bk - 1 > q0 + offset - window
            for c, state in enumerate(states):
                r0 = q0 + c * rows
                part = mask[r0:r0 + rows, k0:k0 + bk]
                assert _live(state) == bool(part.any()), (r0, k0, state)
                if _live(state):
                    jax_flag = bool(_interior_tile(r0, k0, rows, bk, s_q,
                                                   s_kv, causal, window))
                    assert (state == "interior") == jax_flag == bool(
                        part.all()), (r0, k0, state)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_k6_schedule_matches_jax_rules(shape, group):
    """K6's walk: kv tiles of 64 rows from 0 up; each CTA walks every q
    head of its kv head's group (_make_row_maps' _kv_row) over exactly the
    q tiles that _bwd_dkv_kernel's live rule keeps, starting where
    _q_idx's frozen index starts, the two consumers taking the stages in
    turn; a kv tile no query sees has no stage (its rows are written as
    zeros); every stage sees some of the tile, and is interior exactly
    where _interior_tile says so and the mask is all true."""
    s_q, s_kv, causal, window = shape
    rows, bq = fa.K6_ROWS, fa.K6_BQ
    n_kv = 2
    n_heads = n_kv * group
    walk = fa.k6_schedule(s_q, s_kv, group, causal, window)
    assert [k0 for k0, _ in walk] == list(range(0, s_kv, rows))
    mask = _full_mask(s_q, s_kv, causal, window, bq, rows)
    offset = s_kv - s_q
    kv_row, _, q_idx = _make_row_maps(n_heads, n_kv, group, bq, rows, causal,
                                      offset)
    for k0, stages in walk:
        cols = mask[:, k0:k0 + rows]
        want = [q0 for q0 in range(0, s_q, bq) if cols[q0:q0 + bq].any()]
        if not want:
            assert stages == [], f"kv tile {k0} sees no query: dead"
            continue
        assert [(g, q0) for g, q0, _, _ in stages] == [
            (g, q0) for g in range(group) for q0 in want]
        assert [c for _, _, c, _ in stages] == [
            i % fa.K6_CONSUMERS for i in range(len(stages))]
        for kvh in range(n_kv):
            heads = {kvh * group + g for g, _, _, _ in stages}
            assert {kv_row(h) for h in heads} == {kvh}
        if causal:
            first = int(q_idx(0, k0 // rows, 0)[1]) * bq
            assert want[0] == first, (k0, want[0], first)
        for g, q0, _, state in stages:
            if causal:
                assert q0 + bq - 1 + offset >= k0
                if window:
                    assert q0 <= k0 + rows - 1 - offset + window - 1
            part = mask[q0:q0 + bq, k0:k0 + rows]
            assert part.any() and state in ("interior", "masked")
            jax_flag = bool(_interior_tile(q0, k0, bq, rows, s_q, s_kv,
                                           causal, window))
            assert (state == "interior") == jax_flag == bool(part.all()), (
                q0, k0, state)


def test_bwd_tile_constants_match_csrc():
    """The Python twins' backward tile sizes are the kernels' own."""
    assert _constant("flash_bwd_dq.cu", "kRows") == fa.K5_ROWS
    assert _constant("flash_bwd_dq.cu", "kBK") == fa.K5_BK
    assert _constant("flash_bwd_dkv.cu", "kRows") == fa.K6_ROWS
    assert _constant("flash_bwd_dkv.cu", "kBQ") == fa.K6_BQ
    assert _constant("flash_bwd_dkv.cu", "kNC") == fa.K6_CONSUMERS


# ---- K6 at capacity 256: the group's q heads split over the grid ----

K6_SPLITS = tuple((g, n) for g in (1, 4, 7, 8)
                  for n in range(1, g + 1) if g % n == 0)


@pytest.mark.parametrize("group,splits", K6_SPLITS,
                         ids=lambda x: str(x))
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_k6_wide_schedule_covers_each_pair_once(shape, group, splits):
    """K6's walk at capacity 256: kv tiles of 64 rows from 0 up, the
    splits of each tile side by side; split s walks members [s * group /
    splits, (s + 1) * group / splits) over exactly the q tiles that
    _bwd_dkv_kernel's live rule keeps; every kept (kv row, q head, query)
    pair of _tile_mask lies in exactly one split's stages and no dropped
    pair in any; each stage is interior exactly where _interior_tile says
    so and the mask is all true; a kv tile no query sees has no stage in
    any split."""
    s_q, s_kv, causal, window = shape
    rows, bq = fa.K6_ROWS, fa.K6_BQ
    walk = fa.k6_wide_schedule(s_q, s_kv, group, splits, causal, window)
    assert [(k0, sp) for k0, sp, _ in walk] == [
        (k0, sp) for k0 in range(0, s_kv, rows) for sp in range(splits)]
    mask = _full_mask(s_q, s_kv, causal, window, bq, rows)
    kept = mask[:s_q, :s_kv]
    seen = np.zeros((group, s_q, s_kv), np.int32)
    for k0, split, stages in walk:
        lo, hi = split * group // splits, (split + 1) * group // splits
        assert {g for g, _, _ in stages} <= set(range(lo, hi))
        cols = mask[:, k0:k0 + rows]
        want = [q0 for q0 in range(0, s_q, bq) if cols[q0:q0 + bq].any()]
        assert [(g, q0) for g, q0, _ in stages] == [
            (g, q0) for g in range(lo, hi) for q0 in want]
        for g, q0, state in stages:
            part = mask[q0:q0 + bq, k0:k0 + rows]
            assert part.any()
            jax_flag = bool(_interior_tile(q0, k0, bq, rows, s_q, s_kv,
                                           causal, window))
            assert (state == "interior") == jax_flag == bool(part.all())
            seen[g, q0:q0 + bq, k0:k0 + rows] += kept[q0:q0 + bq,
                                                      k0:k0 + rows]
    assert (seen == kept[None].astype(np.int32)).all()


@pytest.mark.parametrize("args,want", [
    ((1, 2048, 1, 8, 256, "bfloat16"), 8),    # Gemma-2B: 32 CTAs alone
    ((1, 2048, 16, 1, 256, "bfloat16"), 1),   # Gemma-7B: 512 CTAs
    ((1, 2048, 2, 8, 256, "bfloat16"), 4),    # 64 CTAs: 4 x 64 fill 132
    ((1, 1000, 2, 4, 192, "bfloat16"), 4),    # 32 CTAs, hd 192
    ((1, 2048, 1, 7, 256, "bfloat16"), 7),    # a prime group: all or one
    ((1, 8448, 1, 8, 256, "bfloat16"), 1),    # 132 CTAs fill the card
    ((1, 2048, 1, 8, 128, "bfloat16"), 1),    # hd <= 128: no split
    ((1, 2048, 1, 8, 256, "float32"), 1),     # f32: the tile loop
])
def test_k6_splits_by_shape(args, want):
    """K6's split of the group: none where the grid fills an H100's 132
    SMs, else the least divisor of the group that does, else the group;
    only bf16 at capacity 256."""
    import torch

    batch, s_kv, n_kv, group, hd, dtype = args
    got = fa.k6_splits(batch, s_kv, n_kv, group, hd, getattr(torch, dtype),
                       132)
    assert got == want and group % got == 0
