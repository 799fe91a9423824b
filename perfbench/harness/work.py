"""Operations and bytes of the work a run did, and the card's peaks: the
yardstick of every share of a peak or a roofline.

Frozen copies, so that later edits of the program or its tools cannot
move the yardstick:

- ``PEAK_BF16``, ``HBM_BPS``, :func:`bound_s` and :func:`causal_pairs`
  from ``chip_smoke.py`` (``PEAK_BF16``, ``HBM_BPS``, ``bound_ms``,
  ``causal_pairs``), ``bound_s`` in seconds;
- :func:`k1_work` from ``chip_smoke.py`` phase 2's operations and bytes
  of one flash prefill launch (q and out read and written once, k and v
  read once);
- :func:`k2_work` from ``chip_smoke.py`` ``decode_bound``.

:func:`step_flops` counts a model call's useful operations: each
processed token through every weight it needs (for a routed layer, its
``top_k`` experts, not a dispatch's padding), attention over the causal
(windowed) pairs, and the output head only for rows whose logits are
needed (a prefill's last row, each decode row).
"""

# NVIDIA H100 SXM data sheet: dense bf16 tensor rate and HBM3 bandwidth,
# at the full 700 W power limit.
PEAK_BF16 = 989e12
HBM_BPS = 3.35e12


def bound_s(flops, nbytes, peak=PEAK_BF16):
    """The least time of ``flops`` operations over ``nbytes`` bytes."""
    return max(flops / peak, nbytes / HBM_BPS)


def causal_pairs(s_q, s_kv, window):
    """(query, key) pairs the causal (windowed) mask keeps, the queries
    being the last ``s_q`` of ``s_kv`` positions."""
    off = s_kv - s_q
    total = 0
    for i in range(s_q):
        hi = i + off + 1
        lo = max(0, i + off - window + 1) if window else 0
        total += hi - lo
    return total


def k1_work(s_q, s_kv, window, n_heads, n_kv, hd, esize=2):
    """(operations, bytes) of one causal flash prefill launch."""
    flops = 4.0 * n_heads * hd * causal_pairs(s_q, s_kv, window)
    nbytes = (2 * s_q * n_heads * hd + 2 * s_kv * n_kv * hd) * esize
    return flops, nbytes


def k2_work(lens, window, n_heads, n_kv, hd, esize=2):
    """(operations, bytes) of one paged decode launch over rows attending
    ``lens`` tokens each."""
    toks = sum(min(s, window) if window else s for s in lens)
    nbytes = (toks * n_kv * hd * 2 + 2 * len(lens) * n_heads * hd) * esize
    return 4.0 * toks * n_heads * hd, nbytes


def token_flops(m):
    """Operations of one token through one layer's weights (model dict
    ``m`` from ``harness.model.geometry``)."""
    d, q, kv = m["d"], m["n_heads"] * m["hd"], m["n_kv"] * m["hd"]
    attn = d * q + 2 * d * kv + q * d
    if m["experts"]:
        ffn = m["top_k"] * 3 * d * m["ff"] + d * m["experts"]
    else:
        ffn = 3 * d * m["ff"]
    return 2.0 * (attn + ffn)


def prefill_flops(m, s, prefix):
    """A prefill of ``s`` tokens over ``prefix`` cached ones."""
    pairs = causal_pairs(s, prefix + s, m["window"])
    return (m["layers"] * (s * token_flops(m)
                           + 4.0 * m["n_heads"] * m["hd"] * pairs)
            + 2.0 * m["d"] * m["vocab"])


def decode_flops(m, contexts):
    """A decode step of rows whose new token attends ``contexts``
    tokens (the live rows only)."""
    w = m["window"]
    toks = sum(min(c, w) if w else c for c in contexts)
    return (m["layers"] * (len(contexts) * token_flops(m)
                           + 4.0 * m["n_heads"] * m["hd"] * toks)
            + 2.0 * m["d"] * m["vocab"] * len(contexts))
