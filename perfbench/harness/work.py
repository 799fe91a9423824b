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

:func:`prefill_flops` and :func:`decode_flops` count a model call's
useful operations, layer group by layer group of the geometry's
:func:`plan`: each processed token through every weight it needs (for a
routed layer, its ``top_k`` experts, not a dispatch's padding; a
group's ``token_flops``), attention over the causal pairs of the
group's window, and the output head only for rows whose logits are
needed (a prefill's last row, each decode row). Each group counts
``count`` times one layer, and the groups are summed from 0, so a stack
of one group counts as ``layers`` times one layer.
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
    """Operations of one token through one layer's weights, a layer of a
    stack whose layers are alike (model dict ``m``: :func:`plan`'s keys
    and ``d``, ``ff``, ``experts``, ``top_k``)."""
    d, q, kv = m["d"], m["n_heads"] * m["hd"], m["n_kv"] * m["hd"]
    attn = d * q + 2 * d * kv + q * d
    if m["experts"]:
        ffn = m["top_k"] * 3 * d * m["ff"] + d * m["experts"]
    else:
        ffn = 3 * d * m["ff"]
    return 2.0 * (attn + ffn)


def uniform_plan(m):
    """One group of ``m["layers"]`` layers alike (:func:`token_flops`)."""
    return [{"count": m["layers"], "window": m["window"],
             "n_heads": m["n_heads"], "n_kv": m["n_kv"], "hd": m["hd"],
             "token_flops": token_flops(m)}]


def plan(m):
    """The layers of model dict ``m`` in groups, in layer order: each
    group's ``count`` of layers, their ``window`` (0: none), ``n_heads``,
    ``n_kv``, ``hd`` and ``token_flops``. A dict without ``plan`` is one
    group (:func:`uniform_plan`)."""
    return m["plan"] if "plan" in m else uniform_plan(m)


def prefill_flops(m, s, prefix):
    """A prefill of ``s`` tokens over ``prefix`` cached ones."""
    total = 0.0
    for grp in plan(m):
        pairs = causal_pairs(s, prefix + s, grp["window"])
        total += grp["count"] * (s * grp["token_flops"]
                                 + 4.0 * grp["n_heads"] * grp["hd"] * pairs)
    return total + 2.0 * m["d"] * m["vocab"]


def decode_flops(m, contexts):
    """A decode step of rows whose new token attends ``contexts``
    tokens (the live rows only)."""
    total = 0.0
    for grp in plan(m):
        w = grp["window"]
        toks = sum(min(c, w) if w else c for c in contexts)
        total += grp["count"] * (len(contexts) * grp["token_flops"]
                                 + 4.0 * grp["n_heads"] * grp["hd"] * toks)
    return total + 2.0 * m["d"] * m["vocab"] * len(contexts)
