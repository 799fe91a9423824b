"""How ``correct`` is decided: after the window, a sample of the
requests the timed path finished (drawn from the seed, the longest among
them) goes through the plain reference of the configuration's family
(its ``logits``: ``harness.model``) over its prompt and its served
tokens, and the number compared is the widest gap by which a served
token's reference logit lies below the reference's best at its position.
Greedy decoding serves the program's best, so a sound program leaves
only its rounding in that gap.

The control (``perfbench/control.py``) reads the same gap for the token
that a lower precision puts first at each of those positions.
"""

import numpy as np
import torch

from .model import family

# Served tokens the sample reaches: some hundreds, beside the longest
# request.
SAMPLE_TOKENS = 384


def sample(turns, seed, want_tokens, routes_of=None):
    """Finished requests: the one with the longest context, then others
    in an order drawn from ``seed`` until ``want_tokens`` served tokens.
    With ``routes_of``, only requests whose routing was recorded whole."""
    done = sorted((t for t in turns if t.done), key=lambda t: t.rid)
    if routes_of is not None:
        done = [t for t in done if _routes(routes_of, t) is not None]
    if not done:
        return []
    longest = max(done, key=lambda t: len(t.prompt) + len(t.tokens))
    rest = [t for t in done if t is not longest]
    picked, n = [longest], len(longest.tokens)
    for i in np.random.default_rng([int(seed) % (1 << 63), 9]).permutation(
            len(rest)):
        if n >= want_tokens:
            break
        picked.append(rest[i])
        n += len(rest[i].tokens)
    return picked


def _routes(routes_of, t):
    return routes_of(t.rid, len(t.prompt) + len(t.tokens) - 1)


def gaps(weights, g, turns, quant=None, routes_of=None):
    """(served gaps, control gaps, routing margins) over ``turns``: per
    served position, the reference's best logit minus that of the served
    token, and with ``quant`` minus that of the token the lower precision
    puts first; per token and routed layer, the routing margin of the
    program's choices (``routes_of(rid, length)``; without it the
    reference routes itself and there are none), and with ``quant``
    under the lower precision too (then each turn's are a pair)."""
    logits = family(g).logits
    served, control, margins = [], [], []
    for t in turns:
        seq = t.prompt + t.tokens[:-1]
        pos = list(range(len(t.prompt) - 1, len(seq)))
        routes = None if routes_of is None else _routes(routes_of, t)
        ref, margin = logits(weights, g, seq, pos, routes=routes)
        best = ref.max(-1).values
        toks = torch.as_tensor(t.tokens, device=ref.device)[:, None]
        served.append((best - ref.gather(1, toks)[:, 0]).cpu())
        if quant is not None:
            low, low_margin = logits(weights, g, seq, pos, quant, routes)
            pick = low.argmax(-1, keepdim=True)
            control.append((best - ref.gather(1, pick)[:, 0]).cpu())
            margin = [margin, low_margin]
        margins.append(margin)
        del ref
    return served, control, margins


def summary(served, margins):
    """``max_gap`` (the widest gap), ``mean_gap`` (the mean over every
    served token), ``off_argmax`` (the share of them that are not the
    reference's best); for a routed model ``route_margin`` (the largest
    routing margin), ``route_margin_mean`` (the mean over every token's
    decision at every routed layer) and ``route_margin_layer`` (the
    largest of the routed layers' means, so that a fault in one layer is
    not spread over the others). ``margins`` is each sequence's
    [layers, tokens]."""
    flat = torch.cat(served)
    out = {"max_gap": float(flat.max()), "mean_gap": float(flat.mean()),
           "off_argmax": float((flat > 0).float().mean())}
    m = torch.cat(margins, dim=1)
    if m.numel():
        out.update(route_margin=float(m.max()),
                   route_margin_mean=float(m.mean()),
                   route_margin_layer=float(m.mean(dim=1).max()))
    return out


def readings(weights, g, turns, seed, routes_of=None):
    """The sample's readings (:func:`summary`) with its size; None when
    no request finished."""
    picked = sample(turns, seed, SAMPLE_TOKENS, routes_of)
    if not picked:
        return None
    served, _, margins = gaps(weights, g, picked, routes_of=routes_of)
    return {**summary(served, margins), "requests": len(picked),
            "tokens": sum(len(t.tokens) for t in picked),
            "longest_context": max(len(t.prompt) + len(t.tokens)
                                   for t in picked)}


def judge(weights, g, turns, seed, limits, routes_of=None):
    """(correct, each number compared beside its limit, every reading).
    ``limits`` are the cell's: reading name -> the largest value a
    correct run may read."""
    found = readings(weights, g, turns, seed, routes_of)
    compared = {name: {"value": None if found is None else found[name],
                       "limit": limit}
                for name, limit in limits.items()}
    correct = found is not None and all(
        c["value"] <= c["limit"] for c in compared.values())
    return correct, compared, found or {}
