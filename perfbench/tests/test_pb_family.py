"""A configuration's model family is a file found by name: a family
added as new files runs a cell end to end; the two families refuse the
keys of a model they do not run; and their weights are, leaf by leaf,
what the harness drew before families were files (a frozen copy of its
``make_weights`` below)."""

import glob
import json
import os
import re
import shutil
import time

import pytest
import torch

import tiny
from harness import catalog, model, run_cell

FAMILIES = ("llama", "moe")


# Frozen copy of ``harness.model`` ``_shapes`` and ``make_weights`` as
# they were before the families moved into ``families/``.
def frozen_shapes(g):
    d, q, kv, ff, e = (g["d"], g["n_heads"] * g["hd"],
                       g["n_kv"] * g["hd"], g["ff"], g["experts"])
    layer = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}
    if e:
        layer.update(e_gate=(e, d, ff), e_up=(e, d, ff), e_down=(e, ff, d))
    else:
        layer.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
    return layer


def frozen_make_weights(g, seed, device, chunk=1 << 30):
    dt = getattr(torch, g["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    std = g["d"] ** -0.5
    shapes = frozen_shapes(g)
    per_layer = sum(int(torch.Size(s).numel()) for s in shapes.values())
    total = 2 * g["vocab"] * g["d"] + g["layers"] * per_layer
    buf = torch.empty(total, dtype=dt, device=device)
    for lo in range(0, total, chunk):
        buf[lo:lo + chunk].normal_(0.0, std, generator=gen)
    at = 0

    def take(shape):
        nonlocal at
        n = int(torch.Size(shape).numel())
        view = buf[at:at + n].view(shape)
        at += n
        return view

    ones = torch.ones((2 * g["layers"] + 1, g["d"]), dtype=dt,
                      device=device)
    routers = None
    if g["experts"]:
        routers = torch.empty((g["layers"], g["d"], g["experts"]),
                              dtype=torch.float32, device=device)
        routers.normal_(0.0, std, generator=gen)
    embed = take((g["vocab"], g["d"]))
    lm_head = take((g["d"], g["vocab"]))
    layers = []
    for li in range(g["layers"]):
        layer = {name: take(shape) for name, shape in shapes.items()}
        layer["ln1"], layer["ln2"] = ones[2 * li], ones[2 * li + 1]
        if routers is not None:
            layer["router"] = routers[li]
        layers.append(layer)
    return {"embed": embed, "layers": layers, "final_ln": ones[-1],
            "lm_head": lm_head}


def leaves(tree, path=""):
    """(path, tensor) of every leaf, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_same_tree(new, old):
    a, b = list(leaves(new)), list(leaves(old))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("conf", [
    tiny.TINY, tiny.TINY_MOE, dict(tiny.TINY_MOE, torch_dtype="bfloat16"),
    dict(tiny.TINY, sliding_window=None, torch_dtype="float32")],
    ids=["llama", "moe-f32", "moe-bf16", "llama-f32"])
@pytest.mark.parametrize("chunk", [1 << 30, 1000])
def test_weights_are_the_frozen_draw(monkeypatch, conf, chunk):
    monkeypatch.setattr(model, "CHUNK", chunk)
    g = model.geometry(conf)
    for seed in (7, 2**40 + 3):
        assert_same_tree(model.make_weights(g, seed, "cpu"),
                         frozen_make_weights(g, seed, "cpu", chunk))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("key,value", [
    ("num_experts", 128), ("num_shared_experts", 1),
    ("layer_types", ["sliding_attention"] * 3 + ["full_attention"]),
    ("num_dense_layers", 2), ("score_func", "sigmoid"),
    ("hidden_act", "gelu"), ("tie_word_embeddings", True)])
def test_family_refuses_what_it_does_not_run(family, key, value):
    base = tiny.TINY_MOE if family == "moe" else tiny.TINY
    with pytest.raises(ValueError, match=key):
        model.geometry(dict(base, family=family, **{key: value}))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("window,kind", [
    (160, "sliding_attention"), (None, "full_attention")])
def test_one_kind_of_layer_agreeing_with_the_window(family, window, kind):
    base = tiny.TINY_MOE if family == "moe" else tiny.TINY
    conf = dict(base, family=family, sliding_window=window)
    g = model.geometry(dict(conf, layer_types=[kind] * 2))
    assert g["plan"][0]["window"] == (window or 0)
    other = ({"sliding_attention", "full_attention"} - {kind}).pop()
    with pytest.raises(ValueError, match="layer_types"):
        model.geometry(dict(conf, layer_types=[other] * 2))


@pytest.mark.parametrize("entry", catalog.benchmark()["configs"],
                         ids=lambda c: c["name"])
def test_real_configs_are_one_group(entry):
    conf = catalog.config(entry["name"])
    g = model.geometry(conf)
    (grp,) = g["plan"]
    assert grp["count"] == g["layers"] == conf["num_hidden_layers"]
    assert grp["window"] == (conf.get("sliding_window") or 0)
    assert (grp["n_heads"], grp["n_kv"], grp["hd"]) == (
        g["n_heads"], g["n_kv"], g["hd"])
    routed = model.family(g).route_attr is not None
    assert g["routed"] == (list(range(g["layers"])) if routed else [])


def test_harness_names_no_family():
    names = [os.path.basename(p)[:-3] for p in
             glob.glob(os.path.join(tiny.ROOT, "families", "*.py"))]
    assert sorted(names) == sorted(FAMILIES)
    for path in glob.glob(os.path.join(tiny.ROOT, "harness", "*.py")):
        with open(path) as f:
            text = f.read()
        for name in names:
            assert not re.search(rf"\b{name}\b", text, re.I), (path, name)


def test_family_added_as_new_files_runs_a_cell(tmp_path):
    root, bench = tiny.make_root(tmp_path)
    # A family of its own: the dense family's file under a new name,
    # reading a reference file of its own.
    shutil.copy(os.path.join(root, "reference", "plain.py"),
                os.path.join(root, "reference", "plain_copy.py"))
    with open(os.path.join(root, "families", "llama.py")) as f:
        text = f.read()
    assert 'catalog.reference("plain", ROOT)' in text
    with open(os.path.join(root, "families", "dense_copy.py"), "w") as f:
        f.write(text.replace('catalog.reference("plain", ROOT)',
                             'catalog.reference("plain_copy", ROOT)'))
    with open(os.path.join(root, "configs", "tiny-copy.json"), "w") as f:
        json.dump(dict(tiny.TINY, family="dense_copy"), f)
    with open(os.path.join(root, "workloads", "tiny-copy.sessions.json"),
              "w") as f:
        json.dump(tiny.CELL, f)
    bench["workloads"].append({"name": "tiny-copy.sessions",
                               "config": "tiny-copy", "traffic": "sessions",
                               "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.sessions" in m.get("workloads", ()):
            m["workloads"].append("tiny-copy.sessions")

    fam = catalog.family("dense_copy", root)
    assert fam._reference.__file__.endswith("plain_copy.py")
    result, _ = run_cell.run("tiny-copy.sessions", 5, 2.5, True, "cpu",
                             time.perf_counter(), bench=bench, root=root)
    assert result["correct"] is True, result["check"]
    assert result["traffic"]["sample"]["tokens"] > 0
    assert result["metrics"]["model.mfu.serve"]["value"] > 0
