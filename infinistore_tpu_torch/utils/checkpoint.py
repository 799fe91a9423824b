"""Training checkpoints: save and resume the parameters and the AdamW state.

Counterpart of ``infinistore_tpu/utils/checkpoint.py`` (orbax there),
over ``torch.distributed.checkpoint`` here: the parameter tree (plain
tensors, or DTensors under a mesh) and ``optimizer.state_dict()`` are
written under ``ckpt_dir/step_<N>``. Under a mesh every rank writes its
own shards. A restore into a ``template`` takes the template's
placements: each rank reads only its shards (a checkpoint saved under
one mesh restores under another, or into one process). Orbax's format is
not kept: the port reads back its own checkpoints.
"""

import os
import shutil

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata
from torch.distributed.tensor import DTensor

from .._device import resolve_device


def _path(ckpt_dir, step):
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")


def _distributed():
    return dist.is_available() and dist.is_initialized()


def _rank():
    return dist.get_rank() if _distributed() else 0


def _barrier():
    if _distributed():
        dist.barrier()


def save_train_state(ckpt_dir, step, params, optimizer):
    """Write one checkpoint of ``params`` (a tree of tensors) and
    ``optimizer`` (a ``torch.optim`` optimizer over its leaves) to
    ``ckpt_dir/step_<step>``; every rank of a joined group calls it.
    Atomic: it is written under a temporary name and renamed when whole,
    and :func:`latest_step` never matches the temporary name. Returns the
    checkpoint path."""
    path = _path(ckpt_dir, step)
    tmp = f"{path}.tmp"
    if _rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)  # a crashed save's
        os.makedirs(tmp)
    _barrier()
    dcp.save({"params": params, "optim": optimizer.state_dict()},
             checkpoint_id=tmp)
    if _rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)
    _barrier()
    return path


def latest_step(ckpt_dir):
    """The highest step with a finished checkpoint, or None."""
    try:
        entries = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return None
    steps = [int(e[5:]) for e in entries
             if e.startswith("step_") and e[5:].isdigit()]
    return max(steps) if steps else None


def _empty_like_saved(meta, like=None, device="cpu"):
    """A tensor to load one saved tensor into: ``like``'s placement and
    dtype where the template has one of the saved size (a DTensor keeps
    its mesh and placements), else a plain tensor of the saved size and
    dtype on ``device``."""
    size = tuple(meta.size)
    if like is not None and tuple(like.shape) == size:
        return torch.empty_like(like, dtype=meta.properties.dtype)
    return torch.empty(size, dtype=meta.properties.dtype, device=device)


def _unflatten(flat, prefix):
    """{"a.b.0.c": v} under ``prefix`` -> nested dicts (lists where every
    key of a level is a number)."""
    tree = {}
    for name, v in flat.items():
        if not name.startswith(prefix + "."):
            continue
        parts = name[len(prefix) + 1:].split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(tree)


def _leaves(tree, prefix):
    """(dotted name, leaf) of a params tree, as the checkpoint names
    them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def restore_train_state(ckpt_dir, step=None, template=None, device="cuda"):
    """Load (step, params, optimizer state). ``step`` defaults to the
    latest; an explicit step that was never saved, or an empty
    directory, gives None.

    With ``template`` = (params, optimizer), the checkpoint is read into
    them in place, with their placements (each rank of a mesh reads its
    shards; every rank calls it), and the optimizer is returned as the
    third item. Without it the parameters come back as a tree of plain
    tensors on ``device`` (the card unless ``device="cpu"``) and the
    optimizer state as the dict ``optimizer.load_state_dict`` takes."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
    path = _path(ckpt_dir, step)
    if not os.path.isdir(path):
        return None
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    params, optimizer = template if template is not None else (None, None)
    like = dict(_leaves(params, "params")) if params is not None else {}
    if optimizer is not None:
        by_index = dict(enumerate(
            p for g in optimizer.param_groups for p in g["params"]))
    target = {}
    load_device = (resolve_device(device) if template is None
                   else torch.device("cpu"))
    for name, m in meta.items():
        if not isinstance(m, TensorStorageMetadata):
            target[name] = None  # a saved object: loaded as it is
            continue
        ref = like.get(name)
        if ref is None and optimizer is not None and name.startswith(
                "optim.state."):
            ref = by_index.get(int(name.split(".")[2]))
        target[name] = _empty_like_saved(m, ref, load_device)
    dcp.load(target, checkpoint_id=path)
    state = _unflatten(target, "optim")
    per_param = state.get("state", {})
    if isinstance(per_param, list):  # every parameter had state
        per_param = dict(enumerate(per_param))
    state["state"] = {int(k): v for k, v in per_param.items()}
    if template is None:
        return step, _unflatten(target, "params"), state
    with torch.no_grad():
        for name, leaf in like.items():
            src = target[name]
            if isinstance(leaf, DTensor):
                leaf.to_local().copy_(src.to_local())
            else:
                leaf.copy_(src)
    optimizer.load_state_dict(state)
    return step, params, optimizer


__all__ = ["save_train_state", "restore_train_state", "latest_step"]
