"""Training checkpoints of the port (``utils/checkpoint.py``, over
``torch.distributed.checkpoint``): the cases of
``tests/test_checkpoint.py`` (save and restore byte-equal, training
continuing from the restored state exactly as from the live one, the
latest step, an empty directory; the profile-window cases there are
``test_torch_profiling.py``'s), an interrupted save that
``latest_step`` never takes, and an FSDP save at dp = 2 on gloo CPU
ranks restored into a dp = 2 template and into one process."""

import os

import numpy as np
import pytest
import torch

import torch_parallel_ranks
from infinistore_tpu_torch.models import llama
from infinistore_tpu_torch.parallel.launch import run_ranks
from infinistore_tpu_torch.utils import (latest_step, restore_train_state,
                                         save_train_state)


def tiny():
    return llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=1,
                             n_heads=2, n_kv_heads=2, d_ff=64, max_seq=64,
                             page_size=8, dtype="float32")


def _tokens(seed=0, rows=2):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 64, (rows, 16)).astype(np.int32))


def _state(seed):
    cfg = tiny()
    params = llama.init_params(torch.Generator().manual_seed(seed), cfg,
                               "cpu")
    return cfg, params, llama.adamw(params, 1e-3)


def test_save_restore_roundtrip(tmp_path):
    cfg, params, opt = _state(0)
    tokens = _tokens()
    for _ in range(3):
        llama.train_step(params, opt, cfg, tokens)
    save_train_state(tmp_path, 3, params, opt)
    assert latest_step(tmp_path) == 3

    _, t_params, t_opt = _state(7)  # another init: every byte must load
    got = restore_train_state(tmp_path, template=(t_params, t_opt))
    assert got is not None
    step, r_params, r_opt = got
    assert step == 3
    for a, b in zip(llama.param_leaves(r_params), llama.param_leaves(params)):
        assert torch.equal(a, b)
    # Training continues from the restored state exactly as from the
    # live one (moments and step count restored).
    l1 = llama.train_step(params, opt, cfg, tokens)
    l2 = llama.train_step(r_params, r_opt, cfg, tokens)
    assert float(l1) == float(l2)
    for a, b in zip(llama.param_leaves(r_params), llama.param_leaves(params)):
        assert torch.equal(a, b)


def test_latest_step_selection(tmp_path):
    cfg, params, opt = _state(1)
    for s in (1, 5, 12):
        save_train_state(tmp_path, s, params, opt)
    assert latest_step(tmp_path) == 12
    step, _, _ = restore_train_state(tmp_path, template=(params, opt))
    assert step == 12
    step, _, _ = restore_train_state(tmp_path, step=5,
                                     template=(params, opt))
    assert step == 5
    # An explicit step that was never saved.
    assert restore_train_state(tmp_path, step=7,
                               template=(params, opt)) is None


def test_restore_empty_dir_returns_none(tmp_path):
    assert restore_train_state(tmp_path / "nope", device="cpu") is None
    assert latest_step(tmp_path / "nope") is None


def test_interrupted_save_is_never_latest(tmp_path):
    """A save cut off before its rename leaves only the temporary name,
    which latest_step skips; the next save of that step replaces it."""
    cfg, params, opt = _state(2)
    save_train_state(tmp_path, 1, params, opt)
    os.makedirs(tmp_path / "step_2.tmp")
    assert latest_step(tmp_path) == 1
    save_train_state(tmp_path, 2, params, opt)
    assert latest_step(tmp_path) == 2
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_2"]


def test_restore_without_template(tmp_path):
    """No template: the tree of plain tensors on the asked device, and the
    optimizer state as ``load_state_dict`` takes it."""
    cfg, params, opt = _state(3)
    llama.train_step(params, opt, cfg, _tokens())
    save_train_state(tmp_path, 1, params, opt)
    step, r_params, state = restore_train_state(tmp_path, device="cpu")
    assert step == 1
    for a, b in zip(llama.param_leaves(r_params), llama.param_leaves(params)):
        assert torch.equal(a, b)
    _, fresh, f_opt = _state(4)
    f_opt.load_state_dict(state)
    for sa, sb in zip(f_opt.state_dict()["state"].values(),
                      opt.state_dict()["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sb)


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    cfg = tiny()
    tree = torch_parallel_ranks.tree_map_numpy(
        llama.init_params(torch.Generator().manual_seed(5), cfg, "cpu"))
    other = torch_parallel_ranks.tree_map_numpy(
        llama.init_params(torch.Generator().manual_seed(6), cfg, "cpu"))
    ckpt = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    out = run_ranks(torch_parallel_ranks.ckpt_fsdp, 2,
                    (cfg, tree, other, _tokens(8, rows=4).numpy(), ckpt),
                    device="cpu", timeout=300)[0]
    return out, ckpt


def test_fsdp_restore_into_fsdp_template(fsdp):
    """dp = 2: each rank's restored shards and moments byte-equal to the
    saved ones, and the next step's loss the same from both."""
    out, _ = fsdp
    assert out["step"] == 1 and out["sharded_leaves"] > 0
    assert out["shards_equal"] and out["moments_equal"]
    assert out["losses"][0] == out["losses"][1]


def test_fsdp_restore_into_one_process(fsdp):
    """The dp = 2 checkpoint read back whole by one process, byte-equal
    to the saved parameters."""
    out, ckpt = fsdp
    step, params, state = restore_train_state(ckpt, device="cpu")
    assert step == 1
    saved = dict(torch_parallel_ranks.flat_leaves(out["saved"]))
    got = dict(torch_parallel_ranks.flat_leaves(
        torch_parallel_ranks.tree_map_numpy(params)))
    assert saved.keys() == got.keys()
    for name, a in saved.items():
        assert np.array_equal(got[name], a), name
    assert state["state"] and "exp_avg" in state["state"][0]
