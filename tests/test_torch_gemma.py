"""Gemma-1 at head dim 256: the port's model against the JAX package's on
the CPU, on the same weights and tokens.

Both configs come from a gemma ``config.json`` namespace through each
package's ``hf.config_from_hf`` (GeGLU, (1 + w) norms, sqrt(d)-scaled
embeddings, the decoupled head dim), cut to 2 layers and narrow widths:
one MHA config (4 / 4 heads) and one group-8 config (8 / 1, Gemma-2B's
shape of attention). The weights are numpy from a seed in the JAX tree's
shape, carried over by ``params_from_jax``. Checked: the dense prefill
(logits and every layer's KV), a prefill over a cached prefix, three
paged decode steps, and ``loss_fn`` with the grad of every leaf.

Tolerances, as relative L2 over each tensor: float32 1e-5 for logits and
KV (the two packages differ only in summation order), 1e-4 for the
grads (the backward adds one more reduction order per product)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import hf as jhf
from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch.models import hf as thf
from infinistore_tpu_torch.models import llama as tl

TOL = 1e-5
TOL_GRAD = 1e-4

# google/gemma-7b's config.json keys, at narrow widths and 2 layers.
GEMMA = dict(model_type="gemma", vocab_size=256, hidden_size=128,
             intermediate_size=256, num_hidden_layers=2, head_dim=256,
             hidden_act="gelu", max_position_embeddings=64,
             rms_norm_eps=1e-6, rope_theta=10000.0, rope_scaling=None)
HEADS = {"mha 4/4": (4, 4), "group 8/1": (8, 1)}


def _configs(heads):
    n_heads, n_kv = HEADS[heads]
    ns = types.SimpleNamespace(**GEMMA, num_attention_heads=n_heads,
                               num_key_value_heads=n_kv)
    jcfg = jhf.config_from_hf(ns, page_size=8, dtype="float32")
    tcfg = thf.config_from_hf(ns, page_size=8, dtype="float32")
    assert tcfg.head_dim == jcfg.head_dim == 256
    assert tcfg.norm_plus_one and tcfg.embed_scale == 128 ** 0.5
    return jcfg, tcfg


def _weights(jcfg, seed):
    """Numpy leaves from ``seed`` in the JAX tree's shapes: matrices with
    fan-in scaled normals (q . k / 16 stays of order one at hd 256),
    the embedding at 0.02, the zero-centred norms near 0."""
    rng = np.random.default_rng(seed)
    shapes = jl.init_params(jax.random.PRNGKey(0), jcfg)

    def leaf(x):
        shape = np.shape(x)
        if len(shape) == 1:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        scale = 0.02 if shape[0] == jcfg.vocab_size else shape[0] ** -0.5
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    tree = jax.tree_util.tree_map(leaf, shapes)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tl.params_from_jax(tree, device="cpu"))


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) /
                 max(np.linalg.norm(ref), 1e-30))


def _pools(jcfg, j_kvs, table, n_pages):
    shape = (jcfg.n_layers, n_pages, *jcfg.kv_page_shape())
    kp = np.zeros(shape, np.float32)
    vp = np.zeros(shape, np.float32)
    for li, (k, v) in enumerate(j_kvs):
        pk, pv = jl.kv_to_pages(jcfg, k, v)
        for b in range(table.shape[0]):
            kp[li, table[b, :pk.shape[1]]] = np.asarray(pk[b])
            vp[li, table[b, :pv.shape[1]]] = np.asarray(pv[b])
    return kp, vp


@pytest.mark.parametrize("heads", list(HEADS))
def test_gemma_prefill_prefix_and_decode_match_jax(heads):
    jcfg, tcfg = _configs(heads)
    jparams, tparams = _weights(jcfg, 21)
    rng = np.random.default_rng(22)
    batch, s, p_len = 2, 19, 8
    tokens = rng.integers(0, jcfg.vocab_size, (batch, s)).astype(np.int32)

    j_logits, j_kvs = jl.prefill(jparams, jcfg, jnp.asarray(tokens))
    t_logits, t_kvs = tl.prefill(tparams, tcfg, torch.from_numpy(tokens))
    assert _rel(t_logits, j_logits) <= TOL
    for (jk, jv), (tk, tv) in zip(j_kvs, t_kvs):
        assert tk.shape[-1] == 256
        assert _rel(tk, jk) <= TOL and _rel(tv, jv) <= TOL

    j_pre = [(k[:, :p_len], v[:, :p_len]) for k, v in j_kvs]
    t_pre = [(k[:, :p_len], v[:, :p_len]) for k, v in t_kvs]
    j_tail, _ = jl.prefill_with_prefix(jparams, jcfg,
                                       jnp.asarray(tokens[:, p_len:]), j_pre)
    t_tail, _ = tl.prefill_with_prefix(tparams, tcfg,
                                       torch.from_numpy(tokens[:, p_len:]),
                                       t_pre)
    assert _rel(t_tail, j_tail) <= TOL

    table = np.arange(1, 1 + batch * 5, dtype=np.int32).reshape(batch, 5)
    kp, vp = _pools(jcfg, j_kvs, table, n_pages=16)
    j_kp, j_vp = jnp.asarray(kp), jnp.asarray(vp)
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    seq_lens = np.full(batch, s, np.int32)
    token = rng.integers(0, jcfg.vocab_size, batch).astype(np.int32)
    for _ in range(3):
        j_lg, j_kp, j_vp = jl.decode_step(
            jparams, jcfg, jnp.asarray(token), jnp.asarray(seq_lens), j_kp,
            j_vp, jnp.asarray(table))
        t_lg, t_kp, t_vp = tl.decode_step(
            tparams, tcfg, torch.from_numpy(token),
            torch.from_numpy(seq_lens), t_kp, t_vp, torch.from_numpy(table))
        assert _rel(t_lg, j_lg) <= TOL
        token = np.asarray(j_lg).argmax(-1).astype(np.int32)
        seq_lens = seq_lens + 1
    assert _rel(t_kp, j_kp) <= TOL and _rel(t_vp, j_vp) <= TOL


@pytest.mark.parametrize("heads", list(HEADS))
def test_gemma_loss_and_grads_match_jax(heads):
    """loss_fn and every leaf's grad (through the port's FlashAttention
    Function, whose CPU leaves are the plain forward-with-lse and
    backward at hd 256) against jax.value_and_grad(llama.loss_fn)."""
    jcfg, tcfg = _configs(heads)
    jparams, tparams = _weights(jcfg, 23)
    tokens = np.random.default_rng(24).integers(
        0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    j_loss, j_grads = jax.value_and_grad(jl.loss_fn)(jparams, jcfg,
                                                     jnp.asarray(tokens))
    leaves = tl.trainable(tparams)
    paths = jax.tree_util.tree_leaves_with_path(j_grads)
    assert len(leaves) == len(paths)
    t_loss = tl.loss_fn(tparams, tcfg, torch.from_numpy(tokens))
    t_grads = torch.autograd.grad(t_loss, leaves)
    by_id = {id(t): g for t, g in zip(leaves, t_grads)}
    assert abs(float(t_loss.detach()) - float(j_loss)) <= \
        TOL * abs(float(j_loss))
    for path, jg in paths:
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        tg = by_id[id(node)]
        assert torch.isfinite(tg).all()
        assert _rel(tg, jg) <= TOL_GRAD, (jax.tree_util.keystr(path),
                                          _rel(tg, jg))
