"""The layers, embedding ops and score top-k of the PyTorch port against the
JAX package: the same numpy-seeded inputs and parameters go through both.
Values and gradients agree to rtol 1e-5 (float32 sums in another order);
top-k ids are exact, ties included.
"""
import numpy as np
import pytest
import torch

# a machine with the GPU and without JAX skips this file
jax = pytest.importorskip("jax")
pytest.importorskip("librecommender_tpu.data")

import jax.numpy as jnp

from librecommender_tpu.data.data_info import MultiSparseInfo as JMultiSparseInfo
from librecommender_tpu.ops import embeddings as j_emb
from librecommender_tpu.ops import initializers as j_init
from librecommender_tpu.ops import nn as j_nn
from librecommender_tpu.ops.topk import topk_from_scores as j_topk_from_scores
from librecommender_tpu_torch.data.data_info import MultiSparseInfo
from librecommender_tpu_torch.ops import embeddings as t_emb
from librecommender_tpu_torch.ops import initializers as t_init
from librecommender_tpu_torch.ops import nn as t_nn
from librecommender_tpu_torch.ops.topk import pad_consumed, topk_from_scores
from librecommender_tpu_torch.utils.save_load import flatten_tree, unflatten_tree

RTOL, ATOL = 1e-5, 1e-6


def to_torch(tree, grad=False):
    """A JAX parameter tree as the same tree of float32 tensors."""
    flat = {k: torch.tensor(np.asarray(v), dtype=torch.float32, requires_grad=grad)
            for k, v in flatten_tree(jax.device_get(tree)).items()}
    return unflatten_tree(flat), flat


def perturbed(tree, seed):
    """Random values in place of the zero biases and unit scales, so that
    every parameter matters to the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x + jnp.asarray(0.1 * rng.normal(size=x.shape).astype(np.float32)),
        tree)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol)


def grads_close(j_fn, t_fn, j_params):
    """Value and parameter gradients of a scalar function in both packages."""
    t_params, flat = to_torch(j_params, grad=True)
    j_val, j_grads = jax.value_and_grad(j_fn)(j_params)
    t_val = t_fn(t_params)
    close(t_val, j_val)
    t_grads = torch.autograd.grad(t_val, list(flat.values()), allow_unused=True)
    for key, g in zip(flat, t_grads):
        if g is None:   # a parameter the function does not read: JAX gives zeros
            g = torch.zeros_like(flat[key])
        assert torch.isfinite(g).all(), key
        close(g, flatten_tree(jax.device_get(j_grads))[key], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("activation", list(j_nn.ACTIVATIONS))
def test_activations_match_jax(activation):
    x = np.random.default_rng(0).normal(size=(7, 33)).astype(np.float32) * 3
    close(t_nn.ACTIVATIONS[activation](torch.from_numpy(x)),
          j_nn.ACTIVATIONS[activation](jnp.asarray(x)))
    assert sorted(map(str, t_nn.ACTIVATIONS)) == sorted(map(str, j_nn.ACTIVATIONS))


@pytest.mark.parametrize("use_ln,final_activation", [(False, True), (True, True),
                                                     (True, False)])
def test_mlp_matches_jax(use_ln, final_activation):
    rng = np.random.default_rng(1)
    params = perturbed(j_nn.init_mlp(jax.random.PRNGKey(0), 24, [32, 16], use_ln), 1)
    x = rng.normal(size=(19, 24)).astype(np.float32)
    cot = rng.normal(size=(19, 16)).astype(np.float32)
    grads_close(
        lambda p: jnp.sum(j_nn.mlp(p, jnp.asarray(x), final_activation=final_activation)
                          * cot),
        lambda p: torch.sum(t_nn.mlp(p, torch.from_numpy(x),
                                     final_activation=final_activation)
                            * torch.from_numpy(cot)),
        params)
    # the port's own init has the same tree
    gen = torch.Generator().manual_seed(0)
    mine = t_nn.init_mlp(gen, 24, [32, 16], use_ln)
    assert {k: tuple(v.shape) for k, v in flatten_tree(mine).items()} == \
        {k: tuple(v.shape) for k, v in flatten_tree(jax.device_get(params)).items()}


def test_layer_norm_matches_jax_and_not_torch_default():
    rng = np.random.default_rng(2)
    params = perturbed(j_nn.init_layer_norm(16), 2)
    x = (rng.normal(size=(5, 4, 16)) * 1e-3).astype(np.float32)  # eps matters
    cot = rng.normal(size=x.shape).astype(np.float32)
    grads_close(lambda p: jnp.sum(j_nn.layer_norm(p, jnp.asarray(x)) * cot),
                lambda p: torch.sum(t_nn.layer_norm(p, torch.from_numpy(x))
                                    * torch.from_numpy(cot)),
                params)
    t_params, _ = to_torch(params)
    mine = t_nn.layer_norm(t_params, torch.from_numpy(x))
    default = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (16,), t_params["scale"], t_params["bias"])
    assert not torch.allclose(mine, default, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("hidden,multi", [((36,), False), ((36,), True),
                                          ((12, 8), True)])
def test_din_attention_matches_jax(hidden, multi):
    rng = np.random.default_rng(3)
    B, L, D, T = 9, 6, 8, 3
    params = perturbed(j_nn.init_din_attention(jax.random.PRNGKey(1), D, hidden), 3)
    keys = rng.normal(size=(B, L, D)).astype(np.float32)
    queries = rng.normal(size=(T, B, D) if multi else (B, D)).astype(np.float32)
    mask = rng.random((B, L)) < 0.6
    mask[0] = False   # an all-pad history: a cold user
    mask[1] = True
    cot = rng.normal(size=queries.shape).astype(np.float32)

    def j_fn(p, k=jnp.asarray(keys), q=jnp.asarray(queries)):
        return jnp.sum(j_nn.din_attention(p, q, k, jnp.asarray(mask)) * cot)

    def t_fn(p, k=torch.from_numpy(keys), q=torch.from_numpy(queries)):
        return torch.sum(t_nn.din_attention(p, q, k, torch.from_numpy(mask))
                         * torch.from_numpy(cot))

    grads_close(j_fn, t_fn, params)
    t_params, _ = to_torch(params)
    out = t_nn.din_attention(t_params, torch.from_numpy(queries),
                             torch.from_numpy(keys), torch.from_numpy(mask))
    assert out.shape == queries.shape
    assert not out[..., 0, :].any()  # the all-masked row pools to zero
    # gradients to the keys and queries of the all-masked row are finite too
    k = torch.from_numpy(keys).requires_grad_()
    q = torch.from_numpy(queries).requires_grad_()
    gk, gq = torch.autograd.grad(t_fn(t_params, k, q), [k, q])
    jk, jq = jax.grad(lambda kk, qq: j_fn(params, kk, qq), argnums=(0, 1))(
        jnp.asarray(keys), jnp.asarray(queries))
    assert torch.isfinite(gk).all() and torch.isfinite(gq).all()
    close(gk, jk, rtol=1e-4, atol=1e-5)
    close(gq, jq, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("combiner", ["normal", "sum", "mean", "sqrtn"])
def test_combine_multi_sparse_matches_jax(combiner):
    rng = np.random.default_rng(4)
    B, F, D = 11, 6, 8   # fields: plain, [group of 3], plain, plain
    info = dict(field_offset=[1], field_len=[3], feat_oov=np.array([9]),
                pad_val={"g": "missing"})
    table = rng.normal(size=(20, D)).astype(np.float32)
    idx = rng.integers(0, 20, (B, F))
    idx[:, 1:4] = rng.integers(5, 10, (B, 3))   # 9 is the group's OOV (pad)
    idx[0, 1:4] = 9                             # a row with every slot padded
    cot = None

    def j_fn(t):
        out = j_emb.combine_multi_sparse(j_emb.sparse_embeds(t, jnp.asarray(idx)),
                                         jnp.asarray(idx), JMultiSparseInfo(**info),
                                         combiner)
        return jnp.sum(out * cot), out

    def t_fn(t):
        ids = torch.from_numpy(idx)
        out = t_emb.combine_multi_sparse(t_emb.sparse_embeds(t, ids), ids,
                                         MultiSparseInfo(**info), combiner)
        return torch.sum(out * torch.from_numpy(cot)), out

    width = F if combiner == "normal" else F - 2
    cot = rng.normal(size=(B, width, D)).astype(np.float32)
    (j_val, j_out), j_grad = jax.value_and_grad(j_fn, has_aux=True)(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    t_val, t_out = t_fn(t)
    assert t_out.shape == (B, width, D)
    close(t_out, j_out)
    close(torch.autograd.grad(t_val, t)[0], j_grad, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        t_emb.combine_multi_sparse(torch.zeros(B, F, D), torch.from_numpy(idx),
                                   MultiSparseInfo(**info), "median")


def test_dense_embeds_and_seq_pooling_match_jax():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(3, 8)).astype(np.float32)
    vals = rng.normal(size=(7, 3)).astype(np.float32)
    close(t_emb.dense_embeds(torch.from_numpy(table), torch.from_numpy(vals)),
          j_emb.dense_embeds(jnp.asarray(table), jnp.asarray(vals)))
    items = rng.normal(size=(21, 8)).astype(np.float32)
    seq = rng.integers(0, 21, (6, 5)).astype(np.int32)
    seq[0] = 20   # all pad
    close(t_emb.seq_mean_pool(torch.from_numpy(items), torch.from_numpy(seq), 20),
          j_emb.seq_mean_pool(jnp.asarray(items), jnp.asarray(seq), 20))
    np.testing.assert_array_equal(
        t_emb.seq_mask(torch.from_numpy(seq), 20).numpy(),
        np.asarray(j_emb.seq_mask(jnp.asarray(seq), 20)))


@pytest.mark.parametrize("with_consumed", [False, True])
def test_topk_from_scores_ids_exact_with_ties(with_consumed):
    rng = np.random.default_rng(6)
    U, N, k = 12, 300, 25
    # a few distinct values only: every row is full of ties
    scores = rng.integers(0, 6, (U, N)).astype(np.float32) / 4
    consumed = None
    if with_consumed:
        lists = {u: rng.choice(N, int(rng.integers(0, 40)), replace=False).tolist()
                 for u in range(U)}
        lists[3] = []
        consumed = pad_consumed(lists, np.arange(U), n_rec=k, n_items=N)
    want_ids, want_scores = j_topk_from_scores(
        jnp.asarray(scores), None if consumed is None else jnp.asarray(consumed), k)
    ids, top = topk_from_scores(torch.from_numpy(scores), consumed, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(top.numpy(), np.asarray(want_scores))
    if with_consumed:
        for u in range(U):
            assert not set(ids[u].tolist()) & set(lists[u])
    # the input is left as it was
    assert torch.isfinite(torch.from_numpy(scores)).all()


def test_he_init_has_jax_distribution():
    from scipy.stats import ks_2samp

    want = np.asarray(j_init.he_init(jax.random.PRNGKey(0), (400, 100), fan_in=400))
    gen = torch.Generator().manual_seed(0)
    got = t_init.he_init(gen, (400, 100), fan_in=400).numpy()
    scale = np.sqrt(2.0 / 400)
    assert got.dtype == np.float32 and np.abs(got).max() <= 2 * scale + 1e-6
    assert abs(got.std() - want.std()) < 0.02 * want.std()
    assert ks_2samp(got.ravel(), want.ravel()).pvalue > 1e-3


def test_dropout_keeps_the_expectation_and_repeats_from_its_generator():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(1)
    out = t_nn.dropout(x, 0.3, gen)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(out[kept], torch.tensor(1 / 0.7))
    again = t_nn.dropout(x, 0.3, torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    # mlp draws only when training
    params = t_nn.init_mlp(torch.Generator().manual_seed(2), 8, [8, 4])
    h = torch.randn(5, 8, generator=torch.Generator().manual_seed(3))
    a = t_nn.mlp(params, h, dropout_rate=0.5, train=False)
    b = t_nn.mlp(params, h)
    assert torch.equal(a, b)
    c = t_nn.mlp(params, h, dropout_rate=0.5, train=True,
                 generator=torch.Generator().manual_seed(4))
    assert not torch.equal(a, c)
