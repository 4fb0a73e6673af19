"""The sequence models' layers of the PyTorch port against the JAX package's,
on the CPU: multi-head attention, the transformer layer and its
target-position form, sinusoidal positions, RMS norm, L2 normalisation and
the short-axis top-k. Inputs are drawn from a seeded numpy generator and the
parameters are JAX's own initialisation. Tolerance: values and gradients
(of the sum of the output times a random cotangent) at rtol 1e-5, in
float32, and an atol of 1e-6 times the array's largest magnitude (at least
1): a gradient entry is a sum over the batch whose terms may cancel.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch.ops import nn as tnn
from librecommender_tpu_torch.ops.topk import (topk_lastdim_small,
                                               topk_lastdim_small_onehot)
from librecommender_tpu_torch.utils.save_load import flatten_tree, unflatten_tree

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, what=""):
    want = np.asarray(want)
    top = float(np.abs(want[np.isfinite(want)]).max(initial=1.0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(1.0, top), err_msg=what)


def _torch_tree(tree):
    """A JAX parameter tree -> the same tree of float32 tensors that want
    gradients, and the flat list of its leaves' keys."""
    flat = {k: torch.tensor(np.asarray(v), requires_grad=True)
            for k, v in flatten_tree(tree).items()}
    return unflatten_tree(flat), flat


def _compare(jax_fn, torch_fn, params, arrays, seed=0):
    """Run ``jax_fn(params, *arrays)`` and ``torch_fn(tree, *tensors)``; hold
    their values and the gradients of sum(out * cot) with respect to the
    parameters and the float inputs against each other."""
    import jax
    import jax.numpy as jnp

    floats = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    want = jax_fn(params, *arrays)
    cot = np.random.default_rng(seed).standard_normal(
        np.shape(want)).astype(np.float32)

    def scalar(p, *fl):
        args = list(arrays)
        for i, f in zip(floats, fl):
            args[i] = f
        return jnp.sum(jax_fn(p, *args) * cot)

    grads = jax.grad(scalar, argnums=tuple(range(1 + len(floats))))(
        params, *(jnp.asarray(arrays[i]) for i in floats))
    tree, flat = _torch_tree(params)
    tensors = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]
    got = torch_fn(tree, *tensors)
    _close(got.detach(), want, "value")
    leaves = list(flat.values()) + [tensors[i] for i in floats]
    t_grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), leaves,
                                  allow_unused=True)
    j_grads = [g for _, g in sorted(flatten_tree(grads[0]).items(),
                                    key=lambda kv: list(flat).index(kv[0]))]
    j_grads += list(grads[1:])
    names = list(flat) + [f"input {i}" for i in floats]
    for name, tg, jg in zip(names, t_grads, j_grads):
        tg = torch.zeros(jg.shape) if tg is None else tg
        _close(tg, jg, f"gradient of {name}")


def _mask(rng, B, L, all_masked_row=True):
    mask = rng.random((B, L)) < 0.7
    mask[0] = True
    if all_masked_row:
        mask[1] = False   # a row whose keys are all masked: uniform weights
    return mask


# (Lq, Lk, self-attention, causal, heads): Lq * Lk on both sides of the JAX
# package's small-window gate, 128
MHA_CASES = [
    (1, 10, False, False, 2),     # SIM's ESU: one target over the top-k
    (4, 6, False, False, 1),
    (8, 8, True, False, 2),
    (8, 8, True, True, 1),
    (12, 12, True, False, 2),     # 144 > 128
    (12, 12, True, True, 2),
    (5, 40, False, False, 1),     # 200 > 128
    (16, 24, False, True, 2),
]


@pytest.mark.parametrize("Lq,Lk,self_att,causal,heads", MHA_CASES)
def test_mha_matches_jax(Lq, Lk, self_att, causal, heads):
    import jax

    from librecommender_tpu.ops import nn as jnn

    rng = np.random.default_rng(Lq * 100 + Lk)
    B, D = 5, 8
    params = jax.device_get(jnn.init_mha(jax.random.PRNGKey(Lq), D, heads))
    q = rng.standard_normal((B, Lq, D)).astype(np.float32)
    k = q if self_att else rng.standard_normal((B, Lk, D)).astype(np.float32)
    mask = _mask(rng, B, Lk)

    if self_att:
        def jf(p, x, m):
            return jnn.mha(p, x, x, mask=m, causal=causal, num_heads=heads)

        def tf(p, x, m):
            return tnn.mha(p, x, x, mask=m, causal=causal, num_heads=heads)

        _compare(jf, tf, params, [q, mask])
    else:
        def jf(p, x, y, m):
            return jnn.mha(p, x, y, mask=m, causal=causal, num_heads=heads)

        def tf(p, x, y, m):
            return tnn.mha(p, x, y, mask=m, causal=causal, num_heads=heads)

        _compare(jf, tf, params, [q, k, mask])


def test_mha_fuses_the_projections_only_for_self_attention(monkeypatch):
    """queries is keys: one matmul of the concatenated weights, as in JAX."""
    params = tnn.init_mha(torch.Generator().manual_seed(0), 8, 2)
    x = torch.randn(3, 4, 8)
    seen = []
    cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda ts, dim=0: seen.append(len(ts)) or cat(ts, dim=dim))
    a = tnn.mha(params, x, x)
    assert seen == [3]
    seen.clear()
    b = tnn.mha(params, x, x.clone())
    assert seen == []
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_mha_all_masked_row_gets_uniform_weights():
    params = tnn.init_mha(torch.Generator().manual_seed(0), 8, 2)
    q, k = torch.randn(2, 1, 8), torch.randn(2, 5, 8)
    mask = torch.tensor([[True] * 5, [False] * 5])
    out = tnn.mha(params, q, k, mask=mask, num_heads=2)
    assert torch.isfinite(out).all()
    # uniform weights: the mean of the value projections
    v = (k[1] @ params["wv"]).mean(0)
    torch.testing.assert_close(out[1, 0], v @ params["wo"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal,heads", [(False, 1), (True, 2)])
def test_transformer_layer_matches_jax(causal, heads):
    import jax

    from librecommender_tpu.ops import nn as jnn

    rng = np.random.default_rng(7)
    B, L, D = 4, 9, 8
    params = jax.device_get(jnn.init_transformer_layer(
        jax.random.PRNGKey(3), D, heads, 4 * D))
    # non-trivial layer norms
    params["ln1"]["scale"] = rng.uniform(0.5, 1.5, D).astype(np.float32)
    params["ln2"]["bias"] = rng.standard_normal(D).astype(np.float32) * 0.1
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = _mask(rng, B, L)
    _compare(lambda p, a, m: jnn.transformer_layer(p, a, m, causal, heads),
             lambda p, a, m: tnn.transformer_layer(p, a, m, causal, heads),
             params, [x, mask])


@pytest.mark.parametrize("n_layers,causal,heads", [(1, False, 2), (1, True, 1),
                                                   (2, True, 2)])
def test_transformer_target_out_matches_jax(n_layers, causal, heads):
    import jax

    from librecommender_tpu.ops import nn as jnn

    rng = np.random.default_rng(n_layers * 10 + heads)
    # L * L > 128: the causal stack's sequence layer takes JAX's general
    # attention form (the small-window one is held in test_mha_matches_jax)
    T, B, L, D = 3, 4, 12, 8
    keys = jax.random.split(jax.random.PRNGKey(5), n_layers)
    layers = [jax.device_get(jnn.init_transformer_layer(k, D, heads, 4 * D))
              for k in keys]
    seq = rng.standard_normal((B, L, D)).astype(np.float32)
    tgt = rng.standard_normal((T, B, D)).astype(np.float32)
    mask = _mask(rng, B, L)
    _compare(
        lambda p, s, m, t: jnn.transformer_target_out(p["layers"], s, m, t,
                                                      heads, causal),
        lambda p, s, m, t: tnn.transformer_target_out(p["layers"], s, m, t,
                                                      heads, causal),
        {"layers": layers}, [seq, mask, tgt])


def test_transformer_target_out_refuses_deep_non_causal_stacks():
    layer = tnn.init_transformer_layer(torch.Generator().manual_seed(0), 8, 2, 32)
    with pytest.raises(ValueError, match="causal"):
        tnn.transformer_target_out([layer, layer], torch.zeros(2, 3, 8),
                                   torch.ones(2, 3, dtype=torch.bool),
                                   torch.zeros(1, 2, 8))


@pytest.mark.parametrize("seq_len,dim", [(11, 8), (51, 64), (1, 5)])
def test_positional_encoding_matches_jax(seq_len, dim):
    from librecommender_tpu.ops import nn as jnn

    _close(tnn.positional_encoding(seq_len, dim),
           jnn.positional_encoding(seq_len, dim))


def test_rms_norm_and_l2_normalize_match_jax():
    import jax.numpy as jnp

    from librecommender_tpu.ops import nn as jnn

    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 5, 8)).astype(np.float32)
    x[0, 0] = 1e-9   # below l2_normalize's eps
    scale = {"scale": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    _compare(lambda p, a: jnn.rms_norm(p, a), lambda p, a: tnn.rms_norm(p, a),
             scale, [x])
    assert tnn.init_rms_norm(8)["scale"].shape == (8,)
    for axis in (-1, 1):
        _close(tnn.l2_normalize(torch.from_numpy(x), dim=axis),
               jnn.l2_normalize(jnp.asarray(x), axis=axis))


def _topk_inputs():
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, (2, 6, 12)).astype(np.float32)   # many ties
    x[0, 0, 5:] = -np.inf                                     # a short history
    x[0, 1] = -np.inf                                         # an empty one
    x[1, 2, ::2] = np.inf
    return x


@pytest.mark.parametrize("k", [1, 4, 12])
def test_topk_lastdim_small_matches_jax(k):
    import jax
    import jax.numpy as jnp

    from librecommender_tpu.ops.topk import topk_lastdim_small_onehot as jtopk

    x = _topk_inputs()
    j_vals, j_idx, j_hot = jtopk(jnp.asarray(x), k)
    t = torch.from_numpy(x).requires_grad_()
    t_vals, t_idx, t_hot = topk_lastdim_small_onehot(t, k)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_vals.detach().numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(t_hot.numpy(), np.asarray(j_hot))
    assert t_idx.dtype == torch.int32
    # ties to the lowest index: the same ids as a stable descending sort
    order = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    np.testing.assert_array_equal(t_idx.numpy(), order)
    vals, idx = topk_lastdim_small(torch.from_numpy(x), k)
    assert torch.equal(idx, t_idx) and torch.equal(vals, t_vals.detach())
    # gradient: a finite one to each selected position (none NaN at -inf)
    cot = np.random.default_rng(k).standard_normal(t_vals.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jtopk(a, k)[0] * cot))(jnp.asarray(x))
    (got,) = torch.autograd.grad((t_vals * torch.from_numpy(cot)).sum(), t)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
