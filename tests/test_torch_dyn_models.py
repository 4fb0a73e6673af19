"""The recurrent and convolutional ops and the dynamic-embedding models
(RNN4Rec, Caser, WaveNet) of the PyTorch port against the JAX package, on
the CPU.

Ops: the same inputs from a seed through both packages, value and gradient
rtol 1e-5 (atol 1e-6). Models: both build the ``tests/conftest.py`` pure
frame; the port starts from JAX's initial parameters, and with
``shuffle=False`` and ``sampler="unconsumed"`` both see the same batches.
Tolerances in float32: user representations, loss and every gradient rtol
1e-5 (atol 1e-7); parameters after a 2-epoch fit rtol 1e-4, atol 1e-5;
recommendation ids equal, where two items' scores lie within 1e-5 relative
of each other in either order; predictions after save and load in the other
package 1e-6. Dropout above 0 draws from the port's own generator and is
held in distribution only.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetPure
from librecommender_tpu_torch.evaluation import evaluate
from librecommender_tpu_torch.ops import nn as tnn
from librecommender_tpu_torch.utils.save_load import flatten_tree

from tests.test_torch_embed_models import (_serve, as_numpy, batch_of, cols,
                                           jax_loss_and_grads, jax_params,
                                           same_params, same_recs,
                                           torch_loss_and_grads, within_spread)

SMALL = dict(embed_size=8, batch_size=256, seed=3, recent_num=6)

# name -> (class, kwargs beside SMALL)
MODELS = {
    "rnn4rec-gru": ("RNN4Rec", dict(hidden_units=(12,))),
    "rnn4rec-lstm": ("RNN4Rec", dict(rnn_type="lstm", hidden_units=(12,))),
    "rnn4rec-gru-ln": ("RNN4Rec", dict(hidden_units=(12,), use_layer_norm=True)),
    "caser": ("Caser", {}),
    # norm_embed only where a representation is never the zero vector: an
    # empty history gives RNN4Rec's zero state, whose norm JAX
    # differentiates to NaN (the port's gradient there is finite)
    "caser-norm": ("Caser", dict(norm_embed=True)),
    "wave_net": ("WaveNet", dict(n_filters=6)),
}


@pytest.fixture()
def both(pure_frames):
    """(JAX train, JAX info), (port train, port info, port eval)."""
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    train, evals, _ = pure_frames
    j_train, j_info = JDatasetPure.build_trainset(train)
    t_train, t_info = DatasetPure.build_trainset(cols(train))
    t_eval = DatasetPure.build_evalset(cols(evals))
    return (j_train, j_info), (t_train, t_info, t_eval)


def jax_model(name, info, task="ranking", **kw):
    import jax

    from librecommender_tpu import models as jmodels

    cls, extra = MODELS[name]
    model = getattr(jmodels, cls)(task, info, **{**SMALL, **extra, **kw})
    model.build_model()
    return model, jax.device_get(model.params)


def torch_model(name, info, init=None, task="ranking", device="cpu", **kw):
    cls, extra = MODELS[name]
    model = getattr(tmodels, cls)(task, info, device=device,
                                  **{**SMALL, **extra, **kw})
    if init is not None:
        model.params_from_arrays(init)
    return model


# ---------------------------------------------------------------- the ops
def _ops():
    from librecommender_tpu.ops import nn as jnn

    return jnn


def _params(tree):
    """A numpy tree -> (JAX tree, torch tree of leaf tensors wanting grad)."""
    import jax
    import jax.numpy as jnp

    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), tree))


def _init(name, *args):
    import jax

    return jax.device_get(getattr(_ops(), name)(jax.random.PRNGKey(7), *args))


def _hold(run_jax, run_torch, jp, tp, x):
    """Value and gradient of sum(out * probe) in both, for the params and x."""
    import jax
    import jax.numpy as jnp

    xt = torch.tensor(x, requires_grad=True)
    out_t = run_torch(tp, xt)
    probe = np.random.default_rng(1).normal(size=tuple(out_t.shape)).astype(np.float32)

    def j_loss(p, xx):
        out = run_jax(p, xx)
        return jnp.sum(out * probe), out

    (_, out_j), (g_p, g_x) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    leaves = list(flatten_tree(tp).items())
    grads = torch.autograd.grad((out_t * torch.from_numpy(probe)).sum(),
                                [v for _, v in leaves] + [xt])
    want = as_numpy(jax.device_get(g_p))
    for (k, _), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(g_x), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("masked", [False, True])
def test_recurrences_match_jax(kind, masked):
    """GRU (one input-side bias, the reset gate on ``h @ wh_n``) and LSTM
    (gates i, f, g, o) over left-padded rows, final state and every step's,
    in value and gradient."""
    import jax.numpy as jnp

    jnn = _ops()
    rng = np.random.default_rng(0)
    B, L, D, H = 5, 7, 6, 4
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    lens = np.array([7, 3, 0, 1, 5])
    mask = np.arange(L)[None, :] >= (L - lens)[:, None] if masked else None
    tree = _init(f"init_{kind}", D, H)
    tree["b"] = rng.normal(scale=0.1, size=tree["b"].shape).astype(np.float32)
    jp, tp = _params(tree)
    j_run, t_run = getattr(jnn, kind), getattr(tnn, kind)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    for which in (0, 1):   # the final state, then every step's
        _hold(lambda p, xx: j_run(p, xx, mask=jm)[which],
              lambda p, xx: t_run(p, xx, mask=tm)[which], jp, tp, x)
    if masked:   # a row with no valid step keeps the zero state
        h, _ = t_run(tp, torch.from_numpy(x), mask=tm)
        assert (h[2] == 0).all()


@pytest.mark.parametrize("kernel", [1, 2, 3])
@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("op", ["conv1d", "conv1d-same", "causal_conv1d"])
def test_convolutions_match_jax(op, kernel, dilation):
    jnn = _ops()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 12, 5)).astype(np.float32)
    tree = _init("init_conv1d", kernel, 5, 4)
    tree["b"] = rng.normal(scale=0.1, size=4).astype(np.float32)
    jp, tp = _params(tree)
    if op == "causal_conv1d":
        kw = dict(dilation=dilation)
        _hold(lambda p, xx: jnn.causal_conv1d(p, xx, **kw),
              lambda p, xx: tnn.causal_conv1d(p, xx, **kw), jp, tp, x)
    else:
        kw = dict(padding="SAME" if op == "conv1d-same" else "VALID",
                  dilation=dilation)
        _hold(lambda p, xx: jnn.conv1d(p, xx, **kw),
              lambda p, xx: tnn.conv1d(p, xx, **kw), jp, tp, x)


def test_conv1d_holds_cudnn_to_float32():
    """The convolution and its backward both run with cuDNN's TF32 off,
    whatever the caller's setting, and the setting is the caller's again
    after each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []
    convs = (torch.ops.aten.convolution, torch.ops.aten.convolution_backward)

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in convs:
                seen.append((func.overloadpacket.__name__,
                             torch.backends.cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    params = tnn.init_conv1d(torch.Generator().manual_seed(0), 2, 5, 4)
    params["w"].requires_grad_()
    x = torch.randn(3, 12, 5, requires_grad=True)
    before = torch.backends.cudnn.allow_tf32
    for setting in (True, False):
        torch.backends.cudnn.allow_tf32 = setting
        seen.clear()
        try:
            with Record():
                tnn.causal_conv1d(params, x, dilation=2).sum().backward()
            assert torch.backends.cudnn.allow_tf32 is setting
        finally:
            torch.backends.cudnn.allow_tf32 = before
        assert seen == [("convolution", False), ("convolution_backward", False)]


@pytest.mark.cuda
def test_conv1d_on_gpu_is_float32():
    """On the card under PyTorch's default (cuDNN's TF32 on), the value and
    both gradients within 1e-5 of the largest entry of float64's on the CPU;
    TF32 would be near 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    gen = torch.Generator().manual_seed(0)
    params = tnn.init_conv1d(gen, 3, 64, 16)
    x = torch.randn(4096, 10, 64, generator=gen)
    r = torch.randn(4096, 10, 16, generator=gen)

    def run(device, dtype):
        xs = x.to(device, dtype, copy=True).requires_grad_()
        w = params["w"].to(device, dtype, copy=True).requires_grad_()
        y = tnn.causal_conv1d({"w": w, "b": params["b"].to(device, dtype)}, xs,
                              dilation=2)
        (y * r.to(device, dtype)).sum().backward()
        return [t.detach().cpu().double() for t in (y, xs.grad, w.grad)]

    assert torch.backends.cudnn.allow_tf32
    for got, want in zip(run("cuda", torch.float32), run("cpu", torch.float64)):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("name", ["bce_loss", "focal_loss"])
def test_pointwise_losses_match_jax_at_zero_logits(name):
    """At a logit of exactly 0 (an empty history's first step) the gradient
    is JAX's: its ``maximum`` splits the tie and |x| has slope 1 there."""
    import jax
    import jax.numpy as jnp

    from librecommender_tpu.ops import losses as jl
    from librecommender_tpu_torch.ops import losses as pl

    x = np.array([0.0, 0.0, 0.3, -0.2, 0.0, -0.0], np.float32)
    y = np.array([1.0, 0.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    w = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 1.0], np.float32)
    want = jax.grad(lambda a: getattr(jl, name)(a, jnp.asarray(y), jnp.asarray(w)))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    getattr(pl, name)(xt, torch.from_numpy(y), torch.from_numpy(w)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-8)


# -------------------------------------------------------------- the models
# (model, task, loss_type, sampled negatives a row)
LOSS_CASES = (
    [(name, "ranking", "cross_entropy", 2) for name in MODELS]
    + [(name, "ranking", "focal", 1) for name in ("rnn4rec-lstm", "caser")]
    + [(name, "ranking", "bpr", 2) for name in ("rnn4rec-gru", "caser", "wave_net")]
    + [("wave_net", "ranking", "max_margin", 1), ("rnn4rec-gru-ln", "rating",
                                                  "cross_entropy", 0)]
)


@pytest.mark.parametrize(
    "name,task,loss_type,num_neg", LOSS_CASES,
    ids=[f"{n}-{t}-{lt}" for n, t, lt, _ in LOSS_CASES])
def test_forward_loss_and_gradients_match_jax(both, name, task, loss_type, num_neg):
    import jax.numpy as jnp

    (_, j_info), (t_train, t_info, _) = both
    jm, init = jax_model(name, j_info, task, loss_type=loss_type)
    tm = torch_model(name, t_info, init, task, loss_type=loss_type)
    same_params(tm.params_to_arrays(), init, rtol=0, atol=0)
    assert tm.paradigm == jm.paradigm
    np.testing.assert_array_equal(tm.recent_seq_table.numpy(),
                                  np.asarray(jm.recent_seq_table))
    seqs = tm.batch_extras(t_train)["seq"]
    np.testing.assert_array_equal(seqs, jm.batch_extras(t_train)["seq"])
    labels = t_train.labels if task == "rating" else None
    batch = batch_of(t_info, t_train, num_neg=num_neg, labels=labels)
    batch["seq"] = seqs[:len(batch["user"])]

    users = jnp.asarray(batch["user"])
    want = jm._user_repr(jm.params, users, jnp.asarray(batch["seq"]), False, None)
    got = tm._user_repr(tm._tree(), torch.from_numpy(batch["user"]),
                        torch.from_numpy(batch["seq"]), False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    j_loss, j_grads = jax_loss_and_grads(jm, batch)
    t_loss, t_grads = torch_loss_and_grads(tm, batch)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    for k, g in j_grads.items():
        np.testing.assert_allclose(t_grads[k], g, rtol=1e-5, atol=1e-7, err_msg=k)


# WaveNet's 2-epoch fit spreads float32 rounding: JAX's own fit from its
# start moved by 1e-7 ends 1.2e-5 away (the port 1.2e-5). It is held to
# twice that distance, by array, plus 1e-5; the others to rtol 1e-4, atol 1e-5
SPREADING = ("wave_net",)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(MODELS))
def test_two_epoch_fit_matches_jax(both, name):
    (j_train, j_info), (t_train, t_info, t_eval) = both
    kw = dict(n_epochs=2, lr=0.001, sampler="unconsumed", num_neg=2)
    jm, init = jax_model(name, j_info, **kw)
    tm = torch_model(name, t_info, init, **kw)
    jm.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
    tm.fit(t_train, neg_sampling=True, verbose=0, shuffle=False)
    if name in SPREADING:
        import jax

        moved, _ = jax_model(name, j_info, **kw)
        noise = np.random.default_rng(0)
        moved.params = jax.tree.map(
            lambda a: a + 1e-7 * noise.standard_normal(a.shape).astype(a.dtype),
            moved.params)
        moved.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
        within_spread(tm.params_to_arrays(), as_numpy(jax_params(jm)),
                      as_numpy(jax_params(moved)))
        limit = 2 * np.abs(moved.user_embeds_np - jm.user_embeds_np).max() + 1e-5
        assert np.abs(tm.user_embeds_np - jm.user_embeds_np).max() <= limit
    else:
        same_params(tm.params_to_arrays(), jax_params(jm))
        np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np,
                                   rtol=1e-4, atol=1e-5)
    assert np.isfinite(tm.trainer.epoch_losses).all()
    res = evaluate(tm, t_eval, neg_sampling=True, metrics=["roc_auc"])
    assert np.isfinite(res["roc_auc"])


def _trained_pair(both, name, **kw):
    """JAX's model with trained-looking random parameters (biases and all
    non-zero), and the port's holding the same, both post-fit."""
    (_, j_info), (_, t_info, _) = both
    jm, init = jax_model(name, j_info, **kw)
    rng = np.random.default_rng(5)
    init = {k: (v + rng.normal(scale=0.1, size=np.shape(v)).astype(np.float32))
            for k, v in as_numpy(init).items()}
    from librecommender_tpu.utils.save_load import unflatten_tree

    jm.params = unflatten_tree(init)
    jm.post_fit()
    tm = torch_model(name, t_info, init, **kw)
    tm.post_fit()
    return jm, tm, t_info


@pytest.mark.parametrize("name", list(MODELS))
def test_recommend_ids_and_request_seq_match_jax(both, name):
    """Exported embeddings (the OOV user row from an empty-history forward),
    recommend_user for known users and a cold one, with and without the
    consumed filter, the cold-start list, and a request ``seq``: raw, inner,
    unknown items dropped, empty, and a cold user's."""
    jm, tm, info = _trained_pair(both, name)
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm.item_embeds_np, jm.item_embeds_np, rtol=1e-6)
    oov = tm.dyn_user_embedding(-1, seq=[])
    np.testing.assert_allclose(tm.user_embeds_np[-1][: oov.shape[0]], oov,
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(tm.user_embeds_np[-1], tm.user_embeds_np[:-1].mean(0))
    np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    raw_users = [int(info.id2user[u]) for u in (0, 5, 17, 33)] + [-1]

    def scorer(u_vec):
        return lambda item: u_vec @ tm.item_embeds_np[info.item2id[item]]

    for kwargs in ({}, {"filter_consumed": False}, {"cold_start": "popular"}):
        want = jm.recommend_user(raw_users, 9, **kwargs)
        have = tm.recommend_user(raw_users, 9, **kwargs)
        for u in raw_users:
            u_vec = tm.user_embeds_np[info.user2id.get(u, info.n_users)]
            same_recs(have[u], want[u], scorer(u_vec.astype(np.float64)), (u, kwargs))
    items = [int(info.id2item[i]) for i in (3, 8, 1, 40, 77, 2, 9, 11)]
    requests = [(raw_users[1], items[:5] + [10**9], False),
                (raw_users[2], [3, 8, 1], True), (raw_users[0], [], False),
                (-1, items, False), (raw_users[3], items, False)]
    for user, seq, inner in requests:
        u = info.user2id.get(user, 0) if inner else user
        want = jm.recommend_user(u, 7, inner_id=inner, seq=seq)
        have = tm.recommend_user(u, 7, inner_id=inner, seq=seq)
        embed = tm.dyn_user_embedding(u, seq=seq, inner_id=inner)
        np.testing.assert_allclose(
            embed, np.asarray(jm.dyn_user_embedding(u, seq=seq, inner_id=inner)),
            rtol=1e-5, atol=1e-6)
        if tm.item_embeds_np.shape[1] == embed.shape[0] + 1:
            embed = np.concatenate([embed, np.ones(1, np.float32)])
        same_recs(have[u], want[u], scorer(embed.astype(np.float64)), (user, seq))
    # the stored history as a request gives the static recommendations
    uid = 5
    history = [int(info.id2item[i]) for i in info.user_consumed[uid]]
    user = int(info.id2user[uid])
    np.testing.assert_array_equal(tm.recommend_user(user, 9, seq=history)[user],
                                  tm.recommend_user(user, 9)[user])
    with pytest.raises(ValueError):
        tm.recommend_user(raw_users[:2], 5, seq=items)


@pytest.mark.parametrize("name", ["rnn4rec-lstm", "caser", "wave_net"])
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_model_loads_in_the_other_package(both, tmp_path, name, saver):
    """A fitted model saved by one package predicts and recommends the same
    in the other (Caser's and WaveNet's lists of convolutions included); the
    port's save is served over HTTP by its class name."""
    import json

    from librecommender_tpu import models as jmodels

    (j_train, j_info), (t_train, t_info, _) = both
    cls = MODELS[name][0]
    if saver == "jax":
        src, _ = jax_model(name, j_info, n_epochs=1)
        src.fit(j_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, name)
        dst = getattr(tmodels, cls).load(tmp_path, name, device="cpu")
    else:
        src = torch_model(name, t_info, n_epochs=1)
        src.fit(t_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, name)
        dst = getattr(jmodels, cls).load(tmp_path, name)
    assert type(dst).__name__ == cls
    users = np.arange(60) % t_info.n_users
    items = (np.arange(60) * 3) % t_info.n_items
    np.testing.assert_allclose(dst.predict(users, items, inner_id=True),
                               src.predict(users, items, inner_id=True), atol=1e-6)
    raw = [int(t_info.id2user[3]), -1]   # a known user and a cold one
    want, have = src.recommend_user(raw, 5), dst.recommend_user(raw, 5)
    for u in raw:
        np.testing.assert_array_equal(have[u], want[u])
    if saver == "torch":
        hyper = json.loads((tmp_path / f"{name}_hyper_params.json").read_text())
        assert "device" not in hyper and hyper["model_class"] == cls
        assert _serve(tmp_path, name, raw[0]) == [int(i) for i in want[raw[0]]]


def test_rnn4rec_dropout_in_distribution(both, monkeypatch):
    """Input dropout in training only: from the model's generator, it zeroes
    about ``rate`` of the history embeddings and scales the rest by
    1 / (1 - rate); same-seed fits repeat; inference is deterministic."""
    from librecommender_tpu_torch.models import rnn4rec

    _, (t_train, t_info, _) = both
    seen = []
    plain = rnn4rec.dropout

    def recorded(x, rate, generator):
        out = plain(x, rate, generator)
        seen.append((x.detach(), out.detach(), rate))
        return out

    monkeypatch.setattr(rnn4rec, "dropout", recorded)

    def fit(**kw):
        m = torch_model("rnn4rec-gru", t_info, n_epochs=1, **kw)
        m.fit(t_train, neg_sampling=True, verbose=0)
        return m

    a = fit(dropout_rate=0.4)
    x, out, rate = seen[0]
    dropped = (out == 0) & (x != 0)
    share = float(dropped.float().mean())
    n = x.numel()
    assert abs(share - rate) <= 4 * np.sqrt(rate * (1 - rate) / n)
    kept = ~dropped
    torch.testing.assert_close(out[kept], x[kept] / (1 - rate))
    b = fit(dropout_rate=0.4)
    for k, v in a.params_to_arrays().items():
        np.testing.assert_array_equal(v, b.params_to_arrays()[k], err_msg=k)
    seen.clear()
    users = np.arange(20) % t_info.n_users
    np.testing.assert_array_equal(a.predict(users, users, inner_id=True),
                                  a.predict(users, users, inner_id=True))
    a.set_embeddings()
    assert not seen   # no dropout outside training


def test_constructor_contract(both):
    _, (_, t_info, _) = both
    for cls in ("RNN4Rec", "Caser", "WaveNet"):
        model = getattr(tmodels, cls)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                model("ranking", t_info)   # device=None means the GPU
        m = model("ranking", t_info, device="cpu")
        assert "device" not in m.all_args
        assert (m.seq_mode, m.max_seq_len, m.paradigm) == ("recent", 10, "pointwise")
        assert model("ranking", t_info, device="cpu", loss_type="bpr").paradigm == \
            "pairwise"
        with pytest.raises(ValueError):
            model("ranking", t_info, device="cpu", loss_type="hinge")
    with pytest.raises(ValueError):
        tmodels.RNN4Rec("ranking", t_info, device="cpu", rnn_type="rnn")
    w = tmodels.WaveNet("ranking", t_info, device="cpu", embed_size=8)
    w.build_model()
    assert w.net["item_embed"].shape[1] == 16 and len(w._tree()["convs"]) == 4
    c = tmodels.Caser("ranking", t_info, device="cpu", recent_num=4)
    c.build_model()
    assert [conv["w"].shape[0] for conv in c._tree()["h_convs"]] == [1, 2, 3, 4]


# model -> (JAX's AUC on the planted synthetic, PARITY.md), each as
# parity/run_ours.py runs it: embed 32, batch 2048, lr 0.001, 5 epochs,
# recent_num 10, otherwise the model's defaults
DYN_PARITY = {
    "RNN4Rec": 0.6814,   # PARITY.md:28
    "Caser": 0.7170,     # PARITY.md:81
    "WaveNet": 0.6964,   # PARITY.md:82
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(DYN_PARITY))
def test_dyn_model_auc_on_planted_synthetic(name):
    """The PARITY.md protocol: ML-1M-sized planted data, chrono split,
    seed-2222 eval negatives. The port's draws differ from JAX's (torch
    generators), so each model is held to its JAX column +/- 0.01."""
    from parity.synthetic import chrono_split, make_ml1m_like

    train, evals = chrono_split(make_ml1m_like())
    keep = ["user", "item", "label", "time"]
    train_data, info = DatasetPure.build_trainset(cols(train[keep]))
    eval_data = DatasetPure.build_evalset(cols(evals[keep]))
    model = getattr(tmodels, name)("ranking", info, embed_size=32, n_epochs=5,
                                   lr=0.001, batch_size=2048, recent_num=10,
                                   device="cpu")
    model.fit(train_data, neg_sampling=True, verbose=1, shuffle=True)
    res = evaluate(model, eval_data, neg_sampling=True, eval_batch_size=8192, k=10,
                   metrics=["roc_auc", "precision", "recall", "ndcg"], seed=2222)
    print(f"port {name} on the planted synthetic: {res}")
    want = DYN_PARITY[name]
    assert want - 0.01 <= res["roc_auc"] <= want + 0.01
