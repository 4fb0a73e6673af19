"""FM, DeepFM, WideDeep, AutoInt and NCF of the PyTorch port against the JAX
package, on the CPU.

Both packages build the ``tests/conftest.py`` feature frame (and, for the
multi-sparse combiners, the multi-sparse frame of
``tests/test_torch_feat_data.py``); the port starts from JAX's initial
parameters, and with ``shuffle=False`` and ``sampler="unconsumed"`` both see
the same batches. Tolerances in float32: logits, loss and every gradient
rtol 1e-5, atol 1e-6; FTRL's weights after 20 steps rtol 1e-6; parameters
after a 2-epoch fit rtol 1e-4, atol 1e-5 (float32 sums in another order,
through Adam; AutoInt, whose fit spreads rounding, no farther from JAX than
twice JAX's own fit from a start moved by 1e-7, plus 1e-5); recommendation
ids equal; predictions after save and load in the other package 1e-6. On the CPU the lookups take the plain versions of
the gather and segment-sum kernels; the ``cuda`` test runs steps on the card
and asserts the kernels' launch counts.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetFeat, TransformedSet
from librecommender_tpu_torch.evaluation import evaluate
from librecommender_tpu_torch.ops import table_gather
from librecommender_tpu_torch.serving import DictStore, create_server
from librecommender_tpu_torch.training.optimizers import Ftrl
from librecommender_tpu_torch.utils.save_load import flatten_tree

FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
SMALL = dict(embed_size=8, batch_size=256, seed=3)
HIDDEN = dict(hidden_units=(16, 8))

# name -> (model class, kwargs beside SMALL)
MODELS = {
    "fm": ("FM", {}),
    "deepfm": ("DeepFM", HIDDEN),
    "wide_deep": ("WideDeep", HIDDEN),
    "autoint": ("AutoInt", {}),
    "ncf": ("NCF", HIDDEN),
}
COMBINERS = ("sum", "mean", "sqrtn", "normal")


def as_columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def _frames(kind, feat_frames):
    """(train, eval, feature columns) of the conftest or multi-sparse frame."""
    if kind == "conftest":
        train, evals, _ = feat_frames
        return train, evals, FEAT_COLS
    from tests.test_torch_feat_data import MULTI_COLS, _multi_sparse_frames

    train, evals = _multi_sparse_frames()
    return train, evals, MULTI_COLS


def build_both(kind, feat_frames):
    from librecommender_tpu.data import DatasetFeat as JDatasetFeat

    train, evals, cols = _frames(kind, feat_frames)
    j_train, j_info = JDatasetFeat.build_trainset(train, **cols)
    t_train, t_info = DatasetFeat.build_trainset(as_columns(train), **cols)
    t_eval = DatasetFeat.build_evalset(as_columns(evals))
    return (j_train, j_info), (t_train, t_info, t_eval)


@pytest.fixture()
def both(feat_frames):
    return build_both("conftest", feat_frames)


def _kwargs(name, **kw):
    cls, extra = MODELS[name]
    return cls, {**SMALL, **extra, **kw}


def jax_model(name, info, **kw):
    import jax

    from librecommender_tpu import models as jmodels

    cls, kwargs = _kwargs(name, **kw)
    model = getattr(jmodels, cls)("ranking", info, **kwargs)
    model.build_model()
    return model, jax.device_get(model.params)


def torch_model(name, info, init=None, device="cpu", **kw):
    cls, kwargs = _kwargs(name, **kw)
    model = getattr(tmodels, cls)("ranking", info, device=device, **kwargs)
    if init is not None:
        model.params_from_arrays(init)
    return model


def flat_numpy(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def same_params(got, want, rtol=1e-4, atol=1e-5):
    want = flat_numpy(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _batch(info, train, n=96, num_neg=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "user": train.user_indices[:n].astype(np.int32),
        "item": train.item_indices[:n].astype(np.int32),
        "label": np.ones(n, np.float32),
        "weight": (rng.random(n) < 0.9).astype(np.float32),
        "item_neg": rng.integers(0, info.n_items, (n, num_neg)).astype(np.int32),
    }


FORWARD_CASES = ([(name, "conftest", None) for name in MODELS]
                 + [(name, "multi_sparse", c) for name in ("fm", "deepfm")
                    for c in COMBINERS])


@pytest.mark.parametrize(
    "name,kind,combiner", FORWARD_CASES,
    ids=[n if k == "conftest" else f"{n}-{c}" for n, k, c in FORWARD_CASES])
def test_forward_and_loss_match_jax(feat_frames, name, kind, combiner):
    import jax
    import jax.numpy as jnp

    (_, j_info), (t_train, t_info, _) = build_both(kind, feat_frames)
    kw = dict(reg=0.01)
    if combiner is not None:
        kw["multi_sparse_combiner"] = combiner
    jm, init = jax_model(name, j_info, **kw)
    tm = torch_model(name, t_info, init, **kw)
    assert tm.n_fields == jm.n_fields
    same_params(tm.params_to_arrays(), init, rtol=0, atol=0)

    batch = _batch(t_info, t_train)
    inputs = {k: batch[k] for k in ("user", "item")}
    want = jax.jit(lambda p, i: jm._forward(p, i, train=False, rng=None))(
        jm.params, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = tm._forward(tm._tree(), {k: torch.from_numpy(v) for k, v in inputs.items()},
                      train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)

    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    j_grads = flat_numpy(jax.device_get(j_grads))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for lookup in (False, True):   # through TableGather's plain versions too
        tm._mxu_lookup = lookup
        loss = tm.loss_fn(tm.net, t_batch)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
        grads = dict(zip(tm.net.keys(),
                         torch.autograd.grad(loss, list(tm.net.values()))))
        for k, g in j_grads.items():
            np.testing.assert_allclose(grads[k].numpy(), g, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_ftrl_matches_jax():
    """20 FTRL steps on random gradients, rows 0-3 of the table never
    touched (their n stays 0), against the JAX package's transform."""
    import jax.numpy as jnp
    import optax

    from librecommender_tpu.training.optimizers import ftrl

    rng = np.random.default_rng(0)
    init = {"table": rng.normal(size=(12, 3)).astype(np.float32) * 0.1,
            "bias": np.float32(0.2)}
    grads = []
    for _ in range(20):
        g = rng.normal(size=(12, 3)).astype(np.float32)
        g[:4] = 0.0
        grads.append({"table": g, "bias": np.float32(rng.normal())})

    opt = ftrl(0.05)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(j_params)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    t_params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    t_opt = Ftrl(list(t_params.values()), lr=0.05)
    for g in grads:
        for k, p in t_params.items():
            p.grad = torch.tensor(g[k])
        t_opt.step()
    for k in init:
        got = t_params[k].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(j_params[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert (t_params["table"].detach()[:4] == 0).all()
    assert (t_opt.state[t_params["table"]]["n"][:4] == 0).all()


def test_wide_deep_sends_linear_weights_to_ftrl(both):
    _, (_, t_info, _) = both
    m = torch_model("wide_deep", t_info)
    m.build_model()
    chain = m._custom_optimizer()(list(m.net.values()))
    ftrl, adam = chain.optimizers
    names = {id(p): k for k, p in m.net.items()}
    wide = sorted(names[id(p)] for g in ftrl.param_groups for p in g["params"])
    deep = sorted(names[id(p)] for g in adam.param_groups for p in g["params"])
    assert wide == sorted(k for k in m.net if k.startswith("linear_"))
    assert deep == sorted(k for k in m.net if not k.startswith("linear_"))
    assert ftrl.defaults["lr"] == 0.01 and adam.defaults["lr"] == 1e-4
    assert adam.defaults["eps"] == m.epsilon


@pytest.mark.slow
@pytest.mark.parametrize("name", list(MODELS))
def test_two_epoch_fit_matches_jax(both, name):
    import jax

    (j_train, j_info), (t_train, t_info, t_eval) = both
    kw = dict(n_epochs=2, sampler="unconsumed", num_neg=2)
    if name != "wide_deep":   # WideDeep keeps its default dict lr
        kw["lr"] = 0.001
    jm, init = jax_model(name, j_info, **kw)
    tm = torch_model(name, t_info, init, **kw)
    tm._mxu_lookup_force = True   # lookups through TableGather's plain versions
    jm.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
    tm.fit(t_train, neg_sampling=True, verbose=0, shuffle=False)
    got = tm.params_to_arrays()
    if name == "autoint":
        # AutoInt's fit spreads rounding: JAX's own fit from its start moved
        # by 1e-7 ends up to 1e-3 away. Held to twice that distance, by
        # parameter, plus 1e-5
        want = flat_numpy(jax.device_get(jm.params))
        noise = np.random.default_rng(0)
        jm2, _ = jax_model(name, j_info, **kw)
        jm2.params = jax.tree.map(
            lambda a: a + 1e-7 * noise.standard_normal(a.shape).astype(a.dtype),
            jm2.params)
        jm2.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
        moved = flat_numpy(jax.device_get(jm2.params))
        assert sorted(got) == sorted(want)
        for k in want:
            limit = 2 * np.abs(moved[k] - want[k]).max() + 1e-5
            assert np.abs(got[k] - want[k]).max() <= limit, k
    else:
        same_params(got, jax.device_get(jm.params))
    assert np.isfinite(tm.trainer.epoch_losses).all()
    assert tm._mxu_lookup is False   # off again after the fit

    users = np.arange(40) % t_info.n_users
    items = (np.arange(40) * 7) % t_info.n_items
    have = tm.predict(users, items, inner_id=True)
    want = jm.predict(users, items, inner_id=True)
    if name == "autoint":
        moved = jm2.predict(users, items, inner_id=True)
        assert np.abs(have - want).max() <= 2 * np.abs(moved - want).max() + 1e-5
    else:
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-5)
    metrics = evaluate(tm, t_eval, neg_sampling=True, metrics=["roc_auc"])
    assert np.isfinite(metrics["roc_auc"])


@pytest.mark.parametrize("name", list(MODELS))
def test_recommend_ids_match_jax(both, name):
    """recommend_user from JAX's initial parameters: the same ids for known
    users and a cold one, with and without the consumed filter, in one chunk
    of users and in several, and the same cold-start list."""
    (_, j_info), (_, t_info, _) = both
    raw_users = [int(t_info.id2user[u]) for u in (0, 5, 17, 33)] + [-1]
    jm, init = jax_model(name, j_info)
    tm = torch_model(name, t_info, init)
    jm.post_fit()
    tm.post_fit()
    np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    for kwargs in ({}, {"filter_consumed": False}, {"users_per_call": 2},
                   {"cold_start": "popular"}):
        want = jm.recommend_user(raw_users, 9, **kwargs)
        have = tm.recommend_user(raw_users, 9, **kwargs)
        for u in raw_users:
            np.testing.assert_array_equal(have[u], want[u])


def _serve(tmp_path, name, user):
    store = DictStore()
    store.set("model_path", str(tmp_path))
    store.set("model_meta", {"model_name": name})
    server, port = create_server("model", store, port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/model/recommend",
            data=json.dumps({"user": user, "n_rec": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            served = json.loads(resp.read())["rec_list"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return served


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_model_loads_in_the_other_package(both, tmp_path, name, saver):
    """A fitted model saved by one package predicts and recommends the same
    in the other; the port's save is served over HTTP by its class name."""
    from librecommender_tpu import models as jmodels

    (j_train, j_info), (t_train, t_info, _) = both
    cls = MODELS[name][0]
    kw = dict(n_epochs=1, dropout_rate=0.1)
    if saver == "jax":
        src, _ = jax_model(name, j_info, **kw)
        src.fit(j_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, name)
        dst = getattr(tmodels, cls).load(tmp_path, name, device="cpu")
    else:
        src = torch_model(name, t_info, **kw)
        src.fit(t_train, neg_sampling=True, verbose=0)
        src.save(tmp_path, name)
        dst = getattr(jmodels, cls).load(tmp_path, name)
    assert type(dst).__name__ == cls
    port, jax_side = (dst, src) if saver == "jax" else (src, dst)
    assert sorted(port.params_to_arrays()) == sorted(flat_numpy(jax_side.params))
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


def test_constructor_contract(both):
    _, (_, t_info, _) = both
    for name, (cls, _) in MODELS.items():
        model = getattr(tmodels, cls)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                model("ranking", t_info)   # device=None means the GPU
        with pytest.raises(ValueError):
            model("ranking", t_info, device="cpu", loss_type="bpr")
        assert "device" not in model("ranking", t_info, device="cpu").all_args
    # WideDeep's lr must be a dict of both parts (the JAX package's check)
    with pytest.raises(ValueError):
        tmodels.WideDeep("ranking", t_info, device="cpu", lr=0.01)
    with pytest.raises(ValueError):
        tmodels.WideDeep("ranking", t_info, device="cpu", lr={"wide": 0.01})
    m = tmodels.WideDeep("ranking", t_info, device="cpu",
                         lr={"wide": 0.01, "deep": 1e-4})
    assert m.lr == {"wide": 0.01, "deep": 1e-4}
    assert tmodels.WideDeep("ranking", t_info, device="cpu").lr == \
        {"wide": 0.01, "deep": 1e-4}
    # the JAX package's defaults
    a = tmodels.AutoInt("ranking", t_info, device="cpu", dropout_rate=0.5)
    assert (a.att_layer_dims, a.num_heads, a.use_residual) == ((16, 16, 16), 2, True)
    f = tmodels.FM("ranking", t_info, device="cpu")
    assert (f.use_bn, f.dropout_rate, f.multi_sparse_combiner) == (True, 0.0, "sqrtn")
    assert "multi_sparse_combiner" not in tmodels.NCF("ranking", t_info,
                                                      device="cpu").all_args


def test_fm_dropout_draws_in_training_only(both):
    """FM drops out its pairwise vector in training, from the model's
    generator; same-seed fits repeat, and inference is deterministic."""
    _, (t_train, t_info, _) = both

    def fit(**kw):
        m = torch_model("fm", t_info, n_epochs=1, **kw)
        m.fit(t_train, neg_sampling=True, verbose=0)
        return m

    a, b, c = fit(dropout_rate=0.3), fit(dropout_rate=0.3), fit()
    pa, pb, pc = (m.params_to_arrays() for m in (a, b, c))
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert any(not np.array_equal(pa[k], pc[k]) for k in pa)
    users, items = np.arange(20) % t_info.n_users, np.arange(20) % t_info.n_items
    np.testing.assert_array_equal(a.predict(users, items, inner_id=True),
                                  a.predict(users, items, inner_id=True))


# model -> JAX's AUC on the planted synthetic (PARITY.md), each at the
# protocol's embed 32, batch 2048, lr 0.001 (WideDeep {"wide": 0.01,
# "deep": 1e-3}), 5 epochs, hidden (128, 64, 32), use_bn=False
# (parity/run_ours.py)
FEAT_PARITY = {
    "FM": 0.7280,         # PARITY.md:25
    "DeepFM": 0.7283,     # PARITY.md:26
    "WideDeep": 0.7255,   # PARITY.md:77
    "AutoInt": 0.7190,    # PARITY.md:78
    "NCF": 0.7217,        # PARITY.md:76
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FEAT_PARITY))
def test_feat_model_auc_on_planted_synthetic(name):
    """The PARITY.md protocol on the ML-1M-sized planted data with its
    chrono split (sex, occupation and genre sparse, age dense), seed-2222
    eval negatives. The port's draws differ from JAX's (torch generators),
    so each model is held to its JAX column +/- 0.01."""
    from parity.synthetic import chrono_split, make_ml1m_like

    train, evals = chrono_split(make_ml1m_like())
    train_data, info = DatasetFeat.build_trainset(
        as_columns(train), user_col=["sex", "age", "occupation"],
        item_col=["genre"], sparse_col=["sex", "occupation", "genre"],
        dense_col=["age"])
    eval_data = DatasetFeat.build_evalset(as_columns(evals))
    kw = dict(embed_size=32, n_epochs=5, batch_size=2048, use_bn=False,
              device="cpu")
    kw["lr"] = {"wide": 0.01, "deep": 1e-3} if name == "WideDeep" else 0.001
    if name in ("DeepFM", "WideDeep", "NCF"):
        kw["hidden_units"] = (128, 64, 32)
    model = getattr(tmodels, name)("ranking", info, **kw)
    model.fit(train_data, neg_sampling=True, verbose=1, shuffle=True)
    res = evaluate(model, eval_data, neg_sampling=True, eval_batch_size=8192, k=10,
                   metrics=["roc_auc", "precision", "recall", "ndcg"], seed=2222)
    print(f"port {name} on the planted synthetic: {res}")
    want = FEAT_PARITY[name]
    assert want - 0.01 <= res["roc_auc"] <= want + 0.01


# ------------------------------------------------------------------- GPU
@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_steps_on_gpu_match_cpu(name):
    """Eight steps on the card (the sparse vocabulary's lookup through the
    gather and segment-sum kernels: one launch of each a step; NCF indexes
    plainly, none) against the same steps on the CPU at rtol 1e-4, atol
    1e-5, WideDeep's FTRL-updated linear weights included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    rng = np.random.default_rng(0)
    n = 6000
    users, items = rng.integers(0, 80, n), rng.integers(0, 300, n)
    data = {"user": users, "item": items, "label": np.ones(n),
            "sex": np.array(["m", "f"])[users % 2], "age": (users % 7) / 7.0,
            "genre": np.array(list("abcd"))[items % 4]}
    train, info = DatasetFeat.build_trainset(data, **FEAT_COLS)
    head = TransformedSet(train.user_indices[:2048], train.item_indices[:2048],
                          train.labels[:2048])
    init = torch_model(name, info)
    init.build_model()
    init = init.params_to_arrays()
    fitted = {}
    for device in ("cuda", "cpu"):
        m = torch_model(name, info, init, device=device, n_epochs=1,
                        batch_size=512, sampler="unconsumed")
        table_gather.reset_launches()
        m.fit(head, neg_sampling=True, verbose=0, shuffle=False)
        if device == "cuda":
            torch.cuda.synchronize()
            steps = -(-2048 // 256)
            want = 0 if name == "ncf" else steps
            assert table_gather.gather_launches == want
            assert table_gather.segsum_launches == want
        fitted[device] = m.params_to_arrays()
    for k in fitted["cpu"]:
        np.testing.assert_allclose(fitted["cuda"][k], fitted["cpu"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
