"""BPR training in the PyTorch port against the JAX package, on the CPU.

The port runs its kernels' plain versions; the JAX package runs its Pallas
gather/segment-sum kernels in interpret mode (``mxu_gather=True``).
Tolerances: losses and lazy Adam rtol 1e-6 (the same f32 arithmetic in
another library); a 2-epoch fit from the same initial parameters on the same
batches rtol 1e-4, atol 1e-5 (``tests/test_mxu_gather.py``'s tolerance for
sums in another order); evaluation on equal parameters rtol 1e-6.
"""
import numpy as np
import pytest
import torch


def _cols(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


# ------------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["mse_loss", "bce_loss", "focal_loss",
                                  "bpr_loss", "max_margin_loss"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(name, weighted):
    import jax
    import jax.numpy as jnp

    from librecommender_tpu.ops import losses as jl
    from librecommender_tpu_torch.ops import losses as pl

    rng = np.random.default_rng(0)
    n = 257
    a = rng.normal(scale=2.0, size=n).astype(np.float32)
    if name in ("bpr_loss", "max_margin_loss"):
        b = rng.normal(scale=2.0, size=n).astype(np.float32)
    else:
        b = (rng.random(n) < 0.4).astype(np.float32)      # labels
    weight = (np.arange(n) < 200).astype(np.float32) if weighted else None
    jw = None if weight is None else jnp.asarray(weight)
    tw = None if weight is None else torch.from_numpy(weight)

    def jax_loss(x, y):
        return getattr(jl, name)(x, y, jw)

    want = jax_loss(jnp.asarray(a), jnp.asarray(b))
    want_ga, want_gb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = getattr(pl, name)(ta, tb, tw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_ga), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_gb), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("schedule", ["exponential", "cosine"])
def test_lr_schedules_match_optax(schedule):
    """The LambdaLR factors at 0-based steps equal optax's schedules, which
    are evaluated before the step count moves."""
    import optax

    from librecommender_tpu_torch.training.trainer import lr_factor

    lr, n_batches, n_epochs = 0.01, 7, 3
    factor = lr_factor(True, n_batches, n_epochs, schedule)
    want = (optax.cosine_decay_schedule(lr, decay_steps=n_batches * n_epochs)
            if schedule == "cosine" else
            optax.exponential_decay(lr, transition_steps=n_batches,
                                    decay_rate=0.96, staircase=True))
    steps = range(n_batches * n_epochs + 3)
    # optax evaluates in float32: an ulp of lr (1e-9) apart near the end
    np.testing.assert_allclose([lr * factor(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6, atol=1e-9)
    assert lr_factor(False, n_batches, n_epochs) is None


# ---------------------------------------------------------------- lazy Adam
def _adam_case(seed):
    rng = np.random.default_rng(seed)
    tables = {"user_embed": (40, 8), "item_embed": (56, 9)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in tables.items()}
    touched = {"user_embed": rng.integers(0, 40, 30),       # duplicates included
               "item_embed": rng.integers(0, 56, 50)}
    grads = {}
    for k, s in tables.items():
        g = np.zeros(s, np.float32)
        np.add.at(g, touched[k], rng.normal(size=(len(touched[k]), s[1])).astype(np.float32))
        grads[k] = g
    return params, grads, touched


@pytest.mark.parametrize("form", ["rows", "dense"])
def test_lazy_adam_matches_jax(form):
    import jax.numpy as jnp

    from librecommender_tpu.training import sparse_optim as js
    from librecommender_tpu_torch.training import sparse_optim as ps

    keys = ("user_embed", "item_embed")
    params, _, _ = _adam_case(1)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = js.init_table_state(jparams, keys)
    tstate = ps.init_table_state(tparams, keys)
    for step in range(3):  # moments and bias correction carry over
        _, grads, touched = _adam_case(10 + step)
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        if form == "rows":
            new, jstate = js.lazy_adam_update(
                jparams, jg, jstate, {k: jnp.asarray(v) for k, v in touched.items()},
                0.01, eps=1e-5)
            ps.lazy_adam_update(tparams, tg, tstate,
                                {k: torch.from_numpy(v) for k, v in touched.items()},
                                0.01, eps=1e-5)
        else:
            new, jstate = js.dense_masked_adam_update(jparams, jg, jstate, keys,
                                                      0.01, eps=1e-5)
            ps.dense_masked_adam_update(tparams, tg, tstate, keys, 0.01, eps=1e-5)
        jparams = {**jparams, **new}
    assert tstate["count"] == int(jstate["count"]) == 3
    for k in keys:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(tstate[m][k].numpy(), np.asarray(jstate[m][k]),
                                       rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------- the fit
def _port_build(frame):
    from librecommender_tpu_torch.data import DatasetPure

    return DatasetPure.build_trainset(_cols(frame))


def test_dense_masked_adam_matches_row_path(pure_frames):
    """The port's two lazy-Adam forms agree up to the documented case (a
    touched row whose gradient is exactly zero: the padded tail's row 0),
    at ``tests/test_mxu_gather.py``'s tolerance for the same check."""
    from librecommender_tpu_torch.models import BPR

    ptrain, pinfo = _port_build(pure_frames[0])

    def fit(mode):
        m = BPR("ranking", pinfo, embed_size=8, n_epochs=2, batch_size=256,
                seed=3, device="cpu")
        m.sparse_update_mode = mode
        m.fit(ptrain, neg_sampling=True, verbose=0)
        return m.params_to_arrays()

    rows, dense = fit("rows"), fit("dense")
    for k in rows:
        np.testing.assert_allclose(rows[k], dense[k], rtol=1e-3, atol=1e-3, err_msg=k)


FIT_CONFIGS = [
    pytest.param(dict(), "dense", id="lazy-dense"),
    pytest.param(dict(), "rows", id="lazy-rows"),
    pytest.param(dict(sparse_optimizer=False, lr_decay=True), None, id="adam-decay"),
    pytest.param(dict(norm_embed=True, reg=0.01), None, id="norm-reg"),
    pytest.param(dict(optimizer="sgd", lr=0.05), None, id="sgd"),
    pytest.param(dict(optimizer="momentum", lr=0.05), None, id="momentum"),
]


@pytest.mark.parametrize("kwargs,mode", FIT_CONFIGS)
def test_fit_matches_jax(pure_frames, pure_builds, kwargs, mode):
    """JAX's initial parameters loaded into the port, then 2 epochs in both,
    unshuffled, with host-drawn (``unconsumed``) negatives: the same batches."""
    from librecommender_tpu.models import BPR as JaxBPR
    from librecommender_tpu_torch.models import BPR

    train_data, _, _, jinfo = pure_builds
    ptrain, pinfo = _port_build(pure_frames[0])
    common = dict(embed_size=8, n_epochs=2, batch_size=256, seed=3,
                  sampler="unconsumed", **{"lr": 0.01, **kwargs})
    jm = JaxBPR("ranking", jinfo, mxu_gather=True, **common)
    jm.build_model()
    pm = BPR("ranking", pinfo, device="cpu", **common)
    init = {k: np.asarray(v) for k, v in jm.params.items()}
    pm.params_from_arrays(init)
    if mode is not None:
        jm.sparse_update_mode = pm.sparse_update_mode = mode
    jm.fit(train_data, neg_sampling=True, verbose=0, shuffle=False)
    pm.fit(ptrain, neg_sampling=True, verbose=0, shuffle=False)
    got = pm.params_to_arrays()
    for k, v in jm.params.items():
        assert not np.allclose(got[k], init[k], rtol=1e-3, atol=1e-4)  # it trained
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(pm.user_embeds_np, jm.user_embeds_np, rtol=1e-4, atol=1e-5)


def test_fit_is_deterministic(pure_frames):
    """Same seed, device-drawn negatives and shuffling: bit-identical."""
    from librecommender_tpu_torch.models import BPR

    ptrain, pinfo = _port_build(pure_frames[0])

    def fit(seed):
        m = BPR("ranking", pinfo, embed_size=8, n_epochs=2, batch_size=128,
                seed=seed, device="cpu")
        m.fit(ptrain, neg_sampling=True, verbose=0)
        return m.params_to_arrays(), m.trainer.epoch_losses

    (a, la), (b, lb), (c, _) = fit(5), fit(5), fit(6)
    assert la == lb
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])


def test_fit_rejects_unported_options(pure_frames, tmp_path):
    from librecommender_tpu_torch.models import BPR

    ptrain, pinfo = _port_build(pure_frames[0])
    m = BPR("ranking", pinfo, embed_size=8, n_epochs=1, device="cpu")
    with pytest.raises(NotImplementedError, match="1.14"):
        m.fit(ptrain, neg_sampling=True, verbose=0, checkpoint_dir=tmp_path)
    with pytest.raises(NotImplementedError, match="1.16"):
        m.fit(ptrain, neg_sampling=True, verbose=0, mesh=object())
    with pytest.raises(ValueError, match="negative sampling"):
        m.fit(ptrain, neg_sampling=False, verbose=0)


def test_fit_early_stopping_and_profile(pure_frames, tmp_path, capsys):
    from librecommender_tpu_torch.data import DatasetPure
    from librecommender_tpu_torch.models import BPR

    train, evals, _ = pure_frames
    ptrain, pinfo = _port_build(train)
    peval = DatasetPure.build_evalset(_cols(evals))
    m = BPR("ranking", pinfo, embed_size=8, n_epochs=4, batch_size=128,
            lr=0.05, device="cpu")
    m.fit(ptrain, neg_sampling=True, verbose=2, eval_data=peval,
          metrics=["roc_auc", "precision"], eval_user_num=20, early_stopping=1,
          profile_dir=tmp_path)
    out = capsys.readouterr().out
    assert "eval roc_auc" in out and "train_loss" in out
    assert (tmp_path / "epoch2_trace.json").exists()
    assert 2 <= len(m.trainer.epoch_times) <= 4


@pytest.fixture(scope="module")
def trained_pair(pure_frames, tmp_path_factory):
    """A JAX BPR fitted on the train frame, and the port's model holding the
    same parameters, with each package's own eval set."""
    from librecommender_tpu.data import DatasetPure as JaxDatasetPure
    from librecommender_tpu.models import BPR as JaxBPR
    from librecommender_tpu_torch.data import DatasetPure
    from librecommender_tpu_torch.models import BPR

    train, evals, _ = pure_frames
    jtrain, jinfo = JaxDatasetPure.build_trainset(train)
    jeval = JaxDatasetPure.build_evalset(evals)
    jm = JaxBPR("ranking", jinfo, embed_size=8, n_epochs=2, batch_size=128, lr=0.02)
    jm.fit(jtrain, neg_sampling=True, verbose=0)
    ptrain, pinfo = DatasetPure.build_trainset(_cols(train))
    peval = DatasetPure.build_evalset(_cols(evals))
    pm = BPR("ranking", pinfo, embed_size=8, device="cpu")
    pm.params_from_arrays({k: np.asarray(v) for k, v in jm.params.items()})
    pm.post_fit()
    return jm, jeval, pm, peval, ptrain


def test_evaluate_matches_jax(trained_pair):
    from librecommender_tpu.evaluation import evaluate as jax_evaluate
    from librecommender_tpu_torch.evaluation import evaluate

    jm, jeval, pm, peval, _ = trained_pair
    metrics = ["loss", "roc_auc", "pr_auc", "balanced_accuracy", "roc_gauc",
               "precision", "recall", "map", "ndcg", "coverage"]
    kw = dict(neg_sampling=True, metrics=metrics, k=5, sample_user_num=30, seed=7)
    want = jax_evaluate(jm, jeval, **kw)
    got = evaluate(pm, peval, **kw)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, err_msg=name)


def test_port_trained_model_round_trips_through_jax(trained_pair, tmp_path):
    from librecommender_tpu.models import BPR as JaxBPR
    from librecommender_tpu_torch.models import BPR

    _, _, _, _, ptrain = trained_pair
    pm = BPR("ranking", trained_pair[2].data_info, embed_size=8, n_epochs=2,
             batch_size=128, device="cpu")
    pm.fit(ptrain, neg_sampling=True, verbose=0)
    pm.save(tmp_path, "bpr")
    back = JaxBPR.load(tmp_path, "bpr")
    users = [pm.data_info.id2user[i] for i in range(8)]
    want, got = back.recommend_user(users, 7), pm.recommend_user(users, 7)
    for u in users:
        np.testing.assert_array_equal(got[u], want[u])
    np.testing.assert_array_equal(back.default_recs, pm.default_recs)


@pytest.mark.slow
def test_bpr_auc_on_planted_synthetic():
    """The PARITY.md protocol: ML-1M-sized planted data, chrono split, embed
    32, batch 2048, lr 0.01, 5 epochs, seed-2222 eval negatives. JAX's AUC
    across seeds 42/7/2024 is 0.7288 / 0.7306 / 0.7300; the port's draws
    differ (torch generators), so it is held to that band +/- 0.01."""
    from parity.synthetic import chrono_split, make_ml1m_like

    from librecommender_tpu_torch.data import DatasetPure
    from librecommender_tpu_torch.evaluation import evaluate
    from librecommender_tpu_torch.models import BPR

    train, evals = chrono_split(make_ml1m_like())
    cols = ["user", "item", "label", "time"]
    train_data, info = DatasetPure.build_trainset(_cols(train[cols]))
    eval_data = DatasetPure.build_evalset(_cols(evals[cols]))
    model = BPR("ranking", info, embed_size=32, n_epochs=5, lr=0.01,
                batch_size=2048, device="cpu")
    model.fit(train_data, neg_sampling=True, verbose=1, shuffle=True)
    res = evaluate(model, eval_data, neg_sampling=True, eval_batch_size=8192, k=10,
                   metrics=["roc_auc", "precision", "recall", "ndcg"], seed=2222)
    print(f"port BPR on the planted synthetic: {res}")
    assert 0.7188 <= res["roc_auc"] <= 0.7406


# model -> (JAX's AUC on the planted synthetic, PARITY.md, and the model's
# kwargs beside the protocol's embed 32, batch 2048, lr 0.001, 5 epochs,
# hidden (128, 64, 32), use_bn=False, recent_num=10)
SEQ_PARITY = {
    "DIN": (0.7336, {}),                                       # PARITY.md:27
    "Transformer": (0.7341, {}),                               # PARITY.md:29
    "YouTubeRanking": (0.7356, {}),                            # PARITY.md:79
    "SIM": (0.7394, dict(long_max_len=50, search_topk=10)),    # PARITY.md:83
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SEQ_PARITY))
def test_sequence_model_auc_on_planted_synthetic(name):
    """The PARITY.md protocol for the feature models (sex, occupation and
    genre sparse, age dense) on the ML-1M-sized planted data with its chrono
    split, seed-2222 eval negatives. The port's draws differ from JAX's
    (torch generators), so each model is held to its JAX column +/- 0.01."""
    from parity.synthetic import chrono_split, make_ml1m_like

    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.data import DatasetFeat
    from librecommender_tpu_torch.evaluation import evaluate

    want, kw = SEQ_PARITY[name]
    train, evals = chrono_split(make_ml1m_like())
    train_data, info = DatasetFeat.build_trainset(
        _cols(train), user_col=["sex", "age", "occupation"], item_col=["genre"],
        sparse_col=["sex", "occupation", "genre"], dense_col=["age"])
    eval_data = DatasetFeat.build_evalset(_cols(evals))
    model = getattr(models, name)(
        "ranking", info, embed_size=32, n_epochs=5, lr=0.001, batch_size=2048,
        hidden_units=(128, 64, 32), recent_num=10, use_bn=False, device="cpu",
        **kw)
    model.fit(train_data, neg_sampling=True, verbose=1, shuffle=True)
    res = evaluate(model, eval_data, neg_sampling=True, eval_batch_size=8192, k=10,
                   metrics=["roc_auc", "precision", "recall", "ndcg"], seed=2222)
    print(f"port {name} on the planted synthetic: {res}")
    assert want - 0.01 <= res["roc_auc"] <= want + 0.01
