"""YouTubeRanking, Transformer and SIM of the PyTorch port against the JAX
package, on the CPU.

Both packages build the ``tests/conftest.py`` feature frame; the port starts
from JAX's initial parameters, and with ``shuffle=False`` and
``sampler="unconsumed"`` both see the same batches. Tolerances in float32:
forward and loss rtol 1e-5, gradients rtol 1e-4, atol 1e-6; parameters after
a 2-epoch fit rtol 1e-4, atol 1e-5 (float32 sums in another order, through
Adam); recommendation ids equal; predictions after save and load in the
other package 1e-6. The Transformer's bfloat16 encoder rounds its layer
norms, softmax and products differently in XLA and in PyTorch, so there:
forward and loss rtol 2e-2, atol 2e-2 on logits of order 1 (a few bfloat16
ulps of the encoder's output); each gradient no farther from the float32
gradient than twice JAX's own bfloat16 gradient is, plus 1e-3 of its
largest entry (both lie up to a fifth of the largest entry from it at this
size); the fit's parameters, by the same rule, against JAX's float32 fit
from the same start. The JAX
package's Pallas scatter runs in interpret mode where its flag is on. The
``cuda`` test runs the same steps on the card and asserts the kernels'
launch counts.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from librecommender_tpu_torch.batch.sequence import build_train_seqs
from librecommender_tpu_torch.data import DatasetFeat, TransformedSet
from librecommender_tpu_torch.evaluation import evaluate
from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.ops import row_scatter
from librecommender_tpu_torch.ops import table_gather
from librecommender_tpu_torch.serving import DictStore, create_server
from librecommender_tpu_torch.utils.save_load import flatten_tree

FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
SMALL = dict(embed_size=8, hidden_units=(32, 16), recent_num=5, batch_size=256,
             seed=3)
LONG = 8   # SIM's long window at this size

# name -> (model class, kwargs)
CASES = {
    "youtube": ("YouTubeRanking", {}),
    "transformer_f32": ("Transformer", dict(compute_dtype="f32")),
    "transformer_bf16": ("Transformer", {}),
    "sim": ("SIM", dict(long_max_len=LONG, search_topk=3)),
    "sim_frozen_long": ("SIM", dict(long_max_len=LONG, search_topk=3,
                                    long_history_grad=False)),
}
# forward-only variants of the other code paths
VARIANTS = {
    "transformer_deep": ("Transformer", dict(
        compute_dtype="f32", num_tfm_layers=2, positional_embedding="sinusoidal",
        feat_agg_mode="elementwise", num_heads=1)),
    "transformer_causal": ("Transformer", dict(
        compute_dtype="f32", num_tfm_layers=2, use_causal_mask=True,
        feat_agg_mode=None)),
    "sim_concat": ("SIM", dict(long_max_len=LONG, search_topk=3,
                               feat_agg_mode="concat", alpha=0.5, beta=0.8)),
}


def _bf16(name):
    return name.endswith("bf16")


def as_columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


@pytest.fixture()
def both(feat_frames):
    from librecommender_tpu.data import DatasetFeat as JDatasetFeat

    train, evals, _ = feat_frames
    j_train, j_info = JDatasetFeat.build_trainset(train, **FEAT_COLS)
    t_train, t_info = DatasetFeat.build_trainset(as_columns(train), **FEAT_COLS)
    t_eval = DatasetFeat.build_evalset(as_columns(evals))
    return (j_train, j_info), (t_train, t_info, t_eval)


def jax_model(name, info, **kw):
    import jax

    from librecommender_tpu import models as jmodels

    cls, base = {**CASES, **VARIANTS}[name]
    model = getattr(jmodels, cls)("ranking", info, **{**SMALL, **base, **kw})
    model.build_model()
    return model, jax.device_get(model.params)


def torch_model(name, info, init=None, device="cpu", **kw):
    cls, base = {**CASES, **VARIANTS}[name]
    model = getattr(tmodels, cls)("ranking", info, device=device,
                                  **{**SMALL, **base, **kw})
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
    """One training batch from the head of the train set, with all-pad
    histories in it (each user's first interaction)."""
    rng = np.random.default_rng(seed)
    u, i = train.user_indices, train.item_indices
    batch = {
        "user": u[:n].astype(np.int32),
        "item": i[:n].astype(np.int32),
        "label": np.ones(n, np.float32),
        "weight": (rng.random(n) < 0.9).astype(np.float32),
        "item_neg": rng.integers(0, info.n_items, (n, num_neg)).astype(np.int32),
        "seq": build_train_seqs(u, i, info.n_items, 5)[0][:n],
        "seq_long": build_train_seqs(u, i, info.n_items, LONG)[0][:n],
    }
    assert (batch["seq_long"] == info.n_items).all(axis=1).any()
    return batch


@pytest.mark.parametrize("name", list(CASES) + list(VARIANTS))
def test_forward_and_loss_match_jax(both, name):
    import jax
    import jax.numpy as jnp

    (j_train, j_info), (t_train, t_info, _) = both
    jm, init = jax_model(name, j_info, reg=0.01)
    tm = torch_model(name, t_info, init, reg=0.01)
    same_params(tm.params_to_arrays(), init, rtol=0, atol=0)
    assert tm.token_dim == jm.token_dim and tm.n_fields == jm.n_fields
    rtol, atol = (2e-2, 2e-2) if _bf16(name) else (1e-5, 1e-6)

    batch = _batch(t_info, t_train)
    if not name.startswith("sim"):
        del batch["seq_long"]
    inputs = {k: batch[k] for k in batch if k in ("user", "item")
              or k.startswith("seq")}
    want = jax.jit(lambda p, i: jm._forward(p, i, train=False, rng=None))(
        jm.params, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = tm._forward(tm._tree(), {k: torch.from_numpy(v) for k, v in inputs.items()},
                      train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)

    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    j_grads = flat_numpy(jax.device_get(j_grads))
    if _bf16(name):
        # the float32 gradient, which both bfloat16 encoders approximate
        jm32, _ = jax_model(name, j_info, reg=0.01, compute_dtype="f32")
        g32 = flat_numpy(jax.device_get(jax.jit(jax.grad(jm32.loss_fn))(
            jm.params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))))
    for flag in (False, True):   # the scatter-add backward changes nothing
        tm.pallas_grad_scatter = flag
        loss = tm.loss_fn(tm.net, t_batch)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=rtol)
        grads = dict(zip(tm.net.keys(),
                         torch.autograd.grad(loss, list(tm.net.values()),
                                             allow_unused=True)))
        for k, g in j_grads.items():
            have = np.zeros_like(g) if grads[k] is None else grads[k].numpy()
            assert np.isfinite(have).all(), k   # all-pad histories too
            if _bf16(name):
                top = float(np.abs(g32[k]).max())
                jax_err = float(np.abs(g - g32[k]).max())
                assert np.abs(have - g32[k]).max() <= 2 * jax_err + 1e-3 * top, k
            else:
                np.testing.assert_allclose(have, g, rtol=1e-4, atol=1e-6,
                                           err_msg=k)


def test_sim_builds_its_token_table_once_a_forward(both, monkeypatch):
    _, (t_train, t_info, _) = both
    tm = torch_model("sim_concat", t_info)
    tm.build_model()
    calls = []
    raw = tm._token_embeds_raw
    monkeypatch.setattr(tm, "_token_embeds_raw",
                        lambda p, ids: calls.append(tuple(ids.shape)) or raw(p, ids))
    batch = {k: torch.from_numpy(v) for k, v in _batch(t_info, t_train).items()}
    tm.loss_fn(tm.net, batch)
    # the targets, the long history and the short window share it
    assert calls == [(t_info.n_items + 1,)]
    calls.clear()
    tm._score_users(np.arange(3))
    assert calls == [(t_info.n_items + 1,)]


def test_sim_catalog_reads_the_long_table(both):
    _, (_, t_info, _) = both
    tm = torch_model("sim", t_info)
    tm.build_model()
    users = torch.tensor([0, 4, t_info.n_users])
    assert tm._catalog_seq(users, key="seq_long").shape == (3, LONG)
    assert torch.equal(tm._catalog_seq(users, key="seq_long"),
                       tm.recent_long_table[users])
    assert torch.equal(tm._catalog_seq(users), tm.recent_seq_table[users])
    # the short window is the long one's suffix
    assert torch.equal(tm.recent_long_table[:, -5:], tm.recent_seq_table)


# (name, kernel lookups forced, optimizer). Adam moves an entry whose
# gradient is near zero by lr * g / eps, so float32 summation-order noise in
# g (at most 3e-7 absolute, measured step by step from identical parameters,
# where the forward logits agree within 1e-6 at every step of JAX's own
# trajectory) becomes lr / eps times larger in the parameters: at lr 0.01
# the Transformer and SIM land up to 3e-2 and 6e-3 from JAX after 2 epochs
# (and the Transformer as far from a port fit of parameters perturbed by
# 1e-7), at lr 0.001 SIM up to 7e-4. Those two are held at the models'
# default lr, SIM with eps 1e-3.
FITS = [("youtube", False, dict(lr=0.01)),
        ("transformer_f32", True, dict(lr=0.001)),
        ("transformer_bf16", False, dict(lr=0.001)),
        ("sim", True, dict(lr=0.001, epsilon=1e-3)),
        ("sim_frozen_long", False, dict(lr=0.001, epsilon=1e-3))]


@pytest.mark.slow
@pytest.mark.parametrize("name,force,optim", FITS, ids=[f[0] for f in FITS])
def test_two_epoch_fit_matches_jax(both, monkeypatch, name, force, optim):
    import jax

    from librecommender_tpu.ops import pallas_scatter as ps

    monkeypatch.setattr(ps, "_INTERPRET", True)
    (j_train, j_info), (t_train, t_info, t_eval) = both
    kw = dict(n_epochs=2, sampler="unconsumed", num_neg=2, **optim)
    jm, init = jax_model(name, j_info, **kw)
    tm = torch_model(name, t_info, init, **kw)
    jm.pallas_grad_scatter = tm.pallas_grad_scatter = True
    if force:   # lookups through TableGather (its plain versions here)
        tm._mxu_lookup_force = True
    jm.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
    tm.fit(t_train, neg_sampling=True, verbose=0, shuffle=False)
    got = tm.params_to_arrays()
    if _bf16(name):
        # no farther from the float32 fit than JAX's bfloat16 fit is
        j32, _ = jax_model(name, j_info, compute_dtype="f32", **kw)
        j32.params = jax.tree.map(jax.numpy.asarray, init)
        j32.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
        want32 = flat_numpy(jax.device_get(j32.params))
        want16 = flat_numpy(jax.device_get(jm.params))
        for k, w in want32.items():
            jax_err = float(np.abs(want16[k] - w).max())
            assert np.abs(got[k] - w).max() <= 2 * jax_err + 1e-3, k
    else:
        same_params(got, jax.device_get(jm.params))
    assert all(np.isfinite(v).all() for v in got.values())
    assert np.isfinite(tm.trainer.epoch_losses).all()

    # the rest from the same parameters, so that ids can be held equal
    tm.params_from_arrays(jax.device_get(jm.params))
    tm.build_default_recs()
    users = np.arange(40) % t_info.n_users
    items = (np.arange(40) * 7) % t_info.n_items
    np.testing.assert_allclose(tm.predict(users, items, inner_id=True),
                               jm.predict(users, items, inner_id=True),
                               rtol=1e-4 if not _bf16(name) else 2e-2, atol=1e-5)
    raw_users = [int(t_info.id2user[u]) for u in (0, 5, 17)] + [-1]  # and a cold one
    # bfloat16 scores of two libraries tie-break apart: ids are held in f32
    for kwargs in ({}, {"filter_consumed": False}, {"cold_start": "popular"},
                   {"users_per_call": 2}):
        want = jm.recommend_user(raw_users, 7, **kwargs)
        have = tm.recommend_user(raw_users, 7, **kwargs)
        for u in raw_users:
            assert len(have[u]) == len(want[u]) == 7
            if not _bf16(name):
                np.testing.assert_array_equal(have[u], want[u])
    if not _bf16(name):
        np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    metrics = evaluate(tm, t_eval, neg_sampling=True, metrics=["roc_auc", "precision"])
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("name", ["youtube", "transformer_f32", "sim",
                                  "transformer_deep"])
def test_recommend_ids_match_jax(both, name):
    """recommend_user from JAX's initial parameters: the same ids for known
    users and a cold one, with and without the consumed filter, in one chunk
    of users and in several."""
    (_, j_info), (_, t_info, _) = both
    raw_users = [int(t_info.id2user[u]) for u in (0, 5, 17, 33)] + [-1]
    jm, init = jax_model(name, j_info)
    tm = torch_model(name, t_info, init)
    tm.build_default_recs()
    for kwargs in ({}, {"filter_consumed": False}, {"users_per_call": 2}):
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


@pytest.mark.parametrize("name", ["youtube", "transformer_bf16", "sim"])
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_model_loads_in_the_other_package(both, tmp_path, name, saver):
    from librecommender_tpu import models as jmodels

    (j_train, j_info), (t_train, t_info, _) = both
    cls = CASES[name][0]
    kw = dict(n_epochs=1, dropout_rate=0.0)
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
    assert type(dst).__name__ == cls and dst.hidden_units == (32, 16)
    port, jax_side = (dst, src) if saver == "jax" else (src, dst)
    assert sorted(port.params_to_arrays()) == sorted(flat_numpy(jax_side.params))
    users = np.arange(60) % t_info.n_users
    items = (np.arange(60) * 3) % t_info.n_items
    tol = 2e-2 if _bf16(name) else 1e-6   # bfloat16 encoders in two libraries
    np.testing.assert_allclose(dst.predict(users, items, inner_id=True),
                               src.predict(users, items, inner_id=True), atol=tol)
    raw = [int(t_info.id2user[3]), -1]   # a known user and a cold one
    want, have = src.recommend_user(raw, 5), dst.recommend_user(raw, 5)
    if not _bf16(name):
        for u in raw:
            np.testing.assert_array_equal(have[u], want[u])
    if saver == "torch":
        hyper = json.loads((tmp_path / f"{name}_hyper_params.json").read_text())
        assert "device" not in hyper and hyper["model_class"] == cls
        # the port's HTTP server serves it by its saved class name
        served = _serve(tmp_path, name, raw[0])
        assert served == [int(i) for i in want[raw[0]]]


def test_constructor_contract(both):
    _, (_, t_info, _) = both
    for cls in ("YouTubeRanking", "Transformer", "SIM"):
        model = getattr(tmodels, cls)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                model("ranking", t_info)   # device=None means the GPU
        with pytest.raises(ValueError):
            model("ranking", t_info, device="cpu", loss_type="bpr")
        m = model("ranking", t_info, device="cpu", random_num=4, recent_num=None)
        assert (m.seq_mode, m.max_seq_len) == ("random", 4)
        assert "device" not in m.all_args
    with pytest.raises(ValueError, match="ranking"):
        tmodels.YouTubeRanking("rating", t_info, device="cpu")
    for bad in (dict(compute_dtype="f16"), dict(positional_embedding="rope"),
                dict(feat_agg_mode="sum")):
        with pytest.raises(ValueError):
            tmodels.Transformer("ranking", t_info, device="cpu", **bad)
    for bad in (dict(feat_agg_mode="sum"), dict(long_max_len=4, search_topk=5),
                dict(alpha=1.5)):
        with pytest.raises(ValueError):
            tmodels.SIM("ranking", t_info, device="cpu", **bad)
    m = tmodels.SIM("ranking", t_info, device="cpu", short_max_len=6, long_max_len=20)
    assert m.max_seq_len == 6 and m.long_max_len == 20
    # the JAX package's defaults
    t = tmodels.Transformer("ranking", t_info, device="cpu")
    assert (t.compute_dtype, t.feat_agg_mode, t.num_heads, t.num_tfm_layers) == \
        ("bf16", "concat", 2, 1)
    s = tmodels.SIM("ranking", t_info, device="cpu")
    assert (s.long_max_len, s.search_topk, s.long_history_grad, s.feat_agg_mode) == \
        (100, 10, True, None)


def test_recommend_halves_the_user_chunk_when_memory_runs_out(both, monkeypatch):
    _, (_, t_info, _) = both
    m = torch_model("sim", t_info)
    m.build_model()
    users = list(range(9))
    want = m.recommend_user(users, 5, inner_id=True)
    score, calls = m._score_users, []

    def short_of_memory(uids, overrides=None):
        calls.append(len(uids))
        if len(uids) > 2:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return score(uids, overrides)

    monkeypatch.setattr(m, "_score_users", short_of_memory)
    have = m.recommend_user(users, 5, inner_id=True)
    for u in users:
        np.testing.assert_array_equal(have[u], want[u])
    assert calls[:3] == [9, 4, 2] and m._users_per_call_cap == 2


# ------------------------------------------------------------------- GPU
# a step's launches of (the scatter-add, each lookup kernel)
GPU_LAUNCHES = {"youtube": (1, 1), "transformer_bf16": (3, 2), "sim": (3, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["youtube", "transformer_bf16", "sim"])
def test_steps_on_gpu_match_cpu(name):
    """Eight steps on the card through the gather, segment-sum and
    scatter-add kernels against the same steps on the CPU: f32 models at
    rtol 1e-4, atol 1e-5; the bfloat16 Transformer no farther from the CPU's
    float32 fit than twice the CPU's bfloat16 fit is, plus 1e-3."""
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
    runs = [("cuda", {}), ("cpu", {})]
    if _bf16(name):
        runs.append(("f32", dict(compute_dtype="f32")))
    for device, kw in runs:
        m = torch_model(name, info, init, device=device.replace("f32", "cpu"),
                        n_epochs=1, batch_size=512, sampler="unconsumed", **kw)
        m.pallas_grad_scatter = True
        row_scatter.reset_launches()
        table_gather.reset_launches()
        m.fit(head, neg_sampling=True, verbose=0, shuffle=False)
        if device == "cuda":
            # a step: the history's scatter-add (Transformer: also the
            # targets' and the packed table's; SIM: the targets', the short
            # and the long history's), the sparse fields' lookup (Transformer:
            # also the tokens' features)
            torch.cuda.synchronize()
            scatters, lookups = GPU_LAUNCHES[name]
            steps = -(-2048 // 256)
            assert row_scatter.launches == scatters * steps
            assert table_gather.gather_launches == lookups * steps
            assert table_gather.segsum_launches == lookups * steps
        fitted[device] = m.params_to_arrays()
    for k in fitted["cpu"]:
        if _bf16(name):
            ref = fitted["f32"][k]
            limit = 2 * np.abs(fitted["cpu"][k] - ref).max() + 1e-3
            assert np.abs(fitted["cuda"][k] - ref).max() <= limit, k
        else:
            np.testing.assert_allclose(fitted["cuda"][k], fitted["cpu"][k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)
