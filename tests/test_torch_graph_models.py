"""The graph structures, LightGCN, NGCF and AMSGrad of the PyTorch port
against the JAX package, on the CPU.

Both packages build the ``tests/conftest.py`` pure frame; the port starts
from JAX's initial parameters. Dropout masks are JAX's where a test feeds
them through the port's seam (``_keep_mask``); elsewhere dropout is held in
distribution only. Tolerances in float32: the edge lists and adjacency
matrices exact; propagated embeddings, loss and every gradient rtol 1e-5
(atol 1e-6 for entries that cancel to near zero); AMSGrad over 20 steps
rtol 1e-6 against ``optax.amsgrad``; parameters after a 2-epoch fit rtol
1e-4, atol 1e-5; recommendation ids equal, where two items' scores lie
within 1e-5 relative of each other in either order; predictions after save
and load in the other package 1e-6.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetPure
from librecommender_tpu_torch.evaluation import evaluate
from librecommender_tpu_torch.graph import build_dense_adjacency, build_edges
from librecommender_tpu_torch.training.optimizers import AMSGrad

from tests.test_torch_embed_models import (_serve, as_numpy, batch_of, cols,
                                           same_params, same_recs, within_spread)

SMALL = dict(embed_size=8, batch_size=256, seed=3)

# name -> (class, kwargs beside SMALL)
MODELS = {
    "lightgcn-bf16": ("LightGCN", {}),
    "lightgcn-f32": ("LightGCN", dict(adj_dtype="f32")),
    "lightgcn-edges": ("LightGCN", dict(dense_adj_limit=0)),
    "ngcf": ("NGCF", dict(hidden_units=(8, 8))),
    "ngcf-edges": ("NGCF", dict(hidden_units=(8, 8), dense_adj_limit=0)),
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


def jax_model(name, info, **kw):
    import jax

    from librecommender_tpu import models as jmodels

    cls, extra = MODELS[name]
    model = getattr(jmodels, cls)("ranking", info, **{**SMALL, **extra, **kw})
    model.build_model()
    return model, jax.device_get(model.params)


def torch_model(name, info, init=None, device="cpu", **kw):
    cls, extra = MODELS[name]
    model = getattr(tmodels, cls)("ranking", info, device=device,
                                  **{**SMALL, **extra, **kw})
    if init is not None:
        model.params_from_arrays(init)
    return model


def test_graph_structures_match_jax(both):
    from librecommender_tpu.graph import adjacency as ja

    _, (_, info, _) = both
    args = (info.user_consumed, info.n_users, info.n_items)
    for got, want in zip(build_edges(*args), ja.build_edges(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    eu, ei, _ = build_edges(*args)
    assert np.all(np.diff(eu.astype(np.int64) * info.n_items + ei) > 0)
    dense = build_dense_adjacency(*args, 64, 104)
    np.testing.assert_array_equal(dense, ja.build_dense_adjacency(*args, 64, 104))
    assert dense.shape == (64, 104) and dense[info.n_users:].sum() == 0
    assert build_edges({}, 3, 4)[0].shape == (0,)


def _jax_masks(jm, shapes_keeps):
    """The Bernoulli masks JAX's ``_propagate`` draws under the loss key of
    ``test_embed_models.jax_loss_and_grads``, in the order the port asks for
    them: LightGCN's one, NGCF's node mask then each layer's user and item
    message masks."""
    import jax

    _, r_prop = jax.random.split(jax.random.PRNGKey(0))
    if type(jm).__name__ == "LightGCN":
        keys = [r_prop]
    else:
        r1, r2 = jax.random.split(r_prop)
        keys = [r1] if jm.node_dropout > 0 else []
        for _ in range(len(jm.hidden_units)):
            r2, k1, k2 = jax.random.split(r2, 3)
            keys += [k1, k2]
    return [np.asarray(jax.random.bernoulli(k, keep, shape))
            for k, (shape, keep) in zip(keys, shapes_keeps)]


def _jax_loss_and_grads(jm, batch):
    import jax
    import jax.numpy as jnp

    loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    return float(loss), as_numpy(jax.device_get(grads))


def _torch_loss_and_grads(tm, batch):
    loss = tm.loss_fn(tm.net, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tm.net.values()), materialize_grads=True)
    return loss.item(), {k: g.numpy() for k, g in zip(tm.net.keys(), grads)}


# (model, loss_type, negatives a row, kwargs)
LOSS_CASES = (
    [(name, "bpr", 2, {}) for name in MODELS]
    + [("lightgcn-bf16", "max_margin", 1, dict(margin=0.3, reg=0.01)),
       ("lightgcn-edges", "cross_entropy", 2, dict(reg=0.01)),
       ("lightgcn-f32", "focal", 1, {}),
       ("ngcf", "cross_entropy", 0, dict(reg=0.01)),
       ("ngcf-edges", "max_margin", 2, {}),
       ("ngcf", "focal", 2, {}),
       ("lightgcn-bf16", "bpr", 1, dict(dropout_rate=0.3)),
       ("lightgcn-edges", "bpr", 1, dict(dropout_rate=0.3)),
       ("ngcf", "bpr", 1, dict(node_dropout=0.2, message_dropout=0.3)),
       ("ngcf-edges", "cross_entropy", 1, dict(message_dropout=0.3))]
)


@pytest.mark.parametrize(
    "name,loss_type,num_neg,kw", LOSS_CASES,
    ids=[f"{n}-{lt}-{'-'.join(kw) or 'plain'}" for n, lt, _, kw in LOSS_CASES])
def test_propagation_loss_and_gradients_match_jax(both, name, loss_type, num_neg, kw):
    import jax

    (_, j_info), (t_train, t_info, _) = both
    kw = dict(loss_type=loss_type, **kw)
    jm, init = jax_model(name, j_info, **kw)
    tm = torch_model(name, t_info, init, **kw)
    same_params(tm.params_to_arrays(), init, rtol=0, atol=0)
    assert tm.paradigm == jm.paradigm
    # the same graph on the device
    if jm.adj is not None:
        np.testing.assert_array_equal(tm.adj.numpy(),
                                      np.asarray(jm.adj.astype("float32")))
    else:
        for key in ("edge_u", "edge_i", "edge_w"):
            np.testing.assert_array_equal(getattr(tm, key).numpy(),
                                          np.asarray(getattr(jm, key)))
    want_u, want_i = jm._propagate(jm.params, jax.random.PRNGKey(0), False)
    with torch.no_grad():
        got_u, got_i = tm._propagate(tm._tree(), False)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-5, atol=1e-6)
    # the masks: record the shapes the port asks for, then feed JAX's
    asked = []
    plain = tm._keep_mask
    tm._keep_mask = lambda shape, keep: asked.append((tuple(shape), keep)) or plain(
        shape, keep)
    batch = batch_of(t_info, t_train, num_neg=num_neg)
    tm.loss_fn(tm.net, {k: torch.from_numpy(v) for k, v in batch.items()})
    masks = iter(_jax_masks(jm, asked))
    tm._keep_mask = lambda shape, keep: torch.from_numpy(next(masks))
    j_loss, j_grads = _jax_loss_and_grads(jm, batch)
    t_loss, t_grads = _torch_loss_and_grads(tm, batch)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    for k, g in j_grads.items():
        np.testing.assert_allclose(t_grads[k], g, rtol=1e-5, atol=1e-6, err_msg=k)


def test_bf16_adjacency_keeps_float32_messages(both):
    """A holds bfloat16 values; a layer's input is rounded to bfloat16 and
    its messages are float32 sums, not bfloat16 ones."""
    _, (_, t_info, _) = both
    tm = torch_model("lightgcn-bf16", t_info)
    tm.build_model()
    A = tm.adj
    assert A.dtype == torch.float32
    torch.testing.assert_close(A.to(torch.bfloat16).float(), A, rtol=0, atol=0)
    h = tm.net["item_embed"].detach()
    msg = tm._propagate({"user_embed": tm.net["user_embed"].detach(),
                         "item_embed": h}, False)[0]
    exact = (A.double() @ h.to(torch.bfloat16).double()).float()
    layer1 = (A @ h.to(torch.bfloat16).float())
    torch.testing.assert_close(layer1, exact, rtol=1e-6, atol=1e-8)
    assert not torch.equal(layer1, layer1.to(torch.bfloat16).float())
    assert msg.dtype == torch.float32


def test_dense_propagation_holds_matmul_to_float32(both):
    """The adjacency products run with TF32 off in both directions, whatever
    the caller's setting, and leave the setting as it was."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, (_, t_info, _) = both
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.mm,):
                seen.append(torch.backends.cuda.matmul.allow_tf32)
            return func(*args, **(kwargs or {}))

    before = torch.backends.cuda.matmul.allow_tf32
    for name in ("lightgcn-f32", "ngcf"):
        tm = torch_model(name, t_info)
        tm.build_model()
        batch = {"user": torch.arange(8), "item": torch.arange(8),
                 "label": torch.ones(8), "weight": torch.ones(8),
                 "item_neg": torch.arange(8)[:, None] + 1}
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            seen.clear()
            with Record():
                tm.loss_fn(tm.net, batch).backward()
            assert torch.backends.cuda.matmul.allow_tf32 is True
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        # LightGCN: 3 layers x 2 products forward and backward; NGCF also
        # runs its weight products, which follow the caller's setting
        assert seen.count(False) >= 12 if name.startswith("lightgcn") else 8


def test_dropout_in_distribution(both):
    """The port's own masks: about ``rate`` of the adjacency entries or edge
    weights dropped, the rest scaled by 1 / keep, in training only."""
    _, (_, t_info, _) = both
    for name, kw in (("lightgcn-f32", dict(dropout_rate=0.4)),
                     ("lightgcn-edges", dict(dropout_rate=0.4)),
                     ("ngcf", dict(node_dropout=0.4, message_dropout=0.4))):
        tm = torch_model(name, t_info, **kw)
        tm.build_model()
        seen = []
        plain = tm._keep_mask
        tm._keep_mask = lambda shape, keep: seen.append(plain(shape, keep)) or seen[-1]
        tm._propagate(tm._tree(), True)
        assert seen
        for mask in seen:
            share = 1.0 - float(mask.float().mean())
            assert abs(share - 0.4) <= 5 * np.sqrt(0.24 / mask.numel()), (name, share)
        seen.clear()
        tm.set_embeddings()
        assert not seen


def _optax_steps(params, grads_seq, lr, eps, schedule=None):
    import jax.numpy as jnp
    import optax

    opt = optax.amsgrad(schedule or lr, eps=eps)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for grads in grads_seq:
        upd, state = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, state, p)
        p = optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}


def test_amsgrad_matches_optax():
    """20 steps against ``optax.amsgrad`` at rtol 1e-6, on gradients whose
    scale shrinks tenfold after step 5 (where the running maximum of the
    bias-corrected second moment is what keeps the step small), also under
    the trainer's exponential decay; ``torch.optim.Adam(amsgrad=True)`` lands
    elsewhere."""
    from librecommender_tpu_torch.training.trainer import make_optimizer

    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(30, 4)).astype(np.float32),
              "b": rng.normal(size=7).astype(np.float32)}
    grads_seq = [{k: (rng.normal(size=v.shape) * (1.0 if t < 5 else 0.1)).astype(
        np.float32) for k, v in params.items()} for t in range(20)]

    def run(make):
        tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
        opt, sched = make(list(tp.values()))
        for grads in grads_seq:
            for k, p in tp.items():
                p.grad = torch.from_numpy(grads[k])
            opt.step()
            if sched is not None:
                sched.step()
        return {k: p.detach().numpy() for k, p in tp.items()}

    want = _optax_steps(params, grads_seq, 0.01, 1e-8)
    got = run(lambda ps: (AMSGrad(ps, lr=0.01, eps=1e-8), None))
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
    import optax

    decay = optax.exponential_decay(0.01, transition_steps=3, decay_rate=0.96,
                                    staircase=True)
    want = _optax_steps(params, grads_seq, None, 1e-8, schedule=decay)
    got = run(lambda ps: make_optimizer(ps, 0.01, True, 1e-8, 3, 7, amsgrad=True))
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
    torch_form = run(lambda ps: (torch.optim.Adam(ps, lr=0.01, eps=1e-8,
                                                  amsgrad=True), None))
    assert max(np.abs(torch_form[k] - want[k]).max() for k in params) > 1e-4


def test_model_amsgrad_reaches_the_trainer(both):
    (_, j_info), (t_train, t_info, _) = both
    kw = dict(amsgrad=True, n_epochs=1, sampler="unconsumed")
    tm = torch_model("ngcf", t_info, **kw)
    seen = []
    plain = AMSGrad.step

    def step(self, closure=None):
        seen.append(type(self))
        return plain(self, closure)

    AMSGrad.step = step
    try:
        tm.fit(t_train, neg_sampling=True, verbose=0)
    finally:
        AMSGrad.step = plain
    assert seen and set(seen) == {AMSGrad}
    assert torch_model("ngcf", t_info).amsgrad is False


def _trained_pair(both, name, **kw):
    from librecommender_tpu.utils.save_load import unflatten_tree

    (_, j_info), (_, t_info, _) = both
    jm, init = jax_model(name, j_info, **kw)
    rng = np.random.default_rng(5)
    init = {k: (v + rng.normal(scale=0.1, size=np.shape(v)).astype(np.float32))
            for k, v in as_numpy(init).items()}
    jm.params = unflatten_tree(init)
    jm.post_fit()
    tm = torch_model(name, t_info, init, **kw)
    tm.post_fit()
    return jm, tm, t_info


@pytest.mark.parametrize("name", list(MODELS))
def test_exported_embeddings_and_recommendations_match_jax(both, name):
    jm, tm, info = _trained_pair(both, name)
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm.item_embeds_np, jm.item_embeds_np, rtol=1e-5,
                               atol=1e-6)
    width = 24 if name.startswith("ngcf") else 8   # NGCF concatenates layers
    assert tm.user_embeds_np.shape == (info.n_users + 1, width)
    np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    raw_users = [int(info.id2user[u]) for u in (0, 5, 17, 33)] + [-1]
    for kwargs in ({}, {"filter_consumed": False}, {"cold_start": "popular"}):
        want = jm.recommend_user(raw_users, 9, **kwargs)
        have = tm.recommend_user(raw_users, 9, **kwargs)
        for u in raw_users:
            u_vec = tm.user_embeds_np[info.user2id.get(u, info.n_users)]
            same_recs(have[u], want[u],
                      lambda i: u_vec.astype(np.float64) @ tm.item_embeds_np[
                          info.item2id[i]], (u, kwargs))


@pytest.mark.parametrize("name", ["lightgcn-bf16", "ngcf"])
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_model_loads_in_the_other_package(both, tmp_path, name, saver):
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
    users = np.arange(60) % t_info.n_users
    items = (np.arange(60) * 3) % t_info.n_items
    np.testing.assert_allclose(dst.predict(users, items, inner_id=True),
                               src.predict(users, items, inner_id=True), atol=1e-6)
    raw = [int(t_info.id2user[3]), -1]
    want, have = src.recommend_user(raw, 5), dst.recommend_user(raw, 5)
    for u in raw:
        np.testing.assert_array_equal(have[u], want[u])
    if saver == "torch":
        hyper = json.loads((tmp_path / f"{name}_hyper_params.json").read_text())
        assert "device" not in hyper and hyper["model_class"] == cls
        assert _serve(tmp_path, name, raw[0]) == [int(i) for i in want[raw[0]]]


def test_constructor_contract(both):
    from librecommender_tpu_torch.bases.graph_base import GraphEmbedBase

    _, (_, t_info, _) = both
    for cls in ("LightGCN", "NGCF"):
        model = getattr(tmodels, cls)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                model("ranking", t_info)   # device=None means the GPU
        m = model("ranking", t_info, device="cpu")
        assert "device" not in m.all_args
        assert (m.paradigm, m.epsilon, m.amsgrad) == ("pairwise", 1e-8, False)
        assert model("ranking", t_info, device="cpu",
                     loss_type="cross_entropy").paradigm == "pointwise"
        with pytest.raises(ValueError):
            model("rating", t_info, device="cpu")
        with pytest.raises(ValueError):
            model("ranking", t_info, device="cpu", loss_type="softmax")
    with pytest.raises(ValueError):
        tmodels.LightGCN("ranking", t_info, device="cpu", adj_dtype="f16")

    class ItemToItem(GraphEmbedBase):
        graph_paradigm = "i2i"

    # the item-to-item half is ported (GraphSage, PinSage): the base builds
    i2i = ItemToItem("ranking", t_info, "bpr", 8, device="cpu")
    assert (i2i.graph_paradigm, i2i.paradigm) == ("i2i", "pairwise")


# ----------------------------------------------------------- slow checks
FIT_CASES = {
    "lightgcn-bf16": {},
    "lightgcn-f32": {},
    "lightgcn-edges": {},
    "ngcf": {},
    "ngcf-edges": {},
    "ngcf-amsgrad": dict(amsgrad=True),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", list(FIT_CASES))
def test_two_epoch_fit_matches_jax(both, case):
    import jax

    (j_train, j_info), (t_train, t_info, t_eval) = both
    name = case.replace("-amsgrad", "")
    kw = dict(n_epochs=2, lr=0.001, sampler="unconsumed", num_neg=2,
              **FIT_CASES[case])
    jm, init = jax_model(name, j_info, **kw)
    tm = torch_model(name, t_info, init, **kw)
    jm.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
    tm.fit(t_train, neg_sampling=True, verbose=0, shuffle=False)
    if name.startswith("ngcf"):
        # NGCF's fit spreads float32 rounding (its layers renormalise every
        # step): JAX's own fit from its start moved by 1e-7 lands 1e-5..3e-5
        # away, so each array is held to twice that distance, plus 1e-5
        moved, _ = jax_model(name, j_info, **kw)
        noise = np.random.default_rng(0)
        moved.params = jax.tree.map(
            lambda a: a + 1e-7 * noise.standard_normal(a.shape).astype(a.dtype),
            jax.tree.map(jax.numpy.asarray, init))
        moved.fit(j_train, neg_sampling=True, verbose=0, shuffle=False)
        within_spread(tm.params_to_arrays(), as_numpy(jax.device_get(jm.params)),
                      as_numpy(jax.device_get(moved.params)))
        limit = 2 * np.abs(moved.user_embeds_np - jm.user_embeds_np).max() + 1e-5
        assert np.abs(tm.user_embeds_np - jm.user_embeds_np).max() <= limit
    else:
        same_params(tm.params_to_arrays(), jax.device_get(jm.params))
        np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np,
                                   rtol=1e-4, atol=1e-5)
    assert np.isfinite(tm.trainer.epoch_losses).all()
    res = evaluate(tm, t_eval, neg_sampling=True, metrics=["roc_auc"])
    assert np.isfinite(res["roc_auc"])


# model -> (JAX's AUC on the planted synthetic, PARITY.md), each as
# parity/run_ours.py runs it: embed 32, batch 2048, lr 0.001, 5 epochs
GRAPH_PARITY = {
    "LightGCN": (0.6781, dict(n_layers=3)),             # PARITY.md:32
    "NGCF": (0.7314, dict(loss_type="bpr")),            # PARITY.md:84
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(GRAPH_PARITY))
def test_graph_model_auc_on_planted_synthetic(name):
    from parity.synthetic import chrono_split, make_ml1m_like

    train, evals = chrono_split(make_ml1m_like())
    keep = ["user", "item", "label", "time"]
    train_data, info = DatasetPure.build_trainset(cols(train[keep]))
    eval_data = DatasetPure.build_evalset(cols(evals[keep]))
    want, kw = GRAPH_PARITY[name]
    model = getattr(tmodels, name)("ranking", info, embed_size=32, n_epochs=5,
                                   lr=0.001, batch_size=2048, device="cpu", **kw)
    model.fit(train_data, neg_sampling=True, verbose=1, shuffle=True)
    res = evaluate(model, eval_data, neg_sampling=True, eval_batch_size=8192, k=10,
                   metrics=["roc_auc", "precision", "recall", "ndcg"], seed=2222)
    print(f"port {name} on the planted synthetic: {res}")
    assert want - 0.01 <= res["roc_auc"] <= want + 0.01
