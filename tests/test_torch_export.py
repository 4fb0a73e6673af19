"""The port's AOT serving artifacts (``serving/export_model.py``) against the
JAX package's, on the CPU.

Each of the 13 models the JAX package exports AOT (its zoo's ``AOT_FEAT``
and ``AOT_DYN``) is built in JAX on the ``tests/conftest.py`` frames (embed
8, hidden (16, 8), ``recent_num`` 5; Transformer at ``compute_dtype="f32"``,
as the zoo exports it) with trained-looking parameters (its initialisation
moved by noise; ``-m slow``: after a one-epoch JAX fit), and the port's model
takes JAX's parameters. Both packages save and load their artifacts, and the
loaded scorers are held to each other: ``predict``, ``score_all`` and
``user_embedding`` rtol 1e-5, atol 1e-6; ``recommend`` ids equal but where
two ids' scores lie within 1e-5 relative (near-ties); the params ``.npz``,
the items ``.npz`` and the meta ``.json`` equal key for key. One artifact
takes 1, 2 and 7 users (the symbolic batch). The ``cuda`` test loads on the
card an artifact saved on the CPU and ranks through the streaming top-k.
"""
import json

import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetFeat, DatasetPure
from librecommender_tpu_torch.ops import streaming_topk as st
from librecommender_tpu_torch.serving import (
    load_exported,
    load_exported_dyn,
    save_exported,
)

FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
SMALL = dict(embed_size=8, batch_size=256, seed=3, n_epochs=1)
HIDDEN = dict(hidden_units=(16, 8))
SEQ = dict(recent_num=5)
RTOL, ATOL = 1e-5, 1e-6
NEAR_TIE = 1e-5

# name -> (frame, kwargs beside SMALL)
AOT_FEAT = {
    "FM": ("feat", {}),
    "DeepFM": ("feat", HIDDEN),
    "WideDeep": ("feat", HIDDEN),
    "AutoInt": ("feat", {}),
    "NCF": ("feat", HIDDEN),
    "YouTubeRanking": ("feat", {**HIDDEN, **SEQ}),
    "DIN": ("feat", {**HIDDEN, **SEQ}),
    "Transformer": ("feat", {**HIDDEN, **SEQ, "compute_dtype": "f32"}),
    "SIM": ("feat", {**HIDDEN, **SEQ, "long_max_len": 8, "search_topk": 3}),
}
AOT_DYN = {
    "RNN4Rec": ("pure", SEQ),
    "Caser": ("pure", SEQ),
    "WaveNet": ("pure", {**SEQ, "n_filters": 6}),
    "YouTubeRetrieval": ("feat", {**HIDDEN, **SEQ}),
}
# listwise losses draw their own negatives
NO_NEG = {"YouTubeRetrieval"}


def as_columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def build_both(kind, pure_frames, feat_frames, label=None):
    """(JAX train, JAX info), (port train, port info) of one frame;
    ``label``: replaces the frame's labels (a rating task's)."""
    from librecommender_tpu.data import DatasetFeat as JDatasetFeat
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    train = (pure_frames if kind == "pure" else feat_frames)[0]
    if label is not None:
        train = train.copy()
        train["label"] = label(len(train))
    if kind == "pure":
        return (JDatasetPure.build_trainset(train),
                DatasetPure.build_trainset(as_columns(train)))
    return (JDatasetFeat.build_trainset(train, **FEAT_COLS),
            DatasetFeat.build_trainset(as_columns(train), **FEAT_COLS))


def fitted_pair(name, pure_frames, feat_frames, task="ranking", label=None,
                fit=False):
    """JAX's model and the port's holding its parameters, post-fit. ``fit``:
    JAX's parameters come from a one-epoch fit; otherwise from its
    initialisation moved by N(0, 0.1) noise, so that no bias or table is
    zero (trained-looking, at a fraction of a fit's compile time)."""
    import jax

    from librecommender_tpu import models as jmodels
    from librecommender_tpu.utils.save_load import flatten_tree, unflatten_tree

    kind, kw = {**AOT_FEAT, **AOT_DYN}[name]
    (j_train, j_info), (_, t_info) = build_both(kind, pure_frames, feat_frames,
                                                label)
    jm = getattr(jmodels, name)(task, j_info, **SMALL, **kw)
    if fit:
        jm.fit(j_train, neg_sampling=name not in NO_NEG and task == "ranking",
               verbose=0)
    else:
        jm.build_model()
        rng = np.random.default_rng(5)
        jm.params = jax.tree.map(jax.numpy.asarray, unflatten_tree({
            k: np.asarray(v) + rng.normal(scale=0.1, size=np.shape(v)).astype(
                np.float32)
            for k, v in flatten_tree(jax.device_get(jm.params)).items()}))
    tm = getattr(tmodels, name)(task, t_info, device="cpu", **SMALL, **kw)
    tm.params_from_arrays(jax.device_get(jm.params))
    tm.post_fit()
    return jm, tm, t_info


def assert_ids_near_tie(got, want, scores, what=""):
    """Ids equal, except where the two ids' scores in the row lie within
    NEAR_TIE relative of each other."""
    for r, j in zip(*np.nonzero(got != want)):
        a, b = int(got[r, j]), int(want[r, j])
        sa, sb = float(scores[r, a]), float(scores[r, b])
        assert abs(sa - sb) <= NEAR_TIE * max(abs(sa), abs(sb), 1e-12), (
            f"{what} row {r} slot {j}: {a} ({sa}) vs {b} ({sb})")


def same_files(j_dir, t_dir, name, items=False):
    """The params npz, the meta json (and the items npz) equal key for key."""
    with np.load(j_dir / f"{name}_export_params.npz") as j, \
            np.load(t_dir / f"{name}_export_params.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    j_meta = json.loads((j_dir / f"{name}_export_meta.json").read_text())
    t_meta = json.loads((t_dir / f"{name}_export_meta.json").read_text())
    assert t_meta == j_meta
    if items:
        with np.load(j_dir / f"{name}_export_items.npz") as j, \
                np.load(t_dir / f"{name}_export_items.npz") as t:
            assert sorted(j.files) == sorted(t.files)
            np.testing.assert_array_equal(t["recent_seq"], j["recent_seq"])
            np.testing.assert_allclose(t["item_repr"], j["item_repr"],
                                       rtol=RTOL, atol=ATOL)


def exported_both(jm, tm, tmp_path):
    from librecommender_tpu.serving import load_exported as j_load
    from librecommender_tpu.serving import load_exported_dyn as j_load_dyn
    from librecommender_tpu.serving import save_exported as j_save

    j_dir, t_dir = tmp_path / "jax", tmp_path / "port"
    j_save(j_dir, "m", jm)
    save_exported(t_dir, "m", tm)
    if hasattr(tm, "dyn_user_embedding"):
        return (j_load_dyn(j_dir, "m"), load_exported_dyn(t_dir, "m", device="cpu"),
                j_dir, t_dir)
    return j_load(j_dir, "m"), load_exported(t_dir, "m", device="cpu"), j_dir, t_dir


@pytest.mark.parametrize("name", sorted(AOT_FEAT) + sorted(AOT_DYN))
def test_exported_scorers_match_jax(name, pure_frames, feat_frames, tmp_path):
    hold_scorers(name, pure_frames, feat_frames, tmp_path, fit=False)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(AOT_FEAT) + sorted(AOT_DYN))
def test_exported_scorers_match_jax_after_a_fit(name, pure_frames, feat_frames,
                                                tmp_path):
    hold_scorers(name, pure_frames, feat_frames, tmp_path, fit=True)


def hold_scorers(name, pure_frames, feat_frames, tmp_path, fit):
    jm, tm, info = fitted_pair(name, pure_frames, feat_frames, fit=fit)
    js, ts, j_dir, t_dir = exported_both(jm, tm, tmp_path)
    same_files(j_dir, t_dir, "m", items=name in AOT_DYN)
    assert sorted(p.suffix for p in t_dir.iterdir()) == sorted(
        ".pt2" if p.suffix == ".stablehlo" else p.suffix for p in j_dir.iterdir())
    if name in AOT_FEAT:
        users = np.array([0, 1, 2, 0], np.int32)
        items = np.array([3, 1, 0, 5], np.int32)
        np.testing.assert_allclose(ts.predict(users, items),
                                   js.predict(users, items), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ts.predict(users, items),
                                   tm.predict(users, items, inner_id=True),
                                   rtol=RTOL, atol=ATOL)
        batch = np.array([0, 4, 2], np.int32)
        want = js.score_all(batch)
        np.testing.assert_allclose(ts.score_all(batch), want, rtol=RTOL, atol=ATOL)
        assert_ids_near_tie(ts.recommend(batch, 10), js.recommend(batch, 10),
                            want, name)
        return
    uid = 3
    np.testing.assert_allclose(ts.user_embedding([uid]), js.user_embedding([uid]),
                               rtol=RTOL, atol=ATOL)
    req = tm._convert_seq([1, 2, 3], inner_id=True)[None, :]
    reqs = np.concatenate([req, req]).astype(np.int32)
    np.testing.assert_allclose(ts.user_embedding([uid, 0], reqs),
                               js.user_embedding([uid, 0], reqs),
                               rtol=RTOL, atol=ATOL)
    want = tm.dyn_user_embedding(uid, inner_id=True)
    np.testing.assert_allclose(ts.user_embedding([uid])[0, : want.shape[0]],
                               want, rtol=RTOL, atol=ATOL)
    batch = [uid, 0, 7]
    want = js.score_all(batch)
    np.testing.assert_allclose(ts.score_all(batch), want, rtol=RTOL, atol=ATOL)
    assert_ids_near_tie(ts.recommend(batch, 10), js.recommend(batch, 10), want,
                        name)


def numpy_columns(n_rows=2400, n_users=60, n_items=100, seed=0):
    """Columns like ``tests/conftest.py``'s feature frame, from numpy alone
    (the card's machine has neither pandas nor jax)."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, n_users, n_rows) + 1000,
                                rng.integers(0, n_items, n_rows) + 5000], 1),
                      axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    return {"user": users, "item": items, "label": np.ones(len(users)),
            "sex": np.array(["m", "f"])[users % 2],
            "age": ((users % 50) - 25.0) / 25.0,
            "genre": np.array(["a", "b", "c", "d"])[items % 4]}


def port_model(name, pure_frames=None, feat_frames=None, device="cpu"):
    """The port's model alone, from its own seeded initialisation, on the
    conftest frames, or (without them) on ``numpy_columns``."""
    kind, kw = {**AOT_FEAT, **AOT_DYN}[name]
    if pure_frames is None:
        cols = numpy_columns()
        if kind == "pure":
            cols = {k: cols[k] for k in ("user", "item", "label")}
    else:
        cols = as_columns((pure_frames if kind == "pure" else feat_frames)[0])
    if kind == "pure":
        _, info = DatasetPure.build_trainset(cols)
    else:
        _, info = DatasetFeat.build_trainset(cols, **FEAT_COLS)
    model = getattr(tmodels, name)("ranking", info, device=device, **SMALL, **kw)
    model.build_model()
    model.post_fit()
    return model


def test_items_without_histories_use_padding(pure_frames, feat_frames,
                                             tmp_path):
    """An items ``.npz`` without ``recent_seq`` loads in both packages, and
    their user vectors (every history padding) agree."""
    jm, tm, _ = fitted_pair("RNN4Rec", pure_frames, feat_frames)
    _, _, j_dir, t_dir = exported_both(jm, tm, tmp_path)
    for d in (j_dir, t_dir):
        with np.load(d / "m_export_items.npz") as data:
            item_repr = data["item_repr"]
        np.savez(d / "m_export_items.npz", item_repr=item_repr)
    from librecommender_tpu.serving import load_exported_dyn as j_load_dyn

    js, ts = j_load_dyn(j_dir, "m"), load_exported_dyn(t_dir, "m", device="cpu")
    assert ts.recent_seq is None
    users = np.array([3, 0, 7], np.int32)
    pad = np.full((3, ts.meta["max_seq_len"]), ts.meta["pad_id"], np.int32)
    got = ts.user_embedding(users)
    np.testing.assert_allclose(got, js.user_embedding(users), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, ts.user_embedding(users, pad))
    assert_ids_near_tie(ts.recommend(users, 10), js.recommend(users, 10),
                        js.score_all(users), "RNN4Rec")


@pytest.mark.parametrize("name", ["DeepFM", "DIN", "RNN4Rec"])
def test_symbolic_batch(name, pure_frames, feat_frames, tmp_path):
    """1, 2 and 7 users through one artifact, each equal to the model's own
    scores."""
    tm = port_model(name, pure_frames, feat_frames)
    save_exported(tmp_path, "m", tm)
    dyn = name in AOT_DYN
    scorer = (load_exported_dyn if dyn else load_exported)(tmp_path, "m",
                                                           device="cpu")
    for n in (1, 2, 7):
        users = np.arange(n, dtype=np.int32) * 3
        if dyn:
            want = np.stack([tm.dyn_user_embedding(int(u), inner_id=True)
                             for u in users])
            got = scorer.user_embedding(users)[:, : want.shape[1]]
        else:
            want = tm._score_users(users).numpy()
            got = scorer.score_all(users)
            np.testing.assert_allclose(
                scorer.predict(users, users + 1),
                tm.predict(users, users + 1, inner_id=True).reshape(-1),
                rtol=RTOL, atol=ATOL)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_exported_rating_clip(pure_frames, feat_frames, tmp_path):
    """The rating task's artifact clips to the meta's bounds, as JAX's."""
    rng = np.random.default_rng(0)
    jm, tm, _ = fitted_pair(
        "DeepFM", pure_frames, feat_frames, task="rating",
        label=lambda n: rng.integers(1, 6, n).astype(np.float64))
    js, ts, j_dir, t_dir = exported_both(jm, tm, tmp_path)
    same_files(j_dir, t_dir, "m")
    assert ts.meta["lower_bound"] == 1.0 and ts.meta["upper_bound"] == 5.0
    users, items = np.arange(12) % 7, np.arange(12)
    got = ts.predict(users, items)
    assert (got >= ts.meta["lower_bound"]).all()
    assert (got <= ts.meta["upper_bound"]).all()
    np.testing.assert_allclose(got, js.predict(users, items), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, tm.predict(users, items, inner_id=True),
                               rtol=RTOL, atol=ATOL)


def test_load_exported_refuses_cpu_fallback(pure_frames, feat_frames, tmp_path):
    """``device=None`` means the card: without one, loading raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    save_exported(tmp_path, "m", port_model("DeepFM", pure_frames, feat_frames))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_exported(tmp_path, "m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_exported_dyn(tmp_path, "m")
    assert load_exported(tmp_path, "m", device="cpu").devices() == {
        torch.device("cpu")}


@pytest.mark.cuda
def test_artifacts_saved_on_cpu_score_on_the_card(tmp_path):
    """An artifact saved from a CPU model loads onto the card, every tensor
    there; its user vectors equal the CPU scorer's and the card model's
    (Caser's convolutions held to float32 as the model holds them); its
    recommend is one launch of the streaming top-k."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    tm = port_model("Caser")
    save_exported(tmp_path, "m", tm)
    card = load_exported_dyn(tmp_path, "m")
    cpu = load_exported_dyn(tmp_path, "m", device="cpu")
    assert {d.type for d in card.devices()} == {"cuda"}
    users = np.array([0, 3, 5], np.int32)
    np.testing.assert_allclose(card.user_embedding(users), cpu.user_embedding(users),
                               rtol=1e-5, atol=1e-6)
    on_card = tmodels.Caser("ranking", tm.data_info, device="cuda", **SMALL,
                            **AOT_DYN["Caser"][1])
    on_card.params_from_arrays(tm.params_to_arrays())
    ut = torch.as_tensor(users, device="cuda").long()
    with torch.no_grad():
        want = on_card._embed_users(ut, on_card.recent_seq_table[ut])
    np.testing.assert_allclose(card.user_embedding(users)[:, : want.shape[1]],
                               want.cpu().numpy(), rtol=1e-5, atol=1e-6)
    st.reset_launches()
    card.recommend(users, 10)
    torch.cuda.synchronize()
    assert st.launches == 1
