"""UserCF, ItemCF and Swing of the PyTorch port, and the similarity search
they use, against the JAX package on the CPU.

The JAX package computes the neighbour lists in host C++ (its native
library, built by the root ``conftest.py``); the port multiplies blocks of
rows on the device, here the CPU. Tolerances: similarities rtol 1e-5 (atol
1e-6); neighbour ids equal except where the two ids' exact (float64)
similarities lie within 1e-5 relative of each other (the products add in
another order than the C++'s sequential float32 sums); Swing's scores rtol
1e-5 against the native float32 sums, its ids by the same near-tie rule
against the exact float64 scores. From the same neighbour lists (JAX's,
carried across by ``convert.cf_state_from_jax``), ``predict`` agrees within
rtol 1e-6 and ``recommend_user``'s ids are equal: both add each user's
scores in float64 in the same order.
"""
import numpy as np
import pytest
import scipy.sparse as sp

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.convert import cf_state_from_jax
from librecommender_tpu_torch.data import DatasetPure
from librecommender_tpu_torch.ops import swing as tswing
from librecommender_tpu_torch.utils import similarities as tsim

NEAR_TIE = 1e-5
CF_MODELS = {"UserCF": dict(k_sim=10), "ItemCF": dict(k_sim=10),
             "Swing": dict(top_k=10)}


def cols(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def rated_csr(n_rows, n_cols, density, seed):
    """A random CSR of 1..5 ratings, with a row of one entry and an empty
    row (rows 0 and 1)."""
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_cols, density=density, random_state=seed,
                  format="lil", dtype=np.float32)
    m[0, :] = 0
    m[0, 3] = 1
    m[1, :] = 0
    m = m.tocsr()
    m.eliminate_zeros()
    m.data = rng.integers(1, 6, m.nnz).astype(np.float32)
    return m


def exact_sims(x, kind):
    """Float64 similarities of every row pair (the C++'s preprocessing in
    float64)."""
    x = x.tocsr().astype(np.float64)
    if kind == "jaccard":
        b = x.copy()
        b.data[:] = 1.0
        common = (b @ b.T).toarray()
        nnz = np.diff(b.indptr)
        return common / np.maximum(nnz[:, None] + nnz[None, :] - common, 1e-300)
    lengths = np.diff(x.indptr)
    if kind == "pearson":
        means = np.asarray(x.sum(axis=1)).ravel() / np.maximum(lengths, 1)
        x.data = x.data - np.repeat(means, lengths)
    norms = np.sqrt(np.asarray(x.multiply(x).sum(axis=1)).ravel())
    x.data = x.data / np.repeat(np.maximum(norms, 1e-10), lengths)
    return (x @ x.T).toarray()


def assert_ids_near_tie(got, want, exact, what=""):
    """Ids equal, except where both are ids whose exact scores in the row
    lie within NEAR_TIE relative of each other."""
    for r, j in zip(*np.nonzero(got != want)):
        a, b = int(got[r, j]), int(want[r, j])
        assert a >= 0 and b >= 0, f"{what} row {r} slot {j}: {a} vs {b}"
        sa, sb = exact[r, a], exact[r, b]
        assert abs(sa - sb) <= NEAR_TIE * max(abs(sa), abs(sb), 1e-12), (
            f"{what} row {r} slot {j}: {a} ({sa}) vs {b} ({sb})")


# ------------------------------------------------------- similarity search
@pytest.mark.parametrize("kind", tsim.SIM_TYPES)
@pytest.mark.parametrize("min_common", [1, 3])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_topk_similarities_match_native(kind, min_common, dense, monkeypatch):
    """Both k below and above the candidate count; the empty row has no
    neighbours, the single-entry pearson row's 0.0 similarities are kept;
    ``dense=False`` takes the sparse products and many blocks."""
    from librecommender_tpu.native import get_lib
    from librecommender_tpu.utils.similarities import topk_similarities

    assert get_lib() is not None
    x = rated_csr(120, 40, 0.12, seed=1)
    if not dense:
        monkeypatch.setattr(tsim, "SCRATCH_BYTES", 40_000)
    exact = exact_sims(x, kind)
    for k in (5, 150):
        want_ids, want_sims = topk_similarities(x, kind, k, min_common)
        got_ids, got_sims = tsim.topk_similarities(x, kind, k, min_common)
        assert got_ids.dtype == np.int32 and got_sims.dtype == np.float32
        assert_ids_near_tie(got_ids, want_ids, exact, f"{kind} k={k}")
        np.testing.assert_allclose(got_sims, want_sims, rtol=1e-5, atol=1e-6)
        assert (got_ids[1] == -1).all() and (got_sims[1] == 0).all()
        if kind == "pearson" and min_common == 1:
            # row 0's single entry centres to 0: its similarities are 0.0
            n = int((got_ids[0] >= 0).sum())
            assert n > 0 and (got_sims[0, :n] == 0.0).all()


@pytest.mark.parametrize("kind", tsim.SIM_TYPES)
def test_update_topk_after_vocabulary_growth(kind, monkeypatch):
    """Old lists of fewer rows, new rows and new columns, touched old rows
    and untouched ones naming touched rows: the native update's lists."""
    from librecommender_tpu.utils.similarities import (
        topk_similarities,
        update_topk_similarities,
    )

    old = rated_csr(100, 40, 0.1, seed=2)
    new = rated_csr(130, 50, 0.03, seed=3)
    old_pad = old.copy()
    old_pad.resize(130, 50)
    merged = (old_pad + new).tocsr()
    touched = np.unique(new.nonzero()[0])
    exact = exact_sims(merged, kind)
    default = tsim.SCRATCH_BYTES
    for k in (4, 12):
        old_ids, old_sims = topk_similarities(old, kind, k, 1)
        want = update_topk_similarities(old_ids, old_sims, merged, touched,
                                        kind, k, 1)
        for budget in (default, 40_000):
            monkeypatch.setattr(tsim, "SCRATCH_BYTES", budget)
            got = tsim.update_topk_similarities(old_ids, old_sims, merged,
                                                touched, kind, k, 1)
            assert got[0].shape == (130, k)
            assert_ids_near_tie(got[0], want[0], exact, f"{kind} k={k}")
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="k_sim changed"):
        tsim.update_topk_similarities(old_ids, old_sims, merged, touched, kind,
                                      k + 1)


def test_update_copies_unaffected_rows_through():
    """An untouched row with no fresh candidate and no stale entry keeps its
    old list as it was, even where it was not in the search's order."""
    x = rated_csr(30, 12, 0.3, seed=4)
    ids, sims = tsim.topk_similarities(x, "cosine", 3)
    shuffled_ids, shuffled_sims = ids.copy(), sims.copy()
    shuffled_ids[:, [0, 1]] = ids[:, [1, 0]]
    shuffled_sims[:, [0, 1]] = sims[:, [1, 0]]
    got_ids, got_sims = tsim.update_topk_similarities(
        shuffled_ids, shuffled_sims, x, [], "cosine", 3)
    np.testing.assert_array_equal(got_ids, shuffled_ids)
    np.testing.assert_array_equal(got_sims, shuffled_sims)


# ----------------------------------------------------------------- swing
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_swing_plain_matches_native(alpha, monkeypatch):
    from librecommender_tpu.native import swing_topk_native

    x = rated_csr(90, 45, 0.15, seed=5)
    ui = x.copy()
    ui.data[:] = 1.0
    ui.sort_indices()
    iu = ui.T.tocsr()
    iu.sort_indices()
    lists = tswing.interaction_lists(x, "cpu")
    exact = tswing.swing_pairs(lists, 45, alpha).numpy()
    default = tswing.SCRATCH_BYTES
    for k in (5, 60):
        want_ids, want_vals = swing_topk_native(ui, iu, alpha, k)
        for budget in (default, 32 * 45 * 7):
            monkeypatch.setattr(tswing, "SCRATCH_BYTES", budget)
            got_ids, got_vals = tswing.swing_topk(lists, 45, alpha, k)
            assert_ids_near_tie(got_ids, want_ids, exact, f"swing k={k}")
            np.testing.assert_allclose(got_vals, want_vals, rtol=1e-5, atol=1e-7)
    # a row block of the scores is that block of the whole
    np.testing.assert_array_equal(tswing.swing_pairs(lists, 45, alpha, (7, 19)),
                                  exact[7:19])


# ---------------------------------------------------- the models vs JAX
@pytest.fixture()
def both(pure_frames):
    """(JAX train, info, eval), (port train, info, eval)."""
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    train, evals, _ = pure_frames
    j_train, j_info = JDatasetPure.build_trainset(train)
    j_eval = JDatasetPure.build_evalset(evals)
    t_train, t_info = DatasetPure.build_trainset(cols(train))
    return ((j_train, j_info, j_eval),
            (t_train, t_info, DatasetPure.build_evalset(cols(evals))))


def jax_fit(name, train, info, task="ranking", **kw):
    from librecommender_tpu import models as jmodels

    model = getattr(jmodels, name)(task, info, **{**CF_MODELS[name], **kw})
    model.fit(train, neg_sampling=task == "ranking", verbose=0)
    return model


def torch_from_jax(name, jm, info, task="ranking", **kw):
    model = getattr(tmodels, name)(task, info, device="cpu",
                                   **{**CF_MODELS[name], **kw})
    model.set_cf_state(*cf_state_from_jax(jm.sim_ids, jm.sim_vals, jm.interaction))
    model.post_fit()
    return model


def same_recs(got, want):
    assert list(got) == list(want)
    for u in want:
        np.testing.assert_array_equal(np.asarray(got[u]), np.asarray(want[u]),
                                      err_msg=str(u))


CASES = [("UserCF", "ranking", {}), ("UserCF", "rating", dict(sim_type="pearson")),
         ("ItemCF", "ranking", dict(sim_type="jaccard")), ("ItemCF", "rating", {}),
         ("Swing", "ranking", {})]


@pytest.mark.parametrize("name,task,kw", CASES,
                         ids=[f"{n}-{t}" for n, t, _ in CASES])
def test_inference_from_jax_state(both, name, task, kw):
    """predict (known, unknown and unrated pairs) and recommend_user with
    filtering on and off, the can't-filter pass-through (n_rec large), cold
    users and the popular fill (n_rec past the candidates)."""
    (j_train, j_info, _), (t_train, t_info, _) = both
    jm = jax_fit(name, j_train, j_info, task, **kw)
    tm = torch_from_jax(name, jm, t_info, task, **kw)
    rng = np.random.default_rng(0)
    users = np.concatenate([rng.choice(j_info.user_unique_vals, 40), [-7]])
    items = np.concatenate([rng.choice(j_info.item_unique_vals, 40), [-9]])
    np.testing.assert_allclose(tm.predict(users, items), jm.predict(users, items),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.predict(users[:1], items[:1]),
                               jm.predict(users[:1], items[:1]), rtol=1e-6)
    recs_users = list(j_info.user_unique_vals[:12]) + [-3]
    for n_rec, filtered in ((7, True), (7, False), (60, True), (95, True)):
        same_recs(tm.recommend_user(recs_users, n_rec, filter_consumed=filtered),
                  jm.recommend_user(recs_users, n_rec, filter_consumed=filtered))
    same_recs(tm.recommend_user([0, 3, 999], 5, inner_id=True),
              jm.recommend_user([0, 3, 999], 5, inner_id=True))


@pytest.mark.parametrize("name", list(CF_MODELS))
def test_fit_matches_jax(both, name):
    """The port's fit on the CPU: JAX's neighbour lists (ids by the near-tie
    rule, values rtol 1e-5) and default recommendations; evaluate's metrics
    from JAX's lists carried across equal JAX's (1e-6)."""
    from librecommender_tpu.evaluation import evaluate as jevaluate
    from librecommender_tpu_torch.evaluation import evaluate

    (j_train, j_info, j_eval), (t_train, t_info, t_eval) = both
    jm = jax_fit(name, j_train, j_info)
    tm = getattr(tmodels, name)("ranking", t_info, device="cpu", **CF_MODELS[name])
    tm.fit(t_train, neg_sampling=True, verbose=0)
    if name == "Swing":
        lists = tswing.interaction_lists(tm.interaction, "cpu")
        exact = tswing.swing_pairs(lists, t_info.n_items, 1.0).numpy()
    else:
        entity = tm.interaction if name == "UserCF" else tm.interaction.T.tocsr()
        exact = exact_sims(entity, "cosine")
    assert_ids_near_tie(tm.sim_ids, jm.sim_ids, exact, name)
    np.testing.assert_allclose(tm.sim_vals, jm.sim_vals, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tm.default_recs, jm.default_recs)
    metrics = ["roc_auc", "precision", "recall", "ndcg"]
    want = jevaluate(jm, j_eval, neg_sampling=True, metrics=metrics)
    got = evaluate(torch_from_jax(name, jm, t_info), t_eval, neg_sampling=True,
                   metrics=metrics)
    for m in metrics:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-6, err_msg=m)


@pytest.mark.parametrize("name", list(CF_MODELS))
def test_saves_load_both_ways(both, name, tmp_path):
    from librecommender_tpu import models as jmodels

    (j_train, j_info, _), (t_train, t_info, _) = both
    jm = jax_fit(name, j_train, j_info)
    tm = torch_from_jax(name, jm, t_info)
    users = j_info.user_unique_vals[:10]
    items = j_info.item_unique_vals[:10]
    jm.save(tmp_path / "jax", name)
    loaded = getattr(tmodels, name).load(tmp_path / "jax", name, device="cpu")
    np.testing.assert_allclose(loaded.predict(users, items), jm.predict(users, items),
                               rtol=1e-6)
    same_recs(loaded.recommend_user(users, 5), jm.recommend_user(users, 5))
    tm.save(tmp_path / "torch", name)
    back = getattr(jmodels, name).load(tmp_path / "torch", name)
    np.testing.assert_array_equal(back.sim_ids, tm.sim_ids)
    same_recs(tm.recommend_user(users, 5), back.recommend_user(users, 5))
    assert (loaded.interaction != jm.interaction).nnz == 0
    np.testing.assert_array_equal(loaded.sim_ids, jm.sim_ids)


def test_aliases_are_the_cf_and_graph_models():
    from librecommender_tpu.models import aliases as jaliases
    from librecommender_tpu_torch.models import aliases

    for name, base in (("GraphSageDGL", "GraphSage"), ("PinSageDGL", "PinSage"),
                       ("RsUserCF", "UserCF"), ("RsItemCF", "ItemCF")):
        cls = getattr(tmodels, name)
        assert cls is getattr(aliases, name)
        assert issubclass(cls, getattr(tmodels, base))
        assert getattr(jaliases, name).__mro__[1].__name__ == base


def test_rs_user_cf_fits_like_user_cf(both):
    _, (t_train, t_info, _) = both
    fits = []
    for cls in (tmodels.RsUserCF, tmodels.UserCF):
        model = cls("ranking", t_info, k_sim=10, device="cpu")
        model.fit(t_train, neg_sampling=True, verbose=0)
        fits.append(model)
    np.testing.assert_array_equal(fits[0].sim_ids, fits[1].sim_ids)
    np.testing.assert_array_equal(fits[0].sim_vals, fits[1].sim_vals)


def test_cf_models_refuse_unknown_kinds(both):
    _, (_, t_info, _) = both
    with pytest.raises(ValueError, match="unknown sim_type"):
        tmodels.UserCF("ranking", t_info, sim_type="dot", device="cpu")
    with pytest.raises(ValueError, match="only suitable for ranking"):
        tmodels.Swing("rating", t_info, device="cpu")


def test_cf_entry_points_need_a_gpu(both, tmp_path):
    """device=None means the GPU: without one the CF models raise rather
    than search on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    _, (t_train, t_info, _) = both
    for name, kw in CF_MODELS.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tmodels, name)("ranking", t_info, **kw)
    model = tmodels.ItemCF("ranking", t_info, k_sim=5, device="cpu")
    model.fit(t_train, neg_sampling=True, verbose=0)
    model.save(tmp_path, "icf")
    with pytest.raises(RuntimeError):
        tmodels.ItemCF.load(tmp_path, "icf")
