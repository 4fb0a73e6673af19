"""``init_ann``, ``init_knn`` and ``search_knn_users`` / ``search_knn_items``
of the port's embedding models against the JAX package's on the CPU.

BPR, ALS and RNN4Rec (``tests/test_knn_embed_reference.py``'s models) get
JAX's parameters, perturbed so that they look trained; the port's exported
tables must match JAX's (rtol 1e-5, atol 1e-6), and then hold JAX's exact
bytes, so that both packages index the same vectors. Held exactly: the HNSW
graphs (byte-equal) and every id they return, and ``recommend_user``
through JAX's IVF index loaded in the port, consumed filter and popular fill
included, but where two candidates' scores lie within 1e-5 relative. Exact
knn (on the device through the streaming top-k in the port, a numpy argsort
in JAX): ids equal but near-ties.
"""
import numpy as np
import pytest

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetPure
from librecommender_tpu_torch.retrieval import IVFIndex

NEAR_TIE = 1e-5
MODELS = ("BPR", "ALS", "RNN4Rec")


def cols(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


@pytest.fixture(scope="module")
def infos(pure_frames):
    from librecommender_tpu.data import DatasetPure as JDatasetPure

    train = pure_frames[0]
    return (JDatasetPure.build_trainset(train)[1],
            DatasetPure.build_trainset(cols(train))[1])


@pytest.fixture(scope="module", params=MODELS)
def pair(request, infos):
    """(JAX model, port model, port DataInfo), post-fit on the same
    parameters, the port's tables replaced by JAX's bytes."""
    from librecommender_tpu import models as jmodels
    from librecommender_tpu.utils.save_load import unflatten_tree
    from librecommender_tpu_torch.utils.save_load import flatten_tree

    j_info, t_info = infos
    name = request.param
    jm = getattr(jmodels, name)("ranking", j_info, embed_size=16, seed=3)
    jm.build_model()
    rng = np.random.default_rng(5)
    init = {k: (np.asarray(v) + rng.normal(scale=0.1, size=np.shape(v))).astype(np.float32)
            for k, v in flatten_tree(jm.params).items()}
    jm.params = unflatten_tree(init)
    jm.post_fit()
    tm = getattr(tmodels, name)("ranking", t_info, embed_size=16, seed=3,
                                device="cpu")
    tm.params_from_arrays(init)
    tm.post_fit()
    np.testing.assert_allclose(tm.user_embeds_np, jm.user_embeds_np,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.item_embeds_np, jm.item_embeds_np,
                               rtol=1e-5, atol=1e-6)
    tm._set_exported(np.array(jm.user_embeds_np), np.array(jm.item_embeds_np))
    return jm, tm, t_info


@pytest.fixture(autouse=True)
def _drop_index(request):
    """Each test starts from models without an approximate index."""
    yield
    if "pair" in request.fixturenames:
        jm, tm, _ = request.getfixturevalue("pair")
        jm.ann = tm.ann = None


def raw_users(info):
    return [int(info.id2user[u]) for u in range(info.n_users)] + [-1]


def some_items(info):
    return [int(info.id2item[i]) for i in range(0, info.n_items, 7)]


def same_recs(have, want, score, what):
    """Equal id lists, but where the two ids' scores (``score``: id ->
    float64) lie within NEAR_TIE relative."""
    have, want = list(have), list(want)
    assert len(have) == len(want), what
    for i, (a, b) in enumerate(zip(have, want)):
        if a != b:
            sa, sb = score(a), score(b)
            assert abs(sa - sb) <= NEAR_TIE * max(abs(sa), abs(sb)), (what, i, a, b)


def hnsw_bytes(index):
    import ctypes

    buf = ctypes.create_string_buffer(index._lib.hnsw_blob_size(index._handle))
    index._lib.hnsw_serialize(index._handle, buf)
    return buf.raw


def test_init_ann_hnsw_equals_jax(pair):
    jm, tm, info = pair
    jm.init_ann(index="hnsw", M=8, ef_construction=64, ef_search=50)
    tm.init_ann(index="hnsw", M=8, ef_construction=64, ef_search=50)
    assert tm.ann.blob() == hnsw_bytes(jm.ann)
    users = raw_users(info)
    for kwargs in ({}, {"filter_consumed": False}):
        want = jm.recommend_user(users, 10, **kwargs)
        have = tm.recommend_user(users, 10, **kwargs)
        for u in users:
            np.testing.assert_array_equal(have[u], want[u], err_msg=str((u, kwargs)))


@pytest.mark.parametrize("sim_type", ["cosine", "inner-product"])
def test_init_knn_approximate_equals_jax(pair, sim_type):
    jm, tm, info = pair
    jm.init_knn(approximate=True, sim_type=sim_type, M=12, ef_construction=64)
    tm.init_knn(approximate=True, sim_type=sim_type, M=12, ef_construction=64)
    for side in ("user", "item"):
        assert tm._knn_indexes[side].blob() == hnsw_bytes(jm._knn_indexes[side])
    for user in raw_users(info)[:-1:5]:
        assert tm.search_knn_users(user, 10) == jm.search_knn_users(user, 10)
    for item in some_items(info):
        assert tm.search_knn_items(item, 10) == jm.search_knn_items(item, 10)
    assert tm.search_knn_users(-1, 10) is None and tm.search_knn_items(-1, 3) is None


@pytest.mark.parametrize("sim_type", ["cosine", "inner-product", None])
def test_exact_knn_equals_jax_but_near_ties(pair, sim_type):
    """``None``: a model that never called ``init_knn`` (exact inner
    product over the factors)."""
    jm, tm, info = pair
    if sim_type is None:
        for m in (jm, tm):
            for attr in ("sim_type", "include_bias", "knn_approximate"):
                m.__dict__.pop(attr, None)
    else:
        jm.init_knn(approximate=False, sim_type=sim_type)
        tm.init_knn(approximate=False, sim_type=sim_type)
    for side, ids, search_t, search_j, to_inner in (
        ("user", raw_users(info)[:-1:4], tm.search_knn_users, jm.search_knn_users,
         info.user2id),
        ("item", some_items(info), tm.search_knn_items, jm.search_knn_items,
         info.item2id),
    ):
        base = tm._knn_space(side).astype(np.float64)
        for raw in ids:
            q = base[to_inner[raw]]
            back = info.id2user if side == "user" else info.id2item
            inner = {v: k for k, v in back.items()}

            def score(r, q=q, inner=inner):
                return float(base[inner[r]] @ q)

            same_recs(search_t(raw, 10), search_j(raw, 10), score, (side, raw))


def test_ivf_recommend_through_jax_index_equals_jax(pair, tmp_path):
    """JAX's IVF index, saved and loaded in the port as ``model.ann``: the
    same lists for every user and a cold one, with and without the consumed
    filter; some users fetch past the probed lists and reach the popular
    fill."""
    jm, tm, info = pair
    jm.init_ann(index="ivf", n_clusters=10, n_probe=1)
    jm.ann.save(tmp_path)
    tm.ann = IVFIndex.load(tmp_path, device="cpu")
    tm._ann_search_kw = {"n_probe": 1}
    users = raw_users(info)
    for kwargs in ({}, {"filter_consumed": False}):
        want = jm.recommend_user(users, 10, **kwargs)
        have = tm.recommend_user(users, 10, **kwargs)
        for u in users:
            u_vec = tm.user_embeds_np[info.user2id.get(u, info.n_users)].astype(np.float64)

            def score(item, u_vec=u_vec):
                return float(u_vec @ tm.item_embeds_np[info.item2id[item]])

            same_recs(have[u], want[u], score, (u, kwargs))
    # the popular fill ran: fewer than 10 unconsumed candidates for a user
    uids = np.arange(info.n_users)
    fetch = 10 + max(len(info.user_consumed[int(u)]) for u in uids)
    ids, _ = tm.ann.search(tm.user_embeds_np[uids], fetch, n_probe=1)
    short = sum(len(set(ids[u][ids[u] >= 0]) - set(info.user_consumed[u])) < 10
                for u in uids)
    assert short > 0


def test_port_ivf_overlaps_exact_and_filters_consumed(pair):
    """The port's own IVF build, probing every cluster: near-exact lists,
    no consumed item."""
    _, tm, info = pair
    user = int(info.id2user[0])
    exact = tm.recommend_user(user, 10)[user]
    tm.init_ann(index="ivf", n_clusters=8, n_probe=8)
    approx = tm.recommend_user(user, 10)[user]
    assert len(set(map(int, exact)) & set(map(int, approx))) >= 8
    consumed = set(info.user_consumed[0])
    assert not ({info.item2id[i] for i in approx} & consumed)
