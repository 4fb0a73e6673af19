"""The port's native C++ server (``serving/native_server``) on the CPU.

Small models are fitted by the JAX package (BPR, ItemCF, RNN4Rec, DIN,
TwoTower, FM) on the ``tests/conftest.py`` frames, saved, and loaded by the
port, so that both hold the same parameters. The port's ``export_native``
writes the artifacts from the port's model, the port's server (built from
``librecommender_tpu_torch/csrc/``) serves them, and every list is held to
the JAX model's ``recommend_user``: the checks of the JAX package's
``tests/serving/test_native_server.py`` and of its interpreter-built static
table (``tests/serving/test_native_runtime.py``), plus the backend hop to
the port's HTTP app and ``export_native``'s files against the JAX
package's.

Lists are equal, but where two items' float64 scores lie within 1e-5
relative (``NEAR_TIE``; the server sums float32 products in its own order);
knn lists are the JAX model's, less the items it scores 0 (the server drops
them). The JAX package's server binary is not started here: its build
writes the binary in place, where another test process may be building it.
"""
import concurrent.futures
import http.client
import json
import os
import subprocess
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.serving import native_server as tns

NEAR_TIE = 1e-5
SMALL = dict(embed_size=8, n_epochs=1, batch_size=256)
FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
# name -> (dataset, kwargs, neg_sampling), as the JAX package's tests fit them
MODELS = {
    "BPR": ("pure", SMALL, True),
    "ItemCF": ("pure", dict(k_sim=10), True),
    "RNN4Rec": ("pure", SMALL, True),
    "DIN": ("feat", dict(SMALL, recent_num=5), True),
    "TwoTower": ("feat", dict(SMALL, loss_type="softmax", hidden_units=(16,)), False),
    "FM": ("feat", SMALL, True),
}


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def fitted(pure_frames, feat_frames, tmp_path_factory):
    """name -> (JAX model, the port's model loaded from JAX's save)."""
    from librecommender_tpu import models as jmodels
    from librecommender_tpu.data import DatasetFeat, DatasetPure

    data = {"pure": DatasetPure.build_trainset(pure_frames[0]),
            "feat": DatasetFeat.build_trainset(feat_frames[0], **FEAT_COLS)}
    root = tmp_path_factory.mktemp("fitted")
    out = {}
    for name, (kind, kw, neg) in MODELS.items():
        train, info = data[kind]
        jm = getattr(jmodels, name)("ranking", info, **kw)
        jm.fit(train, neg_sampling=neg, verbose=0)
        jm.save(root / name, name)
        out[name] = (jm, getattr(tmodels, name).load(root / name, name, device="cpu"))
    return out


@pytest.fixture(scope="module")
def exported(fitted, tmp_path_factory):
    """name -> the port's artifact directory of the port's model."""
    root = tmp_path_factory.mktemp("native")
    out = {}
    for name in ("BPR", "ItemCF", "RNN4Rec", "DIN", "TwoTower", "FM"):
        out[name] = tns.export_native(root / name, fitted[name][1])
    out["DIN_tiled"] = tns.export_native(root / "DIN_tiled", fitted["DIN"][1],
                                         tile_size=16)
    return out


@contextmanager
def native(artifact_dir, **kw):
    proc, port = tns.start_native_server(artifact_dir, **kw)
    try:
        yield port
    finally:
        proc.kill()
        proc.wait()


def _post(port, url, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{url}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return [int(i) for i in json.loads(resp.read())["rec_list"]]


def _want(jm, user, n_rec, **kw):
    return [int(i) for i in jm.recommend_user(user=user, n_rec=n_rec, **kw)[user]]


def assert_near(got, want, scores, item2id, what=""):
    """Equal lists but where both items' float64 ``scores`` (by inner id)
    lie within NEAR_TIE relative."""
    assert len(got) == len(want), (what, got, want)
    for pos, (a, b) in enumerate(zip(got, want)):
        if a != b:
            sa, sb = scores[item2id[a]], scores[item2id[b]]
            assert abs(sa - sb) <= NEAR_TIE * max(abs(sa), abs(sb), 1e-12), (
                what, pos, a, b, sa, sb)


def _embed_scores(jm, uid):
    users = np.asarray(jm.user_embeds_np, np.float64)
    items = np.asarray(jm.item_embeds_np, np.float64)[: jm.n_items]
    return items @ users[uid if uid is not None else -1]


def _consumed_raw(info, user):
    return {int(info.id2item[i]) for i in info.user_consumed[info.user2id[user]]}


# ------------------------------------------------------------------ families
def test_embed_server(fitted, exported, pure_frames):
    jm, _ = fitted["BPR"]
    info = jm.data_info
    user = int(pure_frames[0].user.iloc[0])
    scores = _embed_scores(jm, info.user2id[user])
    with native(exported["BPR"]) as port:
        assert_near(_post(port, "/embed/recommend", {"user": user, "n_rec": 5}),
                    _want(jm, user, 5), scores, info.item2id)
        # a cold user takes the OOV row
        cold = _post(port, "/embed/recommend", {"user": -9999, "n_rec": 5})
        assert_near(cold, [int(i) for i in jm.recommend_user(-9999, 5)[-9999]],
                    _embed_scores(jm, None), info.item2id, "cold")
        # n_rec + |consumed| > n_items: the reference's can't-filter
        # passthrough (an unfiltered top-k)
        deep = info.n_items - 3
        got = _post(port, "/embed/recommend", {"user": user, "n_rec": deep})
        assert_near(got, _want(jm, user, deep), scores, info.item2id, "deep")
        assert set(got) & _consumed_raw(info, user)


def test_knn_server(fitted, exported, pure_frames):
    """Item-based CF: the JAX model's list less the items it scores 0; no
    consumed item; the deep request's passthrough puts consumed items in
    the front half."""
    jm, _ = fitted["ItemCF"]
    info = jm.data_info
    user = int(pure_frames[0].user.iloc[0])
    uid = info.user2id[user]
    scores = np.zeros(info.n_items)
    for c in info.user_consumed[uid]:
        for nbr, sim in zip(jm.sim_ids[c], jm.sim_vals[c]):
            if nbr >= 0:
                scores[nbr] += float(sim)
    with native(exported["ItemCF"]) as port:
        got = _post(port, "/knn/recommend", {"user": user, "n_rec": 5})
        want = [i for i in _want(jm, user, 5) if scores[info.item2id[i]] != 0]
        assert 0 < len(got)
        assert_near(got, want, scores, info.item2id)
        assert not set(got) & _consumed_raw(info, user)
        deep = info.n_items - 3
        got = _post(port, "/knn/recommend", {"user": user, "n_rec": deep})
        assert set(got[: deep // 2]) & _consumed_raw(info, user)


def test_model_and_online_endpoints(fitted, exported, pure_frames):
    """RNN4Rec's programs run in the server (no backend): /model and
    /online with a request seq equal the JAX model's lists; no consumed
    item; a cold user with a seq serves."""
    jm, _ = fitted["RNN4Rec"]
    info = jm.data_info
    frame = pure_frames[0]
    user = int(frame.user.iloc[0])
    seq = [int(i) for i in frame.item.iloc[:5]]
    with native(exported["RNN4Rec"]) as port:
        got = _post(port, "/model/recommend", {"user": user, "n_rec": 5})
        assert got == _want(jm, user, 5)
        assert not set(got) & _consumed_raw(info, user)
        got = _post(port, "/online/recommend", {"user": user, "n_rec": 5, "seq": seq})
        assert got == _want(jm, user, 5, seq=seq)
        cold = _post(port, "/online/recommend", {"user": -4242, "n_rec": 5, "seq": seq})
        assert len(cold) == 5


@pytest.mark.parametrize("artifact,n_rec", [("DIN", 5), ("DIN_tiled", 7)])
def test_feat_model_and_online(fitted, exported, feat_frames, artifact, n_rec):
    """DIN's /model (the static table, or with ``tile_size=16`` the tiles'
    live scoring) and /online with request seq and features, or features
    alone, assembled in C++, equal the JAX model's lists; so does a deep
    request's passthrough."""
    jm, _ = fitted["DIN"]
    info = jm.data_info
    frame = feat_frames[0]
    user = int(frame.user.iloc[0])
    seq = [int(i) for i in frame.item.iloc[:4]]
    feats = {"sex": str(frame.sex.iloc[1]), "age": 0.25}
    if artifact == "DIN_tiled":
        meta = json.loads((exported[artifact] / "runtime_meta.json").read_text())
        assert meta["tile"] == 16 and info.n_items > 16
    with native(exported[artifact]) as port:
        assert _post(port, "/model/recommend",
                     {"user": user, "n_rec": n_rec}) == _want(jm, user, n_rec)
        assert _post(port, "/online/recommend", {
            "user": user, "n_rec": n_rec, "seq": seq, "user_feats": feats,
        }) == _want(jm, user, n_rec, seq=seq, user_feats=feats)
        assert _post(port, "/online/recommend", {
            "user": user, "n_rec": n_rec, "user_feats": feats,
        }) == _want(jm, user, n_rec, user_feats=feats)
        deep = info.n_items - 3
        assert _post(port, "/model/recommend",
                     {"user": user, "n_rec": deep}) == _want(jm, user, deep)


def test_dyn_request_coalescing(fitted, exported, pure_frames):
    """Concurrent /online requests coalesce into batched tower runs
    (``user_repr_b``); each answer is its own request's."""
    jm, _ = fitted["RNN4Rec"]
    assert (exported["RNN4Rec"] / "user_repr_b.program.json").exists()
    frame = pure_frames[0]
    users = [int(u) for u in frame.user.unique()[:12]]
    seqs = {u: [int(i) for i in frame.item.iloc[k: k + 4]]
            for k, u in enumerate(users)}
    want = {u: _want(jm, u, 5, seq=seqs[u]) for u in users}
    with native(exported["RNN4Rec"]) as port:
        def hit(u):
            return u, _post(port, "/online/recommend",
                            {"user": u, "n_rec": 5, "seq": seqs[u]})

        with concurrent.futures.ThreadPoolExecutor(max_workers=12) as pool:
            for u, got in pool.map(hit, users * 4):
                assert got == want[u], u


def test_two_tower_online_features(fitted, exported, feat_frames):
    jm, _ = fitted["TwoTower"]
    frame = feat_frames[0]
    user = int(frame.user.iloc[0])
    feats = {"sex": str(frame.sex.iloc[1]), "age": 0.75}
    with native(exported["TwoTower"]) as port:
        assert _post(port, "/online/recommend", {
            "user": user, "n_rec": 5, "user_feats": feats,
        }) == _want(jm, user, 5, user_feats=feats)
        # without overrides the tower gives the static list
        assert _post(port, "/online/recommend",
                     {"user": user, "n_rec": 5}) == _want(jm, user, 5)


def test_fm_online_without_seq(fitted, exported, feat_frames):
    jm, _ = fitted["FM"]
    user = int(feat_frames[0].user.iloc[0])
    feats = {"sex": str(feat_frames[0].sex.iloc[1])}
    with native(exported["FM"]) as port:
        assert _post(port, "/online/recommend", {
            "user": user, "n_rec": 5, "user_feats": feats,
        }) == _want(jm, user, 5, user_feats=feats)


def test_online_hardening(fitted, exported, feat_frames):
    """Unknown feature names, wrong-typed values, an oversized seq with
    unknown items and a garbage user neither crash the server nor change
    what it gives for the rest."""
    jm, _ = fitted["DIN"]
    frame = feat_frames[0]
    user = int(frame.user.iloc[0])
    with native(exported["DIN"]) as port:
        got = _post(port, "/online/recommend", {
            "user": user, "n_rec": 5,
            "user_feats": {"no_such_col": 1, "sex": 123456, "age": "not-a-number"}})
        assert len(got) == 5
        seq = [int(i) for i in frame.item.iloc[:40]] + [999999] * 10
        assert _post(port, "/online/recommend", {
            "user": user, "n_rec": 5, "seq": seq}) == _want(jm, user, 5, seq=seq)
        assert len(_post(port, "/online/recommend", {
            "user": "not-a-user", "n_rec": 5, "user_feats": []})) == 5
        assert len(_post(port, "/model/recommend", {"user": user, "n_rec": 3})) == 3


# ------------------------------------------------------------ the transport
def test_benchmark_client(fitted, exported):
    """The C++ load generator: keep-alive requests, no failure."""
    info = fitted["BPR"][0].data_info
    with native(exported["BPR"]) as port:
        out = subprocess.run(
            [str(tns.build_benchmark()), "127.0.0.1", str(port), "/embed/recommend",
             "2", "300", str(info.n_users)],
            capture_output=True, text=True, timeout=60)
        stats = json.loads(out.stdout)
        assert stats["n_fail"] == 0 and stats["n_ok"] >= 299
        assert stats["req_per_s"] > 100


def test_keepalive_then_close(exported):
    with native(exported["BPR"]) as port:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        for _ in range(2):
            conn.request("POST", "/embed/recommend",
                         body=json.dumps({"user": 1, "n_rec": 3}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.headers["Connection"] == "keep-alive"
            assert len(json.loads(resp.read())["rec_list"]) == 3
        conn.request("POST", "/embed/recommend",
                     body=json.dumps({"user": 1, "n_rec": 3}),
                     headers={"Content-Type": "application/json",
                              "Connection": "close"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.headers["Connection"] == "close"
        conn.close()


def test_embed_ivf(fitted, pure_frames, tmp_path):
    """``ivf=True`` writes the port's own index (the same build from the
    model's seed); the IVF-probed /embed equals its ``search`` with
    consumed items filtered."""
    from librecommender_tpu_torch.retrieval.ivf import IVFIndex

    jm, pm = fitted["BPR"]
    info = pm.data_info
    path = tns.export_native(tmp_path / "ivf", pm, ivf=True, n_probe=4,
                             programs=False, device="cpu")
    index = IVFIndex.build(pm.item_embeds_np[: pm.n_items], seed=pm.seed,
                           device="cpu")
    shape = np.fromfile(path / "ivf_centroids_shape.bin", np.int64)
    np.testing.assert_array_equal(
        np.fromfile(path / "ivf_centroids.bin", np.float32).reshape(shape),
        index.centroids.numpy())
    shape = np.fromfile(path / "ivf_lists_shape.bin", np.int64)
    np.testing.assert_array_equal(
        np.fromfile(path / "ivf_lists.bin", np.int32).reshape(shape),
        index.lists.numpy())
    assert json.loads((path / "native_meta.json").read_text())["ivf_n_probe"] == 4
    users = [int(u) for u in pure_frames[0].user.unique()[:6]]
    with native(path) as port:
        for user in users:
            uid = info.user2id[user]
            consumed = set(map(int, info.user_consumed[uid]))
            ids, _ = index.search(pm.user_embeds_np[uid][None], 5 + len(consumed),
                                  n_probe=4)
            want = [int(info.id2item[i]) for i in ids[0]
                    if i >= 0 and int(i) not in consumed][:5]
            assert_near(_post(port, "/embed/recommend", {"user": user, "n_rec": 5}),
                        want, _embed_scores(jm, uid), info.item2id, user)


def test_backend_hop_to_the_port_app(fitted, tmp_path, pure_frames):
    """Artifacts without programs: /model and /online go to the port's HTTP
    app's /candidates (``backend=``) and equal the JAX model's lists."""
    import threading

    from librecommender_tpu_torch import serving

    jm, pm = fitted["RNN4Rec"]
    path = tns.export_native(tmp_path / "hop", pm, programs=False)
    store = serving.DictStore()
    serving.online2store(serving.save_online(tmp_path / "online", pm), store)
    app, app_port = serving.create_server("online", store, port=0, device="cpu")
    thread = threading.Thread(target=app.serve_forever, daemon=True)
    thread.start()
    frame = pure_frames[0]
    user = int(frame.user.iloc[0])
    seq = [int(i) for i in frame.item.iloc[:5]]
    try:
        with native(path, backend=("127.0.0.1", app_port)) as port:
            assert _post(port, "/model/recommend",
                         {"user": user, "n_rec": 5}) == _want(jm, user, 5)
            assert _post(port, "/online/recommend", {
                "user": user, "n_rec": 5, "seq": seq}) == _want(jm, user, 5, seq=seq)
    finally:
        app.shutdown()
        app.server_close()
        thread.join(timeout=10)


# --------------------------------------------------------------- the export
JAX_FILES = {
    # name -> files whose arrays the port recomputes in float32 from the
    # carried parameters (the recurrent forward), held at rtol 1e-5
    "BPR": (), "ItemCF": (), "DIN": (), "RNN4Rec": ("user_embed.bin", "item_embed.bin"),
}


@pytest.mark.parametrize("name", sorted(JAX_FILES))
def test_export_writes_the_jax_files(fitted, tmp_path, name):
    """``export_native``'s files (programs aside) are the JAX package's, byte
    for byte."""
    from librecommender_tpu.serving.native_server import export_native as jax_export

    jm, pm = fitted[name]
    j_dir = jax_export(tmp_path / "jax", jm, programs=False)
    t_dir = tns.export_native(tmp_path / "port", pm, programs=False)
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    for f in sorted(os.listdir(j_dir)):
        a, b = (j_dir / f).read_bytes(), (t_dir / f).read_bytes()
        if f in JAX_FILES[name]:
            np.testing.assert_allclose(np.frombuffer(b, np.float32),
                                       np.frombuffer(a, np.float32),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        else:
            assert a == b, f


def test_topk_via_interpreter(fitted, tmp_path):
    """The /model static table rebuilt through the server's interpreter
    (``--build-topk``) equals the port model's own build, but where two
    items' scores lie within NEAR_TIE relative."""
    _, pm = fitted["DIN"]
    p_torch = tns.export_native(tmp_path / "torch", pm)
    p_int = tns.export_native(tmp_path / "interp", pm, topk_via_interpreter=True)
    shape = np.fromfile(p_torch / "static_topk_shape.bin", np.int64)
    np.testing.assert_array_equal(
        shape, np.fromfile(p_int / "static_topk_shape.bin", np.int64))
    got = np.fromfile(p_int / "static_topk.bin", np.int32).reshape(shape)
    want = np.fromfile(p_torch / "static_topk.bin", np.int32).reshape(shape)
    scores = pm._score_users(np.arange(shape[0])).double().numpy()
    for r, j in zip(*np.nonzero(got != want)):
        a, b = scores[r, got[r, j]], scores[r, want[r, j]]
        assert abs(a - b) <= NEAR_TIE * max(abs(a), abs(b)), (r, j)


def test_program_builds_key_on_their_flags(monkeypatch):
    """Each host program is keyed on its own flags; a failing compiler
    raises."""
    from librecommender_tpu_torch.ops import _build

    heads = ("model_runtime.hpp", "jaxpr_interp.hpp")
    assert (_build.host_program_path("server", heads, _build.SERVER_FLAGS)
            != _build.host_program_path("server", heads, _build.PROGRAM_FLAGS))
    assert "-pthread" in _build.SERVER_FLAGS and "-fopenmp" not in _build.CLIENT_FLAGS
    monkeypatch.setattr(_build, "GXX", "false")
    with pytest.raises(RuntimeError, match="false failed for benchmark.cpp"):
        _build.build_host_program("benchmark", flags=("-DPROBE_A_FAILED_BUILD",))


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_card_export_serves_the_card_lists(tmp_path):
    """A BPR on the card: its artifacts (with the IVF index built on the
    card) served natively, each list the card model's under the near-tie
    rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from librecommender_tpu_torch.data import DatasetPure

    rng = np.random.default_rng(0)
    cols = {"user": rng.integers(0, 200, 6000), "item": rng.integers(0, 300, 6000),
            "label": np.ones(6000)}
    train, info = DatasetPure.build_trainset(cols)
    model = tmodels.BPR("ranking", info, embed_size=16, n_epochs=1, device="cuda")
    model.fit(train, neg_sampling=True, verbose=0)
    path = tns.export_native(tmp_path / "card", model, ivf=True, n_probe=4)
    plain = tns.export_native(tmp_path / "plain", model)
    users = [int(info.id2user[u]) for u in range(8)]
    with native(plain) as port:
        for user in users:
            uid = info.user2id[user]
            scores = (model.item_embeds_np[: info.n_items].astype(np.float64)
                      @ model.user_embeds_np[uid].astype(np.float64))
            assert_near(_post(port, "/embed/recommend", {"user": user, "n_rec": 10}),
                        [int(i) for i in model.recommend_user(user, 10)[user]],
                        scores, info.item2id, user)
    assert (path / "ivf_lists.bin").exists()
