"""The PyTorch port's serving tier against the JAX package's, on the CPU.

Small models are fitted by the JAX package (UserCF, ItemCF, Swing, BPR,
RNN4Rec, DIN) on the ``tests/conftest.py`` frames, saved, and loaded by the
port, so that both hold the same state. Then:

- artifacts both ways: each package's savers write an artifact of its own
  model; either package's loaders hydrate either artifact into a
  ``DictStore`` equal key for key to JAX's own; an IVF index saved by either
  package searches alike in the other;
- each kind against JAX's aiohttp app on the same artifact: ``knn`` lists
  equal; ``embed`` lists equal but where two items' float64 scores lie
  within 1e-5 relative (the port ranks float32 products through the
  streaming top-k, JAX float64 products on the host), and the consumed
  items that both lists append past the unconsumed ones; ``online``,
  ``model`` and ``/candidates`` lists equal;
- ``RedisStore`` against ``tests/serving/fake_resp.py``'s RESP2 server, the
  launcher's store choice and the load generator.

The JAX package is imported inside the fixtures and tests: the ``cuda`` test
at the end runs on the card, where there is no JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_serving_tier.py``).
"""
import asyncio
import json
import threading
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch import serving as tserving
from librecommender_tpu_torch.serving import store as tstore

NEAR_TIE = 1e-5
CF_MODELS = {"UserCF": dict(k_sim=10), "ItemCF": dict(k_sim=10),
             "Swing": dict(top_k=10)}
SMALL = dict(embed_size=8, n_epochs=1, batch_size=256)
FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])


# ---------------------------------------------------------------- fixtures
def _jax_fit(cls, info, train, **kw):
    from librecommender_tpu import models as jmodels

    model = getattr(jmodels, cls)("ranking", info, **kw)
    model.fit(train, neg_sampling=True, verbose=0)
    return model


@pytest.fixture(scope="module")
def fitted(pure_frames, feat_frames, tmp_path_factory):
    """name -> (JAX model, the port's model loaded from JAX's save)."""
    from librecommender_tpu.data import DatasetFeat, DatasetPure

    train, info = DatasetPure.build_trainset(pure_frames[0])
    f_train, f_info = DatasetFeat.build_trainset(feat_frames[0], **FEAT_COLS)
    jax_models = {name: _jax_fit(name, info, train, **kw)
                  for name, kw in CF_MODELS.items()}
    jax_models["BPR"] = _jax_fit("BPR", info, train, **SMALL)
    jax_models["RNN4Rec"] = _jax_fit("RNN4Rec", info, train, **SMALL)
    jax_models["DIN"] = _jax_fit("DIN", f_info, f_train, recent_num=5, **SMALL)
    root = tmp_path_factory.mktemp("fitted")
    out = {}
    for name, jm in jax_models.items():
        jm.save(root / name, name)
        out[name] = (jm, getattr(tmodels, name).load(root / name, name, device="cpu"))
    return out


SAVERS = {"knn": "save_knn", "embed": "save_embed", "online": "save_online"}
LOADERS = {"knn": "knn2store", "embed": "embed2store", "online": "online2store"}


@pytest.fixture(scope="module")
def artifacts(fitted, tmp_path_factory):
    """(name, kind) -> (JAX's artifact of the JAX model, the port's artifact
    of the port's model)."""
    from librecommender_tpu import serving as jserving

    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name, kind in ARTIFACTS:
        jm, pm = fitted[name]
        out[name, kind] = tuple(
            getattr(pkg, SAVERS[kind])(root / f"{side}_{name}_{kind}", model)
            for side, pkg, model in (("jax", jserving, jm), ("port", tserving, pm)))
    return out


ARTIFACTS = [("UserCF", "knn"), ("ItemCF", "knn"), ("Swing", "knn"),
             ("BPR", "embed"), ("RNN4Rec", "embed"), ("BPR", "online"),
             ("RNN4Rec", "online"), ("DIN", "online")]


def _hydrate(pkg, kind, path, store=None):
    store = pkg.DictStore() if store is None else store
    getattr(pkg, LOADERS[kind])(path, store)
    return store


# --------------------------------------------------------------- servers
@contextmanager
def port_server(kind, store, device="cpu"):
    server, port = tserving.create_server(kind, store, port=0, device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{port}", server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def port_post(kind, store, route, payloads, device="cpu"):
    with port_server(kind, store, device) as (base, _):
        out = []
        for p in payloads:
            status, body = _http(base + route, p)
            assert status == 200
            out.append(body)
        return out


def jax_post(kind, store, route, payloads):
    from aiohttp.test_utils import TestClient, TestServer

    from librecommender_tpu.serving.app import create_app

    async def go():
        client = TestClient(TestServer(create_app(kind, store)))
        await client.start_server()
        try:
            out = []
            for p in payloads:
                resp = await client.post(route, json=p)
                assert resp.status == 200, await resp.text()
                out.append(await resp.json())
            return out
        finally:
            await client.close()

    return asyncio.run(go())


def _payloads(model, n_recs=(5, 12)):
    """Known users at each n_rec, one whose n_rec passes its unconsumed
    items, an unknown user and the default n_rec."""
    info = model.data_info
    users = [int(info.id2user[i]) for i in range(4)]
    out = [{"user": u, "n_rec": n} for u in users for n in n_recs]
    out.append({"user": users[1], "n_rec": model.n_items})
    out.append({"user": 31337, "n_rec": 6})
    out.append({"user": users[2]})
    return out


# ------------------------------------------------------- artifacts both ways
# tables the port recomputes from the carried parameters in float32 (the
# recurrent forward of the user rows), so within float32 rounding of JAX's
RECOMPUTED = {("RNN4Rec", "embed"): ("user_embed",)}


@pytest.mark.parametrize("name,kind", ARTIFACTS,
                         ids=[f"{n}-{k}" for n, k in ARTIFACTS])
def test_artifacts_hydrate_alike_both_ways(artifacts, name, kind):
    """Either package's loader on either package's artifact gives the same
    store, key for key, and the port's artifact JAX's (an online store's
    ``model_path`` is its directory)."""
    from librecommender_tpu import serving as jserving

    jpath, ppath = artifacts[name, kind]
    want = _hydrate(jserving, kind, jpath)._data
    assert _hydrate(tserving, kind, jpath)._data == want
    got = _hydrate(tserving, kind, ppath)._data
    assert _hydrate(jserving, kind, ppath)._data == got
    got = dict(got)
    if kind == "online":
        assert got.pop("model_path") == str(ppath)
        got["model_path"] = want["model_path"]
    for key in RECOMPUTED.get((name, kind), ()):
        np.testing.assert_allclose(got.pop(key), want[key], rtol=1e-5, atol=1e-7)
        got[key] = want[key]
    assert got == want


def test_ivf_index_saved_by_either_package_searches_alike(fitted, tmp_path):
    from librecommender_tpu import serving as jserving
    from librecommender_tpu.retrieval.ivf import IVFIndex as JIVF

    from librecommender_tpu_torch.retrieval.ivf import IVFIndex as TIVF

    jm, pm = fitted["BPR"]
    queries = pm.user_embeds_np[:16]
    items = pm.item_embeds_np[:-1].astype(np.float64)
    tserving.save_ivf_index(tmp_path / "port", pm, n_clusters=6, n_probe=3)
    jserving.save_ivf_index(tmp_path / "jax", jm, n_clusters=6, n_probe=3)
    for side in ("port", "jax"):
        path = tmp_path / side
        assert json.loads((path / "ivf_config.json").read_text()) == {"n_probe": 3}
        t_ids, t_sc = TIVF.load(path, device="cpu").search(queries, 10, n_probe=3)
        j_ids, j_sc = JIVF.load(path).search(queries, 10, n_probe=3)
        j_ids, j_sc = np.asarray(j_ids), np.asarray(j_sc)
        np.testing.assert_array_equal(t_ids < 0, j_ids < 0)
        exact = queries.astype(np.float64) @ items.T
        _assert_near_ties(t_ids, j_ids, exact, side)
        np.testing.assert_allclose(t_sc, j_sc, rtol=NEAR_TIE, atol=1e-6)


def _assert_near_ties(got, want, exact, what, masked=()):
    """Ids equal, but where both ids' exact scores in the row lie within
    NEAR_TIE relative, or both are ``masked`` (scored -inf)."""
    for r, j in zip(*np.nonzero(np.asarray(got) != np.asarray(want))):
        a, b = int(got[r][j]), int(want[r][j])
        if a in masked and b in masked:
            continue
        sa, sb = exact[r][a], exact[r][b]
        assert abs(sa - sb) <= NEAR_TIE * max(abs(sa), abs(sb), 1e-12), (
            f"{what} row {r} slot {j}: {a} ({sa}) vs {b} ({sb})")


# ------------------------------------------------------ kinds against JAX
@pytest.mark.parametrize("name", list(CF_MODELS))
def test_knn_kind_matches_jax_app(fitted, artifacts, name):
    from librecommender_tpu import serving as jserving

    jpath, ppath = artifacts[name, "knn"]
    payloads = _payloads(fitted[name][0])
    want = jax_post("knn", _hydrate(jserving, "knn", jpath), "/knn/recommend",
                    payloads)
    got = port_post("knn", _hydrate(tserving, "knn", ppath), "/knn/recommend",
                    payloads)
    assert got == want
    assert got[-2] == {"rec_list": []}        # the unknown user
    assert sum(len(g["rec_list"]) for g in got) > 0


@pytest.mark.parametrize("name,fetch_cap", [("BPR", None), ("RNN4Rec", None),
                                            ("BPR", 8)])
def test_embed_kind_matches_jax_app(fitted, artifacts, monkeypatch, name,
                                    fetch_cap):
    """JAX's lengths in every case; ids as JAX's but for near-ties and for
    the consumed items past the unconsumed ones (JAX scores them -inf).
    ``fetch_cap``: the over-fetch capped below the users' consumed counts,
    so that the kind fetches again past the cap."""
    from librecommender_tpu import serving as jserving
    from librecommender_tpu_torch.ops import topk
    from librecommender_tpu_torch.serving import app

    refetched = []
    if fetch_cap is not None:
        monkeypatch.setattr(topk, "MAX_FETCH", fetch_cap)
        monkeypatch.setattr(app, "streaming_topk",
                            lambda *a: refetched.append(a) or topk.streaming_topk(*a))

    jm, _ = fitted[name]
    jpath, ppath = artifacts[name, "embed"]
    payloads = _payloads(jm)
    want = jax_post("embed", _hydrate(jserving, "embed", jpath),
                    "/embed/recommend", payloads)
    got = port_post("embed", _hydrate(tserving, "embed", ppath),
                    "/embed/recommend", payloads)
    info = jm.data_info
    users = np.asarray(jm.user_embeds_np, np.float64)
    items = np.asarray(jm.item_embeds_np, np.float64)[:-1]
    for p, g, w in zip(payloads, got, want):
        g, w = g["rec_list"], w["rec_list"]
        assert len(g) == len(w) == min(p.get("n_rec", 10), jm.n_items)
        uid = info.user2id.get(p["user"])
        row = users[-1 if uid is None else uid] @ items.T
        consumed = set() if uid is None else set(info.user_consumed[uid])
        _assert_near_ties([[info.item2id[i] for i in g]],
                          [[info.item2id[i] for i in w]], [row],
                          f"user {p['user']}", masked=consumed)
        assert sorted(g) == sorted(w) or p.get("n_rec") != jm.n_items
    assert bool(refetched) == (fetch_cap is not None)


@pytest.mark.parametrize("name,kind,request_kw", [
    # a sequence model with a request seq of raw ids (an unknown one too)
    ("RNN4Rec", "online", "seq"),
    # DIN with request features
    ("DIN", "online", "user_feats"),
    # a model that takes neither: the request's seq is dropped
    ("BPR", "online", "seq"),
    # the model kind ignores both
    ("DIN", "model", "user_feats"),
])
def test_model_kinds_match_jax_app(fitted, artifacts, name, kind, request_kw):
    from librecommender_tpu import serving as jserving

    jm, pm = fitted[name]
    jpath, ppath = artifacts[name, "online"]
    payloads = _payloads(jm)
    seq = [int(jm.data_info.id2item[i]) for i in (4, 9, 2)] + [-3]
    for p, feats in zip(payloads, ({"sex": "f", "age": 0.7}, {"sex": "m"}, {})):
        p[request_kw] = seq if request_kw == "seq" else feats
    route = f"/{kind}/recommend"
    want = jax_post(kind, _hydrate(jserving, "online", jpath), route, payloads)
    for path in (ppath, jpath):
        got = port_post(kind, _hydrate(tserving, "online", path), route, payloads)
        assert got == want, path.name
    # the request state reached the model: the first request differs from
    # the same request without it, and equals the loaded model's own call
    p = payloads[0]
    kw = {request_kw: p[request_kw]} if kind == "online" and name != "BPR" else {}
    direct = pm.recommend_user(p["user"], p["n_rec"], **kw)[p["user"]]
    assert want[0]["rec_list"] == [int(i) for i in direct]


@pytest.mark.parametrize("name,kind,request_kw", [
    ("BPR", "model", None),
    ("RNN4Rec", "online", "seq"),
    ("DIN", "online", "user_feats"),
])
def test_candidates_match_jax_app(fitted, artifacts, name, kind, request_kw):
    from librecommender_tpu import serving as jserving

    jm, pm = fitted[name]
    jpath, ppath = artifacts[name, "online"]
    seq = [int(jm.data_info.id2item[i]) for i in (7, 1, 3)] + [-3, 424242]
    payloads = [{"user_inner": u, "k": k} for u in (0, 3) for k in (5, 40)]
    payloads += [{"user_inner": 1}, {"user_inner": 2, "k": 10 * jm.n_items}]
    if request_kw:
        for p in payloads[::2]:
            p[request_kw] = seq if request_kw == "seq" else {"sex": "f"}
    want = jax_post(kind, _hydrate(jserving, "online", jpath), "/candidates",
                    payloads)
    got = port_post(kind, _hydrate(tserving, "online", ppath), "/candidates",
                    payloads)
    assert got == want
    for p, g in zip(payloads, got):
        assert len(g["candidates"]) == min(p.get("k", 10), jm.n_items)
    # unfiltered inner ids: recommend_user(inner_id=True, filter_consumed=False)
    p = payloads[0]
    kw = {}
    if request_kw == "seq":
        item2id = pm.data_info.item2id
        kw["seq"] = [item2id[i] for i in p["seq"] if i in item2id]
    elif request_kw:
        kw[request_kw] = p[request_kw]
    direct = pm.recommend_user(0, 5, inner_id=True, filter_consumed=False, **kw)
    assert got[0]["candidates"] == [int(i) for i in direct[0]]


def test_routes_and_errors(artifacts):
    """404 for a route the kind does not serve, 400 for a bad body; an
    unknown kind raises."""
    _, ppath = artifacts["UserCF", "knn"]
    with port_server("knn", _hydrate(tserving, "knn", ppath)) as (base, _):
        assert _http(base + "/health") == (200, {"status": "ok"})
        for url, payload, code in [
            ("/nope", None, 404),
            ("/candidates", {"user_inner": 1}, 404),
            ("/embed/recommend", {"user": 1}, 404),
            ("/knn/recommend", {"n_rec": 3}, 400),
            ("/knn/recommend", {"user": 1, "n_rec": "many"}, 400),
        ]:
            with pytest.raises(urllib.error.HTTPError) as err:
                _http(base + url, payload)
            assert err.value.code == code, url
    with pytest.raises(ValueError, match="unknown serving kind"):
        tserving.create_server("faiss", tserving.DictStore(), device="cpu")


def test_concurrent_first_requests_build_the_cache_once(artifacts, monkeypatch):
    """Many first requests at once: each stored value is read once."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    _, ppath = artifacts["BPR", "embed"]
    store = _hydrate(tserving, "embed", ppath)
    reads = []
    real_get = store.get

    def counting_get(key):
        reads.append(key)
        return real_get(key)

    monkeypatch.setattr(store, "get", counting_get)
    user = int(json.loads((ppath / "id_mapping.json").read_text())
               ["user2id"].popitem()[0])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with port_server("embed", store) as (base, _):
            with ThreadPoolExecutor(24) as pool:
                answers = list(pool.map(
                    lambda _: _http(base + "/embed/recommend",
                                    {"user": user, "n_rec": 5}),
                    range(48), timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert all(a == answers[0] for a in answers)
    assert sorted(reads) == sorted(set(reads))


# --------------------------------------------------------------- the stores
@pytest.fixture()
def resp_server():
    from tests.serving.fake_resp import FakeRespServer

    srv = FakeRespServer()
    yield srv
    srv.close()


def _redis_roundtrip(srv, store):
    assert store.ping()
    store.set("k", {"a": 1, "b": [1, 2, 3]})
    assert store.get("k") == {"a": 1, "b": [1, 2, 3]}
    assert store.get("missing") is None
    store.hset("h", "f", [1.5, 2.5])
    assert store.hget("h", "f") == [1.5, 2.5]
    assert store.hget("h", "nope") is None and store.hget("noh", "f") is None
    assert store.exists("k") and not store.exists("absent")
    store.flushdb()
    assert not store.exists("k")
    assert {name for name, _ in srv.commands} == {
        "PING", "SET", "GET", "HSET", "HGET", "EXISTS", "FLUSHDB"}


def _redis_select(srv, _):
    tstore.RedisStore(host="127.0.0.1", port=srv.port, db=3).close()
    assert srv.commands[-1] == ("SELECT", ["3"])


def _redis_large_value(srv, store):
    big = {"v": "x" * 300_000}   # more than one 65536-byte recv
    store.set("big", big)
    assert store.get("big") == big


def _redis_error_reply(srv, store):
    srv.fail_next(1)
    with pytest.raises(RuntimeError, match="injected failure"):
        store.get("k")
    sock = store.sock
    assert store.ping() and store.sock is sock     # no re-dial
    assert sum(1 for n, _ in srv.commands if n == "PING") == 1


def _redis_redial(srv, store):
    store.set("persist", 42)
    sock = store.sock
    srv.drop_connections()
    # the dead socket shows on use: one re-dial, and the data is there
    assert store.get("persist") == 42
    assert store.sock is not sock and store.ping()


@pytest.mark.parametrize("case", [_redis_roundtrip, _redis_select,
                                  _redis_large_value, _redis_error_reply,
                                  _redis_redial],
                         ids=["roundtrip", "select", "large_value",
                              "error_reply", "redial"])
def test_redis_store_protocol(resp_server, case):
    store = tstore.RedisStore(host="127.0.0.1", port=resp_server.port)
    try:
        case(resp_server, store)
    finally:
        store.close()


@pytest.mark.parametrize("name,kind", [("ItemCF", "knn"), ("BPR", "embed")])
def test_redis_hydrated_serving_equals_dict_store(fitted, artifacts, resp_server,
                                                  name, kind):
    _, ppath = artifacts[name, kind]
    redis = tstore.RedisStore(host="127.0.0.1", port=resp_server.port)
    try:
        _hydrate(tserving, kind, ppath, redis)
        payloads = _payloads(fitted[name][0])
        route = f"/{kind}/recommend"
        assert port_post(kind, redis, route, payloads) == port_post(
            kind, _hydrate(tserving, kind, ppath), route, payloads)
    finally:
        redis.close()


def test_build_store_prefers_reachable_redis(artifacts, resp_server, monkeypatch,
                                             capsys):
    from librecommender_tpu_torch.serving.launch import build_store

    _, ppath = artifacts["UserCF", "knn"]
    monkeypatch.setenv("REDIS_HOST", "127.0.0.1")
    monkeypatch.setenv("REDIS_PORT", str(resp_server.port))
    store = build_store("knn", ppath)
    assert isinstance(store, tstore.RedisStore) and store.exists("k_sims")
    store.close()
    monkeypatch.setenv("REDIS_PORT", "1")   # nothing listens there
    store = build_store("knn", ppath)
    assert isinstance(store, tstore.DictStore) and store.exists("k_sims")
    assert "redis unavailable" in capsys.readouterr().out
    monkeypatch.delenv("REDIS_HOST")
    assert isinstance(build_store("embed", artifacts["BPR", "embed"][1]),
                      tstore.DictStore)


def test_launch_main_raises_without_gpu(artifacts, monkeypatch):
    from librecommender_tpu_torch.serving import launch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: launch.main would serve on it")
    monkeypatch.setenv("SERVING_KIND", "knn")
    monkeypatch.setenv("ARTIFACT_PATH", str(artifacts["UserCF", "knn"][1]))
    monkeypatch.setenv("PORT", "0")
    monkeypatch.delenv("REDIS_HOST", raising=False)
    hydrated = []
    monkeypatch.setattr(launch, "build_store", lambda *a: hydrated.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main()
    assert not hydrated


def test_run_benchmark_against_port_server(fitted, artifacts):
    from librecommender_tpu_torch.serving.benchmark import run_benchmark

    jm, _ = fitted["BPR"]
    users = [int(jm.data_info.id2user[i]) for i in range(3)]
    with port_server("embed", _hydrate(tserving, "embed",
                                       artifacts["BPR", "embed"][1])) as (base, _):
        out = run_benchmark(base + "/embed/recommend",
                            [{"user": u, "n_rec": 5} for u in users], 60, 4)
        assert set(out) == {"requests", "wall_s", "rps", "p50_ms", "p95_ms",
                            "p99_ms"}
        assert out["requests"] == 60 and out["rps"] > 0
        assert 0 < out["p50_ms"] <= out["p95_ms"] <= out["p99_ms"]
        with pytest.raises(RuntimeError, match="HTTP 400"):
            run_benchmark(base + "/embed/recommend", [{"n_rec": 5}], 3, 2)


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_embed_kind_on_the_card_equals_the_cpu_server(tmp_path):
    """The embed kind served from the card: every list equal to the CPU
    server's but for near-ties, one top-k launch a request at least."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from librecommender_tpu_torch.data import DatasetPure
    from librecommender_tpu_torch.ops import streaming_topk as st

    rng = np.random.default_rng(0)
    users, items = rng.integers(0, 300, 20_000), rng.integers(0, 2000, 20_000)
    train, info = DatasetPure.build_trainset(
        {"user": users + 1, "item": items + 1, "label": np.ones(len(users))})
    model = tmodels.BPR("ranking", info, embed_size=64, device="cuda")
    model.build_model()
    model.post_fit()
    path = tserving.save_embed(tmp_path / "embed", model)
    payloads = [{"user": int(info.id2user[u]), "n_rec": n}
                for u in range(0, 300, 10) for n in (10, 50)]
    payloads.append({"user": -5, "n_rec": 10})
    cpu = port_post("embed", _hydrate(tserving, "embed", path), "/embed/recommend",
                    payloads, device="cpu")
    st.reset_launches()
    card = port_post("embed", _hydrate(tserving, "embed", path), "/embed/recommend",
                     payloads, device="cuda")
    assert st.launches >= len(payloads)
    u64 = model.user_embeds_np.astype(np.float64)
    i64 = model.item_embeds_np[:-1].astype(np.float64)
    for p, g, c in zip(payloads, card, cpu):
        uid = info.user2id.get(p["user"], -1)
        inner = [[info.item2id[i] for i in x["rec_list"]] for x in (g, c)]
        assert len(inner[0]) == p["n_rec"]
        _assert_near_ties(inner[:1], inner[1:], [u64[uid] @ i64.T], str(p))
