"""The PyTorch port's HTTP server against the JAX package's aiohttp app.

The same saved BPR is served by both: the port's ``create_server("model",
...)`` on the CPU and the JAX ``create_app("model", ...)`` in-process (the
pattern of tests/serving/test_serving.py). The rec_list of each request must
be identical."""
import asyncio
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest


@pytest.fixture(scope="module")
def saved_online(pure_frames, tmp_path_factory):
    from librecommender_tpu.data import DatasetPure
    from librecommender_tpu.models import BPR
    from librecommender_tpu.serving import save_online

    train_data, data_info = DatasetPure.build_trainset(pure_frames[0])
    model = BPR("ranking", data_info, embed_size=8, n_epochs=1, batch_size=256)
    model.fit(train_data, neg_sampling=True, verbose=0)
    return model, save_online(tmp_path_factory.mktemp("online"), model)


@pytest.fixture()
def port_server(saved_online):
    from librecommender_tpu_torch.serving import DictStore, create_server

    _, path = saved_online
    store = DictStore()
    store.set("model_path", str(path))
    with open(path / "model_meta.json") as f:
        store.set("model_meta", json.load(f))
    server, port = create_server("model", store, port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _jax_post(path, payloads):
    from aiohttp.test_utils import TestClient, TestServer

    from librecommender_tpu.serving import DictStore, online2store
    from librecommender_tpu.serving.app import create_app

    store = DictStore()
    online2store(path, store)

    async def go():
        client = TestClient(TestServer(create_app("model", store)))
        await client.start_server()
        try:
            out = []
            for p in payloads:
                resp = await client.post("/model/recommend", json=p)
                assert resp.status == 200, await resp.text()
                out.append(await resp.json())
            return out
        finally:
            await client.close()

    return asyncio.run(go())


def test_model_recommend_matches_jax_app(saved_online, port_server):
    model, path = saved_online
    users = [int(model.data_info.id2user[i]) for i in range(4)]
    payloads = [{"user": u, "n_rec": n} for u in users for n in (5, 12)]
    payloads.append({"user": 31337, "n_rec": 6})  # unknown user
    payloads.append({"user": users[0]})           # n_rec defaults to 10
    want = _jax_post(path, payloads)
    for p, w in zip(payloads, want):
        status, got = _http(port_server + "/model/recommend", p)
        assert status == 200
        assert got == w
        assert len(got["rec_list"]) == p.get("n_rec", 10)


def test_health_and_errors(port_server):
    assert _http(port_server + "/health") == (200, {"status": "ok"})
    for url, payload, code in [
        ("/nope", None, 404),
        ("/embed/recommend", {"user": 1}, 404),
        ("/model/recommend", {"n_rec": 3}, 400),
    ]:
        with pytest.raises(urllib.error.HTTPError) as err:
            _http(port_server + url, payload)
        assert err.value.code == code


def test_only_model_kind_is_ported():
    """An unknown kind raises; the four kinds of the JAX app are served."""
    from librecommender_tpu_torch.serving import DictStore, create_server
    from librecommender_tpu_torch.serving.app import KINDS

    assert KINDS == ("knn", "embed", "model", "online")
    with pytest.raises(ValueError, match="unknown serving kind"):
        create_server("faiss", DictStore(), device="cpu")


def test_dict_store_interface():
    from librecommender_tpu_torch.serving import DictStore

    s = DictStore()
    s.set("a", [1, 2])
    s.hset("h", "f", np.int64(3))
    assert s.get("a") == [1, 2] and s.hget("h", "f") == 3
    assert s.exists("a") and s.hget("h", "x") is None and s.get("zz") is None
    s.flushdb()
    assert not s.exists("a")
