"""HTTP serving on the standard library's threaded HTTP server.

Counterpart of ``librecommender_tpu/serving/app.py`` (aiohttp there), with
its routes, JSON bodies and status codes. A server serves one kind:

- ``knn``: ``POST /knn/recommend`` from a ``knn2store``-hydrated store
  (UserCF, ItemCF, Swing). The scores are the JAX app's float64 sums on the
  host with the same numpy calls, so the lists are equal item for item: a
  request adds a few thousand similarity terms read from the store, too
  little work for the card, as ``CfBase.recommend_user`` also sums in
  float64 on the host. It is not a CPU fallback of a kernel.
- ``embed``: ``POST /embed/recommend`` from an ``embed2store``-hydrated
  store. The tables go to the server's device once, as float32 (the store's
  float64 values came from float32, so the cast is exact), and a request
  ranks the catalog for one user row (the OOV row for an unknown user)
  through the streaming top-k (``ops/topk.topk_from_embeddings``: on the
  card the kernel of ``csrc/streaming_topk.cu``), over-fetching past the
  consumed items. The JAX app ranks float64 products on the host, so the
  lists agree but where two items' scores are near-ties.
- ``model`` and ``online``: ``POST /{kind}/recommend`` from an
  ``online2store``-registered artifact: the model is loaded on first use,
  once, onto the server's device, as the class its saved hyper-parameters
  name. ``online`` passes a request's ``seq`` (raw item ids) and
  ``user_feats`` to ``recommend_user`` where the model's signature takes
  them and drops them where it does not.
- ``POST /candidates`` (``model`` and ``online``): the inner-id candidates
  of ``{"user_inner": u, "k": k}`` unfiltered, the hop the native server
  makes; a ``seq`` of raw ids is mapped to inner ids, unknown ids dropped.

``{"user": ..., "n_rec": k}`` (``n_rec`` 10 by default) is answered with
``{"rec_list": [...]}``; ``GET /health`` with ``{"status": "ok"}``. A body
that is not JSON or lacks its keys gets 400, an unknown route 404, and a
request whose scoring raises 500.

What a server reads from the store (id maps, consumed lists, the CSR, a
neighbour row, the tables, the model) it reads once and keeps, under a lock:
handler threads run at once, and the first requests must not build a value
twice.
"""
import inspect
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..device import resolve_device
from ..ops.streaming_topk import streaming_topk
from ..ops.topk import topk_from_embeddings

log = logging.getLogger(__name__)

_MISSING = object()


class RecServer(ThreadingHTTPServer):
    """Threaded HTTP server that owns the store and what it reads from it."""

    daemon_threads = True
    # a load generator opens a connection per request (HTTP/1.0)
    request_queue_size = 128

    def __init__(self, address, kind, store, device):
        super().__init__(address, _Handler)
        self.kind = kind
        self.store = store
        self.device = device
        self._cache = {}
        self._cache_lock = threading.RLock()

    def cached(self, key, build):
        """``build()`` once per server for ``key``, then its value."""
        value = self._cache.get(key, _MISSING)
        if value is _MISSING:
            with self._cache_lock:
                if key not in self._cache:
                    self._cache[key] = build()
                value = self._cache[key]
        return value

    def store_value(self, key, default=None):
        def read():
            value = self.store.get(key)
            return default if value is None else value
        return self.cached(key, read)

    def model(self):
        return self.cached("model", self._load_model)

    def _load_model(self):
        from .. import models as model_zoo
        from ..utils.save_load import load_hyper_params

        path = self.store.get("model_path")
        name = self.store.get("model_meta")["model_name"]
        hparams = load_hyper_params(path, name)
        cls = getattr(model_zoo, hparams.get("model_class", name))
        return cls.load(path, name, device=self.device)

    def model_takes(self):
        """The request-time keys the model's ``recommend_user`` takes."""
        def keys():
            params = inspect.signature(self.model().recommend_user).parameters
            return {k for k in ("seq", "user_feats") if k in params}
        return self.cached("model_takes", keys)


# ------------------------------------------------------------------- kinds
def _uid_consumed(server, user):
    """(inner id or None, the user's consumed inner ids in stored order)."""
    uid = server.store_value("user2id").get(str(user))
    if uid is None:
        return None, []
    return uid, server.store_value("user_consumed", {}).get(str(uid), [])


def _raw_items(server, ids):
    id2item = server.store_value("id2item")
    return [id2item.get(str(int(i)), int(i)) for i in ids]


def _k_sims(server, row):
    return server.cached(("k_sims", int(row)),
                         lambda: server.store.hget("k_sims", str(row)) or [])


def knn_recommend(server, user, n_rec):
    uid, consumed = _uid_consumed(server, user)
    if uid is None:
        return []
    n_items = server.store_value("model_meta")["n_items"]

    def interaction():
        inter = server.store.get("interaction")
        return (np.asarray(inter["indptr"]), np.asarray(inter["indices"]),
                np.asarray(inter["data"]))

    indptr, indices, data = server.cached("interaction", interaction)
    scores = np.zeros(n_items)
    if server.store_value("cf_mode") == "user":
        # neighbour by neighbour, each one's interaction row times its sim
        for nbr, sim in _k_sims(server, uid):
            s, e = indptr[nbr], indptr[nbr + 1]
            np.add.at(scores, indices[s:e], sim * data[s:e])
    else:
        # consumed item by consumed item, each one's neighbour list
        flat = [p for i in indices[indptr[uid]:indptr[uid + 1]]
                for p in _k_sims(server, i)]
        if flat:
            nbrs = np.fromiter((p[0] for p in flat), np.int64, len(flat))
            vals = np.fromiter((p[1] for p in flat), np.float64, len(flat))
            np.add.at(scores, nbrs, vals)
    scores[list(set(consumed))] = -np.inf
    take = min(n_rec, n_items - 1)
    top = np.argpartition(-scores, take)[:n_rec]
    top = top[np.argsort(-scores[top])]
    top = [int(t) for t in top if np.isfinite(scores[t])][:n_rec]
    return _raw_items(server, top)


def embed_recommend(server, user, n_rec):
    uid, consumed = _uid_consumed(server, user)
    n_items = server.store_value("model_meta")["n_items"]

    def table(key, rows=None):
        mat = np.asarray(server.store.get(key), dtype=np.float32)
        return torch.from_numpy(mat[:rows]).to(server.device)

    user_embed = server.cached("user_embed", lambda: table("user_embed"))
    item_embed = server.cached("item_embed", lambda: table("item_embed", n_items))
    row = user_embed[uid if uid is not None else -1]
    consumed = list(dict.fromkeys(consumed))
    n = max(0, min(n_rec, n_items))
    fill = min(n, n_items - len(consumed))   # unconsumed items the list takes
    top = []
    if fill > 0:
        ids, scores = topk_from_embeddings(
            row, item_embed, fill, user_consumed={0: consumed} if consumed else None,
            user_ids=[0])
        top = ids[0].tolist()
        if not np.isfinite(scores[0]).all():
            # the over-fetch is capped (ops/topk.MAX_FETCH) and more consumed
            # items than its slack ranked above: fetch past the cap
            ids, _ = streaming_topk(row[None], item_embed,
                                    min(n_items, fill + len(consumed)))
            seen = set(consumed)
            top = [i for i in ids[0].tolist() if i not in seen][:fill]
    # the JAX app's list keeps n entries: past the unconsumed items come
    # consumed ones, which it scores -inf (so in no order)
    return _raw_items(server, top + consumed[: n - len(top)])


def model_recommend(server, user, n_rec):
    recs = server.model().recommend_user(user=user, n_rec=n_rec)
    return [_json_safe(i) for i in next(iter(recs.values()))]


def online_recommend(server, user, n_rec, seq=None, user_feats=None):
    kwargs = _request_kwargs(server, seq, user_feats)
    recs = server.model().recommend_user(user=user, n_rec=n_rec, **kwargs)
    return [_json_safe(i) for i in next(iter(recs.values()))]


def candidates(server, uid, k, seq=None, user_feats=None):
    model = server.model()
    if seq is not None:
        # a request carries raw item ids; scoring runs on inner ids
        item2id = model.data_info.item2id
        seq = [item2id[i] for i in seq if i in item2id]
    kwargs = _request_kwargs(server, seq, user_feats)
    recs = model.recommend_user(user=uid, n_rec=min(k, model.n_items),
                                inner_id=True, filter_consumed=False, **kwargs)
    return [int(i) for i in next(iter(recs.values()))]


def _request_kwargs(server, seq, user_feats):
    """The request's ``seq`` and ``user_feats`` that the model takes."""
    takes = server.model_takes()
    given = {"seq": seq, "user_feats": user_feats}
    return {k: v for k, v in given.items() if v is not None and k in takes}


RECOMMEND = {
    "knn": knn_recommend,
    "embed": embed_recommend,
    "model": model_recommend,
    "online": online_recommend,
}
KINDS = tuple(RECOMMEND)


def _json_safe(v):
    return v.item() if isinstance(v, np.generic) else v


# ----------------------------------------------------------------- handler
class _Handler(BaseHTTPRequestHandler):
    server: RecServer

    def log_message(self, format, *args):
        log.debug(format, *args)

    def _reply(self, status, payload):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            self._reply(200, {"status": "ok"})
        else:
            self._reply(404, {"error": f"no route GET {self.path}"})

    def do_POST(self):
        kind = self.server.kind
        if self.path == f"/{kind}/recommend":
            route, answer = RECOMMEND[kind], "rec_list"
        elif self.path == "/candidates" and kind in ("model", "online"):
            route, answer = candidates, "candidates"
        else:
            self._reply(404, {"error": f"no route POST {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length))
            if route is candidates:
                args = (int(body["user_inner"]), int(body.get("k", 10)))
            else:
                args = (body["user"], int(body.get("n_rec", 10)))
            kwargs = {}
            if kind == "online" or route is candidates:
                kwargs = {"seq": body.get("seq"), "user_feats": body.get("user_feats")}
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
            return
        try:
            out = route(self.server, *args, **kwargs)
        except Exception as e:  # a request must not take the server down
            log.exception("%s failed", self.path)
            self._reply(500, {"error": repr(e)})
            return
        self._reply(200, {answer: out})


def create_server(kind, store, port=0, device=None, host="127.0.0.1"):
    """Server for ``kind`` (one of ``KINDS``) on ``host:port``; ``port=0``
    picks a free one, ``device=None`` means the card. Returns ``(server,
    port)``; run it with ``server.serve_forever()`` and stop it with
    ``server.shutdown()`` and ``server.server_close()``."""
    if kind not in KINDS:
        raise ValueError(f"unknown serving kind {kind!r}: one of {KINDS}")
    server = RecServer((host, port), kind, store, resolve_device(device))
    return server, server.server_address[1]
