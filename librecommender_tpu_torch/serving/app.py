"""HTTP serving of a saved model on the standard library's HTTP server.

Counterpart of the ``model`` app of ``librecommender_tpu/serving/app.py``,
with its routes and JSON: ``POST /model/recommend`` takes
``{"user": ..., "n_rec": k}`` and answers ``{"rec_list": [...]}``;
``GET /health`` answers ``{"status": "ok"}``. The store holds
``model_path`` and ``model_meta`` (``{"model_name": ...}``), as the JAX
package's ``online2store`` writes them. The model is loaded on first use,
once, onto the server's device.
"""
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..device import resolve_device

log = logging.getLogger(__name__)

KINDS = ("model",)


class RecServer(ThreadingHTTPServer):
    """Threaded HTTP server that owns the store and the lazily loaded model."""

    daemon_threads = True

    def __init__(self, address, kind, store, device):
        super().__init__(address, _Handler)
        self.kind = kind
        self.store = store
        self.device = device
        self._model = None
        self._model_lock = threading.Lock()

    def model(self):
        with self._model_lock:
            if self._model is None:
                from .. import models as model_zoo
                from ..utils.save_load import load_hyper_params

                path = self.store.get("model_path")
                name = self.store.get("model_meta")["model_name"]
                hparams = load_hyper_params(path, name)
                cls = getattr(model_zoo, hparams.get("model_class", name))
                self._model = cls.load(path, name, device=self.device)
            return self._model


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
        if self.path != f"/{self.server.kind}/recommend":
            self._reply(404, {"error": f"no route POST {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length))
            user, n_rec = body["user"], int(body.get("n_rec", 10))
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
            return
        try:
            recs = self.server.model().recommend_user(user=user, n_rec=n_rec)
        except Exception as e:  # a request must not take the server down
            log.exception("recommend failed")
            self._reply(500, {"error": repr(e)})
            return
        key = next(iter(recs))
        self._reply(200, {"rec_list": [_json_safe(i) for i in recs[key]]})


def _json_safe(v):
    return v.item() if isinstance(v, np.generic) else v


def create_server(kind, store, port=0, device=None, host="127.0.0.1"):
    """Server for ``kind`` (this slice serves "model") on ``host:port``;
    ``port=0`` picks a free one. Returns ``(server, port)``; run it with
    ``server.serve_forever()`` and stop it with ``server.shutdown()`` and
    ``server.server_close()``."""
    if kind not in KINDS:
        raise ValueError(
            f"kind {kind!r} is not ported yet: this server serves {KINDS}; "
            "knn, embed and online come with the serving slice"
        )
    server = RecServer((host, port), kind, store, resolve_device(device))
    return server, server.server_address[1]
