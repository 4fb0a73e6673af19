"""Container entry point for the serving tier.

    SERVING_KIND=embed ARTIFACT_PATH=/artifacts PORT=8000 \\
        python -m librecommender_tpu_torch.serving.launch

Counterpart of ``librecommender_tpu/serving/launch.py``. Reads
``SERVING_KIND`` (knn, embed, model or online; embed by default),
``ARTIFACT_PATH`` (a directory of ``serialization.py``, saved by either
package), ``PORT`` (8000) and, for the store, ``REDIS_HOST`` and
``REDIS_PORT`` (6379); hydrates the store from the artifact, into Redis when
``REDIS_HOST`` is set and answers PING, else into an in-process
``DictStore``; and serves the kind on the card on every interface. It has no
device switch: on a host without a GPU it raises before it binds the port.
"""
import os
from pathlib import Path

from . import store as stores
from ..device import resolve_device


def build_store(kind, artifact_path):
    """The store for ``kind``, hydrated from ``artifact_path``."""
    host = os.environ.get("REDIS_HOST", "")
    store = None
    if host:
        try:
            store = stores.RedisStore(
                host=host, port=int(os.environ.get("REDIS_PORT", 6379)))
            store.ping()
        except (OSError, RuntimeError) as exc:
            print(f"redis unavailable ({exc}); using in-process store")
            store = None
    if store is None:
        store = stores.DictStore()
    loader = {
        "knn": stores.knn2store,
        "embed": stores.embed2store,
        "model": stores.online2store,
        "online": stores.online2store,
    }[kind]
    loader(Path(artifact_path), store)
    return store


def main():
    from .app import create_server

    device = resolve_device(None)
    kind = os.environ.get("SERVING_KIND", "embed")
    artifact_path = os.environ.get("ARTIFACT_PATH", "/artifacts")
    port = int(os.environ.get("PORT", 8000))
    store = build_store(kind, artifact_path)
    server, port = create_server(kind, store, port=port, device=device,
                                 host="0.0.0.0")
    print(f"serving {kind} from {artifact_path} on port {port} ({device})")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
