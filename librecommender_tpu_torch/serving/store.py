"""Feature stores for serving, and the loaders that hydrate them.

Counterpart of ``librecommender_tpu/serving/store.py``. ``DictStore`` keeps
the values in the process; ``RedisStore`` speaks RESP2 to a Redis server over
a plain socket (no client package needed), each value JSON-encoded. Both
have the same few operations, and ``knn2store``, ``embed2store`` and
``online2store`` write the same keys and values into either from an artifact
directory of ``serialization.py`` (saved by either package).
"""
import json
import socket
from pathlib import Path

import numpy as np


class DictStore:
    """In-process store with the subset of Redis ops the servers use."""

    def __init__(self):
        self._data = {}

    def set(self, key, value):
        self._data[key] = value

    def get(self, key):
        return self._data.get(key)

    def hset(self, key, field, value):
        self._data.setdefault(key, {})[field] = value

    def hget(self, key, field):
        h = self._data.get(key)
        return None if h is None else h.get(field)

    def exists(self, key):
        return key in self._data

    def flushdb(self):
        self._data.clear()


class RedisStore:
    """Minimal RESP2 client: SET, GET, HSET, HGET, EXISTS, FLUSHDB, PING and,
    on connecting to a database other than 0, SELECT.

    A command that meets a broken connection (a Redis restart, an idle
    timeout) re-dials once and is sent again; an error reply raises
    ``RuntimeError`` and keeps the connection. One instance is one
    connection: a threaded caller serializes its commands.
    """

    def __init__(self, host="localhost", port=6379, db=0):
        self.host, self.port, self.db = host, port, db
        self.sock = None
        self._connect()

    def _connect(self):
        if self.sock is not None:
            self.sock.close()
        self.sock = socket.create_connection((self.host, self.port))
        self.buf = b""
        if self.db:
            self._send("SELECT", str(self.db))
            self._reply()

    def close(self):
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def _send(self, *args):
        out = [f"*{len(args)}\r\n".encode()]
        for a in args:
            data = a if isinstance(a, bytes) else str(a).encode()
            out.append(f"${len(data)}\r\n".encode() + data + b"\r\n")
        self.sock.sendall(b"".join(out))

    def _fill(self):
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("redis closed the connection")
        self.buf += chunk

    def _readline(self):
        while b"\r\n" not in self.buf:
            self._fill()
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n):
        while len(self.buf) < n + 2:
            self._fill()
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data

    def _reply(self):
        line = self._readline()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RuntimeError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if t == b"*":
            n = int(rest)
            return None if n == -1 else [self._reply() for _ in range(n)]
        raise RuntimeError(f"bad RESP type: {line!r}")

    def _cmd(self, *args):
        try:
            self._send(*args)
            return self._reply()
        except OSError:   # ConnectionError and BrokenPipeError among them
            # one re-dial; a second failure propagates
            self._connect()
            self._send(*args)
            return self._reply()

    def ping(self):
        return self._cmd("PING") == "PONG"

    def set(self, key, value):
        self._cmd("SET", key, json.dumps(value))

    def get(self, key):
        v = self._cmd("GET", key)
        return None if v is None else json.loads(v)

    def hset(self, key, field, value):
        self._cmd("HSET", key, field, json.dumps(value))

    def hget(self, key, field):
        v = self._cmd("HGET", key, field)
        return None if v is None else json.loads(v)

    def exists(self, key):
        return bool(self._cmd("EXISTS", key))

    def flushdb(self):
        self._cmd("FLUSHDB")


# ------------------------------------------------------------------ loaders
def _load_common(path, store):
    path = Path(path)
    with open(path / "model_meta.json") as f:
        meta = json.load(f)
    store.set("model_meta", meta)
    with open(path / "id_mapping.json") as f:
        ids = json.load(f)
    store.set("user2id", ids["user2id"])
    store.set("id2item", ids["id2item"])
    with open(path / "user_consumed.json") as f:
        store.set("user_consumed", json.load(f))
    return meta


def knn2store(path, store):
    """Hydrate a knn artifact: ``cf_mode``, each row's neighbours as
    ``k_sims[row] = [[id, sim], ...]`` (padding dropped) and the CSR."""
    meta = _load_common(path, store)
    with np.load(Path(path) / "knn_sims.npz") as arrays:
        store.set("cf_mode", str(arrays["cf_mode"][0]))
        sim_ids, sim_vals = arrays["sim_ids"], arrays["sim_vals"]
    for r in range(sim_ids.shape[0]):
        valid = sim_ids[r] >= 0
        store.hset("k_sims", str(r), [
            [int(i), float(s)] for i, s in zip(sim_ids[r][valid], sim_vals[r][valid])
        ])
    with np.load(Path(path) / "interaction.npz") as inter:
        store.set("interaction", {
            "data": inter["data"].tolist(),
            "indices": inter["indices"].tolist(),
            "indptr": inter["indptr"].tolist(),
        })
    return meta


def embed2store(path, store):
    """Hydrate an embed artifact: each table as nested float lists, and its
    shape."""
    meta = _load_common(path, store)
    with np.load(Path(path) / "embeddings.npz") as arrays:
        for key in ("user_embed", "item_embed"):
            mat = arrays[key]
            store.set(key + "_shape", list(mat.shape))
            store.set(key, mat.astype(float).tolist())
    return meta


def online2store(path, store):
    """Register an online artifact: the store holds the directory and the
    light metadata; the parameters stay on disk."""
    meta = _load_common(path, store)
    store.set("model_path", str(path))
    return meta
