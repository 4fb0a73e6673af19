"""HNSW approximate nearest-neighbour index, host C++.

Counterpart of ``librecommender_tpu/retrieval/hnsw.py``: the graph index
behind ``init_knn(approximate=True)`` and ``init_ann(index="hnsw")``, built
and searched by the port's own copy of the C++ (``csrc/hnsw.cpp``, compiled
by ``ops/_build.build_host``). Inner-product similarity; callers
pre-normalize for cosine. The build is single-threaded, so a graph depends
only on the source, the flags, the seed and the vectors: both packages build
the same bytes, and a graph saved by either loads in the other.

It runs on the host, as the JAX package's does; queries given as tensors
come off their device once a call. Where the library cannot be built, the
build raises: there is no brute-force fallback.
"""
import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ..ops import _build


@functools.cache
def hnsw_lib():
    """The HNSW library, built on first use, with its ctypes signatures."""
    lib = _build.load_host("hnsw")
    lib.hnsw_build.restype = ctypes.c_void_p
    lib.hnsw_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.hnsw_search.restype = None
    lib.hnsw_search.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    lib.hnsw_blob_size.restype = ctypes.c_int64
    lib.hnsw_blob_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_serialize.restype = None
    lib.hnsw_serialize.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_deserialize.restype = ctypes.c_void_p
    lib.hnsw_deserialize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.hnsw_free.restype = None
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    return lib


def _host_rows(x):
    """(n, d) C-contiguous float32 numpy rows of an array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.atleast_2d(np.asarray(x, np.float32)))


def _f32_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class HNSWIndex:
    def __init__(self, handle, vectors, lib, M, ef_construction):
        self._handle = handle
        self._lib = lib
        self.vectors = vectors           # (n, d) f32, C-contiguous
        self.M = M
        self.ef_construction = ef_construction

    @classmethod
    def build(cls, vectors, M=16, ef_construction=200, seed=42):
        vectors = _host_rows(vectors)
        lib = hnsw_lib()
        n, d = vectors.shape
        handle = lib.hnsw_build(
            _f32_ptr(vectors), ctypes.c_int64(n), ctypes.c_int64(d),
            ctypes.c_int(M), ctypes.c_int(ef_construction),
            ctypes.c_uint64(seed),
        )
        return cls(handle, vectors, lib, M, ef_construction)

    def search(self, queries, k, ef_search=200, n_probe=None):
        """(nq, d) queries -> (ids (nq, k) int32 [-1 pads], scores (nq, k)
        float32). ``n_probe`` is accepted for the IVF index's signature and
        ignored."""
        queries = _host_rows(queries)
        nq, d = queries.shape
        if d != self.vectors.shape[1]:
            raise ValueError(
                f"query dim {d} != indexed vector dim {self.vectors.shape[1]}"
            )
        k = int(min(k, self.vectors.shape[0]))
        ids = np.empty((nq, k), np.int32)
        scores = np.empty((nq, k), np.float32)
        self._lib.hnsw_search(
            self._handle, _f32_ptr(queries),
            ctypes.c_int64(nq), ctypes.c_int64(d),
            ctypes.c_int(k), ctypes.c_int(max(int(ef_search), k)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _f32_ptr(scores),
        )
        return ids, scores

    def blob(self):
        """The graph's serialized bytes (the ``{name}_graph.bin`` file)."""
        buf = ctypes.create_string_buffer(self._lib.hnsw_blob_size(self._handle))
        self._lib.hnsw_serialize(self._handle, buf)
        return buf.raw

    # ---------------------------------------------------------- persistence
    def save(self, path, name="hnsw"):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / f"{name}_vectors.npy", self.vectors)
        (path / f"{name}_graph.bin").write_bytes(self.blob())

    @classmethod
    def load(cls, path, name="hnsw"):
        path = Path(path)
        vectors = np.ascontiguousarray(
            np.load(path / f"{name}_vectors.npy"), np.float32
        )
        lib = hnsw_lib()
        blob = (path / f"{name}_graph.bin").read_bytes()
        handle = lib.hnsw_deserialize(_f32_ptr(vectors), blob,
                                      ctypes.c_int64(len(blob)))
        return cls(handle, vectors, lib, 16, 200)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.hnsw_free(self._handle)
            self._handle = None
