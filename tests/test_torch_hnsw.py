"""The port's HNSW index (``librecommender_tpu_torch/retrieval/hnsw.py`` on
its own copy of the C++, ``csrc/hnsw.cpp``) against the JAX package's.

The graph depends only on the source, the compiler flags, the seed and the
vectors (the build is single-threaded), and both packages compile the same
source with the same flags: so the serialized graphs must be byte-equal and
the searches equal in ids and scores, exactly.
"""
import ctypes

import numpy as np
import pytest

from librecommender_tpu_torch.ops import _build
from librecommender_tpu_torch.retrieval import hnsw as thnsw
from librecommender_tpu_torch.retrieval.hnsw import HNSWIndex


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(1500, 32)).astype(np.float32)
    queries = rng.normal(size=(60, 32)).astype(np.float32)
    return vecs, queries


def jax_blob(index):
    size = index._lib.hnsw_blob_size(index._handle)
    buf = ctypes.create_string_buffer(size)
    index._lib.hnsw_serialize(index._handle, buf)
    return buf.raw


@pytest.mark.parametrize("M,ef_construction,seed", [(16, 200, 42), (8, 64, 3),
                                                    (5, 20, 1)])
def test_graph_bytes_and_searches_equal_jax(corpus, M, ef_construction, seed):
    from librecommender_tpu.retrieval.hnsw import HNSWIndex as JHNSWIndex

    vecs, queries = corpus
    port = HNSWIndex.build(vecs, M=M, ef_construction=ef_construction, seed=seed)
    jax_ = JHNSWIndex.build(vecs, M=M, ef_construction=ef_construction, seed=seed)
    assert jax_._handle is not None, "the JAX package's native library is missing"
    assert port.blob() == jax_blob(jax_)
    for k, ef in ((10, 200), (5, 16), (3000, 50)):
        ids, scores = port.search(queries, k, ef_search=ef)
        want_ids, want_scores = jax_.search(queries, k, ef_search=ef)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(scores, want_scores)


def test_save_and_load_across_packages(corpus, tmp_path):
    from librecommender_tpu.retrieval.hnsw import HNSWIndex as JHNSWIndex

    vecs, queries = corpus
    port = HNSWIndex.build(vecs[:800], M=8, ef_construction=64, seed=3)
    port.save(tmp_path / "port")
    from_port = JHNSWIndex.load(tmp_path / "port")
    jax_ = JHNSWIndex.build(vecs[:800], M=8, ef_construction=64, seed=3)
    jax_.save(tmp_path / "jax")
    from_jax = HNSWIndex.load(tmp_path / "jax")
    assert from_jax.blob() == port.blob()
    want = port.search(queries, 5, ef_search=64)
    for loaded in (from_port, from_jax, HNSWIndex.load(tmp_path / "port")):
        got = loaded.search(queries, 5, ef_search=64)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_recall_and_true_scores(corpus):
    """``tests/test_hnsw.py``'s bar at the default configuration."""
    vecs, queries = corpus
    index = HNSWIndex.build(vecs, M=16, ef_construction=200, seed=1)
    ids, scores = index.search(queries, 10, ef_search=200)
    exact = np.argsort(-(queries @ vecs.T), axis=1)[:, :10]
    recall = np.mean([len(set(ids[i]) & set(exact[i])) / 10 for i in range(len(ids))])
    assert recall >= 0.9
    np.testing.assert_allclose(scores[0], queries[0] @ vecs[ids[0]].T,
                               rtol=1e-5, atol=1e-5)


def test_query_dim_mismatch_raises(corpus):
    vecs, _ = corpus
    index = HNSWIndex.build(vecs[:300], M=8, ef_construction=64, seed=3)
    with pytest.raises(ValueError, match="dim"):
        index.search(np.zeros((4, vecs.shape[1] + 3), np.float32), 5)


def test_a_failing_compiler_raises(tmp_path, monkeypatch):
    """No brute-force fallback: where the library cannot be built, the
    build raises."""
    monkeypatch.setattr(_build, "GXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    thnsw.hnsw_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
            HNSWIndex.build(np.zeros((10, 4), np.float32))
        monkeypatch.setattr(_build, "GXX", "false")   # runs, exits 1
        with pytest.raises(RuntimeError, match="false failed for hnsw.cpp"):
            HNSWIndex.build(np.zeros((10, 4), np.float32))
    finally:
        thnsw.hnsw_lib.cache_clear()
