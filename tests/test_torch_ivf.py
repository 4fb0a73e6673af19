"""The port's IVF index (``librecommender_tpu_torch/retrieval/ivf.py``)
against the JAX package's on the CPU, and on the card against the port on
the CPU.

Tolerances: centroids after 20 Lloyd iterations from the same initial draw
rtol 1e-5 (atol 1e-6 for entries near zero), assignments and inverted lists
equal; searches over one saved index give equal ids, and scores within rtol
1e-5 or, where a score is small against its terms, the rounding bound of two
float32 dot products summed in any order (``2 D 2**-24 sum_d |q_d x_d|``);
recall@10 at least the JAX test's 0.9. The ``cuda`` tests (no JAX
there) hold the build, the search and the three kernels they run (2.1 the
probe, 2.2a the candidates' gather, 2.2b the cluster sums) at the ML-1M
serving width (3706 items, D = 65, C = 60) against the port on the CPU and
the kernels' plain versions.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch.retrieval import IVFIndex
from librecommender_tpu_torch.retrieval import ivf as tivf


def clustered(n=2000, d=32, n_clusters=16, seed=0):
    """``tests/test_ivf.py``'s well-separated clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] + rng.normal(size=(n, d))).astype(np.float32)


def jax_kmeans(items, n_clusters, iters, seed):
    """JAX's ``_kmeans`` and the initial rows it draws from the same key."""
    import jax
    import jax.numpy as jnp

    from librecommender_tpu.retrieval import ivf as jivf

    key = jax.random.PRNGKey(seed)
    init = jax.random.choice(key, items.shape[0], (n_clusters,), replace=False)
    centroids, assign = jivf._kmeans(jnp.asarray(items), n_clusters, iters, key)
    return np.asarray(init), np.asarray(centroids), np.asarray(assign)


@pytest.mark.parametrize("n_clusters,iters", [(16, 20), (16, 1), (7, 20)])
def test_lloyd_from_jax_draw_equals_jax_kmeans(n_clusters, iters):
    items = clustered()
    init, j_cent, j_assign = jax_kmeans(items, n_clusters, iters, seed=0)
    cent, assign = tivf.lloyd(torch.from_numpy(items), init, iters)
    np.testing.assert_allclose(cent.numpy(), j_cent, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(assign.numpy(), j_assign)


def test_inverted_lists_equal_jax():
    """The stable sort gives JAX's Python loop's lists and counts."""
    from librecommender_tpu.retrieval import IVFIndex as JIVFIndex

    items = clustered(n=700, n_clusters=9)
    _, _, j_assign = jax_kmeans(items, 9, 20, seed=3)
    j_index = JIVFIndex.build(items, n_clusters=9, seed=3)
    lists, counts = tivf.inverted_lists(torch.tensor(j_assign), 9)
    np.testing.assert_array_equal(lists.numpy(), np.asarray(j_index.lists))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_index.counts))


def assert_scores(scores, want, queries, items, ids):
    """Padding (-1) scores -inf in both; the rest within rtol 1e-5 or the
    float32 rounding bound of the two dot products."""
    pad = ids < 0
    assert np.isneginf(scores[pad]).all() and np.isneginf(want[pad]).all()
    rows = np.nonzero(~pad)[0]
    terms = np.abs(queries[rows].astype(np.float64)
                   * items[ids[~pad]].astype(np.float64)).sum(1)
    tol = np.maximum(1e-5 * np.abs(want[~pad]),
                     2 * queries.shape[1] * 2.0**-24 * terms)
    assert np.all(np.abs(scores[~pad] - want[~pad]) <= tol)


# (k, n_probe): a normal search, and k past the probed candidates (padded)
SEARCHES = [(10, 6), (5, 4), (200, 2)]


@pytest.mark.parametrize("k,n_probe", SEARCHES)
def test_jax_saved_index_searches_alike_in_port(tmp_path, k, n_probe):
    from librecommender_tpu.retrieval import IVFIndex as JIVFIndex

    items = clustered(n=600)
    queries = clustered(n=32, seed=7)
    j_index = JIVFIndex.build(items, n_clusters=16, seed=0)
    j_index.save(tmp_path)
    t_index = IVFIndex.load(tmp_path, device="cpu")
    assert t_index.n_items == j_index.n_items
    want_ids, want_scores = j_index.search(queries, k, n_probe)
    ids, scores = t_index.search(queries, k, n_probe)
    assert ids.dtype == np.int32 and scores.dtype == np.float32
    np.testing.assert_array_equal(ids, want_ids)
    assert_scores(scores, want_scores, queries, items, ids)
    if k == 200:   # fewer candidates than k: -1 / -inf padding
        assert (ids == -1).any() and np.isneginf(scores[ids == -1]).all()


@pytest.mark.parametrize("k,n_probe", SEARCHES)
def test_port_saved_index_searches_alike_in_jax(tmp_path, k, n_probe):
    from librecommender_tpu.retrieval import IVFIndex as JIVFIndex

    items = clustered(n=600)
    queries = clustered(n=32, seed=7)
    t_index = IVFIndex.build(items, n_clusters=16, seed=0, device="cpu")
    t_index.save(tmp_path)
    j_index = JIVFIndex.load(tmp_path)
    np.testing.assert_array_equal(np.asarray(j_index.lists), t_index.lists.numpy())
    want_ids, want_scores = j_index.search(queries, k, n_probe)
    ids, scores = t_index.search(queries, k, n_probe)
    np.testing.assert_array_equal(ids, want_ids)
    assert_scores(scores, want_scores, queries, items, ids)


def test_port_recall_vs_exact():
    """The port's own builds (its torch draw) hold JAX's recall bar of 0.9,
    on average over eight seeds: one draw of either package can land in a
    worse local optimum (on these vectors JAX's seed 4 reaches 0.84, the
    port's seed 0 0.85)."""
    items = clustered()
    queries = clustered(n=32, seed=7)
    exact = np.argsort(-(queries @ items.T), axis=1)[:, :10]
    recalls = []
    for seed in range(8):
        index = IVFIndex.build(items, n_clusters=16, seed=seed, device="cpu")
        ids, scores = index.search(queries, k=10, n_probe=6)
        recalls.append(np.mean([len(set(ids[r]) & set(exact[r])) / 10
                                for r in range(len(queries))]))
        valid = ids[0] >= 0
        np.testing.assert_allclose(scores[0][valid],
                                   queries[0] @ items[ids[0][valid]].T, rtol=1e-4)
    assert np.mean(recalls) >= 0.9, recalls


def test_build_is_repeatable_and_lists_are_sorted():
    items = clustered(n=500)
    a = IVFIndex.build(items, seed=5, device="cpu")
    b = IVFIndex.build(items, seed=5, device="cpu")
    assert a.centroids.shape[0] == max(4, int(np.sqrt(500)))
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.lists, b.lists)
    lists = a.lists.numpy()
    for row, count in zip(lists, a.counts.numpy()):
        assert (row[count:] == -1).all()
        assert (np.diff(row[:count]) > 0).all()
    assert sorted(lists[lists >= 0].tolist()) == list(range(500))


def test_search_in_user_chunks_equals_one_chunk(monkeypatch):
    items = clustered(n=400)
    queries = clustered(n=19, seed=2)
    index = IVFIndex.build(items, n_clusters=8, seed=1, device="cpu")
    whole = index.search(queries, 7, 3)
    row_bytes = 3 * index.lists.shape[1] * items.shape[1] * 4
    monkeypatch.setattr(tivf, "SEARCH_CHUNK_BYTES", 4 * row_bytes)
    chunked = index.search(torch.from_numpy(queries), 7, 3)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])


def test_ivf_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IVFIndex.build(clustered(n=50))


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")


def _ml1m_width(seed=0):
    """Item rows at the ML-1M serving width (3706 items, embed 64 and a
    bias column) and 256 users."""
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(3706, 65)).astype(np.float32) * 0.3
    users = rng.normal(size=(256, 65)).astype(np.float32) * 0.3
    return items, users


def _near_tie_rows(normed, centroids, a, b):
    """Rows whose assignments differ only between clusters whose cosines
    (float64) lie within 1e-5 relative."""
    cos = normed.double() @ centroids.double().T
    rows = torch.nonzero(a != b)[:, 0]
    ca = cos[rows, a[rows]]
    cb = cos[rows, b[rows]]
    return bool(((ca - cb).abs() <= 1e-5 * torch.maximum(ca.abs(), cb.abs())).all())


@pytest.mark.cuda
def test_ivf_build_and_search_on_card_match_cpu():
    _card()
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops import table_gather as tg

    items, users = _ml1m_width()
    tg.reset_launches()
    card = IVFIndex.build(items, device="cuda")
    torch.cuda.synchronize()
    # 20 Lloyd steps, a segment-sum each
    assert tg.segsum_launches == 20
    cpu = IVFIndex.build(items, device="cpu")
    assert card.centroids.shape[0] == 60
    assert torch.equal(card.lists.cpu(), cpu.lists)
    np.testing.assert_allclose(card.centroids.cpu().numpy(),
                               cpu.centroids.numpy(), rtol=1e-5, atol=1e-6)
    # the search over the same index on both devices
    st.reset_launches()
    tg.reset_launches()
    ids, scores = card.search(users, 10, 8)
    torch.cuda.synchronize()
    assert st.launches == 1 and tg.gather_launches == 1
    want_ids, want_scores = cpu.search(users, 10, 8)
    differ = ids != want_ids
    if differ.any():   # only near-ties may swap
        u = users.astype(np.float64)[np.nonzero(differ)[0]]
        sa = (u * items.astype(np.float64)[ids[differ]]).sum(1)
        sb = (u * items.astype(np.float64)[want_ids[differ]]).sum(1)
        assert np.all(np.abs(sa - sb) <= 1e-5 * np.maximum(np.abs(sa), np.abs(sb)))
    # scores where the ids agree (a swapped pair is held above)
    assert_scores(np.where(differ, -np.inf, scores),
                  np.where(differ, -np.inf, want_scores), users, items,
                  np.where(differ, -1, ids))


@pytest.mark.cuda
def test_ivf_lloyd_step_on_card_matches_cpu():
    """One Lloyd step from the same centroids: assignments equal but for
    near-ties, the cluster sums of one assignment bit-equal (the segment-sum
    kernel against its plain version)."""
    _card()
    items, _ = _ml1m_width(1)
    normed = tivf.normalize_rows(torch.from_numpy(items))
    centroids = normed[tivf.initial_indices(3706, 60, 0)]
    a_cpu = tivf.assign_clusters(normed, centroids)
    a_card = tivf.assign_clusters(normed.cuda(), centroids.cuda()).cpu()
    assert _near_tie_rows(normed, centroids, a_card, a_cpu)
    new_card, sums_card, counts_card = tivf.update_centroids(
        normed.cuda(), centroids.cuda(), a_card.cuda())
    new_cpu, sums_cpu, counts_cpu = tivf.update_centroids(normed, centroids, a_card)
    assert torch.equal(sums_card.cpu(), sums_cpu)
    assert torch.equal(counts_card.cpu(), counts_cpu)
    np.testing.assert_allclose(new_card.cpu().numpy(), new_cpu.numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_ivf_kernels_at_their_shapes_match_plain():
    """2.1 at the probe's shape, 2.2a at the candidates' and 2.2b at the
    cluster sums', against their plain versions; each launches once."""
    _card()
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops import table_gather as tg

    items, users = _ml1m_width(2)
    index = IVFIndex.build(items, device="cpu")
    cent = index.centroids.cuda()
    q = torch.from_numpy(users).cuda()
    st.reset_launches()
    tg.reset_launches()
    ids, sc = st.streaming_topk(q, cent, 8)
    want_ids, want_sc = st.streaming_topk_plain(q.cpu(), cent.cpu(), 8)
    members = index.lists[want_ids.long()].reshape(-1).cuda()
    table = index.item_embeds.cuda()
    rows = tg.table_gather(table, members)
    normed = tivf.normalize_rows(table)
    assign = tivf.assign_clusters(normed, cent)
    sums = tg.segment_sum(assign, normed, 60)
    torch.cuda.synchronize()
    assert (st.launches, tg.gather_launches, tg.segsum_launches) == (1, 1, 1)
    np.testing.assert_array_equal(ids.cpu().numpy(), want_ids.numpy())
    np.testing.assert_allclose(sc.cpu().numpy(), want_sc.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(rows.cpu(), tg.table_gather_plain(table.cpu(), members.cpu()))
    assert torch.equal(sums.cpu(), tg.segment_sum_plain(assign.cpu(), normed.cpu(), 60))
