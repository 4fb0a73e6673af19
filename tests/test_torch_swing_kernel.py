"""Swing's pair-pass kernels (``csrc/swing.cu``) on the card against their
plain PyTorch version, and the wrapper's host planning on the CPU.

The kernels sum each score in 64-bit fixed point (``w * 2^32`` a term), the
plain version the same float32 weights in float64: the scores agree within
rtol 1e-7 plus 2^-32 a term, two calls are bit-identical, and a row block is
the rows of the whole. The top-k is held by ids where no two exact scores
lie within 1e-5 relative. 2000 users are more than the walks' grid on an
H100 (132 SMs x 4 blocks), so their blocks take several users each. The
card tests (``-m cuda``) also reach the hot-row slices, the column tiles of
a wide catalog and the user chunks of a small scratch budget, each checked
by the launches and the plan the call reports. The plain version's CPU tests
are in ``test_torch_cf_models.py``; the kernels' bodies run on the CPU in
``test_torch_swing_emulation.py``.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch


from librecommender_tpu_torch.ops import swing


def _lists(n_users, n_items, density, seed, device, hot_item=None):
    m = sp.random(n_users, n_items, density=density, random_state=seed,
                  format="csr", dtype=np.float32)
    if hot_item is not None:   # in every user's list
        m = m.tolil()
        m[:, hot_item] = 1.0
        m = m.tocsr()
    m.data[:] = 1.0
    return swing.interaction_lists(m, device)


def _launched(calls, chunks=1):
    """The launches of ``calls`` calls of the pass of ``chunks`` user chunks
    each."""
    return {"walk_count": calls, "walk_write": calls * chunks, "rows": calls * chunks}


def _close_to_plain(got, want, alpha, n_items):
    # w >= 1 / (alpha + n_items): at most this many terms a score
    terms = torch.ceil(want * (alpha + n_items))
    return bool((torch.abs(got - want) <= 1e-7 * want.abs() + terms * 2.0 ** -32).all())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("n_users,n_items,density,alpha", [
    (300, 120, 0.1, 1.0), (64, 700, 0.05, 0.5), (500, 60, 0.3, 2.0),
    (2000, 300, 0.03, 1.0)])
def test_swing_kernel_matches_plain(n_users, n_items, density, alpha):
    _cuda()
    lists = _lists(n_users, n_items, density, 0, "cuda")
    swing.reset_launches()
    got = swing.swing_pairs(lists, n_items, alpha)
    again = swing.swing_pairs(lists, n_items, alpha)
    block = swing.swing_pairs(lists, n_items, alpha, (n_items // 3, n_items // 2))
    torch.cuda.synchronize()
    assert swing.kernel_launches == _launched(3)
    assert swing.launches == sum(_launched(3).values())
    want = swing.swing_pairs_plain(lists, n_items, alpha, (0, n_items))
    assert torch.equal(got, again)
    assert torch.equal(block, got[n_items // 3:n_items // 2])
    assert _close_to_plain(got, want, alpha, n_items)
    ids, vals = swing.swing_topk(lists, n_items, alpha, 10)
    plain_ids = swing.topk_of_scores(want, 10)[0].cpu().numpy()
    exact = want.cpu().numpy()
    for r, j in zip(*np.nonzero(ids != plain_ids)):
        a, b = ids[r, j], plain_ids[r, j]
        assert a >= 0 and b >= 0, f"row {r}: a list is shorter on one side"
        assert abs(exact[r, a] - exact[r, b]) <= 1e-5 * abs(exact[r, b])
    np.testing.assert_allclose(vals, np.take_along_axis(
        exact, np.maximum(ids, 0), 1).astype(np.float32) * (ids >= 0), rtol=1e-6)


@pytest.mark.cuda
def test_swing_kernel_hot_row():
    """One item in every user's list: its row holds most of the adds, so the
    rows pass cuts its bucket into slices combined by atomics."""
    _cuda()
    n_items, alpha = 300, 1.0
    lists = _lists(2000, n_items, 0.03, 1, "cuda", hot_item=17)
    swing.reset_launches()
    got = swing.swing_pairs(lists, n_items, alpha)
    torch.cuda.synchronize()
    assert swing.kernel_launches == _launched(1)
    assert swing.last_pass["hot_rows"] >= 1 and swing.last_pass["hot_slices"] > 1
    want = swing.swing_pairs_plain(lists, n_items, alpha, (0, n_items))
    assert _close_to_plain(got, want, alpha, n_items)
    assert torch.equal(got, swing.swing_pairs(lists, n_items, alpha))


@pytest.mark.cuda
def test_swing_kernel_wide_catalog():
    """40,000 items: a row is wider than a block's shared memory, so each is
    summed in column tiles; a 512-row block of the scores is compared (the
    whole table would be 12.8 GB)."""
    _cuda()
    n_items, alpha, rows = 40_000, 1.0, (0, 512)
    lists = _lists(300, n_items, 50 / n_items, 2, "cuda")
    swing.reset_launches()
    got = swing.swing_pairs(lists, n_items, alpha, rows)
    torch.cuda.synchronize()
    assert swing.kernel_launches == _launched(1)
    assert swing.last_pass["col_tiles"] == 2
    assert swing.last_pass["tasks"] >= 2 * int((got != 0).any(1).sum())
    want = swing.swing_pairs_plain(lists, n_items, alpha, rows)
    assert (want != 0).sum() > 0
    assert _close_to_plain(got, want, alpha, n_items)


@pytest.mark.cuda
def test_swing_kernel_small_scratch(monkeypatch):
    """A scratch budget a fraction of the lists' size cuts the users into
    chunks, each adding into the scores: the sums equal the default's bit for
    bit, and so do the top-k lists."""
    _cuda()
    n_items, alpha = 300, 1.0
    lists = _lists(2000, n_items, 0.03, 3, "cuda")
    default = swing.swing_pairs(lists, n_items, alpha)
    ids, vals = swing.swing_topk(lists, n_items, alpha, 10)
    whole = swing.last_pass["entries"] * 8
    monkeypatch.setattr(swing, "SCRATCH_BYTES", whole // 5)
    swing.reset_launches()
    got = swing.swing_pairs(lists, n_items, alpha)
    torch.cuda.synchronize()
    chunks = swing.last_pass["chunks"]
    assert chunks >= 5
    assert swing.kernel_launches == _launched(1, chunks=chunks)
    assert torch.equal(got, default)
    small_ids, small_vals = swing.swing_topk(lists, n_items, alpha, 10)
    np.testing.assert_array_equal(small_ids, ids)
    np.testing.assert_array_equal(small_vals, vals)


# ---------------------------------------------------------- host planning
def test_user_chunks_cover_users_within_budget():
    rng = np.random.default_rng(0)
    entries = rng.integers(0, 50, 200) * rng.integers(2, 9, 200)
    entries[[3, 50, 51]] = 0
    cost = 12 * entries
    for budget in (1, 500, 4000, int(cost.sum()), 10 * int(cost.sum())):
        chunks = swing.user_chunks(entries, budget)
        assert chunks[0][0] == 0 and chunks[-1][1] == 200
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        for u0, u1 in chunks:
            assert u1 > u0
            assert cost[u0:u1].sum() <= budget or u1 == u0 + 1
            if u1 < 200:   # greedy: the next user would not have fitted
                assert cost[u0:u1 + 1].sum() > budget
    assert swing.user_chunks(entries, 10 * int(cost.sum())) == [(0, 200)]
    assert swing.user_chunks([], 100) == []


def _cover(tasks, counts, n_items):
    """Each (row, column) cell's bucket entries, from the tasks: every entry
    of a row's bucket once in each of its column tiles."""
    starts = np.cumsum(counts) - counts
    seen = {}
    for row, col0, cols, k0, k1, _ in tasks:
        for col in range(col0, col0 + cols):
            seen.setdefault((row, col), []).append((k0, k1))
    for (row, col), spans in seen.items():
        spans.sort()
        assert spans[0][0] == starts[row] and spans[-1][1] == starts[row] + counts[row]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    rows = {r for r, _ in seen}
    assert rows == set(np.flatnonzero(counts))
    assert all(len({c for r, c in seen if r == row}) == n_items for row in rows)


@pytest.mark.parametrize("n_items,tile_cols,min_slice", [
    (50, 64, 1 << 16), (50, 16, 1 << 16), (50, 64, 1), (130, 40, 1)])
def test_row_tasks_cover_every_bucket(n_items, tile_cols, min_slice, monkeypatch):
    """Every row with pairs is covered once per column tile, its bucket in
    consecutive slices; a sliced row (and only one) is hot; the tiles span
    the catalog; the heaviest tasks come first."""
    monkeypatch.setattr(swing, "MIN_SLICE_ADDS", min_slice)
    rng = np.random.default_rng(n_items)
    counts = rng.integers(0, 40, n_items)
    counts[[0, 7]] = 0
    counts[3] = 900     # a hot row
    adds = counts * rng.integers(1, 30, n_items)
    adds[3] = 900 * 30
    monkeypatch.setattr(swing, "TILE_COLS", tile_cols)
    tasks, hot_rows = swing.row_tasks(counts, adds, n_items, sms=2)
    assert tasks.dtype == np.int32 and tasks.shape[1] == 6
    _cover(tasks, counts, n_items)
    sliced = {r for r in np.unique(tasks[:, 0])
              if (tasks[:, 0] == r).sum() > -(-n_items // tile_cols)}
    assert set(tasks[tasks[:, 5] == 1, 0]) == sliced
    assert hot_rows == len(sliced)
    assert (3 in sliced) == (min_slice == 1)
    n_tiles = -(-n_items // tile_cols)
    assert tasks[:, 2].max() <= tile_cols
    work = adds[tasks[:, 0]] / n_tiles / np.array(
        [(tasks[:, 0] == r).sum() / n_tiles for r in tasks[:, 0]])
    assert (np.diff(work) <= 1e-9).all()


def test_row_tasks_slices_the_hot_row_of_a_skewed_chunk():
    """A row with a share of the adds above an even share of the card's
    resident blocks is cut into about that many slices."""
    counts = np.full(100, 50)
    adds = np.full(100, 1000)
    adds[42] = 10 ** 7
    counts[42] = 5000
    tasks, hot_rows = swing.row_tasks(counts, adds, 100, sms=132)
    assert hot_rows == 1
    slices = tasks[tasks[:, 0] == 42]
    assert len(slices) > 100 and slices[:, 5].all()
    assert not tasks[tasks[:, 0] != 42, 5].any()
