"""The row scatter-add of the PyTorch port against the JAX package.

On the CPU the port runs the kernel's plain version; JAX's Pallas kernel
(``ops/pallas_scatter.py``) runs in interpret mode, as
``tests/test_pallas_scatter.py`` runs it. Tolerances are that file's: the
scatter rtol 1e-6, atol 1e-6 (the same f32 values, possibly summed in another
order); the gather's gradient rtol 1e-5, atol 1e-6. The ``cuda`` tests hold
the kernel against its plain version on the card, bit for bit, at the shapes
``chip_smoke.py`` uses; the card's machine has no jax, so this file imports it
only inside the CPU tests.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch.ops import row_scatter as rs
from librecommender_tpu_torch.ops import table_gather as tg


def _ordered_ref(ids, rows, n_rows):
    """numpy's own ordered add (``np.add.at``, ascending n) of the valid ids,
    cut into the plan's segments, whose tables are added in order."""
    _, _, seg_len, _ = tg.staged_plan(n_rows, rows.shape[1], len(ids))
    out = None
    for lo in range(0, max(len(ids), 1), seg_len):
        seg_ids, seg_rows = ids[lo:lo + seg_len], rows[lo:lo + seg_len]
        keep = (seg_ids >= 0) & (seg_ids < n_rows)
        part = np.zeros((n_rows, rows.shape[1]), np.float32)
        np.add.at(part, seg_ids[keep], seg_rows[keep])
        out = part if out is None else out + part
    return out


def _case(seed, n_rows, D, N, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, n_rows if hi is None else hi, N).astype(np.int32)
    rows = rng.normal(size=(N, D)).astype(np.float32)
    return ids, rows


# (n_rows, D, N, ids below): tests/test_pallas_scatter.py's two shapes and
# its gradient test's table with one id per (row, position)
@pytest.mark.parametrize("n_rows,D,N,hi,chunk", [
    (371, 64, 5000, None, 512), (40, 8, 777, 7, 256), (96, 16, 37 * 5, None, 64),
])
def test_scatter_matches_jax_kernel(n_rows, D, N, hi, chunk):
    import jax.numpy as jnp

    from librecommender_tpu.ops import pallas_scatter as ps

    ids, rows = _case(0, n_rows, D, N, hi=hi)
    want = np.asarray(ps.scatter_add_rows(
        jnp.asarray(ids), jnp.asarray(rows), n_rows, chunk=chunk, interpret=True))
    got = rs.scatter_add_rows(torch.from_numpy(ids), torch.from_numpy(rows), n_rows)
    assert got.shape == (n_rows, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if hi is not None:
        assert np.all(got.numpy()[hi:] == 0)  # rows no id touches stay zero
    # ascending n within a segment, the segments in order, bit for bit
    np.testing.assert_array_equal(got.numpy(), _ordered_ref(ids, rows, n_rows))
    plain = np.zeros((n_rows, D), np.float32)
    np.add.at(plain, ids, rows)
    np.testing.assert_allclose(got.numpy(), plain, rtol=1e-6, atol=1e-6)


def test_gather_rows_grad_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from librecommender_tpu.ops import pallas_scatter as ps

    monkeypatch.setattr(ps, "_INTERPRET", True)
    rng = np.random.default_rng(2)
    r, d = 96, 16
    table = rng.normal(size=(r, d)).astype(np.float32)
    ids = rng.integers(0, r, (37, 5)).astype(np.int32)
    cot = rng.normal(size=(37, 5, d)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda t: jnp.sum(ps.gather_rows(t, jnp.asarray(ids)) * jnp.asarray(cot))
    )(jnp.asarray(table)))

    t = torch.from_numpy(table).requires_grad_()
    out = rs.gather_rows(t, torch.from_numpy(ids))
    assert out.shape == (37, 5, d)
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    # and equal to autograd's own gradient of plain indexing
    t2 = torch.from_numpy(table).requires_grad_()
    (t2[torch.from_numpy(ids).long()] * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_scatter_drops_out_of_range_ids_and_takes_no_ids():
    ids, rows = _case(3, 50, 33, 4096, lo=-6, hi=58)
    keep = (ids >= 0) & (ids < 50)
    assert (~keep).any()
    ref = _ordered_ref(ids, rows, 50)
    whole = np.zeros((50, 33), np.float32)
    np.add.at(whole, ids[keep], rows[keep])
    np.testing.assert_allclose(ref, whole, rtol=1e-5, atol=1e-5)  # 8 segments
    for dtype in (torch.int32, torch.int64):
        got = rs.scatter_add_rows(torch.from_numpy(ids).to(dtype),
                                  torch.from_numpy(rows), 50)
        np.testing.assert_array_equal(got.numpy(), ref)
    empty = rs.scatter_add_rows(torch.zeros(0, dtype=torch.int64),
                                torch.zeros((0, 7)), 12)
    assert empty.shape == (12, 7) and not empty.any()


def test_wrapper_rejects_bad_input():
    ids = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError):
        rs.scatter_add_rows(ids, torch.zeros(3, 4, dtype=torch.float64), 10)
    with pytest.raises(TypeError):
        rs.scatter_add_rows(ids.float(), torch.zeros(3, 4), 10)
    with pytest.raises(ValueError):
        rs.scatter_add_rows(ids, torch.zeros(4, 4), 10)
    with pytest.raises(ValueError):
        rs.scatter_add_rows(ids, torch.zeros(3, 4), 0)


# (n_rows, D, N, grid): DIN's history gather, the packed tokens, the JAX
# tests' shapes, D = 33, a 1M-row table (sparse tiles of 256 rows), wide rows,
# and a 16-row vocabulary looked up 32,768 times, whose ids are cut into 64
# segments
@pytest.mark.parametrize("n_rows,D,N,grid", [
    (3712, 64, 81_920, (232, 1, 1)), (3712, 128, 98_304, (232, 1, 1)),
    (371, 64, 5000, (24, 1, 1)), (40, 8, 777, (3, 1, 1)),
    (50, 33, 4096, (4, 1, 8)), (1_000_000, 64, 16_384, (3907, 1, 1)),
    (10, 300, 9000, (1, 3, 9)), (16, 64, 32_768, (1, 1, 64)),
    (12, 7, 0, (1, 1, 1))])
def test_scatter_plan_fits_the_kernel(n_rows, D, N, grid):
    got, cols, seg_len, groups = tg.staged_plan(n_rows, D, N)
    assert got == grid and cols == min(D, tg.MAX_COLS)
    assert got[0] * tg.TILE * groups >= n_rows and got[1] * cols >= D
    assert groups in (1, 2, 4, 8, 16) and (groups == 1 or got[2] == 1)
    if groups > 1:   # few ids a tile, and the grid still fills a card
        assert N * tg.TILE * groups <= tg.SPARSE_HITS * n_rows
        assert got[0] >= tg.SPARSE_BLOCKS
    assert got[2] * seg_len >= N and (got[2] - 1) * seg_len < max(N, 1)
    assert seg_len % tg.SEG_IDS == 0 and got[2] <= 65_535
    if got[0] * got[1] >= tg.FEW_TILES:
        assert got[2] == 1   # one segment: plain index_add_ order
    # the form (partitioned, chunks of ids, workspace bytes) and the shared
    # memory of the add (rings of 32-row chunks, a 256-row tile's sums with
    # groups) and of the place kernel (the chunk's buckets, their state)
    form = tg.staged_form(n_rows, D, N)
    assert form[:3] + (form.work_bytes,) == SCATTER_FORMS[n_rows, D, N]
    _check_form(form, got, cols, groups, seg_len, N)


# (partitioned, chunk, chunks, workspace bytes)
SCATTER_FORMS = {
    (3712, 64, 81_920): (True, 2048, 40, 693_412),
    (3712, 128, 98_304): (True, 2048, 48, 831_908),
    (371, 64, 5000): (False, 0, 0, 0),
    (40, 8, 777): (False, 0, 0, 0),
    (50, 33, 4096): (False, 0, 0, 0),
    (1_000_000, 64, 16_384): (True, 2048, 8, 271_728),
    (10, 300, 9000): (False, 0, 0, 0),
    (16, 64, 32_768): (False, 0, 0, 0),
    (12, 7, 0): (False, 0, 0, 0),
}


def _check_form(form, grid, cols, groups, seg_len, N):
    """A form the kernels take. Partitioned where a segment holds at least
    PART_MIN_IDS ids or a tile PART_MIN_GROUPS groups, with whole-warp chunks
    covering the ids (one chunk up to ONE_CHUNK ids), the workspace of
    staged::workspace_bytes and shared memory within DYN_SMEM; else the scan
    form: no workspace, two chunks of rows staged within 48 KB beside its
    10 KB of lists."""
    assert form.partition == (min(N, seg_len) >= tg.PART_MIN_IDS
                              or groups >= tg.PART_MIN_GROUPS)
    if not form.partition:
        assert form[1:] == (0, 0, 0, 0, 2 * 32 * cols * 4, 0, False)
        assert form.smem + 16 * 128 * 5 + 64 <= 48 * 1024
        return
    nb = grid[0] * grid[2]
    assert form.buckets == nb
    assert form.chunk % 512 == 0 and form.chunk <= tg.MAX_CHUNK_IDS
    assert form.n_chunks * form.chunk >= N > (form.n_chunks - 1) * form.chunk or N == 0
    if N <= tg.ONE_CHUNK:
        assert form.n_chunks == 1
    else:
        assert form.chunk >= tg.PART_IDS
        assert form.n_chunks * nb <= tg.PART_SCAN or form.chunk > tg.PART_IDS
    state = 40 * nb   # two starts (int32) and 16 warps' counts (int16) a bucket
    assert form.on_chip == (13 * form.chunk + state <= tg.DYN_SMEM)
    assert form.work_bytes == (4 * (form.n_chunks * nb + nb + 1 + 2 * N)
                               + (0 if form.on_chip else state * form.n_chunks))
    ring = tg.STAGES * tg.CHUNK_ROWS * cols * 4
    sums = tg.TILE * groups * cols * 4 if groups > 1 else 0
    entries = 2 * tg.ENTRIES * tg.CHUNK_ROWS * 4
    assert form.smem == ring + sums + entries <= tg.DYN_SMEM
    assert form.place_smem == 13 * form.chunk + (state if form.on_chip else 0) <= tg.DYN_SMEM


def test_gate_is_ids_per_row():
    assert rs.use_pallas_grad_scatter((3712, 64), 81_920)
    assert not rs.use_pallas_grad_scatter((3712, 64), 3707)


# ------------------------------------------------------------------- GPU
# (n_rows, D, N, ids from, ids below): DIN's history gather, the packed-token
# table, the long-history shape, the JAX tests' two shapes, D = 33 with
# out-of-range ids, no ids at all, wide rows, DIN's target gather, a 16-row
# vocabulary (ids in segments), many more rows than ids (256-row tiles; the
# skewed case has a run of one id), every id on one row (one tile's hits
# through the ring thousands of times), and N = 4097, one id past a 4096
# boundary (the scan form at this size; the partition's chunks end inside
# buckets at every partitioned shape)
GPU_SHAPES = [
    (3712, 64, 81_920, 0, None), (3712, 128, 98_304, 0, None),
    (3712, 64, 409_600, 0, None), (371, 64, 5000, 0, None),
    (40, 8, 777, 0, 7), (50, 33, 4097, -6, 58), (12, 7, 0, 0, None),
    (20, 300, 9000, 0, None), (3712, 64, 16_384, 0, None),
    (16, 64, 32_768, 0, None), (16, 64, 3707, 0, None),
    (200_000, 64, 8192, 0, None), (3712, 64, 409_600, 5, 6), (3712, 64, 4097, 0, None),
]


def _gpu_case(n_rows, D, N, lo, hi, skewed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    ids, rows = _case(6, n_rows, D, N, lo=lo, hi=hi)
    if skewed and N:
        # popularity falling off by rank, a run of one id, and a hot row
        p = 1.0 / (np.arange(n_rows) + 10.0) ** 0.9
        ids = np.random.default_rng(7).choice(n_rows, N, p=p / p.sum()).astype(np.int32)
        ids[: N // 8] = ids[0]
    return torch.from_numpy(ids).cuda(), torch.from_numpy(rows).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("n_rows,D,N,lo,hi", GPU_SHAPES)
def test_scatter_kernel_bit_equal_on_gpu(n_rows, D, N, lo, hi, skewed):
    ids, rows = _gpu_case(n_rows, D, N, lo, hi, skewed)
    before = rs.launches
    first = rs.scatter_add_rows(ids, rows, n_rows)
    second = rs.scatter_add_rows(ids.long(), rows, n_rows)
    torch.cuda.synchronize()
    assert rs.launches == before + 2
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), rs.scatter_add_rows_plain(ids, rows, n_rows))


@pytest.mark.cuda
def test_gather_rows_autograd_on_gpu():
    ids, rows = _gpu_case(3712, 64, 81_920, 0, None, True)
    table = torch.from_numpy(
        np.random.default_rng(8).normal(size=(3712, 64)).astype(np.float32)
    ).cuda().requires_grad_()
    before = rs.launches
    out = rs.gather_rows(table, ids.view(8192, 10))
    (out * rows.view(8192, 10, 64)).sum().backward()
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    assert torch.equal(out.detach(), table.detach()[ids.long()].view(8192, 10, 64))
    assert torch.equal(table.grad.cpu(), rs.scatter_add_rows_plain(ids, rows, 3712))


# (n_rows, D, N, ids from, ids below, skewed): DIN's history gather and SIM's
# long history (ids by popularity), a 1M-row table (256-row tiles, 3907
# buckets), a 16-row vocabulary (64 segments of 512 ids), ragged ids, and
# 12,289 ids in one bucket (chunks of 2048 ending inside it, the last short)
PARTITION_SHAPES = [
    (3712, 64, 81_920, 0, None, True), (3712, 64, 409_600, 0, None, True),
    (1_000_000, 64, 16_384, 0, None, False), (16, 64, 32_768, 0, None, False),
    (50, 33, 4097, -6, 58, False), (3712, 64, 12_289, 0, 16, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,D,N,lo,hi,skewed", PARTITION_SHAPES)
def test_partition_is_a_stable_sort_on_gpu(n_rows, D, N, lo, hi, skewed):
    """The partition's positions are exactly the indices of a stable sort of
    the valid ids by bucket (segment * row_tiles + row_tile); its rows within
    the tile and the buckets' starts follow."""
    ids, _ = _gpu_case(n_rows, D, N, lo, hi, skewed)
    pos, sub, bstart = tg.staged_partition(ids, n_rows, D)
    (row_tiles, _, _), _, seg_len, groups = tg.staged_plan(n_rows, D, N)
    tile_rows = tg.TILE * groups
    n = torch.arange(N)
    id64 = ids.cpu().long()
    valid = (id64 >= 0) & (id64 < n_rows)
    bucket = (n // seg_len) * row_tiles + id64.clamp(0, n_rows - 1) // tile_rows
    order = torch.sort(bucket[valid], stable=True).indices
    want = n[valid][order]
    assert torch.equal(pos.cpu().long(), want)
    assert torch.equal(sub.cpu().long(), id64[want] % tile_rows)
    n_buckets = int(bstart.shape[0]) - 1
    want_start = torch.zeros(n_buckets + 1, dtype=torch.long)
    want_start[1:] = torch.cumsum(torch.bincount(bucket[valid], minlength=n_buckets), 0)
    assert torch.equal(bstart.cpu().long(), want_start)
