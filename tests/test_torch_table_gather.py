"""Table gather and segment-sum of the PyTorch port against the JAX package.

On the CPU the port runs the kernels' plain versions; JAX's Pallas kernels
(``ops/mxu_gather.py``, ``parity/bench_scatter.py``) run in interpret mode,
as ``tests/test_mxu_gather.py`` runs them. Tolerances: the gather is exact;
segment sums rtol 1e-6 (the same f32 values summed in another order); the
VJP rtol 1e-5, as in ``tests/test_mxu_gather.py``. The ``cuda`` tests hold
each kernel against its plain version on the card, bit for bit, at the
shapes ``chip_smoke.py`` uses; the card's machine has no jax, so this file
imports it only inside the CPU tests.
"""
import numpy as np
import pytest
import torch

from librecommender_tpu_torch.ops import table_gather as tg

from .test_torch_row_scatter import _check_form


def _case(seed, R, D, B, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R, D)).astype(np.float32)
    ids = rng.integers(lo, R if hi is None else hi, B).astype(np.int32)
    vals = rng.normal(size=(B, D)).astype(np.float32)
    return table, ids, vals


def test_gather_matches_jax_kernel():
    import jax.numpy as jnp

    from librecommender_tpu.ops.mxu_gather import mxu_gather

    table, ids, _ = _case(0, 384, 65, 256, lo=-20, hi=420)  # some out of range
    assert ((ids < 0) | (ids >= 384)).any()
    want = np.asarray(mxu_gather(jnp.asarray(table), jnp.asarray(ids)))
    got = tg.table_gather(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[(ids < 0) | (ids >= 384)] == 0).all()


@pytest.mark.parametrize("R,D,B", [(384, 65, 512), (256, 33, 256), (128, 64, 1024)])
def test_segment_sum_matches_jax_kernel(R, D, B):
    import jax.numpy as jnp

    from librecommender_tpu.ops.mxu_gather import segment_sum_mxu

    _, ids, vals = _case(1, R, D, B, lo=-5, hi=R + 9)
    want = np.asarray(segment_sum_mxu(jnp.asarray(ids), jnp.asarray(vals), R))
    got = tg.segment_sum(torch.from_numpy(ids), torch.from_numpy(vals), R)
    assert got.shape == (R, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_segment_sum_bf16_matches_bench_scatter(monkeypatch):
    """``pallas_segsum`` passes no ``interpret`` to ``pl.pallas_call``; the
    test runs it in interpret mode without editing the file."""
    import functools
    from types import SimpleNamespace

    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from parity import bench_scatter

    monkeypatch.setattr(bench_scatter, "pl", SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        program_id=pl.program_id, BlockSpec=pl.BlockSpec))
    _, ids, vals = _case(2, 384, 64, 256)
    for dtype, vals_dtype in ((jnp.bfloat16, torch.bfloat16),
                              (jnp.float32, torch.float32)):
        want = np.asarray(bench_scatter.pallas_segsum(
            jnp.asarray(ids), jnp.asarray(vals), 384, dtype=dtype))
        got = tg.segment_sum(torch.from_numpy(ids), torch.from_numpy(vals), 384,
                             vals_dtype=vals_dtype)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    rounded = torch.from_numpy(vals).to(torch.bfloat16).float()
    assert not torch.equal(rounded, torch.from_numpy(vals))


def test_vjp_matches_jax_grad():
    import jax
    import jax.numpy as jnp

    from librecommender_tpu.ops.mxu_gather import mxu_gather

    table, ids, _ = _case(3, 384, 33, 256, hi=300)
    want = jax.grad(lambda t: jnp.sum(mxu_gather(t, jnp.asarray(ids)) ** 2))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    (tg.TableGather.apply(t, torch.from_numpy(ids)) ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_segment_sum_adds_in_batch_order():
    """The plain version (CPU ``index_add_``) adds each row's values in
    ascending batch order: bit-equal to ``np.add.at``, which does, with many
    duplicates per row. A table of many tiles is one segment; a small one has
    its ids cut into the plan's segments, whose tables are added in order."""
    for R, B, segs in ((1100, 65_536, 1), (50, 8192, 16)):
        _, ids, vals = _case(4, R, 64, B, lo=-3, hi=R + 3)
        (_, _, n_segs), _, seg_len, _ = tg.staged_plan(R, 64, B)
        assert n_segs == segs
        ref = np.zeros((R, 64), np.float32)
        for lo in range(0, B, seg_len):
            seg_ids, seg_vals = ids[lo:lo + seg_len], vals[lo:lo + seg_len]
            keep = (seg_ids >= 0) & (seg_ids < R)
            part = np.zeros((R, 64), np.float32)
            np.add.at(part, seg_ids[keep], seg_vals[keep])
            ref = part if lo == 0 else ref + part
        got = tg.segment_sum_plain(torch.from_numpy(ids), torch.from_numpy(vals), R)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_table_lookup_shapes_and_plain_indexing():
    table, _, _ = _case(5, 40, 16, 1)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 40, (64, 3)))
    t = torch.from_numpy(table)
    for use_kernel in (True, False):
        out = tg.table_lookup(t, ids, use_kernel)
        assert out.shape == (64, 3, 16)
        np.testing.assert_array_equal(out.numpy(), table[ids.numpy()])


def test_wrappers_reject_bad_input():
    t = torch.zeros(10, 4)
    with pytest.raises(TypeError):
        tg.table_gather(t, torch.zeros(3, dtype=torch.float32))
    with pytest.raises(TypeError):
        tg.table_gather(t.double(), torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        tg.segment_sum(torch.zeros(3, dtype=torch.int64), torch.zeros(4, 4), 10)
    with pytest.raises(TypeError):
        tg.segment_sum(torch.zeros(3, dtype=torch.int64), torch.zeros(3, 4), 10,
                       vals_dtype=torch.float16)
    with pytest.raises(ValueError):
        tg.segment_sum(torch.zeros(3, dtype=torch.int64), torch.zeros(3, 4), 0)


# (partitioned, chunk, chunks, workspace bytes) at 0, 77, 8192 and 32,768 ids
SEGSUM_FORMS = {
    (6048, 64): {0: (False, 0, 0, 0), 77: (False, 0, 0, 0),
                 8192: (False, 0, 0, 0), 32_768: (True, 2048, 16, 287_852)},
    (3712, 65): {0: (False, 0, 0, 0), 77: (False, 0, 0, 0),
                 8192: (False, 0, 0, 0), 32_768: (True, 2048, 16, 277_924)},
    (131, 33): {0: (False, 0, 0, 0), 77: (False, 0, 0, 0),
                8192: (False, 0, 0, 0), 32_768: (False, 0, 0, 0)},
    (1_000_000, 64): {0: (True, 512, 1, 31_260), 77: (True, 512, 1, 31_876),
                      8192: (True, 8192, 1, 253_076), 32_768: (True, 2048, 16, 527_824)},
    (10, 300): {0: (False, 0, 0, 0), 77: (False, 0, 0, 0),
                8192: (False, 0, 0, 0), 32_768: (False, 0, 0, 0)},
    (131_072, 64): {0: (True, 512, 1, 4100), 77: (True, 512, 1, 4716),
                    8192: (True, 8192, 1, 69_636), 32_768: (True, 2048, 16, 331_780)},
}


@pytest.mark.parametrize("R,D", [(6048, 64), (3712, 65), (131, 33), (1_000_000, 64),
                                 (10, 300), (131_072, 64)])
def test_segsum_plan_fits_the_kernel(R, D):
    for B in (0, 77, 8192, 32_768):
        (row_tiles, col_tiles, segs), cols, seg_len, groups = tg.staged_plan(R, D, B)
        assert 1 <= groups <= tg.MAX_GROUPS and groups & (groups - 1) == 0
        assert row_tiles * tg.TILE * groups >= R and cols == min(D, tg.MAX_COLS)
        if groups > 1:   # many more rows than ids: larger tiles, a full grid
            assert segs == 1 and row_tiles >= tg.SPARSE_BLOCKS
            assert B * tg.TILE * groups <= tg.SPARSE_HITS * R
        if R == 1_000_000:
            assert groups == tg.MAX_GROUPS
        assert col_tiles * cols >= D and 1 <= segs <= 65_535
        assert segs * seg_len >= B and seg_len % tg.SEG_IDS == 0
        # the form (partitioned, chunks of ids, workspace bytes) and the
        # shared memory of the add and of the place kernel
        form = tg.staged_form(R, D, B)
        assert form[:3] + (form.work_bytes,) == SEGSUM_FORMS[R, D][B]
        _check_form(form, (row_tiles, col_tiles, segs), cols, groups, seg_len, B)
        if row_tiles * col_tiles >= tg.FEW_TILES:
            assert segs == 1   # BPR's tables: plain index_add_ order
        elif B // row_tiles >= 2 * tg.SEG_IDS:
            assert segs > 1    # a small table's ids are spread over blocks


# ------------------------------------------------------------------- GPU
# (R, D, B, out of range and duplicates, or "hot": every id on one row): the
# main path's two tables, a ragged shape, small tables whose ids go in
# segments (a 16-row vocabulary), sparse tiles with a run of one id, the
# bench_scatter shapes, a 1M-row table, every id on one row (one tile's hits
# through the ring thousands of times), and N = 4097, one id past a 4096
# boundary (the scan form at this size; the partition's chunks end inside
# buckets at every partitioned shape)
GPU_SHAPES = [
    (6048, 64, 8192, False), (3712, 65, 8192, False), (131, 33, 77, True),
    (16, 64, 32_768, False), (16, 64, 3707, True), (300, 200, 20_000, True),
    (200_000, 64, 8192, True),
    (3712, 64, 8192, False), (6144, 64, 8192, False), (16384, 64, 8192, False),
    (131_072, 64, 8192, False), (1_000_000, 64, 16384, False),
    (3712, 64, 409_600, "hot"), (3712, 64, 4097, False),
]


def _gpu_case(R, D, B, ragged):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    _, ids, vals = _case(6, R, D, B, lo=-4 if ragged else 0,
                         hi=R + 5 if ragged else None)
    if ragged == "hot":
        ids[:] = 5
    elif ragged:
        ids[: max(20, B // 4)] = ids[0]  # a run of duplicates
    table = np.random.default_rng(7).normal(size=(R, D)).astype(np.float32)
    return (torch.from_numpy(table).cuda(), torch.from_numpy(ids).cuda(),
            torch.from_numpy(vals).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("R,D,B,ragged", GPU_SHAPES)
def test_gather_kernel_matches_plain_on_gpu(R, D, B, ragged):
    table, ids, _ = _gpu_case(R, D, B, ragged)
    before = tg.gather_launches
    out = tg.table_gather(table, ids)
    torch.cuda.synchronize()
    assert tg.gather_launches == before + 1
    torch.testing.assert_close(out, tg.table_gather_plain(table, ids), rtol=0, atol=0)
    torch.testing.assert_close(tg.table_gather(table, ids.long()), out, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D,B,ragged", GPU_SHAPES)
def test_segment_sum_kernel_bit_equal_on_gpu(R, D, B, ragged, vals_dtype):
    _, ids, vals = _gpu_case(R, D, B, ragged)
    counter = ("segsum_bf16_launches" if vals_dtype == torch.bfloat16
               else "segsum_launches")
    before = getattr(tg, counter)
    first = tg.segment_sum(ids, vals, R, vals_dtype=vals_dtype)
    second = tg.segment_sum(ids, vals, R, vals_dtype=vals_dtype)
    torch.cuda.synchronize()
    assert getattr(tg, counter) == before + 2
    assert torch.equal(first, second)
    want = tg.segment_sum_plain(ids, vals, R, vals_dtype=vals_dtype)
    assert torch.equal(first.cpu(), want)


@pytest.mark.cuda
def test_table_gather_autograd_on_gpu():
    table, ids, _ = _gpu_case(3712, 65, 8192, False)
    table.requires_grad_()
    before = (tg.gather_launches, tg.segsum_launches)
    (tg.table_lookup(table, ids.view(-1, 2), True) ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (tg.gather_launches, tg.segsum_launches) == (before[0] + 1, before[1] + 1)
    want = tg.segment_sum_plain(ids, 2 * table.detach()[ids.long()], 3712)
    assert torch.equal(table.grad.cpu(), want)
