"""Streaming top-k of the PyTorch port against the JAX package.

The port runs on the CPU, through the kernel's plain version; JAX's Pallas
kernel runs in interpret mode, as tests/test_pallas_topk.py runs it.
Tolerances: ids exact; scores rtol 1e-5 (two f32 dot products of the same
rows summed in different orders)."""
import numpy as np
import pytest
import torch

RTOL = 1e-5


def _inputs(seed, U, N, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(U, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32))


def _port_topk(users, items, k, n_items=None):
    from librecommender_tpu_torch.ops.streaming_topk import streaming_topk

    ids, scores = streaming_topk(
        torch.from_numpy(users), torch.from_numpy(items), k, n_items=n_items
    )
    return ids.numpy(), scores.numpy()


@pytest.mark.parametrize("shape", [
    (13, 1000, 32, 10), (8, 512, 64, 16), (3, 100, 16, 5),  # test_pallas_topk.py
    (5, 300, 65, 12),   # D = 64 + folded bias column, as BPR serves it
    (4, 200, 16, 1),    # k = 1
    (3, 150, 8, 150),   # k = N
])
def test_plain_topk_matches_pallas(shape):
    from librecommender_tpu.ops.pallas_topk import pallas_topk_padded

    U, N, D, k = shape
    users, items = _inputs(0, U, N, D)
    ids, scores = _port_topk(users, items, k)
    ref_ids, ref_scores = pallas_topk_padded(
        users, items, k, interpret=True, tile_n=256
    )
    assert ids.dtype == np.int32 and ids.shape == (U, k)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=RTOL)


def test_plain_topk_masks_padded_catalog():
    from librecommender_tpu.ops.pallas_topk import pallas_topk_padded

    users, items = _inputs(1, 4, 300, 16)
    ids, scores = _port_topk(users, items, 8, n_items=200)
    ref_ids, ref_scores = pallas_topk_padded(
        users, items, 8, n_items=200, interpret=True, tile_n=256
    )
    assert ids.max() < 200
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=RTOL)


def _tied_inputs(seed, U, n_base, D, copies):
    """Dyadic values (every dot product exact in any order) and each item row
    repeated ``copies`` times at shuffled positions: exact ties."""
    rng = np.random.default_rng(seed)
    users = rng.integers(-4, 5, (U, D)).astype(np.float32) / 4
    base = rng.integers(-4, 5, (n_base, D)).astype(np.float32) / 4
    items = np.repeat(base, copies, axis=0)[rng.permutation(n_base * copies)]
    return users, items


def test_plain_topk_ties_go_to_lower_id():
    from librecommender_tpu.ops.pallas_topk import pallas_topk_padded

    users, items = _tied_inputs(2, 6, 40, 16, 3)
    ids, scores = _port_topk(users, items, 30)
    ref_ids, _ = pallas_topk_padded(users, items, 30, interpret=True, tile_n=256)
    np.testing.assert_array_equal(ids, ref_ids)
    dense = users @ items.T
    np.testing.assert_array_equal(ids, np.argsort(-dense, 1, kind="stable")[:, :30])
    # within a run of equal scores the ids ascend
    same = scores[:, 1:] == scores[:, :-1]
    assert same.any()
    assert (ids[:, 1:][same] > ids[:, :-1][same]).all()


def _consumed_case():
    rng = np.random.default_rng(3)
    U, N, D, n_rec = 7, 60, 16, 10
    users, items = _inputs(3, U, N, D)
    consumed = {u: rng.choice(N, int(rng.integers(0, 20)), replace=False).tolist()
                for u in range(U - 1)}
    # can't-filter passthrough: n_rec + 55 > N, so this row is not filtered
    consumed[U - 1] = rng.choice(N, 55, replace=False).tolist()
    return users, items, n_rec, consumed


def test_pad_consumed_matches_jax():
    from librecommender_tpu.ops.topk import pad_consumed as jax_pad
    from librecommender_tpu_torch.ops.topk import pad_consumed

    _, items, n_rec, consumed = _consumed_case()
    uids = np.arange(len(consumed))
    got = pad_consumed(consumed, uids, n_rec=n_rec, n_items=len(items))
    np.testing.assert_array_equal(
        got, np.asarray(jax_pad(consumed, uids, n_rec=n_rec, n_items=len(items)))
    )
    assert (got[-1] == -1).all()   # the passthrough row is empty
    assert pad_consumed({}, uids) is None


@pytest.mark.parametrize("filter_consumed", [True, False])
def test_topk_from_embeddings_matches_jax(filter_consumed):
    from librecommender_tpu.ops.topk import (
        _streaming_topk as jax_streaming,
        pad_consumed as jax_pad,
        topk_from_embeddings as jax_topk,
    )
    from librecommender_tpu_torch.ops.topk import topk_from_embeddings

    users, items, n_rec, consumed = _consumed_case()
    uids = np.arange(len(users))
    ids, scores = topk_from_embeddings(
        torch.from_numpy(users), torch.from_numpy(items), n_rec,
        user_consumed=consumed, user_ids=uids, filter_consumed=filter_consumed,
    )
    dense_ids, dense_scores = jax_topk(
        users, items, n_rec, user_consumed=consumed, user_ids=uids,
        filter_consumed=filter_consumed,
    )
    np.testing.assert_array_equal(ids, dense_ids)
    np.testing.assert_allclose(scores, dense_scores, rtol=RTOL)
    cons = (jax_pad(consumed, uids, n_rec=n_rec, n_items=len(items))
            if filter_consumed else None)
    s_ids, s_scores = jax_streaming(users, items, n_rec, cons, interpret=True)
    np.testing.assert_array_equal(ids, s_ids)
    np.testing.assert_allclose(scores, s_scores, rtol=RTOL)
    if filter_consumed:
        for u in range(len(users) - 1):
            assert not set(ids[u]) & set(consumed[u])
    # the passthrough row keeps its consumed items among its recommendations
    assert set(ids[-1]) & set(consumed[len(users) - 1])


@pytest.mark.parametrize("U,N,D,k", [
    (1, 3706, 65, 10), (256, 1_000_000, 65, 32), (13, 1000, 32, 10),
    (4, 100_000, 65, 2048), (4096, 1_000_000, 65, 2048), (1, 5, 65, 5),
    (3, 1000, 256, 1000), (4096, 3706, 65, 10),
    (256, 1_000_000, 65, 109), (64, 20_000, 65, 100),  # one pass-1 block an SM
])
def test_kernel_plan_covers_catalog(U, N, D, k):
    from librecommender_tpu_torch.ops.streaming_topk import (
        BLOCKS_PER_SM, HIST_BYTES, MIN_CHUNK, PASS2_ALL_MAX, SHORT_CHUNK_CANDIDATES,
        SM_SMEM, SMEM_LIMIT, TILE_DP, TILE_N, plan,
    )

    p = plan(U, N, D, k, n_sm=132)
    assert p.chunk % TILE_N == 0
    assert (p.n_chunks - 1) * p.chunk < N <= p.n_chunks * p.chunk
    assert p.n_chunks <= -(-N // MIN_CHUNK)
    assert p.chunk >= k or p.n_chunks * k <= SHORT_CHUNK_CANDIDATES
    assert p.P & (p.P - 1) == 0 and p.P >= k + TILE_N
    assert p.smem <= SMEM_LIMIT
    assert p.rows <= max(4, -(-U // 4) * 4)
    # pass 1's blocks fit on the SMs in at most BLOCKS_PER_SM waves
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM // (p.smem + 1024)))
    assert -(-U // p.rows) * p.n_chunks <= max(per_sm * 132, -(-U // p.rows))
    # pass 1 holds, per row, P keys of 8 bytes and the radix counts
    d_pad = -(-D // 4) * 4
    assert p.smem >= (p.rows * d_pad + TILE_N * TILE_DP) * 4 + p.rows * (
        8 * p.P + HIST_BYTES)
    # pass 2 holds a row's candidates (all of them and the kept keys, or a
    # buffer of P) and its radix counts
    if p.n_chunks == 1:
        assert p.smem2 == 0
    else:
        held = p.n_chunks * k if p.n_chunks * k <= PASS2_ALL_MAX else p.P
        assert held >= min(p.n_chunks * k, p.P)
        assert 8 * held + HIST_BYTES <= p.smem2 <= SMEM_LIMIT


def test_streaming_topk_rejects_bad_input():
    from librecommender_tpu_torch.ops.streaming_topk import streaming_topk

    u, i = torch.zeros(2, 4), torch.zeros(10, 4)
    with pytest.raises(ValueError):
        streaming_topk(u, i, 11)
    with pytest.raises(ValueError):
        streaming_topk(u, torch.zeros(10, 5), 3)
    with pytest.raises(TypeError):
        streaming_topk(u.double(), i.double(), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("U,N,D,k", [
    (1, 3706, 65, 10), (13, 1000, 32, 10), (4, 20_000, 65, 2048),
    (64, 5000, 65, 100),
    (4096, 2000, 16, 1), (3, 3000, 256, 2048), (33, 300, 7, 300),  # the limits
])
def test_kernel_matches_plain_on_gpu(U, N, D, k):
    from librecommender_tpu_torch.ops import streaming_topk as st

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    users, items = _tied_inputs(4, U, -(-N // 2), D, 2)
    users = torch.from_numpy(users).cuda()
    items = torch.from_numpy(items[:N]).cuda()
    before = st.launches
    ids, scores = st.streaming_topk(users, items, k)
    torch.cuda.synchronize()
    assert st.launches == before + 1
    ref_ids, ref_scores = st.streaming_topk_plain(users, items, k)
    # dyadic inputs: scores are exact, so ids (ties included) must agree
    torch.testing.assert_close(ids, ref_ids, rtol=0, atol=0)
    torch.testing.assert_close(scores, ref_scores, rtol=0, atol=0)


def _gpu_case(U, N, D, copies, seed=5):
    """Dyadic users and items on the card, each item row repeated
    ``copies`` times: exact scores, so ids must agree exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    users, items = _tied_inputs(seed, U, -(-N // copies), D, copies)
    return torch.from_numpy(users).cuda(), torch.from_numpy(items[:N]).cuda()


def _assert_kernel_equals_plain(users, items, k):
    from librecommender_tpu_torch.ops import streaming_topk as st

    before = st.launches
    ids, scores = st.streaming_topk(users, items, k)
    torch.cuda.synchronize()
    assert st.launches == before + 1
    ref_ids, ref_scores = st.streaming_topk_plain(users, items, k)
    torch.testing.assert_close(ids, ref_ids, rtol=0, atol=0)
    torch.testing.assert_close(scores, ref_scores, rtol=0, atol=0)
    return ids, scores


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 343, 2048, 3706])
def test_kernel_served_shape_on_gpu(k):
    """One served request (U=1) over the ML-1M catalog at BPR's width, every
    k from 1 to the whole catalog."""
    users, items = _gpu_case(1, 3706, 65, 2)
    _assert_kernel_equals_plain(users, items, k)


@pytest.mark.cuda
@pytest.mark.parametrize("U,N,k,copies", [
    (1, 3706, 343, 60),      # runs of ~60 equal scores straddle position k
    (4, 100_000, 2048, 600),
    (40, 6000, 32, 300),     # 32 rows a block
])
def test_kernel_boundary_ties_on_gpu(U, N, k, copies):
    """Runs of equal scores straddle position k: items tied with the k-th
    are left out, and the kept ones must be the lower ids."""
    users, items = _gpu_case(U, N, 65, copies)
    ids, scores = _assert_kernel_equals_plain(users, items, k)
    kth = scores[:, k - 1:k].cpu()
    dense = users.cpu() @ items.cpu().T
    assert bool(((dense == kth).sum(1) > (scores.cpu() == kth).sum(1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("U,N,k", [(2, 3 * 512 + 100, 343), (3, 2 * 2048 + 5, 2048)])
def test_kernel_short_last_chunk_on_gpu(U, N, k):
    """The last chunk holds fewer items than k: pass 1 pads its list with
    sentinels, which pass 2 must never return."""
    from librecommender_tpu_torch.ops.streaming_topk import plan

    users, items = _gpu_case(U, N, 65, 3)
    p = plan(U, N, 65, k, torch.cuda.get_device_properties(0).multi_processor_count)
    assert p.n_chunks > 1 and N - (p.n_chunks - 1) * p.chunk < k
    ids, _ = _assert_kernel_equals_plain(users, items, k)
    assert int(ids.min()) >= 0 and int(ids.max()) < N


@pytest.mark.cuda
@pytest.mark.parametrize("U,N,k", [(1, 3706, 343), (256, 200_000, 32), (4, 100_000, 2048)])
def test_kernel_launches_bit_equal_on_gpu(U, N, k):
    """Two launches on one input give the same bits (the compaction's order
    varies; the final sort erases it)."""
    from librecommender_tpu_torch.ops import streaming_topk as st

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    rng = np.random.default_rng(6)
    users = torch.from_numpy(rng.standard_normal((U, 65), dtype=np.float32)).cuda()
    items = torch.from_numpy(rng.standard_normal((N, 65), dtype=np.float32)).cuda()
    a_ids, a_scores = st.streaming_topk(users, items, k)
    b_ids, b_scores = st.streaming_topk(users, items, k)
    torch.cuda.synchronize()
    assert torch.equal(a_ids, b_ids)
    assert torch.equal(a_scores.view(torch.int32), b_scores.view(torch.int32))
