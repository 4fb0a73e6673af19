"""Swing's pair pass and its per-item top-k.

``swing_pairs`` is the port of the pair pass of ``swing_topk`` in
``librecommender_tpu/native/similarities.cpp`` (host C++ with OpenMP in the
JAX package, no Pallas kernel): for every user pair u < v sharing c >= 2
items, ``w = 1 / (alpha + c)`` (float32) is added to ``score[i, j]`` for every
ordered pair i != j of the shared items. On a CUDA tensor the wrapper
launches the hand-written kernel of ``csrc/swing.cu`` (or raises); on a CPU
tensor it runs the plain PyTorch version beside it, which the CPU tests and
the on-card comparison hold the kernel against.

The kernel sums in 64-bit fixed point (``w * 2^32``, integer atomics), so two
runs are bit-identical; the plain version sums the same float32 weights in
float64. ``swing_topk`` blocks the item rows so that the (rows, n_items)
scratch stays under ``SCRATCH_BYTES``, each block a launch that walks all pairs
again, and orders each row by score (float32, as the C++ keeps them), then
by lower id, padded with -1 / 0.
"""
import ctypes
import functools
import threading

import numpy as np
import torch

#: swing kernel launches so far
launches = 0
_count_lock = threading.Lock()

#: bytes of scratch ``swing_topk`` may hold at once: a block's scores and
#: their sort, and the kernel's per-block work lists
SCRATCH_BYTES = 1 << 30

# fixed-point scale of the kernel's sums
_FIXED = 2.0 ** 32
# resident blocks per SM the kernel's grid aims at (H100: 132 SMs)
_BLOCKS_PER_SM = 4


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


def interaction_lists(interaction, device):
    """(user_indptr int64, user_items int32, item_indptr int64, item_users
    int32) on ``device``: each user's items and each item's users, sorted,
    from a scipy CSR of any values (its stored entries count)."""
    ui = interaction.tocsr().copy()
    ui.sum_duplicates()
    ui.sort_indices()
    iu = ui.T.tocsr()
    iu.sort_indices()

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return (put(ui.indptr, np.int64), put(ui.indices, np.int32),
            put(iu.indptr, np.int64), put(iu.indices, np.int32))


def _check(lists, n_items):
    user_indptr, user_items, item_indptr, item_users = lists
    device = user_items.device
    for t, dtype in zip(lists, (torch.int64, torch.int32, torch.int64, torch.int32)):
        if t.dim() != 1 or t.dtype != dtype or t.device != device:
            raise TypeError(f"swing lists must be 1-D (int64, int32, int64, "
                            f"int32) on one device, got {t.dtype} on {t.device}")
    if item_indptr.shape[0] != n_items + 1:
        raise ValueError(f"item_indptr has {item_indptr.shape[0]} entries for "
                         f"{n_items} items")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"swing_pairs runs on cuda or cpu, not {device}")
    return device


def swing_pairs(lists, n_items, alpha, rows=None):
    """Swing scores of the item rows ``rows = (begin, end)`` (all by default)
    against every item: a (end - begin, n_items) float64 tensor on the
    lists' device; pairs that no user pair shares score 0."""
    device = _check(lists, n_items)
    begin, end = (0, n_items) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= begin <= end <= n_items:
        raise ValueError(f"rows {begin}:{end} outside 0:{n_items}")
    if device.type == "cpu":
        return swing_pairs_plain(lists, n_items, alpha, (begin, end))
    return _swing_cuda(lists, n_items, alpha, begin, end)


def topk_of_scores(scores, k):
    """Each row's k best of a score block (any float dtype), by score as
    float32 (the C++ keeps float32 scores), then lower column; zero scores
    are not candidates. Returns (ids int32 padded with -1, float32 scores
    padded with 0), on the block's device."""
    scores = scores.to(torch.float32)
    keys = torch.where(scores != 0, scores + 0.0, -torch.inf)
    order = torch.argsort(keys, dim=1, descending=True, stable=True)[:, :k]
    valid = torch.gather(keys, 1, order) > -torch.inf
    ids = torch.where(valid, order, -1).to(torch.int32)
    vals = torch.where(valid, torch.gather(scores, 1, order), 0.0)
    pad = k - order.shape[1]
    if pad:
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        vals = torch.nn.functional.pad(vals, (0, pad), value=0.0)
    return ids, vals


def swing_topk(lists, n_items, alpha, k):
    """Each item's k best by Swing score, then lower id: numpy (ids (n_items,
    k) int32 padded with -1, scores float32 padded with 0)."""
    device = lists[1].device
    out_ids = torch.full((n_items, k), -1, dtype=torch.int32, device=device)
    out_vals = torch.zeros((n_items, k), dtype=torch.float32, device=device)
    # per row: the float64 scores, their float32 copy, a sort key and an
    # int64 order
    block = max(1, SCRATCH_BYTES // (32 * max(n_items, 1)))
    for s in range(0, n_items, block):
        e = min(s + block, n_items)
        out_ids[s:e], out_vals[s:e] = topk_of_scores(
            swing_pairs(lists, n_items, alpha, (s, e)), k)
    return out_ids.cpu().numpy(), out_vals.cpu().numpy()


# ------------------------------------------------------------- plain version
def swing_pairs_plain(lists, n_items, alpha, rows):
    """Plain PyTorch version of the pair pass, as ``_swing_fallback`` of
    ``librecommender_tpu/models/swing.py`` walks it, on any device: for each
    user u, its partners v > u sharing c >= 2 of its items add
    ``w = 1 / (alpha + c)`` (float32) over the shared items' ordered pairs,
    summed in float64 as one product a user."""
    user_indptr, user_items, _, _ = lists
    device = user_items.device
    n_users = user_indptr.shape[0] - 1
    ptr = user_indptr.cpu().tolist()
    users = torch.repeat_interleave(torch.arange(n_users, device=device),
                                    user_indptr[1:] - user_indptr[:-1])
    x = torch.zeros(n_users, n_items, device=device)
    x[users, user_items.long()] = 1.0
    begin, end = rows
    scores = torch.zeros(end - begin, n_items, dtype=torch.float64, device=device)
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=device)
    for u in range(n_users):
        items = user_items[ptr[u]:ptr[u + 1]].long()
        if len(items) < 2:
            continue
        sub = x[u + 1:, items]                         # partners x u's items
        c = sub.sum(dim=1)
        keep = c >= 2
        if not bool(keep.any()):
            continue
        y = sub[keep].double()
        w = (1.0 / (alpha32 + c[keep])).double()
        add = y.T @ (w[:, None] * y)                   # (L, L) over u's items
        add.fill_diagonal_(0.0)
        inside = (items >= begin) & (items < end)
        scores[(items[inside] - begin)[:, None], items[None, :]] += add[inside]
    return scores


# ---------------------------------------------------------------- the kernel
@functools.cache
def _kernel():
    from ._build import load

    lib = load("swing")
    fn = lib.swing_pairs
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, ctypes.c_float, i, i, i, p, p, p, i, i, p, p]
    lib.swing_warps.restype = ctypes.c_int
    return fn, lib.swing_warps()


def _swing_cuda(lists, n_items, alpha, begin, end):
    global launches
    user_indptr, user_items, item_indptr, item_users = (t.contiguous() for t in lists)
    fn, warps = _kernel()
    n_users = user_indptr.shape[0] - 1
    device = user_items.device
    acc = torch.zeros((end - begin, n_items), dtype=torch.int64, device=device)
    if n_users < 1 or end == begin:
        return acc.double()
    max_len = max(int((user_indptr[1:] - user_indptr[:-1]).max()), 1)
    # each block's stamp and partner queue (n_users each) and its warps'
    # intersection buffers, within a quarter of SCRATCH_BYTES
    per_block = 4 * (2 * n_users + warps * max_len)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = int(max(1, min(n_users, sms * _BLOCKS_PER_SM,
                          (SCRATCH_BYTES // 4) // per_block)))
    stamp = torch.zeros(grid * n_users, dtype=torch.int32, device=device)
    partners = torch.empty(grid * n_users, dtype=torch.int32, device=device)
    inter = torch.empty(grid * warps * max_len, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(user_indptr.data_ptr(), user_items.data_ptr(), n_users,
                 item_indptr.data_ptr(), item_users.data_ptr(), float(alpha),
                 begin, end, n_items, stamp.data_ptr(), partners.data_ptr(),
                 inter.data_ptr(), max_len, grid, acc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"swing_pairs kernel launch failed: cudaError {err} "
                           f"(users={n_users}, items={n_items}, rows={begin}:{end})")
    with _count_lock:
        launches += 1
    return acc.double() / _FIXED
