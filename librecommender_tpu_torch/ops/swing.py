"""Swing's pair pass and its per-item top-k.

``swing_pairs`` is the port of the pair pass of ``swing_topk`` in
``librecommender_tpu/native/similarities.cpp:396`` (host C++ with OpenMP in
the JAX package, no Pallas kernel): for every user pair u < v sharing c >= 2
items, ``w = 1 / (alpha + c)`` (float32) is added to ``score[i, j]`` for every
ordered pair i != j of the shared items. On a CUDA tensor the wrapper
launches the hand-written kernels of ``csrc/swing.cu`` (or raises); on a CPU
tensor it runs the plain PyTorch version beside it, which the CPU tests and
the on-card comparison hold the kernels against.

What bounds the pass on an H100 is its adds (8.3e9 at ML-1M's size into a
dense 3706 x 3706 table). The kernels make none of them in device memory:
a walk over the users writes each pair's shared items into one list and
files the pair under each of those items' rows, and a block sums each row
in shared memory and writes it once (``csrc/swing_pass.cuh``). A count walk
before it sizes the lists and the buckets, and the host plans from its
counts: ``user_chunks`` cuts the users so that a chunk's lists and buckets
fit what the int64 output leaves of ``SCRATCH_BYTES``, and ``row_tasks``
cuts the rows pass into blocks (column tiles of a wide catalog, slices of a
hot row's bucket).

The kernels sum in 64-bit fixed point (``w * 2^32`` a term, integer adds),
so two runs are bit-identical; the plain version sums the same float32
weights in float64. ``swing_topk`` blocks the item rows so that the
(rows, n_items) scores and their sort stay under ``SCRATCH_BYTES``, and
orders each row by score (float32, as the C++ keeps them), then by lower id,
padded with -1 / 0.
"""
import ctypes
import functools
import threading

import numpy as np
import torch

#: the pass's kernels: a count walk, then a write walk and a rows pass a
#: chunk of users
KERNELS = ("walk_count", "walk_write", "rows")
#: kernel launches so far, in all and by kernel
launches = 0
kernel_launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()
#: what the last call of the kernels did: pairs, list entries, peak scratch
#: bytes, user chunks, rows-pass tasks, hot rows and their slices, column
#: tiles
last_pass = {}

#: bytes of scratch a call may hold at once: ``swing_topk``'s block of
#: scores and their sort, and while the kernels run, their int64 output and a
#: chunk's lists and buckets in what the output leaves (at least a quarter).
#: 4 GiB of an 80 GB card, so that ML-1M's 2.5 GB of lists and buckets are
#: one chunk
SCRATCH_BYTES = 1 << 32
#: partners a walk block counts at once: 16 bytes each of shared memory
PARTNER_TILE = 2048
#: columns of a rows-pass tile: 8 bytes each in a block's 227 KB (H100)
TILE_COLS = 232448 // 8
#: least adds a rows-pass block is given before a hot row is sliced
MIN_SLICE_ADDS = 1 << 16

# fixed-point scale of the kernels' sums
_FIXED = 2.0 ** 32
# resident blocks per SM the walks' grid aims at (H100: 132 SMs); an SM's
# shared memory and its resident blocks at most
_BLOCKS_PER_SM = 4
_SMEM_PER_SM = 233472
_MAX_BLOCKS_PER_SM = 8


def reset_launches():
    global launches
    with _count_lock:
        launches = 0
        for name in KERNELS:
            kernel_launches[name] = 0


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
    # 32 bytes a score: while the kernels run, their int64 sums (a quarter)
    # and the lists and buckets in the rest; then the float64 scores, their
    # float32 copy, a sort key and an int64 order
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


# ------------------------------------------------------------ host planning
def user_chunks(entries, budget):
    """Consecutive user ranges [(u0, u1), ...] covering every user, each
    holding lists and buckets (4 bytes a list entry, 8 a bucket entry) of at
    most ``budget`` bytes, from each user's list ``entries``; a user over
    the budget is a chunk of its own."""
    cost = np.cumsum(12 * np.asarray(entries, np.int64))
    n, chunks, u0 = len(cost), [], 0
    while u0 < n:
        spent = cost[u0 - 1] if u0 else 0
        u1 = max(int(np.searchsorted(cost, spent + budget, side="right")), u0 + 1)
        chunks.append((u0, u1))
        u0 = u1
    return chunks


def row_tasks(counts, adds, n_items, sms):
    """The rows pass's blocks for one chunk: an int32 (tasks, 6) array of
    (row, first column, columns, bucket slice start, end, hot), heaviest
    first, and the number of hot rows.

    ``counts`` and ``adds`` are each row's bucket size and adds (the buckets
    lie row after row). A row with pairs is cut into column tiles of at most
    ``TILE_COLS`` columns; a tile whose adds exceed an even share of the card
    (the adds over its resident blocks, at least ``MIN_SLICE_ADDS``) is hot
    and its bucket is cut into that many slices of equal pair counts, whose
    partial rows the kernel combines with atomics."""
    counts = np.asarray(counts, np.int64)
    adds = np.asarray(adds, np.int64)
    starts = np.cumsum(counts) - counts
    n_tiles = -(-n_items // TILE_COLS)
    width = -(-n_items // n_tiles)
    resident = sms * max(1, min(_MAX_BLOCKS_PER_SM, _SMEM_PER_SM // (8 * width + 1024)))
    target = max(-(-int(adds.sum()) // resident), MIN_SLICE_ADDS)
    rows = np.flatnonzero(counts)
    r = np.repeat(rows, n_tiles)
    tile = np.tile(np.arange(n_tiles), len(rows))
    est = adds[r] / n_tiles
    slices = np.minimum(counts[r], np.maximum(1, np.ceil(est / target))).astype(np.int64)
    r, tile, est, n = (np.repeat(a, slices) for a in (r, tile, est, slices))
    s = np.arange(len(r)) - np.repeat(np.cumsum(slices) - slices, slices)
    k0 = starts[r] + counts[r] * s // n
    k1 = starts[r] + counts[r] * (s + 1) // n
    col0 = tile * width
    tasks = np.stack([r, col0, np.minimum(width, n_items - col0), k0, k1, n > 1], 1)
    order = np.argsort(-est / n, kind="stable")
    return tasks[order].astype(np.int32), int(len(np.unique(r[n > 1])))


# ---------------------------------------------------------------- the kernels
class _Kernels:
    """The C launchers of ``csrc/swing.cu`` (or a library with the same C
    interface) with their argument types."""

    def __init__(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        self.walk, self.rows = lib.swing_walk, lib.swing_rows
        self.walk.argtypes = [i, p, p, i, p, p, i, i, i, i, i, p, p, p, p, p, p, p,
                              p, i, p]
        self.rows.argtypes = [p, i, p, p, ctypes.c_float, i, i, i, p, p]
        for fn in (self.walk, self.rows):
            fn.restype = ctypes.c_int


@functools.cache
def _kernels():
    from ._build import load

    return _Kernels(load("swing"))


def _swing_sums(lists, n_items, alpha, begin, end, kernels, sms, stream):
    """The fixed-point sums (int64, ``w * 2^32`` a term) of rows [begin, end)
    by the pass's kernels on the lists' device, and what the pass did."""
    user_indptr, user_items, item_indptr, item_users = (t.contiguous() for t in lists)
    device = user_items.device
    n_users = user_indptr.shape[0] - 1
    out = torch.zeros((end - begin, n_items), dtype=torch.int64, device=device)
    stats = dict(pairs=0, entries=0, scratch_bytes=0, chunks=0, tasks=0, hot_rows=0,
                 hot_slices=0, col_tiles=-(-n_items // TILE_COLS))
    if n_users < 1 or end == begin:
        return out, stats

    def launch(name, fn, *args):
        global launches
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"swing {name} kernel launch failed: cudaError {err} (users="
                f"{n_users}, items={n_items}, rows={begin}:{end})")
        with _count_lock:
            launches += 1
            kernel_launches[name] += 1

    rows = end - begin
    lists_in = (user_indptr.data_ptr(), user_items.data_ptr(), n_users,
                item_indptr.data_ptr(), item_users.data_ptr(), begin, end)
    grid = int(max(1, min(n_users, sms * _BLOCKS_PER_SM)))
    per_user = torch.zeros((2, n_users), dtype=torch.int64, device=device)
    ui_count = torch.zeros(user_items.shape[0], dtype=torch.int32, device=device)
    ui_adds = torch.zeros(user_items.shape[0], dtype=torch.int64, device=device)
    launch("walk_count", kernels.walk, 0, *lists_in, 0, n_users, PARTNER_TILE,
           per_user[0].data_ptr(), per_user[1].data_ptr(), ui_count.data_ptr(),
           ui_adds.data_ptr(), None, None, None, None, grid, stream)
    entry_base = torch.zeros(n_users + 1, dtype=torch.int64, device=device)
    torch.cumsum(per_user[1], 0, out=entry_base[1:])
    pairs_h, entries_h = per_user.cpu().numpy()
    budget = max(SCRATCH_BYTES - out.numel() * 8, SCRATCH_BYTES // 4)
    chunks = [(u0, u1) for u0, u1 in user_chunks(entries_h, budget)
              if pairs_h[u0:u1].any()]
    if not chunks:
        return out, stats
    # each chunk's bucket entries and adds by row, from its interactions
    user_ptr = user_indptr.cpu().numpy()
    at = (user_items.long() - begin).clamp_(0, rows - 1)   # other items count 0
    by_row = torch.zeros((2, len(chunks), rows), dtype=torch.int64, device=device)
    for n, (u0, u1) in enumerate(chunks):
        s, e = int(user_ptr[u0]), int(user_ptr[u1])
        by_row[0, n].index_add_(0, at[s:e], ui_count[s:e].long())
        by_row[1, n].index_add_(0, at[s:e], ui_adds[s:e])
    counts_h, adds_h = by_row.cpu().numpy()
    plans = []
    for n, (u0, u1) in enumerate(chunks):
        n_entries = int(entries_h[u0:u1].sum())
        if n_entries >= 2 ** 31:
            raise RuntimeError(f"swing: {n_entries} list entries in one chunk of "
                               f"users ({u0}:{u1}), more than int32 offsets hold")
        tasks, hot_rows = row_tasks(counts_h[n], adds_h[n], n_items, sms)
        plans.append((n_entries, tasks))
        stats["pairs"] += int(pairs_h[u0:u1].sum())
        stats["entries"] += n_entries
        stats["tasks"] += len(tasks)
        stats["hot_rows"] += hot_rows
        stats["hot_slices"] += int(tasks[:, 5].sum())
    stats["chunks"] = len(chunks)
    # the plans go up before the first launch that needs them, so that the
    # chunks' launches follow one another without the host
    cursors = torch.as_tensor((np.cumsum(counts_h, 1) - counts_h).astype(np.int32),
                              device=device)
    tasks_d = [torch.as_tensor(tasks, device=device) for _, tasks in plans]
    for n, (u0, u1) in enumerate(chunks):
        n_entries, tasks = plans[n]
        entries = torch.empty(n_entries, dtype=torch.int32, device=device)
        bucket = torch.empty(int(counts_h[n].sum()), dtype=torch.int64, device=device)
        launch("walk_write", kernels.walk, 1, *lists_in, u0, u1, PARTNER_TILE, None,
               None, None, None, entry_base.data_ptr(), entries.data_ptr(),
               cursors[n].data_ptr(), bucket.data_ptr(), grid, stream)
        launch("rows", kernels.rows, tasks_d[n].data_ptr(), len(tasks),
               bucket.data_ptr(), entries.data_ptr(), float(alpha), begin, n_items,
               int(tasks[:, 2].max()), out.data_ptr(), stream)
        held = sum(t.numel() * t.element_size() for t in (
            out, per_user, ui_count, ui_adds, entry_base, at, by_row, cursors,
            entries, bucket, *tasks_d))
        stats["scratch_bytes"] = max(stats["scratch_bytes"], held)
    return out, stats


def fixed_sums_cuda(lists, n_items, alpha, begin, end):
    """The kernels' int64 sums (``w * 2^32`` a term) of rows [begin, end),
    on the lists' CUDA device; ``last_pass`` says what the call did."""
    global last_pass
    device = lists[1].device
    kernels = _kernels()
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        stream = torch.cuda.current_stream(device).cuda_stream
        sums, last_pass = _swing_sums(lists, n_items, alpha, begin, end, kernels,
                                      sms, stream)
    return sums


def _swing_cuda(lists, n_items, alpha, begin, end):
    return fixed_sums_cuda(lists, n_items, alpha, begin, end).double() / _FIXED
