"""Streaming top-k of ``users @ items.T`` without the (U, N) score matrix.

``streaming_topk`` is the port of the TPU kernel
``librecommender_tpu/ops/pallas_topk.py::_topk_kernel``: the k best items of
every user row, descending by score, ties to the lower item id, items with id
``>= n_items`` never returned. On a CUDA tensor it launches the hand-written
kernel of ``csrc/streaming_topk.cu`` (or raises); on a CPU tensor it runs
``streaming_topk_plain``, the plain PyTorch version that the CPU tests and the
on-card comparison hold the kernel against.
"""
import ctypes
import functools
import threading
from contextlib import nullcontext
from typing import NamedTuple

import torch

#: kernel launches so far (one per call that reaches the CUDA kernel)
launches = 0
_count_lock = threading.Lock()

# Must match csrc/streaming_topk.cu.
TILE_N = 128
TILE_DP = 36
ROW_CHOICES = (32, 16, 4)
SMEM_LIMIT = 232_448          # bytes of shared memory a Hopper block may use
SM_SMEM = 233_472             # bytes of shared memory an SM holds, 1 KB a block reserved
HIST_BYTES = 512              # a row's radix counts: 256 buckets of 16 bits
ROW_BYTES = 32 + HIST_BYTES   # a row's state (threshold, count, select) + counts
PASS2_ALL_MAX = 16_384        # pass 2 loads a row's candidates at once up to this
BLOCKS_PER_SM = 2             # pass-1 blocks to aim for, per SM
MIN_CHUNK = 2 * TILE_N        # items a pass-1 block scans, at least
# chunks may hold fewer than k items while a row's n_chunks * k candidates
# stay within this (bench_torch_topk_plans.py)
SHORT_CHUNK_CANDIDATES = 8192

# the plain version scores this many (user, item) pairs at a time
_PLAIN_CHUNK_ELEMS = 1 << 26


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


def _count_launch():
    global launches
    with _count_lock:
        launches += 1


class Plan(NamedTuple):
    rows: int       # user rows per block
    P: int          # per-row buffer of keys: k best + queue
    chunk: int      # items each pass-1 block scans
    n_chunks: int
    smem: int       # pass-1 dynamic shared memory, bytes
    smem2: int      # pass-2 dynamic shared memory, bytes (0: no pass 2)


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def plan(U, n_items, D, k, n_sm):
    """Launch shape for (U, D) users over ``n_items`` items at ``k``.

    Returns a ``Plan(rows, P, chunk, n_chunks, smem, smem2)``: ``rows`` user
    rows per block (the largest of 32/16/4 whose buffers fit in shared memory
    and that does not exceed U rounded up to 4), ``P`` the per-row buffer
    length, and the item chunk each pass-1 block scans, with enough chunks to
    give every SM ``BLOCKS_PER_SM`` blocks (fewer if fewer fit in its shared
    memory: more would run in a second wave), each chunk at least
    ``MIN_CHUNK`` items and at least k unless a row's ``n_chunks * k``
    candidates stay within ``SHORT_CHUNK_CANDIDATES`` (or one chunk covers
    all). Pass 2 holds a row's ``n_chunks * k`` candidates at once (and the k
    it keeps) up to ``PASS2_ALL_MAX``, else a buffer of ``P``.
    """
    if not (1 <= k <= n_items):
        raise ValueError(f"k={k} must lie in [1, n_items={n_items}]")
    # a queue of at least TILE_N / 2 spare slots past one tile's worth
    P = _next_pow2(k + TILE_N + TILE_N // 2)
    d_pad = -(-D // 4) * 4
    u_cap = -(-U // 4) * 4
    rows = smem = None
    for r in ROW_CHOICES:
        need = (r * d_pad + TILE_N * TILE_DP) * 4 + r * (P * 8 + ROW_BYTES)
        if r <= max(u_cap, 4) and need <= SMEM_LIMIT:
            rows, smem = r, need
            break
    if rows is None:
        raise ValueError(f"D={D}, k={k} exceed the kernel's shared memory")
    user_tiles = -(-U // rows)
    # rounded down: a block past what the SMs hold at once runs in a wave of
    # its own
    per_sm = max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))
    want = max(1, per_sm * n_sm // user_tiles)
    # more, shorter chunks lengthen pass 2, which selects from n_chunks * k
    # candidates a row, and a chunk below k hands it every item;
    # bench_torch_topk_plans.py times the alternatives
    most = min(-(-n_items // MIN_CHUNK),
               max(-(-n_items // k), SHORT_CHUNK_CANDIDATES // k))
    n_chunks = max(1, min(want, most))
    chunk = -(-n_items // n_chunks)
    chunk = -(-chunk // TILE_N) * TILE_N
    n_chunks = -(-n_items // chunk)
    smem2 = 0
    if n_chunks > 1 and n_chunks * k <= PASS2_ALL_MAX:
        # every candidate, then the kept keys
        smem2 = 8 * (n_chunks * k + _next_pow2(k)) + ROW_BYTES
    elif n_chunks > 1:
        smem2 = 8 * P + ROW_BYTES
    return Plan(rows, P, chunk, n_chunks, smem, smem2)


def _check(users, items, k, n_items):
    if users.dim() != 2 or items.dim() != 2 or users.shape[1] != items.shape[1]:
        raise ValueError(
            f"users {tuple(users.shape)} and items {tuple(items.shape)} must be "
            "(U, D) and (N, D)"
        )
    if users.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError("streaming_topk takes float32 users and items")
    if users.device != items.device:
        raise ValueError("users and items must be on one device")
    n_items = items.shape[0] if n_items is None else int(n_items)
    if not 0 < n_items <= items.shape[0]:
        raise ValueError(f"n_items={n_items} out of range for {items.shape[0]} rows")
    if not 1 <= int(k) <= n_items:
        raise ValueError(f"k={k} must lie in [1, n_items={n_items}]")
    if users.shape[0] < 1:
        raise ValueError("no user rows")
    return int(k), n_items


def streaming_topk(users, items, k, n_items=None):
    """Top-k of ``users @ items[:n_items].T`` per row.

    users (U, D) f32, items (N, D) f32 on one device; ``n_items`` (default N)
    masks item rows at or past it. Returns (ids (U, k) int32, scores (U, k)
    f32) on that device, best first, ties to the lower id.
    """
    k, n_items = _check(users, items, k, n_items)
    if users.device.type == "cpu":
        return streaming_topk_plain(users, items, k, n_items)
    if users.device.type != "cuda":
        raise ValueError(f"streaming_topk runs on cuda or cpu, not {users.device}")
    return _streaming_topk_cuda(users, items, k, n_items)


@functools.cache
def _kernel():
    from ._build import load

    fn = load("streaming_topk").streaming_topk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
        ctypes.c_void_p] * 4
    return fn


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _streaming_topk_cuda(users, items, k, n_items):
    fn = _kernel()
    users = users.contiguous()
    items = items.contiguous()
    U, D = users.shape
    dev = users.device
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    p = plan(U, n_items, D, k, _sm_count(index))
    # one allocation: the ids, the scores, then (with more than one chunk)
    # pass 1's (U, n_chunks, k) workspace of 64-bit keys
    planes = 2 + 2 * p.n_chunks if p.n_chunks > 1 else 2
    buf = torch.empty((planes, U, k), dtype=torch.int32, device=dev)
    out_i = buf[0]
    out_s = buf[1].view(torch.float32)
    ptr = buf.data_ptr()
    args = (users.data_ptr(), items.data_ptr(), U, n_items, D, k, p.rows, p.P,
            p.chunk, p.n_chunks, ptr + 8 * U * k if planes > 2 else None,
            ptr + 4 * U * k, ptr)
    # the C launcher uses the calling thread's current device
    with nullcontext() if index == current else torch.cuda.device(index):
        err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"streaming_topk kernel launch failed: cudaError {err} "
            f"(U={U}, N={n_items}, D={D}, k={k}, plan={p})"
        )
    _count_launch()
    return out_i, out_s


def streaming_topk_plain(users, items, k, n_items=None):
    """Plain PyTorch version: f32 scores in user chunks (the (U, N) matrix
    stays bounded), then a stable descending sort, which puts the lower id
    first on ties (``torch.topk`` does not promise that order)."""
    k, n_items = _check(users, items, k, n_items)
    items = items[:n_items]
    step = max(1, _PLAIN_CHUNK_ELEMS // n_items)
    ids, scores = [], []
    for u in users.split(step):
        vals, idx = torch.sort(u @ items.T, dim=1, descending=True, stable=True)
        scores.append(vals[:, :k])
        ids.append(idx[:, :k].to(torch.int32))
    return torch.cat(ids), torch.cat(scores)
