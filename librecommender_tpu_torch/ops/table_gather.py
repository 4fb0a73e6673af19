"""Embedding-table gather and its deterministic segment-sum.

``table_gather`` is the port of the TPU kernel
``librecommender_tpu/ops/mxu_gather.py::_gather_kernel`` and
``segment_sum`` the port of ``_segsum_kernel`` there; with
``vals_dtype=torch.bfloat16`` it is also the port of
``parity/bench_scatter.py::pallas_segsum``'s kernel. ``TableGather`` ties the
two together as ``mxu_gather``'s custom VJP does: its forward is the gather,
its backward the segment-sum. On a CUDA tensor each wrapper launches its
hand-written kernel of ``csrc/table_gather.cu`` (or raises); on a CPU tensor
it runs the plain PyTorch version beside it, which the CPU tests and the
on-card comparison hold the kernel against.

The segment-sum adds each output row's values in ascending batch order, the
order of ``index_add_`` on the CPU. A table of few rows has its ids cut into
fixed segments (``staged_plan``: a function of the shapes only), each summed
so and the segments' tables added in order; the plain version makes the same
cut. So the kernel agrees with its plain version bit for bit and a training
run repeats exactly.
"""
import ctypes
import functools
import threading

import torch

#: gather kernel launches so far
gather_launches = 0
#: segment-sum kernel launches so far, float32 values
segsum_launches = 0
#: segment-sum kernel launches so far, values rounded to bf16
segsum_bf16_launches = 0
_count_lock = threading.Lock()

# Must match csrc/staged_add.cuh.
TILE = 16                     # output rows a block owns, one a warp
MAX_COLS = 128                # columns a block owns
MAX_IDS = 0x3FFFFFFF - 8192
# The cut into segments: a table of fewer than FEW_TILES tiles, with at least
# 2 * SEG_IDS ids to a row tile, gets about SEG_BLOCKS blocks, a segment never
# shorter than SEG_IDS ids.
FEW_TILES, SEG_BLOCKS, SEG_IDS = 64, 128, 512
# Sparse tiles: a block owns up to MAX_GROUPS * TILE rows while it still
# expects at most SPARSE_HITS ids in them and the grid keeps SPARSE_BLOCKS.
MAX_GROUPS, SPARSE_HITS, SPARSE_BLOCKS = 16, 32, 256

_VALS_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches():
    global gather_launches, segsum_launches, segsum_bf16_launches
    with _count_lock:
        gather_launches = segsum_launches = segsum_bf16_launches = 0


def _count(kind):
    global gather_launches, segsum_launches, segsum_bf16_launches
    with _count_lock:
        if kind == "gather":
            gather_launches += 1
        elif kind == "segsum":
            segsum_launches += 1
        else:
            segsum_bf16_launches += 1


@functools.lru_cache(maxsize=256)
def staged_plan(n_rows, D, N):
    """The launch of the segment-sum and of the scatter-add: ``(grid, cols,
    seg_len, groups)``. A block owns ``TILE * groups`` rows and ``cols`` =
    min(D, 128) columns of ``seg_len`` ids, so the grid is ceil(n_rows / (16
    groups)) x ceil(D / cols) x ceil(N / seg_len) blocks, each of which reads
    its segment's ids. ``groups`` is 1 unless the table has many more rows
    than there are ids (then a power of two up to 16: fewer, larger tiles,
    the same order of additions). One
    segment (``seg_len >= N``) unless the table has fewer than ``FEW_TILES``
    tiles and a row tile would add ``2 * SEG_IDS`` ids or more; then about
    ``SEG_BLOCKS`` blocks, segments a multiple of ``SEG_IDS`` long. It depends
    on the shapes only, never on the card: the cut decides the order of the
    additions."""
    cols = min(D, MAX_COLS)
    groups = 1
    while (groups < MAX_GROUPS
           and N * TILE * 2 * groups <= SPARSE_HITS * n_rows
           and n_rows >= SPARSE_BLOCKS * TILE * 2 * groups):
        groups *= 2
    row_tiles, col_tiles = -(-n_rows // (TILE * groups)), -(-D // cols)
    tiles = row_tiles * col_tiles
    segs = 1
    if tiles < FEW_TILES and N // row_tiles >= 2 * SEG_IDS:
        segs = max(1, min(-(-SEG_BLOCKS // tiles), N // SEG_IDS))
    seg_len = max(SEG_IDS, -(-(-(-N // segs)) // SEG_IDS) * SEG_IDS)
    return (row_tiles, col_tiles, max(1, -(-N // seg_len))), cols, seg_len, groups


def _check_ids(ids, device):
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be 1-D int32 or int64, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if ids.device != device:
        raise ValueError(f"ids on {ids.device}, expected {device}")


def _device_kind(device, what):
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")
    return device.type


def table_gather(table, ids):
    """``table[ids]`` with zero rows for ids outside [0, R).

    table (R, D) float32, ids (B,) int32/int64 on one device -> (B, D).
    """
    if table.dim() != 2 or table.dtype != torch.float32 or table.shape[0] < 1:
        raise TypeError(f"table must be a non-empty (R, D) float32, got "
                        f"{table.dtype} {tuple(table.shape)}")
    _check_ids(ids, table.device)
    if _device_kind(table.device, "table_gather") == "cpu":
        return table_gather_plain(table, ids)
    return _gather_cuda(table, ids)


def segment_sum(ids, vals, n_rows, vals_dtype=torch.float32):
    """``zeros(n_rows, D).index_add_(0, ids, vals)``, ids outside
    [0, n_rows) dropped, each row summed in ascending batch order.

    ids (B,) int32/int64, vals (B, D) float32 -> (n_rows, D) float32. With
    ``vals_dtype=torch.bfloat16`` every value is rounded to bf16 (round to
    nearest even) before it is added; the sums stay float32.
    """
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise TypeError(f"vals must be (B, D) float32, got {vals.dtype} "
                        f"{tuple(vals.shape)}")
    _check_ids(ids, vals.device)
    if ids.shape[0] != vals.shape[0]:
        raise ValueError(f"{ids.shape[0]} ids for {vals.shape[0]} rows of vals")
    if vals_dtype not in _VALS_DTYPES:
        raise TypeError(f"vals_dtype must be one of {_VALS_DTYPES}")
    n_rows = int(n_rows)
    if n_rows < 1:
        raise ValueError(f"n_rows={n_rows} must be positive")
    if _device_kind(vals.device, "segment_sum") == "cpu":
        return segment_sum_plain(ids, vals, n_rows, vals_dtype)
    return _segsum_cuda(ids, vals, n_rows, vals_dtype)


class TableGather(torch.autograd.Function):
    """``table[ids]`` whose backward is ``segment_sum`` (the counterpart of
    ``mxu_gather``'s custom VJP); ids get no gradient."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table_gather(table, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return segment_sum(ids, grad.contiguous(), ctx.n_rows), None


def table_lookup(table, ids, use_kernel):
    """``table[ids]`` for ids of any shape; through ``TableGather`` when
    ``use_kernel`` (flattened around its (B,) contract and restored), plain
    indexing otherwise."""
    if not use_kernel:
        return table[ids]
    out = TableGather.apply(table, ids.reshape(-1))
    return out.reshape(*ids.shape, table.shape[1])


# ------------------------------------------------------------ plain versions
def table_gather_plain(table, ids):
    """Plain PyTorch version of the gather kernel."""
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                          device=table.device))


def ordered_add_plain(ids, vals, n_rows):
    """``index_add_`` of the valid ids on the CPU, where it adds in ascending
    batch order (on a CUDA tensor ``index_add_`` uses atomics, so the copy to
    the CPU is what makes this the kernels' bit-exact reference): each segment
    of ``staged_plan`` into a table of its own, the tables added in segment
    order. One segment, so plain ``index_add_``, unless the table is small."""
    ids, vals = ids.cpu(), vals.cpu()
    N, D = vals.shape
    _, _, seg_len, _ = staged_plan(n_rows, D, N)
    valid = (ids >= 0) & (ids < n_rows)
    out = None
    for lo in range(0, max(N, 1), seg_len):
        keep = valid[lo:lo + seg_len]
        part = torch.zeros((n_rows, D), dtype=torch.float32).index_add_(
            0, ids[lo:lo + seg_len][keep].long(), vals[lo:lo + seg_len][keep])
        out = part if out is None else out + part
    return out


def segment_sum_plain(ids, vals, n_rows, vals_dtype=torch.float32):
    """Plain PyTorch version of the segment-sum kernel (``ordered_add_plain``,
    the values rounded to bf16 first where asked)."""
    vals = vals.cpu()
    if vals_dtype == torch.bfloat16:
        vals = vals.to(torch.bfloat16).to(torch.float32)
    return ordered_add_plain(ids, vals, n_rows)


# --------------------------------------------------------------- the kernels
@functools.cache
def _kernels():
    from ._build import load

    lib = load("table_gather")
    gather = lib.table_gather
    gather.restype = ctypes.c_int
    gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
    segsum = lib.segment_sum
    segsum.restype = ctypes.c_int
    segsum.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return gather, segsum


def _index(device):
    return device.index if device.index is not None else torch.cuda.current_device()


def _gather_cuda(table, ids):
    gather, _ = _kernels()
    table, ids = table.contiguous(), ids.contiguous()
    (R, D), B = table.shape, ids.shape[0]
    index = _index(table.device)
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    # the C launcher uses the calling thread's current device
    with torch.cuda.device(index):
        err = gather(table.data_ptr(), ids.data_ptr(),
                     int(ids.dtype == torch.int64), R, B, D, out.data_ptr(),
                     torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"table_gather kernel launch failed: cudaError {err} "
                           f"(R={R}, B={B}, D={D})")
    _count("gather")
    return out


def _staged_launch(what, call, ids, vals, n_rows):
    """Launch a kernel of csrc/staged_add.cuh's kind through ``call(ids
    pointer, ids are int64, vals pointer, N, D, n_rows, cols, seg_len, groups,
    partial pointer, out pointer, stream)``; returns the (n_rows, D) sums."""
    ids, vals = ids.contiguous(), vals.contiguous()
    N, D = vals.shape
    if N > MAX_IDS:
        raise ValueError(f"{what} takes at most {MAX_IDS} ids, got {N}")
    index = _index(vals.device)
    (_, _, segs), cols, seg_len, groups = staged_plan(n_rows, D, N)
    out = torch.empty((n_rows, D), dtype=torch.float32, device=vals.device)
    partial = None
    if segs > 1:
        partial = torch.empty((segs, n_rows, D), dtype=torch.float32,
                              device=vals.device)
    # the C launcher uses the calling thread's current device
    with torch.cuda.device(index):
        err = call(ids.data_ptr(), int(ids.dtype == torch.int64),
                   vals.data_ptr(), N, D, n_rows, cols, seg_len, groups,
                   None if partial is None else partial.data_ptr(),
                   out.data_ptr(), torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} (n_rows={n_rows}, "
            f"N={N}, D={D}, cols={cols}, seg_len={seg_len}, groups={groups})"
        )
    return out


def _segsum_cuda(ids, vals, n_rows, vals_dtype):
    _, segsum = _kernels()
    bf16 = int(vals_dtype == torch.bfloat16)

    def call(ids_ptr, ids_int64, vals_ptr, N, D, R, cols, seg_len, groups,
             partial, out, stream):
        return segsum(ids_ptr, ids_int64, vals_ptr, N, D, R, cols, seg_len,
                      groups, bf16, partial, out, stream)

    out = _staged_launch("segment_sum", call, ids, vals, n_rows)
    _count("segsum_bf16" if bf16 else "segsum")
    return out
