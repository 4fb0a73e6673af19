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
from collections import namedtuple

import torch

# Launch counts: exact for one thread; a wrapper adds one without a lock, so
# calls from several threads at once may lose a count, never add one.
#: gather kernel launches so far
gather_launches = 0
#: segment-sum kernel launches so far, float32 values
segsum_launches = 0
#: segment-sum kernel launches so far, values rounded to bf16
segsum_bf16_launches = 0

# Must match csrc/gather_rows.cuh: a block's threads, the grid's blocks a
# multiprocessor at most, the vectors a thread has in flight where it has
# more than one.
GATHER_THREADS, GATHER_BLOCKS_PER_SM, GATHER_BATCH = 256, 4, 4

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
# The add's rings: STAGES chunks of CHUNK_ROWS source rows, ENTRIES chunks of
# their positions, in shared memory.
STAGES, CHUNK_ROWS = 6, 32
ENTRIES = 2 * STAGES
# The form: a call partitions its ids when a segment holds at least
# PART_MIN_IDS of them or a tile at least PART_MIN_GROUPS groups of rows (a
# table of many more rows than ids); below that, the partition's two
# kernels cost more than every block's scan of its segment (the scan form,
# csrc/scan_add.cuh).
PART_MIN_IDS, PART_MIN_GROUPS = 32768, 8
# The partition: up to ONE_CHUNK ids go in one chunk (one launch: no count
# kernel); more in chunks of at least PART_IDS ids (a multiple of 512, at
# most MAX_CHUNK_IDS), longer where a chunk block would otherwise read more
# than PART_SCAN counts. A block's bucket state (40 bytes a bucket) stays in
# its DYN_SMEM bytes of shared memory beside the chunk's 13 bytes an id (its
# buckets and rows, then its positions and buckets in bucket order) where it
# fits.
ONE_CHUNK, PART_IDS, PART_SCAN, MAX_CHUNK_IDS = 8192, 2048, 1 << 18, 12288
DYN_SMEM = 226 * 1024

_VALS_DTYPES = (torch.float32, torch.bfloat16)
_ID_DTYPES = (torch.int32, torch.int64)


def reset_launches():
    global gather_launches, segsum_launches, segsum_bf16_launches
    gather_launches = segsum_launches = segsum_bf16_launches = 0


#: the gather's launch: blocks, threads a block, 16-byte vectors of output
#: a thread has in flight, whole vectors of output and the floats after them
GatherPlan = namedtuple("GatherPlan", "grid threads batch vectors tail")


def gather_plan(B, D, sms):
    """The gather's launch for (B,) ids into a table of D columns on a card
    of ``sms`` multiprocessors: a thread stores whole 16-byte vectors of the
    (B, D) output, one block for each GATHER_THREADS vectors up to
    GATHER_BLOCKS_PER_SM blocks a multiprocessor, which then stride over the
    rest with GATHER_BATCH vectors a thread in flight; block 0 writes the
    B * D % 4 floats after the last vector. Mirrors ``gather::plan`` of
    csrc/gather_rows.cuh, which the C launcher runs
    (tests/test_torch_gather_emulation.py holds the two equal)."""
    vectors, tail = divmod(B * D, 4)
    grid = max(1, min(-(-vectors // GATHER_THREADS), sms * GATHER_BLOCKS_PER_SM))
    batch = GATHER_BATCH if vectors > grid * GATHER_THREADS else 1
    return GatherPlan(grid, GATHER_THREADS, batch, vectors, tail)


def _add_smem(cols, groups):
    """The add's shared memory: the rows' ring, with groups > 1 the tile's
    sums, the positions' ring (positions and rows within the tile)."""
    sums = TILE * groups if groups > 1 else 0
    return 4 * ((STAGES * CHUNK_ROWS + sums) * cols + 2 * ENTRIES * CHUNK_ROWS)


@functools.lru_cache(maxsize=256)
def staged_plan(n_rows, D, N):
    """The launch of the segment-sum and of the scatter-add: ``(grid, cols,
    seg_len, groups)``. A block owns ``TILE * groups`` rows and ``cols`` =
    min(D, 128) columns of ``seg_len`` ids, so the grid is ceil(n_rows / (16
    groups)) x ceil(D / cols) x ceil(N / seg_len) blocks, each of which adds
    its bucket's hits (``staged_form``). ``groups`` is 1 unless the table has
    many more rows than there are ids (then a power of two up to 16: fewer,
    larger tiles, the same order of additions, while the tile's sums fit the
    add's shared memory beside its rings). One segment (``seg_len >= N``)
    unless the table has fewer than ``FEW_TILES`` tiles and a row tile would
    add ``2 * SEG_IDS`` ids or more; then about ``SEG_BLOCKS`` blocks,
    segments a multiple of ``SEG_IDS`` long. It depends on the shapes only,
    never on the card: the cut decides the order of the additions."""
    cols = min(D, MAX_COLS)
    groups = 1
    while (groups < MAX_GROUPS
           and N * TILE * 2 * groups <= SPARSE_HITS * n_rows
           and n_rows >= SPARSE_BLOCKS * TILE * 2 * groups
           and _add_smem(cols, 2 * groups) <= DYN_SMEM):
        groups *= 2
    row_tiles, col_tiles = -(-n_rows // (TILE * groups)), -(-D // cols)
    tiles = row_tiles * col_tiles
    segs = 1
    if tiles < FEW_TILES and N // row_tiles >= 2 * SEG_IDS:
        segs = max(1, min(-(-SEG_BLOCKS // tiles), N // SEG_IDS))
    seg_len = max(SEG_IDS, -(-(-(-N // segs)) // SEG_IDS) * SEG_IDS)
    return (row_tiles, col_tiles, max(1, -(-N // seg_len))), cols, seg_len, groups


#: how a call of the ordered add runs (``staged_form``): whether it
#: partitions its ids, ids a partition chunk, chunks, buckets (segments x row
#: tiles), workspace bytes, the add's shared memory and the place kernel's,
#: and whether the buckets' state stays on chip
StagedForm = namedtuple(
    "StagedForm",
    "partition chunk n_chunks buckets work_bytes smem place_smem on_chip")


def uses_partition(n_rows, D, N):
    """Whether a call at these shapes partitions its ids (else the scan form):
    a segment of at least PART_MIN_IDS ids, or tiles of at least
    PART_MIN_GROUPS groups. Shapes only, like the plan; either form adds in
    the same order."""
    _, _, seg_len, groups = staged_plan(n_rows, D, N)
    return min(N, seg_len) >= PART_MIN_IDS or groups >= PART_MIN_GROUPS


@functools.lru_cache(maxsize=256)
def staged_form(n_rows, D, N, partition=None):
    """The form of a call at ``staged_plan(n_rows, D, N)``, partitioned where
    ``uses_partition`` (or ``partition``) says so. The scan form has no
    chunks and no workspace; its add stages two chunks of rows (chunk 0 tells
    the launcher). Partitioned, a bucket is one block's tile of one segment;
    the ids go in chunks of ``chunk`` (one block each of the count and the
    place kernels; up to ONE_CHUNK ids one chunk, and no count kernel), as
    few as keep each chunk block's scan of the (chunks x buckets) counts
    within PART_SCAN. The workspace holds the counts, the buckets' starts,
    the positions and rows within the tile (int32) of the ids, and the
    buckets' state of each chunk block where it does not fit on chip.
    Mirrors ``staged::plan`` and ``staged::workspace_bytes``, which refuse a
    smaller workspace (tests/test_torch_staged_emulation.py holds the two
    counts equal)."""
    (row_tiles, _, segs), cols, _, groups = staged_plan(n_rows, D, N)
    if not (uses_partition(n_rows, D, N) if partition is None else partition):
        return StagedForm(False, 0, 0, 0, 0, 2 * CHUNK_ROWS * cols * 4, 0, False)
    nb = segs * row_tiles
    if N <= ONE_CHUNK:
        chunk = max(512, -(-N // 512) * 512)
    else:
        chunk = max(PART_IDS, -(-N // max(1, PART_SCAN // nb)))
        chunk = min(-(-chunk // 512) * 512, MAX_CHUNK_IDS)
    n_chunks, on_chip, work, place = partition_layout(N, nb, chunk)
    return StagedForm(True, chunk, n_chunks, nb, work, _add_smem(cols, groups),
                      place, on_chip)


def partition_layout(N, nb, chunk):
    """The partition of N ids into nb buckets in chunks of ``chunk`` ids:
    ``(chunks, whether a chunk block's bucket state fits on chip, workspace
    bytes, the place kernel's shared memory)``. The C launcher counts the
    workspace itself (``staged::workspace_bytes``) and launches nothing when
    the buffer it is given is smaller."""
    n_chunks = max(1, -(-N // chunk))
    on_chip = 13 * chunk + 40 * nb <= DYN_SMEM
    work = 4 * (n_chunks * nb + nb + 1 + 2 * N) + (0 if on_chip else 40 * nb * n_chunks)
    return n_chunks, on_chip, work, 13 * chunk + (40 * nb if on_chip else 0)


def _check_ids(ids, device):
    if ids.dim() != 1 or ids.dtype not in _ID_DTYPES:
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
    if table.is_cuda:   # the checks of _check_ids, without device objects
        if ids.dim() != 1 or ids.dtype not in _ID_DTYPES or not ids.is_cuda \
                or ids.get_device() != table.get_device():
            _check_ids(ids, table.device)
        return _gather_cuda(table, ids)
    _check_ids(ids, table.device)
    _device_kind(table.device, "table_gather")
    return table_gather_plain(table, ids)


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
    return _segsum_cuda(ids, vals, n_rows, vals_dtype)[0]


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
    indexing otherwise. Where no gradient is wanted, the gather runs without
    an autograd node."""
    if not use_kernel:
        return table[ids]
    flat = ids if ids.dim() == 1 else ids.reshape(-1)
    if table.requires_grad and torch.is_grad_enabled():
        out = TableGather.apply(table, flat)
    else:
        out = table_gather(table, flat)
    return out if ids.dim() == 1 else out.reshape(*ids.shape, table.shape[1])


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
#: the C signature of a staged launcher (``segment_sum`` has a bf16 flag
#: after ``vec``): ids, ids are int64, rows, N, D, n_rows, cols, seg_len,
#: groups, chunk, vec, work, work bytes, partial, out, stream
STAGED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]


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
    segsum.argtypes = STAGED_ARGTYPES[:11] + [ctypes.c_int] + STAGED_ARGTYPES[11:]
    return gather, segsum


def _launch(index, fn, *args):
    """``fn(*args, stream)``, the stream the current one of device ``index``
    as a raw pointer. The C launchers launch on the calling thread's current
    device, so ``index`` is made current around the call where it is not."""
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _gather_cuda(table, ids):
    global gather_launches
    table, ids = table.contiguous(), ids.contiguous()
    (R, D), B = table.shape, ids.shape[0]
    out = table.new_empty((B, D))
    if B:
        err = _launch(table.get_device(), _kernels()[0], table.data_ptr(),
                      ids.data_ptr(), ids.dtype == torch.int64, R, B, D,
                      out.data_ptr())
        if err != 0:
            raise RuntimeError(f"table_gather kernel launch failed: cudaError "
                               f"{err} (R={R}, B={B}, D={D})")
        gather_launches += 1
    return out


def _staged_launch(what, call, ids, vals, n_rows, partition=None):
    """Launch a kernel of csrc/staged_add.cuh's kind through ``call(ids
    pointer, ids are int64, vals pointer, N, D, n_rows, cols, seg_len, groups,
    chunk, vec, work pointer, work bytes, partial pointer, out pointer,
    stream)``; returns
    the (n_rows, D) sums and the one allocation that holds them, the partial
    tables and the workspace (``staged_form``). The C launcher sets its
    kernels' shared-memory attribute once a device."""
    ids, vals = ids.contiguous(), vals.contiguous()
    N, D = vals.shape
    if N > MAX_IDS:
        raise ValueError(f"{what} takes at most {MAX_IDS} ids, got {N}")
    (_, _, segs), cols, seg_len, groups = staged_plan(n_rows, D, N)
    form = staged_form(n_rows, D, N, partition)
    n_out = n_rows * D
    n_partial = segs * n_out if segs > 1 else 0
    n_work = -(-form.work_bytes // 4)
    buf = vals.new_empty(n_out + n_partial + n_work)
    ptr = buf.data_ptr()
    # 16-byte copies where every row starts 16-byte aligned
    vec = 4 if D % 4 == 0 and vals.data_ptr() % 16 == 0 else 1
    err = _launch(vals.get_device(), call, ids.data_ptr(),
                  int(ids.dtype == torch.int64), vals.data_ptr(), N, D, n_rows,
                  cols, seg_len, groups, form.chunk, vec,
                  ptr + 4 * (n_out + n_partial), 4 * n_work,
                  ptr + 4 * n_out if n_partial else None, ptr)
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} (n_rows={n_rows}, "
            f"N={N}, D={D}, cols={cols}, seg_len={seg_len}, groups={groups}, "
            f"{form})"
        )
    return buf[:n_out].view(n_rows, D), buf


def _segsum_cuda(ids, vals, n_rows, vals_dtype, partition=None):
    global segsum_launches, segsum_bf16_launches
    _, segsum = _kernels()
    bf16 = int(vals_dtype == torch.bfloat16)

    def call(*args):
        return segsum(*args[:11], bf16, *args[11:])

    out, buf = _staged_launch("segment_sum", call, ids, vals, n_rows, partition)
    if bf16:
        segsum_bf16_launches += 1
    else:
        segsum_launches += 1
    return out, buf


def staged_partition(ids, n_rows, D):
    """The partition of ``ids`` that a segment-sum of (N, D) values into
    ``n_rows`` rows runs on the card, read back from its workspace:
    (positions of the valid ids sorted by (bucket, n), each one's row within
    its tile, each bucket's start and then the valid ids in all). A bucket is
    ``segment * row_tiles + row_tile`` of ``staged_plan``. It runs (and
    counts) a whole segment-sum of zeros, partitioned whatever its form; for
    tests."""
    N = ids.shape[0]
    vals = torch.zeros((N, D), dtype=torch.float32, device=ids.device)
    _, buf = _segsum_cuda(ids, vals, n_rows, torch.float32, partition=True)
    (_, _, segs), _, _, _ = staged_plan(n_rows, D, N)
    form = staged_form(n_rows, D, N, True)
    work = buf[n_rows * D * (1 + (segs if segs > 1 else 0)):]
    counts = form.n_chunks * form.buckets
    words = work.view(torch.int32)
    bstart = words[counts:counts + form.buckets + 1]
    n_valid = int(bstart[-1])
    first = counts + form.buckets + 1
    pos = words[first:first + n_valid]
    sub = words[first + N:first + N + n_valid]
    return pos, sub, bstart
