"""Row gather whose backward is a deterministic scatter-add of many rows.

``scatter_add_rows`` is the port of the TPU kernel
``librecommender_tpu/ops/pallas_scatter.py::_scatter_kernel`` and
``GatherRows``/``gather_rows`` of ``_gather_rows_op``/``gather_rows`` there:
the forward is plain ``table[ids]``, the backward adds the (N, D) cotangent
rows into a (n_rows, D) table, N being many times n_rows (a batch times its
history length into an item table). On a CUDA tensor the wrapper launches the
hand-written kernel of ``csrc/row_scatter.cu`` (or raises); on a CPU tensor it
runs the plain PyTorch version beside it, which the CPU tests and the on-card
comparison hold the kernel against.

The kernel adds each output row's hits in ascending n, the order of
``index_add_`` on the CPU (a table of few rows in fixed segments of the ids,
as the segment-sum of ``table_gather`` does and the plain version with it), so
it agrees with its plain version bit for bit and a training run repeats
exactly.
"""
import ctypes
import functools
import threading

import torch

from .table_gather import (STAGED_ARGTYPES, _check_ids, _device_kind,
                           _staged_launch, ordered_add_plain)

#: scatter kernel launches so far
launches = 0
_count_lock = threading.Lock()

#: ``use_pallas_grad_scatter`` takes the kernel from this many ids per table
#: row on: a sequence gather's forward and backward through it is level with
#: plain indexing's from 2 to 4 ids a row on an H100 and faster from 8 on,
#: slower at 1 and below (chip_smoke.py's scatter-gate sweep, 3712 x 64)
GATE_IDS_PER_ROW = 4


def reset_launches():
    global launches
    with _count_lock:
        launches = 0


def scatter_add_rows(ids, rows, n_rows):
    """``zeros(n_rows, D).index_add_(0, ids, rows)``, each output row summed
    in ascending n (within each segment of ``table_gather.staged_plan``, the
    segments in order, where a small table has more than one).

    ids (N,) int32/int64, rows (N, D) float32 on one device, any N >= 0 ->
    (n_rows, D) float32. Ids outside [0, n_rows) are dropped, so that no
    launch writes out of bounds (the TPU kernel leaves them undefined); rows
    that no id touches come out zero.
    """
    if rows.dim() != 2 or rows.dtype != torch.float32 or rows.shape[1] < 1:
        raise TypeError(f"rows must be (N, D) float32 with D >= 1, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    _check_ids(ids, rows.device)
    if ids.shape[0] != rows.shape[0]:
        raise ValueError(f"{ids.shape[0]} ids for {rows.shape[0]} rows")
    n_rows = int(n_rows)
    if n_rows < 1:
        raise ValueError(f"n_rows={n_rows} must be positive")
    if _device_kind(rows.device, "scatter_add_rows") == "cpu":
        return scatter_add_rows_plain(ids, rows, n_rows)
    return _scatter_cuda(ids, rows, n_rows)


class GatherRows(torch.autograd.Function):
    """``table[ids]`` for ids of any shape, whose backward is
    ``scatter_add_rows`` of the flattened ids and cotangent (the counterpart
    of ``gather_rows``' custom VJP); ids get no gradient."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table[ids.long()]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows = grad.reshape(-1, grad.shape[-1]).to(torch.float32).contiguous()
        out = scatter_add_rows(ids.reshape(-1), rows, ctx.n_rows)
        return out.to(grad.dtype), None


def gather_rows(table, ids):
    """``table[ids]`` whose gradient runs through ``scatter_add_rows``. For a
    small table gathered many times over (ids many times the table's rows):
    a sequence model's history and targets into its item or token table."""
    return GatherRows.apply(table, ids)


def use_pallas_grad_scatter(table_shape, n_ids):
    """The ``pallas_grad_scatter="auto"`` gate: the kernel where the gather
    has at least ``GATE_IDS_PER_ROW`` ids per table row. (The name is the JAX
    package's; the kernel here is CUDA.)"""
    return n_ids >= GATE_IDS_PER_ROW * table_shape[0]


# ------------------------------------------------------------- plain version
def scatter_add_rows_plain(ids, rows, n_rows):
    """Plain PyTorch version of the scatter kernel: ``index_add_`` of the
    valid ids on the CPU, in ascending n (``ordered_add_plain``)."""
    return ordered_add_plain(ids, rows, n_rows)


# ---------------------------------------------------------------- the kernel
@functools.cache
def _kernel():
    from ._build import load

    fn = load("row_scatter").scatter_add_rows
    fn.restype = ctypes.c_int
    fn.argtypes = STAGED_ARGTYPES
    return fn


def _scatter_cuda(ids, rows, n_rows):
    global launches
    out, _ = _staged_launch("scatter_add_rows", _kernel(), ids, rows, n_rows)
    with _count_lock:
        launches += 1
    return out
