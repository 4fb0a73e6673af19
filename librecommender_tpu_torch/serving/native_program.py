"""The port's scoring functions as flat op-list programs for the C++
interpreter.

Counterpart of ``librecommender_tpu/serving/native_program.py``. The JAX
package traces a scoring function to a jaxpr and writes it as a flat list of
lax primitives (JSON) beside a blob of constants; its C++ interpreter
(``csrc/jaxpr_interp.hpp``, a copy of the JAX package's) runs the list with
no Python. Here the same function of the port is exported with
``torch.export`` at static shapes, decomposed to core ATen
(``run_decompositions``), and each ATen node is lowered to the primitives
that interpreter runs, in the forms a jaxpr gives them: the same JSON schema
(``"version": 1``, ``inputs``, ``constants``, ``ops``, ``outputs``) and the
same blob (little-endian row-major constants at 64-byte-aligned offsets), so
the JAX package's own interpreter runs a port program unchanged.

Lowering rules:

- Parameters, feature tables and histories the function closes over are
  lifted into constants by the export and land in the blob. A node whose
  inputs are all constants is evaluated here, on the CPU, and its value
  stored instead (the position table, the catalog's ids, the per-item half
  of a catalog scorer), unless its value is far larger than its inputs, in
  which case the node is lowered like any other.
- Inputs are declared as the JAX package declares them: int32 ids and
  float32 rows (the server writes requests in those dtypes); the program
  casts the ids to the port's int64 first thing.
- ATen broadcasts implicitly. An operand of lower rank is lifted to the
  output's rank by ``broadcast_in_dim``, as a jaxpr does; size-1 dimensions
  are left to the interpreter's elementwise broadcast, as jaxprs leave them.
- Indexing (``index.Tensor``, ``index_select``, ``embedding``) becomes one
  ``gather`` in the form ``jnp`` gives ``x[idx]``: the indices with a
  trailing index-vector dimension, negative indices wrapped first.
  ``select`` and ``slice`` are static slices.
- ``relu`` is ``max`` with 0, ``sigmoid`` is ``logistic``, ``where`` is
  ``select_n`` (false case first), ``any`` is ``reduce_or``; ``_softmax``,
  ``var`` and ``mean`` decompose into reductions and elementwise ops.
- The GRU and LSTM of ``ops/nn.py`` are Python loops over the sequence, so
  they export unrolled, L steps of plain ops, where a jaxpr keeps one
  ``scan``.
- An ATen op with no rule raises ``NotImplementedError`` naming it; nothing
  is skipped.
"""
import contextlib
import importlib
import json
import math
import operator
import threading
from pathlib import Path

import numpy as np
import torch

from .export_model import _Program

aten = torch.ops.aten

_DTYPE_NAMES = {
    torch.float32: "f32",
    torch.float64: "f64",
    torch.bfloat16: "bf16",
    torch.int32: "i32",
    torch.int64: "i64",
    torch.bool: "bool",
}

# a constant node is folded unless its value outgrows its constant inputs by
# more than this factor plus this many elements
_FOLD_GROWTH = 4
_FOLD_SLACK = 1 << 16


def _dtype_name(dt):
    if dt in _DTYPE_NAMES:
        return _DTYPE_NAMES[dt]
    raise NotImplementedError(f"native program: unsupported dtype {dt}")


def _is_float(dt):
    return dt.is_floating_point


class _Blob:
    """Constant pool with 64-byte-aligned offsets (the JAX package's)."""

    def __init__(self):
        self.chunks = []
        self.size = 0

    def add(self, arr):
        """Append ``arr`` (a CPU tensor); returns (offset, stored dtype
        name). The interpreter computes floats in f32, so bf16 and f64
        constants are stored rounded through f32; bools store as one byte."""
        if arr.dtype in (torch.bfloat16, torch.float64):
            arr = arr.to(torch.float32)
        if arr.dtype == torch.bool:
            arr = arr.to(torch.int8)
        data = np.ascontiguousarray(arr.numpy()).tobytes()
        pad = (-self.size) % 64
        if pad:
            self.chunks.append(b"\0" * pad)
            self.size += pad
        offset = self.size
        self.chunks.append(data)
        self.size += len(data)
        stored = {torch.float32: "f32", torch.int32: "i32", torch.int64: "i64",
                  torch.int8: "i8"}[arr.dtype]
        return offset, stored

    def tobytes(self):
        return b"".join(self.chunks)


class _T:
    """A tensor of the program: its id, static shape and torch dtype."""

    __slots__ = ("id", "shape", "dtype")

    def __init__(self, tid, shape, dtype):
        self.id, self.shape, self.dtype = tid, tuple(shape), dtype


class _C:
    """A value known at lowering time; it enters the blob at first use."""

    __slots__ = ("value", "id")

    def __init__(self, value):
        self.value, self.id = value, None

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype


def _numel(shape):
    return math.prod(shape)


def _norm_dim(d, rank):
    return d + rank if d < 0 else d


def _norm_dims(dims, rank):
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return list(range(rank))
    if isinstance(dims, int):
        dims = [dims]
    return sorted(_norm_dim(d, rank) for d in dims)


def _cpu_kwargs(kwargs):
    return {k: (torch.device("cpu") if k == "device" else v)
            for k, v in kwargs.items()}


def _walk(x, fn):
    if isinstance(x, (list, tuple)):
        return type(x)(_walk(v, fn) for v in x)
    return fn(x)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


class _Lowering:
    """Walks an exported graph and writes the op list."""

    def __init__(self):
        self.ops = []
        self.constants = []
        self.blob = _Blob()
        self.next_id = 0

    # ------------------------------------------------------------ plumbing
    def new_id(self):
        i = self.next_id
        self.next_id += 1
        return i

    def decl(self, shape, dtype):
        return {"id": self.new_id(), "shape": [int(d) for d in shape],
                "dtype": _dtype_name(dtype)}

    def tid(self, v):
        """The program id of a tensor value, storing a constant on first use."""
        if isinstance(v, _T):
            return v.id
        if v.id is None:
            value = v.value.detach().to("cpu").contiguous()
            offset, stored = self.blob.add(value)
            v.id = self.new_id()
            self.constants.append({
                "id": v.id, "shape": [int(d) for d in value.shape],
                "dtype": _dtype_name(value.dtype), "stored": stored,
                "offset": offset,
            })
        return v.id

    def emit(self, prim, inputs, out_shape, out_dtype, **attrs):
        out = self.decl(out_shape, out_dtype)
        self.ops.append({"prim": prim, "inputs": [self.tid(v) for v in inputs],
                         "attrs": attrs, "outputs": [out]})
        return _T(out["id"], out_shape, out_dtype)

    def const(self, value, dtype):
        return _C(torch.tensor(value, dtype=dtype))

    # -------------------------------------------------------------- shapes
    def convert(self, v, dtype):
        if v.dtype == dtype:
            return v
        if isinstance(v, _C):
            return _C(v.value.to(dtype))
        return self.emit("convert_element_type", [v], v.shape, dtype,
                         new_dtype=_dtype_name(dtype), weak_type=False,
                         sharding=None)

    def reshape(self, v, shape):
        shape = tuple(int(d) for d in shape)
        if v.shape == shape:
            return v
        if isinstance(v, _C):
            return _C(v.value.reshape(shape))
        return self.emit("reshape", [v], shape, v.dtype,
                         new_sizes=list(shape), dimensions=None, sharding=None)

    def rank_to(self, v, rank):
        """``v`` lifted to ``rank`` by leading size-1 dimensions (NumPy's
        right alignment); rank-0 values stay scalars."""
        r = len(v.shape)
        if r == rank or r == 0:
            return v
        shape = (1,) * (rank - r) + v.shape
        if isinstance(v, _C):
            return _C(v.value.reshape(shape))
        return self.emit("broadcast_in_dim", [v], shape, v.dtype,
                         shape=list(shape),
                         broadcast_dimensions=list(range(rank - r, rank)),
                         sharding=None)

    def broadcast_to(self, v, shape):
        """``v`` materialized at ``shape`` (NumPy's broadcast)."""
        shape = tuple(shape)
        if v.shape == shape:
            return v
        r, R = len(v.shape), len(shape)
        return self.emit("broadcast_in_dim", [v], shape, v.dtype,
                         shape=list(shape),
                         broadcast_dimensions=list(range(R - r, R)),
                         sharding=None)

    def transpose(self, v, perm):
        perm = [int(p) for p in perm]
        if perm == list(range(len(perm))):
            return v
        shape = tuple(v.shape[p] for p in perm)
        return self.emit("transpose", [v], shape, v.dtype, permutation=perm)

    def slice(self, v, dim, start, stop, step=1):
        starts = [0] * len(v.shape)
        limits = list(v.shape)
        strides = [1] * len(v.shape)
        starts[dim], limits[dim], strides[dim] = start, stop, step
        shape = list(v.shape)
        shape[dim] = max(0, -(-(stop - start) // step))
        return self.emit("slice", [v], shape, v.dtype, start_indices=starts,
                         limit_indices=limits,
                         strides=None if step == 1 else strides)

    # -------------------------------------------------------- elementwise
    def binary(self, prim, a, b, dtype, shape):
        a, b = self.convert(a, dtype), self.convert(b, dtype)
        a, b = self.rank_to(a, len(shape)), self.rank_to(b, len(shape))
        return self.emit(prim, [a, b], shape, dtype)

    def compare(self, prim, a, b, shape):
        a, b = self.rank_to(a, len(shape)), self.rank_to(b, len(shape))
        return self.emit(prim, [a, b], shape, torch.bool)

    def unary(self, prim, a, dtype, shape):
        return self.emit(prim, [self.convert(a, dtype)], shape, dtype)

    def select(self, pred, on_true, on_false, dtype, shape):
        """``where(pred, on_true, on_false)``: select_n takes the false case
        first."""
        pred = self.broadcast_to(self.rank_to(self.convert(pred, torch.bool),
                                              len(shape)), shape)
        cases = [self.rank_to(self.convert(v, dtype), len(shape))
                 for v in (on_false, on_true)]
        return self.emit("select_n", [pred, *cases], shape, dtype)

    # --------------------------------------------------------- reductions
    def reduce(self, prim, x, axes, keep_shape, out_shape, dtype):
        red_shape = tuple(d for i, d in enumerate(x.shape) if i not in axes)
        out = self.emit(prim, [x], red_shape, dtype, axes=list(axes),
                        out_sharding=None)
        return self.reshape(out, keep_shape if keep_shape is not None
                            else out_shape)

    def keepdim_shape(self, shape, axes):
        return tuple(1 if i in axes else d for i, d in enumerate(shape))

    # ------------------------------------------------------------ indexing
    def index(self, x, indices, out_shape):
        """``x[indices]``, ``indices`` one entry per leading dim of x, None
        where the dim is taken whole: one gather over the indexed dims."""
        rank = len(x.shape)
        indices = list(indices) + [None] * (rank - len(indices))
        pos = [d for d, i in enumerate(indices) if i is not None]
        idx = []
        for d in pos:
            i = indices[d]
            if i.dtype == torch.bool:
                raise NotImplementedError(
                    "native program: boolean mask indexing has a data-dependent "
                    "shape")
            idx.append(self.wrap_index(self.convert(i, torch.int64), x.shape[d]))
        bshape = tuple(torch.broadcast_shapes(*[i.shape for i in idx]))
        k = len(pos)
        cols = []
        for i in idx:
            i = self.rank_to(i, len(bshape))
            if i.shape != bshape:
                i = self.broadcast_to(i, bshape)
            cols.append(self.reshape(i, bshape + (1,)))
        if k == 1:
            start = cols[0]
        elif all(isinstance(c, _C) for c in cols):
            start = _C(torch.cat([c.value for c in cols], dim=-1))
        else:
            start = self.emit("concatenate", cols, bshape + (k,), torch.int64,
                              dimension=len(bshape))
        rest = [d for d in range(rank) if d not in pos]
        xt = self.transpose(x, pos + rest)
        rest_shape = tuple(x.shape[d] for d in rest)
        nb = len(bshape)
        g = self.emit(
            "gather", [xt, start], bshape + rest_shape, x.dtype,
            dimension_numbers=[list(range(nb, nb + len(rest))), list(range(k)),
                               list(range(k)), [], []],
            slice_sizes=[1] * k + list(rest_shape),
            unique_indices=False, indices_are_sorted=False,
            mode="PROMISE_IN_BOUNDS", fill_value=None,
        )
        # adjacent indexed dims after a taken dim keep their place (torch's
        # rule); otherwise the broadcast index dims lead, as gathered
        p = pos[0]
        if p > 0 and pos == list(range(p, p + k)):
            perm = (list(range(nb, nb + p)) + list(range(nb))
                    + list(range(nb + p, nb + len(rest))))
            g = self.transpose(g, perm)
        if g.shape != tuple(out_shape):
            raise RuntimeError(f"native program: index lowered to {g.shape}, "
                               f"ATen's shape is {tuple(out_shape)}")
        return g

    def wrap_index(self, i, size):
        """Negative indices count from the end, as ATen's and jnp's do."""
        if isinstance(i, _C):
            return _C(torch.where(i.value < 0, i.value + size, i.value))
        neg = self.compare("lt", i, self.const(0, torch.int64), i.shape)
        up = self.binary("add", i, self.const(size, torch.int64), torch.int64,
                         i.shape)
        return self.emit("select_n", [neg, i, up], i.shape, torch.int64)

    # ------------------------------------------------------------- matmul
    def dot(self, a, b, contract, batch, shape):
        a, b = self.convert(a, torch.float32), self.convert(b, torch.float32)
        return self.emit(
            "dot_general", [a, b], shape, torch.float32,
            dimension_numbers=[[contract[0], contract[1]], [batch[0], batch[1]]],
            precision=None, preferred_element_type="f32", out_sharding=None,
        )


# ------------------------------------------------------------------ rules
_BINARY = {
    aten.add.Tensor: "add", aten.add.Scalar: "add",
    aten.sub.Tensor: "sub", aten.sub.Scalar: "sub",
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.maximum.default: "max", aten.minimum.default: "min",
    aten.pow.Tensor_Tensor: "pow",
}
_COMPARE = {
    aten.eq.Tensor: "eq", aten.eq.Scalar: "eq",
    aten.ne.Tensor: "ne", aten.ne.Scalar: "ne",
    aten.lt.Tensor: "lt", aten.lt.Scalar: "lt",
    aten.gt.Tensor: "gt", aten.gt.Scalar: "gt",
    aten.le.Tensor: "le", aten.le.Scalar: "le",
    aten.ge.Tensor: "ge", aten.ge.Scalar: "ge",
}
_LOGIC = {
    aten.bitwise_and.Tensor: "and", aten.bitwise_or.Tensor: "or",
    aten.bitwise_xor.Tensor: "xor", aten.logical_and.default: "and",
    aten.logical_or.default: "or", aten.logical_xor.default: "xor",
}
_UNARY = {
    aten.exp.default: "exp", aten.log.default: "log",
    aten.tanh.default: "tanh", aten.sigmoid.default: "logistic",
    aten.sqrt.default: "sqrt", aten.rsqrt.default: "rsqrt",
    aten.abs.default: "abs", aten.neg.default: "neg",
    aten.sign.default: "sign", aten.floor.default: "floor",
    aten.ceil.default: "ceil", aten.round.default: "round",
    aten.erf.default: "erf", aten.log1p.default: "log1p",
    aten.expm1.default: "expm1", aten.sin.default: "sin",
    aten.cos.default: "cos",
}
_IDENTITY = {
    aten.clone.default, aten.alias.default, aten.lift_fresh_copy.default,
    aten.detach.default, aten.contiguous.default,
}
_SKIP = {
    aten._assert_tensor_metadata.default, aten._assert_scalar.default,
    aten.sym_constrain_range_for_size.default,
}
_RESHAPE = {
    aten.view.default, aten._unsafe_view.default, aten.reshape.default,
    aten.squeeze.default, aten.squeeze.dim, aten.squeeze.dims,
    aten.unsqueeze.default, aten.flatten.using_ints,
}


def _out(node):
    """(shape, dtype) of a node's single tensor output."""
    val = node.meta["val"]
    return tuple(int(d) for d in val.shape), val.dtype


def _lower_node(L, node, args, kwargs):
    """Lower one ATen node whose arguments are resolved values."""
    t = node.target
    if t in _SKIP:
        return None
    if t in _IDENTITY:
        return args[0]
    if t is aten._to_copy.default:
        dtype = kwargs.get("dtype")
        return args[0] if dtype is None else L.convert(args[0], dtype)
    if t in _RESHAPE:
        return L.reshape(args[0], _out(node)[0])
    multi = isinstance(node.meta.get("val"), (list, tuple))
    shape, dtype = (None, None) if multi else _out(node)

    def tensor(v, like_dtype):
        if isinstance(v, (_T, _C)):
            return v
        return L.const(v, like_dtype)

    if t in _BINARY:
        a = tensor(args[0], dtype)
        b = tensor(args[1], dtype)
        if t in (aten.add.Tensor, aten.sub.Tensor) and kwargs.get("alpha", 1) != 1:
            b = L.binary("mul", b, L.const(kwargs["alpha"], dtype), dtype, b.shape)
        return L.binary(_BINARY[t], a, b, dtype, shape)
    if t is aten.rsub.Scalar:
        a = tensor(args[0], dtype)
        if kwargs.get("alpha", 1) != 1:
            a = L.binary("mul", a, L.const(kwargs["alpha"], dtype), dtype, a.shape)
        return L.binary("sub", L.const(args[1], dtype), a, dtype, shape)
    if t in (aten.div.Tensor, aten.div.Scalar):
        return L.binary("div", tensor(args[0], dtype), tensor(args[1], dtype),
                        dtype, shape)
    if t in (aten.remainder.Tensor, aten.remainder.Scalar):
        a, b = tensor(args[0], dtype), tensor(args[1], dtype)
        r = L.binary("rem", a, b, dtype, shape)
        zero = L.const(0, dtype)
        nonzero = L.compare("ne", r, zero, shape)
        sign_r = L.compare("lt", r, zero, shape)
        sign_b = L.compare("lt", L.rank_to(L.convert(b, dtype), len(shape)), zero,
                           shape)
        differ = L.emit("ne", [sign_r, L.rank_to(sign_b, len(shape))], shape,
                        torch.bool)
        fix = L.emit("and", [nonzero, differ], shape, torch.bool)
        return L.select(fix, L.binary("add", r, b, dtype, shape), r, dtype, shape)
    if t in _COMPARE:
        a = args[0]
        b = tensor(args[1], a.dtype if not isinstance(args[1], float)
                   or _is_float(a.dtype) else torch.float32)
        return L.compare(_COMPARE[t], a, b, shape)
    if t in _LOGIC:
        a, b = args
        if dtype == torch.bool:
            a, b = (v if v.dtype == torch.bool else
                    L.compare("ne", v, L.const(0, v.dtype), v.shape)
                    for v in (a, b))
        return L.binary(_LOGIC[t], a, b, dtype, shape)
    if t is aten.logical_not.default:
        a = args[0]
        if a.dtype != torch.bool:
            a = L.compare("ne", a, L.const(0, a.dtype), a.shape)
        return L.emit("not", [a], shape, torch.bool)
    if t in _UNARY:
        return L.unary(_UNARY[t], args[0], dtype, shape)
    if t is aten.relu.default:
        return L.binary("max", args[0], L.const(0, dtype), dtype, shape)
    if t is aten.pow.Tensor_Scalar:
        x, e = args
        if float(e) == int(e):
            return L.emit("integer_pow", [L.convert(x, dtype)], shape, dtype,
                          y=int(e))
        if float(e) == 0.5:
            return L.unary("sqrt", x, dtype, shape)
        return L.binary("pow", x, L.const(e, dtype), dtype, shape)
    if t is aten.pow.Scalar:
        return L.binary("pow", L.const(args[0], dtype), args[1], dtype, shape)
    if t in (aten.clamp.default, aten.clamp_min.default, aten.clamp_max.default,
             aten.clamp.Tensor):
        x = L.convert(args[0], dtype)
        if t is aten.clamp_min.default:
            lo, hi = args[1], None
        elif t is aten.clamp_max.default:
            lo, hi = None, args[1]
        else:
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
        if lo is not None:
            x = L.binary("max", x, tensor(lo, dtype), dtype, shape)
        if hi is not None:
            x = L.binary("min", x, tensor(hi, dtype), dtype, shape)
        return x
    if t in (aten.where.self, aten.where.ScalarOther, aten.where.ScalarSelf,
             aten.where.Scalar):
        cond, a, b = args
        return L.select(cond, tensor(a, dtype), tensor(b, dtype), dtype, shape)

    # ---- shapes
    if t is aten.permute.default:
        return L.transpose(args[0], [_norm_dim(d, len(args[0].shape))
                                     for d in args[1]])
    if t in (aten.t.default, aten.transpose.int):
        x = args[0]
        r = len(x.shape)
        d0, d1 = (0, 1) if t is aten.t.default else (
            _norm_dim(args[1], r), _norm_dim(args[2], r))
        perm = list(range(r))
        if r >= 2:
            perm[d0], perm[d1] = perm[d1], perm[d0]
        return L.transpose(x, perm)
    if t is aten.expand.default:
        return L.broadcast_to(L.rank_to(args[0], len(shape)), shape)
    if t is aten.repeat.default:
        return _repeat(L, args[0], list(args[1]), shape)
    if t is aten.cat.default:
        tensors = [v for v in args[0] if _numel(v.shape) > 0
                   or len(v.shape) == len(shape)]
        dim = _norm_dim(args[1] if len(args) > 1 else kwargs.get("dim", 0),
                        len(shape))
        tensors = [L.convert(v, dtype) for v in tensors]
        if len(tensors) == 1:
            return tensors[0]
        return L.emit("concatenate", tensors, shape, dtype, dimension=dim)
    if t is aten.slice.Tensor:
        x = args[0]
        dim = _norm_dim(args[1] if len(args) > 1 else 0, len(x.shape))
        size = x.shape[dim]
        start = args[2] if len(args) > 2 and args[2] is not None else 0
        stop = args[3] if len(args) > 3 and args[3] is not None else size
        step = args[4] if len(args) > 4 else 1
        start = min(max(start + size if start < 0 else start, 0), size)
        stop = min(max(stop + size if stop < 0 else stop, 0), size)
        stop = max(stop, start)
        return L.slice(x, dim, start, stop, step)
    if t is aten.select.int:
        x = args[0]
        dim = _norm_dim(args[1], len(x.shape))
        i = args[2] + x.shape[dim] if args[2] < 0 else args[2]
        return L.reshape(L.slice(x, dim, i, i + 1), shape)
    if t in (aten.split_with_sizes.default, aten.split.Tensor):
        x = args[0]
        dim = _norm_dim(args[2] if len(args) > 2 else kwargs.get("dim", 0),
                        len(x.shape))
        size = x.shape[dim]
        if t is aten.split.Tensor:
            step = args[1]
            sizes = [min(step, size - s) for s in range(0, size, step)]
        else:
            sizes = list(args[1])
        out, start = [], 0
        for s in sizes:
            out.append(L.slice(x, dim, start, start + s))
            start += s
        return out
    if t is aten.unbind.int:
        x = args[0]
        dim = _norm_dim(args[1] if len(args) > 1 else 0, len(x.shape))
        keep = tuple(d for i, d in enumerate(x.shape) if i != dim)
        return [L.reshape(L.slice(x, dim, i, i + 1), keep)
                for i in range(x.shape[dim])]
    if t is aten.constant_pad_nd.default:
        x = args[0]
        pad = list(args[1])
        value = args[2] if len(args) > 2 else 0
        cfg = [[0, 0, 0] for _ in x.shape]
        for j in range(len(pad) // 2):
            d = len(x.shape) - 1 - j
            cfg[d] = [int(pad[2 * j]), int(pad[2 * j + 1]), 0]
        return L.emit("pad", [x, L.const(value, x.dtype)], shape, x.dtype,
                      padding_config=cfg)
    if t in (aten.full.default, aten.scalar_tensor.default, aten.zeros.default,
             aten.ones.default, aten.new_zeros.default, aten.new_ones.default,
             aten.full_like.default, aten.zeros_like.default,
             aten.ones_like.default, aten.new_full.default):
        value = {aten.zeros.default: 0, aten.new_zeros.default: 0,
                 aten.zeros_like.default: 0, aten.ones.default: 1,
                 aten.new_ones.default: 1, aten.ones_like.default: 1}.get(t)
        if value is None:
            value = args[0] if t is aten.scalar_tensor.default else args[1]
            if t is aten.new_full.default:
                value = args[2]
        scalar = L.const(value, dtype)
        return L.broadcast_to(scalar, shape) if shape else scalar
    if t in (aten.arange.default, aten.arange.start, aten.arange.start_step):
        vals = [0, *args] if t is aten.arange.default else list(args)
        start, step = vals[0], vals[2] if len(vals) > 2 else 1
        iota = L.emit("iota", [], shape, dtype, dtype=_dtype_name(dtype),
                      shape=list(shape), dimension=0, sharding=None)
        if step != 1:
            iota = L.binary("mul", iota, L.const(step, dtype), dtype, shape)
        if start != 0:
            iota = L.binary("add", iota, L.const(start, dtype), dtype, shape)
        return iota

    # ---- indexing
    if t is aten.index.Tensor:
        return L.index(args[0], args[1], shape)
    if t is aten.index_select.default:
        x, dim, idx = args
        dim = _norm_dim(dim, len(x.shape))
        return L.index(x, [None] * dim + [idx], shape)
    if t is aten.embedding.default:
        return L.index(args[0], [args[1]], shape)

    # ---- reductions
    if t in (aten.sum.dim_IntList, aten.sum.default, aten.mean.dim,
             aten.mean.default, aten.amax.default, aten.amin.default,
             aten.any.dim, aten.any.dims, aten.any.default):
        x = args[0]
        rank = len(x.shape)
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        if t in (aten.sum.default, aten.mean.default, aten.any.default):
            dims = None
        axes = _norm_dims(dims, rank)
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        keep_shape = L.keepdim_shape(x.shape, axes) if keep else None
        if t in (aten.any.dim, aten.any.dims, aten.any.default):
            if x.dtype != torch.bool:
                x = L.compare("ne", x, L.const(0, x.dtype), x.shape)
            return L.reduce("reduce_or", x, axes, keep_shape, shape, torch.bool)
        prim = {aten.amax.default: "reduce_max",
                aten.amin.default: "reduce_min"}.get(t, "reduce_sum")
        x = L.convert(x, dtype)
        out = L.reduce(prim, x, axes, keep_shape, shape, dtype)
        if t in (aten.mean.dim, aten.mean.default):
            count = _numel([x.shape[a] for a in axes])
            out = L.binary("div", out, L.const(count, dtype), dtype, out.shape)
        return out
    if t is aten.var.correction:
        x = L.convert(args[0], dtype)
        rank = len(x.shape)
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        axes = _norm_dims(dims, rank)
        correction = kwargs.get("correction")
        correction = 1 if correction is None else correction
        keep = kwargs.get("keepdim", False)
        n = _numel([x.shape[a] for a in axes])
        kshape = L.keepdim_shape(x.shape, axes)
        mean = L.reduce("reduce_sum", x, axes, kshape, kshape, dtype)
        mean = L.binary("div", mean, L.const(n, dtype), dtype, kshape)
        d = L.binary("sub", x, mean, dtype, x.shape)
        sq = L.binary("mul", d, d, dtype, x.shape)
        out = L.reduce("reduce_sum", sq, axes, kshape if keep else None, shape,
                       dtype)
        return L.binary("div", out, L.const(max(n - correction, 0), dtype),
                        dtype, shape)
    if t is aten.linalg_vector_norm.default:
        x = L.convert(args[0], dtype)
        order = args[1] if len(args) > 1 else kwargs.get("ord", 2)
        if order != 2:
            raise NotImplementedError(
                f"native program: aten.linalg_vector_norm of order {order}")
        dims = args[2] if len(args) > 2 else kwargs.get("dim")
        axes = _norm_dims(dims, len(x.shape))
        keep = args[3] if len(args) > 3 else kwargs.get("keepdim", False)
        sq = L.binary("mul", x, x, dtype, x.shape)
        kshape = L.keepdim_shape(x.shape, axes) if keep else None
        return L.unary("sqrt", L.reduce("reduce_sum", sq, axes, kshape, shape,
                                        dtype), dtype, shape)
    if t is aten._softmax.default:
        x = L.convert(args[0], dtype)
        dim = _norm_dim(args[1], len(x.shape))
        kshape = L.keepdim_shape(x.shape, [dim])
        m = L.reduce("reduce_max", x, [dim], kshape, kshape, dtype)
        shifted = L.binary("sub", x, m, dtype, shape)
        e = L.unary("exp", shifted, dtype, shape)
        s = L.reduce("reduce_sum", e, [dim], kshape, kshape, dtype)
        return L.binary("div", e, s, dtype, shape)

    # ---- products
    if t is aten.mm.default:
        return L.dot(args[0], args[1], ([1], [0]), ([], []), shape)
    if t is aten.bmm.default:
        return L.dot(args[0], args[1], ([2], [1]), ([0], [0]), shape)
    if t is aten.addmm.default:
        bias, a, b = args
        beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
        out = L.dot(a, b, ([1], [0]), ([], []), shape)
        if alpha != 1:
            out = L.binary("mul", out, L.const(alpha, dtype), dtype, shape)
        if beta != 1:
            bias = L.binary("mul", bias, L.const(beta, dtype), dtype, bias.shape)
        return L.binary("add", out, bias, dtype, shape)
    if t is aten.convolution.default:
        x, w, bias, stride, padding, dilation, transposed, _, groups = args
        if transposed:
            raise NotImplementedError(
                "native program: aten.convolution with transposed=True")
        nsp = len(x.shape) - 2
        spec = list(range(nsp + 2))
        out = L.emit(
            "conv_general_dilated",
            [L.convert(x, torch.float32), L.convert(w, torch.float32)],
            shape, torch.float32,
            window_strides=list(stride), padding=[[p, p] for p in padding],
            lhs_dilation=[1] * nsp, rhs_dilation=list(dilation),
            dimension_numbers=[spec, spec, spec], feature_group_count=groups,
            batch_group_count=1, precision=None, preferred_element_type=None,
        )
        if bias is not None:
            b = L.reshape(bias, (bias.shape[0],) + (1,) * nsp)
            out = L.binary("add", out, b, dtype, shape)
        return out
    raise NotImplementedError(f"native program: no lowering for ATen op {t}")


def _repeat(L, x, repeats, shape):
    """``x.repeat(repeats)``: each dim (s) broadcast to (r, s), then merged."""
    x = L.rank_to(x, len(repeats))
    if len(x.shape) < len(repeats):   # rank 0
        x = L.reshape(x, (1,) * len(repeats))
    inter = []
    for r, s in zip(repeats, x.shape):
        inter += [r, s]
    b = L.emit("broadcast_in_dim", [x], inter, x.dtype, shape=inter,
               broadcast_dimensions=[2 * i + 1 for i in range(len(repeats))],
               sharding=None)
    return L.reshape(b, shape)


def _fold(node, args, kwargs):
    """The node's value from constant arguments, on the CPU, or None where
    it would outgrow them (see ``_FOLD_GROWTH``)."""
    raw = _walk(args, lambda v: v.value if isinstance(v, _C) else v)
    raw_kw = _cpu_kwargs({k: _walk(v, lambda x: x.value if isinstance(x, _C)
                                   else x) for k, v in kwargs.items()})
    in_elems = sum(_numel(v.shape) for v in _leaves(args) if isinstance(v, _C))
    val = node.meta.get("val")
    out_elems = sum(_numel(v.shape) for v in _leaves(val)
                    if isinstance(v, torch.Tensor)) if val is not None else 0
    if out_elems > _FOLD_GROWTH * in_elems + _FOLD_SLACK:
        return None
    with torch.no_grad():
        out = node.target(*raw, **raw_kw)
    return _walk(out, lambda v: _C(v) if isinstance(v, torch.Tensor) else v)


# torch's tracers treat every tensor of at most this many elements as a
# constant they may evaluate; a one-element program input (one user's id)
# then reaches ``run_decompositions`` as an uninitialised value, and an index
# on it fails or bakes garbage in. The export turns that tracking off.
_CONSTANT_LIMITS = ("torch.fx.experimental.proxy_tensor",
                    "torch._subclasses.fake_tensor")
_TRACE_LOCK = threading.Lock()


@contextlib.contextmanager
def _no_constant_tracking():
    """Sets the limit to 0 while the export runs. The limit is a module
    global of torch, so this state is process-wide: the lock orders these
    exports among themselves, but any other trace that runs in the process
    meanwhile (in another thread) sees the limit at 0 too. Raises where this
    torch has the limit in none of the modules, rather than tracing without
    it."""
    with _TRACE_LOCK:
        saved = []
        for name in _CONSTANT_LIMITS:
            module = importlib.import_module(name)
            if hasattr(module, "CONSTANT_NUMEL_LIMIT"):
                saved.append((module, module.CONSTANT_NUMEL_LIMIT))
        if not saved:
            raise RuntimeError(
                "native program: this torch has no CONSTANT_NUMEL_LIMIT in "
                f"{', '.join(_CONSTANT_LIMITS)}; a one-element input would "
                "be traced as a constant")
        for module, _ in saved:
            module.CONSTANT_NUMEL_LIMIT = 0
        try:
            yield
        finally:
            for module, value in saved:
                module.CONSTANT_NUMEL_LIMIT = value


def _example_tensor(a):
    """An example argument as the port computes with it: ids int64, rows
    float32 (on the CPU unless it is a tensor already)."""
    if isinstance(a, torch.Tensor):
        return a.long() if not a.is_floating_point() else a.float()
    arr = np.asarray(a)
    return torch.as_tensor(arr, dtype=torch.float32 if arr.dtype.kind == "f"
                           else torch.int64)


def trace_to_program(fn, *example_args, device=None):
    """Export ``fn`` at the example shapes and lower it to a program.

    Returns (program_dict, blob_bytes). ``example_args`` (numpy arrays or
    tensors) become the program inputs in order, declared int32 for ids and
    float32 for rows, as the JAX package declares them; everything ``fn``
    closes over is baked into the constant pool. ``device``: where the
    example tensors go for the trace (the model's device; default the CPU).
    """
    examples = tuple(_example_tensor(a) for a in example_args)
    if device is not None:
        examples = tuple(e.to(device) for e in examples)
    with torch.no_grad(), _no_constant_tracking():
        ep = torch.export.export(_Program(fn), examples, strict=False)
        ep = ep.run_decompositions()
    L = _Lowering()
    sig = ep.graph_signature
    lifted = {}
    for spec in sig.input_specs:
        if spec.kind.name == "USER_INPUT":
            continue
        source = ep.constants if spec.target in ep.constants else ep.state_dict
        lifted[spec.arg.name] = _C(source[spec.target].detach().to("cpu"))
    input_decls = []
    env = {}
    user_inputs = [s.arg.name for s in sig.input_specs
                   if s.kind.name == "USER_INPUT"]
    for name, ex in zip(user_inputs, examples):
        decl_dtype = torch.float32 if ex.is_floating_point() else torch.int32
        decl = L.decl(ex.shape, decl_dtype)
        input_decls.append(decl)
        env[name] = L.convert(_T(decl["id"], ex.shape, decl_dtype), ex.dtype)
    env.update(lifted)

    def resolve(a):
        return env[a.name] if isinstance(a, torch.fx.Node) else a

    outputs = None
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            outputs = list(_leaves(_walk(node.args[0], resolve)))
            break
        args = _walk(tuple(node.args), resolve)
        kwargs = {k: _walk(v, resolve) for k, v in node.kwargs.items()}
        if node.target is operator.getitem:
            env[node.name] = args[0][args[1]]
            continue
        if node.op != "call_function":
            raise NotImplementedError(f"native program: graph node {node.op}")
        value = None
        if node.target not in _SKIP and not any(
                isinstance(v, _T) for v in _leaves((args, list(kwargs.values())))):
            value = _fold(node, args, kwargs)
        if value is None:
            value = _lower_node(L, node, args, kwargs)
        env[node.name] = value
    out_ids = [L.tid(v) for v in outputs]
    program = {
        "version": 1,
        "inputs": input_decls,
        "constants": L.constants,
        "ops": L.ops,
        "outputs": out_ids,
    }
    return program, L.blob.tobytes()


def save_program(path, name, fn, *example_args, device=None):
    """Write ``{name}.program.json`` and ``{name}.blob.bin`` under ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    program, blob = trace_to_program(fn, *example_args, device=device)
    (path / f"{name}.program.json").write_text(json.dumps(program))
    (path / f"{name}.blob.bin").write_bytes(blob)
    return program


# --------------------------------------------------------- server artifacts
# the JAX package's widths: the feature family's tiled catalog scorer scores
# this many items a program run (the server pads the last tile); the dynamic
# family's coalesced user tower embeds this many requests at once; the static
# top-K table keeps this many items a user
_TILE_SIZE = 256
_DYN_BATCH = 8
_STATIC_TOPK = 512
# users a static top-K chunk scores on the model's device
_TOPK_CHUNK = 64


def _bin(path, name, arr):
    """``{name}.bin`` and its ``{name}_shape.bin`` (int64 dims)."""
    arr = np.ascontiguousarray(arr)
    np.asarray(arr.shape, np.int64).tofile(path / f"{name}_shape.bin")
    arr.tofile(path / f"{name}.bin")


def _detached_tree(model):
    return model._tree({k: v.detach() for k, v in model.net.items()})


def _user_row_examples(model, ov_inputs, examples):
    """The request-time feature slots a model's user side has, in the JAX
    package's order: one example row each."""
    info = model.data_info
    if model.feats.user_sparse is not None:
        ov_inputs.append("user_sparse_row")
        examples.append(np.asarray(info.user_sparse_unique)[:1].astype(np.int32))
    if model.feats.user_dense is not None:
        ov_inputs.append("user_dense_row")
        examples.append(np.asarray(info.user_dense_unique)[:1].astype(np.float32))


def static_topk_table(model, k):
    """(n_users + 1, k) int32: every user's top-k catalog items (the cold row
    last), scored on the model's device by its catalog scorer a chunk of
    ``_TOPK_CHUNK`` users at a time and ranked by ``topk_from_scores``."""
    from ..ops.topk import topk_from_scores

    n_rows = model.n_users + 1
    out = np.empty((n_rows, k), np.int32)
    for start in range(0, n_rows, _TOPK_CHUNK):
        uids = np.arange(start, min(start + _TOPK_CHUNK, n_rows))
        ids, _ = topk_from_scores(model._score_users(uids), None, k)
        out[start : start + len(uids)] = ids.cpu().numpy()
    return out


def export_native_programs(path, model, tile_size=None):
    """Write the scoring programs and the tables the C++ server needs to
    answer /model/recommend and /online/recommend without Python, as the JAX
    package writes them. Returns the runtime meta dict (None for a model
    family with no native program path). ``tile_size`` overrides the
    feature family's tile width (``_TILE_SIZE``).

    - feature and sequence models: ``score_all`` (one user's catalog),
      ``score_dyn`` (with request-time overrides), ``score_tile`` (one tile
      of items), the stored histories, the static top-K table and the
      feature maps;
    - TwoTower: ``user_repr`` and ``user_repr_b`` (``_DYN_BATCH`` users);
    - the dynamic-embedding models: ``user_repr``, ``user_repr_b``, the item
      matrix with the bias folded in and the stored histories.
    """
    from ..bases.dyn_embed_base import DynEmbedBase
    from ..bases.feat_base import FeatBase

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    dev = model.device
    meta = None

    if isinstance(model, FeatBase):
        model._sync_feature_tables()
        tree = _detached_tree(model)
        users1 = np.zeros(1, np.int32)
        catalog = getattr(model, "_score_catalog", None)

        def score(u, overrides=None, items=None):
            if catalog is not None:
                return catalog(tree, u, overrides, items)
            n = model.n_items if items is None else items.shape[0]
            inputs = model._catalog_pair_inputs(u, overrides, items)
            return model._forward(tree, inputs, train=False).reshape(
                u.shape[0], n)

        save_program(path, "score_all", lambda u: score(u), users1, device=dev)

        # one input slot per override the model takes, in an order the meta
        # records
        ov_inputs = ["users"]
        examples = [users1]
        if hasattr(model, "max_seq_len"):
            ov_inputs.append("seq")
            examples.append(np.full((1, model.max_seq_len), model.pad_id,
                                    np.int32))
        if hasattr(model, "long_max_len"):
            ov_inputs.append("seq_long")
            examples.append(np.full((1, model.long_max_len), model.pad_id,
                                    np.int32))
        _user_row_examples(model, ov_inputs, examples)
        keys = ov_inputs[1:]
        if keys:
            save_program(path, "score_dyn",
                         lambda u, *ovs: score(u, dict(zip(keys, ovs))),
                         *examples, device=dev)

        # the tiled catalog scorer (users, item tile, override slots) ->
        # (1, T), traced with per-id token assembly: a tile touches `tile`
        # items, so the packed all-items token table would rebuild the whole
        # catalog's tokens in every tile
        tile = int(min(tile_size or _TILE_SIZE, model.n_items))
        items_ex = np.arange(tile, dtype=np.int32)
        pack_attr = getattr(model, "token_pack_max_items", None)
        try:
            if pack_attr is not None:
                model.token_pack_max_items = 0
            save_program(
                path, "score_tile",
                lambda u, items, *ovs: score(u, dict(zip(keys, ovs)), items),
                users1, items_ex, *examples[1:], device=dev)
        finally:
            if pack_attr is not None:
                model.token_pack_max_items = pack_attr

        if getattr(model, "recent_seq_table", None) is not None:
            _bin(path, "recent_seq",
                 model.recent_seq_table.cpu().numpy().astype(np.int32))
        if getattr(model, "recent_long_table", None) is not None:
            _bin(path, "recent_long",
                 model.recent_long_table.cpu().numpy().astype(np.int32))

        K = int(min(model.n_items, _STATIC_TOPK))
        _bin(path, "static_topk", static_topk_table(model, K))
        meta = {
            "kind": "feat",
            "inputs": ov_inputs,
            "n_users": int(model.n_users),
            "n_items": int(model.n_items),
            "pad_id": int(getattr(model, "pad_id", model.n_items)),
            "max_seq_len": int(getattr(model, "max_seq_len", 0)),
            "long_max_len": int(getattr(model, "long_max_len", 0)),
            "tile": tile,
            "static_topk": K,
        }
        _export_feature_tables(path, model)

    elif hasattr(model, "user_tower") and \
            getattr(model, "item_embeds_np", None) is not None:
        # TwoTower: the user vector is recomputed through the tower with
        # request-time feature overrides
        tree = _detached_tree(model)
        ov_inputs = ["users"]
        examples = [np.zeros(1, np.int32)]
        _user_row_examples(model, ov_inputs, examples)
        keys = ov_inputs[1:]

        def tower(u, *ovs):
            kw = dict(zip(keys, ovs))
            return model.user_tower(tree, u,
                                    sparse_rows=kw.get("user_sparse_row"),
                                    dense_rows=kw.get("user_dense_row"))

        save_program(path, "user_repr", tower, *examples, device=dev)
        save_program(path, "user_repr_b", tower,
                     *(np.repeat(e, _DYN_BATCH, axis=0) for e in examples),
                     device=dev)
        meta = {
            "kind": "dyn_feats",
            "inputs": ov_inputs,
            "n_users": int(model.n_users),
            "n_items": int(model.n_items),
            "pad_id": int(model.n_items),
            "max_seq_len": 0,
            "dyn_batch": _DYN_BATCH,
        }
        _export_feature_tables(path, model)

    elif isinstance(model, DynEmbedBase):
        model._sync_feature_tables()
        tree = _detached_tree(model)
        users1 = np.zeros(1, np.int32)
        seqs1 = np.full((1, model.max_seq_len), model.pad_id, np.int32)

        def user_repr(u, s):
            return model._user_repr(tree, u, s, False)

        save_program(path, "user_repr", user_repr, users1, seqs1, device=dev)
        save_program(path, "user_repr_b", user_repr,
                     np.repeat(users1, _DYN_BATCH),
                     np.repeat(seqs1, _DYN_BATCH, 0), device=dev)
        item_repr = model._item_repr(tree)[: model.n_items].cpu().numpy()
        bias = model._item_bias(tree)
        if bias is not None:
            item_repr = np.hstack(
                [item_repr, bias[: model.n_items, None].cpu().numpy()])
        _bin(path, "item_repr", item_repr.astype(np.float32))
        _bin(path, "recent_seq",
             model.recent_seq_table.cpu().numpy().astype(np.int32))
        meta = {
            "kind": "dyn",
            "inputs": ["users", "seq"],
            "n_users": int(model.n_users),
            "n_items": int(model.n_items),
            "pad_id": int(model.pad_id),
            "max_seq_len": int(model.max_seq_len),
            "has_bias": bias is not None,
            "dyn_batch": _DYN_BATCH,
        }

    if meta is not None:
        (path / "runtime_meta.json").write_text(json.dumps(meta))
    return meta


def _export_feature_tables(path, model):
    """User feature rows and the raw value -> flat index maps, so that the
    server assembles override rows as ``FeatureTables.build_user_sparse_row``
    does."""
    info = model.data_info
    if info.user_sparse_unique is not None:
        _bin(path, "user_sparse_rows",
             np.asarray(info.user_sparse_unique).astype(np.int32))
    if info.user_dense_unique is not None:
        _bin(path, "user_dense_rows",
             np.asarray(info.user_dense_unique).astype(np.float32))
    feat_map = {"sparse": {}, "dense": {}}
    for j, name in enumerate(info.user_sparse_col.name):
        col_pos = info.user_sparse_col.index[j]
        mapping = (info.sparse_idx_mapping or {}).get(name, {})
        offset = int(info.sparse_offset[col_pos])
        feat_map["sparse"][name] = {
            "pos": j,
            "oov": int(info.sparse_oov[col_pos]),
            "values": {str(k): offset + int(v) for k, v in mapping.items()},
        }
    for j, name in enumerate(info.user_dense_col.name):
        feat_map["dense"][name] = j
    (path / "feat_map.json").write_text(json.dumps(feat_map))
