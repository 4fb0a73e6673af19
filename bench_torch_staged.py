#!/usr/bin/env python3
"""Time the segment-sum and the scatter-add of librecommender_tpu_torch (one
ordered-add body, ``csrc/staged_add.cuh``) at every shape ``chip_smoke.py``
holds them at (its ``TABLE_SHAPES`` and ``scatter_cases()``), or the table
gather at every ``TABLE_SHAPES`` shape, on one GPU.

    python3 bench_torch_staged.py [--root DIR] [--only TEXT ...] [--label L]
                                  [--out DIR] [--forms | --gather]

``--root`` imports the package from another checkout (a parent commit
unpacked beside this one), so that two versions are timed in one call on
one card, in turns. Each shape is checked bit for bit against the plain
version (``chip_smoke.check_ordered_add``) and gives one JSON line: device ms
by kernel (torch.profiler), events ms (median of 10 calls by CUDA events),
host enqueue ms of a call on an idle card, and ``index_add_`` on the card by
events and by device time. ``--forms`` instead times each shape, and the
shapes of ``CUT_SHAPES`` around the line between the two forms, in both
forms of the body (the scan of ``csrc/scan_add.cuh`` and the partition), each
checked bit for bit: the numbers behind ``table_gather.uses_partition``.
``--gather`` times the gather instead, each shape checked exact against
its plain version with int32 and int64 ids: device ms (torch.profiler),
events ms, host enqueue ms on an idle card of ``table_gather`` and of
``TableGather.apply``, the same three for ``index_select`` (and the enqueue
of ``table[ids]``), and the probes of ``bench_gather_probe.cu`` by device
ms: an empty kernel and a store-only fill of the output at the gather's
grid (the floors), and the first gather's body as it was, with its loads
issued before its stores and without its id load. A last line splits the
wrapper's host cost by stage (host us a call, calls back to back) at the
two main-path shapes. ``--only`` keeps the shapes whose name contains one
of the texts; ``--out`` also writes the lines to ``DIR/staged_<label>.jsonl``
(``gather_<label>.jsonl`` with ``--gather``).
"""
import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

#: each kernel's add, by the name the profiler gives it
ADD_NAMES = {"segsum": "::segsum_kernel", "scatter": "::scatter_rows_kernel"}
#: the form a call of ``calls`` forces, by its label
FORCED = {"": None, "scan ": False, "partition ": True}

# (name, kernel, n_rows, D, N, ids kind): calls between the shapes of
# chip_smoke.py where the two forms meet. Ids in one segment from 16,384 to
# 65,536 (the scatter-add into DIN's item table; BPR's item table at larger
# batches) and 64-row and 128-row tiles (groups 4 and 8: a table of 8, then
# 32 thousand rows looked up 8192 times; groups 2 at 8192 rows)
CUT_SHAPES = [
    *((f"scatter cut, N {n}, {kind} ids", "scatter", 3712, 64, n, kind)
      for n in (24_576, 32_768, 49_152) for kind in ("uniform", "popularity")),
    *((f"segsum cut, item table, B {n}", "segsum", 3712, 65, n, "uniform")
      for n in (16_384, 24_576, 49_152, 65_536)),
    *((f"segsum cut, V={v}", "segsum", v, 64, 8192, "uniform")
      for v in (8192, 32_768)),
]


def _smoke():
    """chip_smoke.py beside this file, as a module (shapes, ids, checks and
    timing helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(smoke, forms):
    """(name, kernel, n_rows, D, N, ids(rng), bf16 too) for every shape:
    chip_smoke.py's phase 1b segment-sums and phase 1c scatter-adds, and with
    ``forms`` CUT_SHAPES."""
    for what, R, D, B, ragged, bf16 in smoke.TABLE_SHAPES:
        yield (f"segsum {what}", "segsum", R, D, B,
               lambda rng, R=R, B=B, ragged=ragged: smoke.table_ids(rng, R, B, ragged),
               bf16)
    for key, n_rows, D, N, lo, hi, kind in smoke.scatter_cases():
        yield (f"scatter {key}", "scatter", n_rows, D, N,
               lambda rng, a=(n_rows, N, lo, hi, kind): smoke.scatter_ids(rng, *a),
               False)
    if forms:
        for name, kernel, n_rows, D, N, kind in CUT_SHAPES:
            yield (name, kernel, n_rows, D, N,
                   lambda rng, a=(n_rows, N, 0, None, kind): smoke.scatter_ids(rng, *a),
                   False)


def calls(kernel, ids, rows, n_rows, dtype, forms):
    """The calls to time: the wrapper's own, or (``forms``) the scan form and
    the partitioned form of the same function."""
    from librecommender_tpu_torch.ops import row_scatter as rs
    from librecommender_tpu_torch.ops import table_gather as tg

    if not forms:
        if kernel == "segsum":
            return {"": lambda: tg.segment_sum(ids, rows, n_rows, vals_dtype=dtype)}
        return {"": lambda: rs.scatter_add_rows(ids, rows, n_rows)}
    if kernel == "segsum":
        return {f"{name} ": (lambda p=p: tg._segsum_cuda(ids, rows, n_rows, dtype, p)[0])
                for name, p in (("scan", False), ("partition", True))}
    return {f"{name} ": (lambda p=p: tg._staged_launch(
        "scatter_add_rows", rs._kernel(), ids, rows, n_rows, p)[0])
        for name, p in (("scan", False), ("partition", True))}


def measure(smoke, check, forms, name, kernel, n_rows, D, N, make_ids, bf16):
    from librecommender_tpu_torch.ops import table_gather as tg

    rng = np.random.default_rng(abs(hash((n_rows, D, N))) % (1 << 31))
    ids = torch.from_numpy(make_ids(rng)).cuda()
    rows = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32)).cuda()
    valid = (ids >= 0) & (ids < n_rows)
    ids_long, rows_valid = ids.long()[valid], rows[valid]
    out = []
    dtypes = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    for dtype in dtypes if kernel == "segsum" else (torch.float32,):
        want = tg.segment_sum_plain(ids, rows, n_rows, vals_dtype=dtype)
        for form, call in calls(kernel, ids, rows, n_rows, dtype, forms).items():
            shape = (form + name + (" bf16" if dtype == torch.bfloat16 else ""))
            first, second = call(), call()
            torch.cuda.synchronize()
            if check:
                smoke.check_ordered_add(first, second, want, shape)
            row = dict(
                shape=shape, n_rows=n_rows, D=D, N=N,
                plan=tg.staged_plan(n_rows, D, N),
                **smoke.device_row(call, smoke.staged_launches(
                    ADD_NAMES[kernel], n_rows, D, N, FORCED[form])),
                ms=smoke.time_ms(call))
            if not forms:
                def library():
                    return torch.zeros((n_rows, D), device="cuda").index_add_(
                        0, ids_long, rows_valid)

                row.update(enqueue_ms=smoke.enqueue_ms(call),
                           library_ms=smoke.time_ms(library),
                           library_device_ms=smoke.device_total_ms(library))
            out.append(row)
    return out

# ------------------------------------------------------------------ gather
#: the two shapes of TABLE_SHAPES a training step gathers at: BPR's item
#: table and DIN's sparse vocabulary
MAIN_GATHER = ("main path, item table", "DIN sparse fields")
PROBES = {"empty": 0, "fill": 1, "parent_copy": 2, "parent_loads_first": 3,
          "parent_no_id": 4}


def probe_library(build_dir):
    """bench_gather_probe.cu built with the port's nvcc flags (a few
    seconds), loaded with ctypes."""
    from librecommender_tpu_torch.ops import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / "libgather_probe.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(HERE / "bench_gather_probe.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for bench_gather_probe.cu:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def gather_grid(tg, B, D):
    """(blocks, threads) of the timed checkout's gather launch: its
    ``gather_plan`` where it has one, else the first body's (one warp an
    output row, 8 warps a block)."""
    plan = getattr(tg, "gather_plan", None)
    if plan is None:
        return -(-B // 8), 256
    p = plan(B, D, torch.cuda.get_device_properties(0).multi_processor_count)
    return p.grid, p.threads


def measure_gather(smoke, probe, name, R, D, B, ragged):
    from librecommender_tpu_torch.ops import table_gather as tg

    rng = np.random.default_rng(abs(hash((R, D, B))) % (1 << 31))
    ids = torch.from_numpy(smoke.table_ids(rng, R, B, ragged)).cuda()
    table = torch.from_numpy(rng.standard_normal((R, D), dtype=np.float32)).cuda()
    for idx in (ids, ids.long()):
        before = tg.gather_launches
        got = tg.table_gather(table, idx)
        torch.cuda.synchronize()
        if tg.gather_launches != before + 1:
            raise SystemExit(f"{name}: table_gather counted "
                             f"{tg.gather_launches - before} launches")
        if not torch.equal(got, tg.table_gather_plain(table, idx)):
            raise SystemExit(f"{name}: table_gather differs from its plain "
                             f"version ({idx.dtype} ids)")
    ids_in = ids.long().clamp(0, R - 1)   # the library calls take ids in range
    table_rg = table.detach().requires_grad_()

    def call():
        return tg.table_gather(table, ids)

    def library():
        return torch.index_select(table, 0, ids_in)

    row = dict(shape=name, R=R, D=D, B=B, grid=gather_grid(tg, B, D),
               device_ms=smoke.device_ms(call, {"::gather_kernel": 1})[0],
               ms=smoke.time_ms(call), enqueue_ms=smoke.enqueue_ms(call),
               apply_enqueue_ms=smoke.enqueue_ms(lambda: tg.TableGather.apply(table_rg, ids)),
               library_ms=smoke.time_ms(library),
               library_device_ms=smoke.device_total_ms(library),
               library_enqueue_ms=smoke.enqueue_ms(library),
               index_enqueue_ms=smoke.enqueue_ms(lambda: table[ids_in]))
    out = torch.empty((B, D), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    grid, threads = row["grid"]
    parent_grid = -(-B // 8), 256
    for kind, code in PROBES.items():
        if code >= 2 and D > 128:
            continue
        args = (code, grid, threads, table.data_ptr(), ids.data_ptr(), R, B, D, out.data_ptr(), stream)
        if probe(*args) != 0:
            raise SystemExit(f"{name}: probe {kind} failed to launch")
        row[f"probe_{kind}_device_ms"] = smoke.device_ms(
            lambda a=args: probe(*a), {f"probe_{kind}": 1})[0]
    if (grid, threads) != parent_grid:   # the floor at the first body's grid too
        args = (0, *parent_grid, 0, 0, R, B, D, out.data_ptr(), stream)
        row["probe_empty_parent_grid_device_ms"] = smoke.device_ms(
            lambda: probe(*args), {"probe_empty": 1})[0]
    return row


def per_call_us(fn, calls=200, repeats=5):
    """Median over ``repeats`` of the host microseconds a call of ``fn()``
    takes, ``calls`` calls back to back (the card synchronised before each
    run of calls, not inside it)."""
    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t) * 1e6 / calls)
    torch.cuda.synchronize()
    return statistics.median(runs)


def wrapper_stages(smoke, R, D, B):
    """The gather wrapper's host cost split by stage, host us a call: the
    pieces each version's ``_gather_cuda`` is made of, timed alone, and the
    whole calls beside index_select and plain indexing."""
    from librecommender_tpu_torch.ops import table_gather as tg

    rng = np.random.default_rng(1)
    ids = torch.from_numpy(smoke.table_ids(rng, R, B, False)).cuda()
    table = torch.from_numpy(rng.standard_normal((R, D), dtype=np.float32)).cuda()
    table_rg = table.detach().requires_grad_()
    ids_in, index = ids.long().clamp(0, R - 1), table.get_device()
    out = torch.empty((B, D), dtype=torch.float32, device="cuda")
    gather = tg._kernels()[0]
    stream = torch.cuda.current_stream(index).cuda_stream
    f32, id_types = torch.float32, (torch.int32, torch.int64)
    stages = {
        "checks: dim, dtype, shape, device objects": lambda: (
            table.dim() != 2 or table.dtype != f32 or table.shape[0] < 1,
            ids.dim() != 1 or ids.dtype not in id_types, ids.device != table.device),
        "checks: is_cuda, get_device": lambda: (
            table.is_cuda, ids.is_cuda, ids.get_device() != table.get_device()),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "current_stream(index).cuda_stream": lambda: torch.cuda.current_stream(index).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)": lambda: torch._C._cuda_getCurrentRawStream(index),
        "torch.empty((B, D), dtype, device)": lambda: torch.empty(
            (B, D), dtype=f32, device=table.device),
        "table.new_empty((B, D))": lambda: table.new_empty((B, D)),
        "contiguous() x2, data_ptr() x3": lambda: (
            table.contiguous().data_ptr(), ids.contiguous().data_ptr(), out.data_ptr()),
        "ctypes call and launch": lambda: gather(table.data_ptr(), ids.data_ptr(), 0, R,
                                                 B, D, out.data_ptr(), stream),
        "table_gather": lambda: tg.table_gather(table, ids),
        "TableGather.apply (table requires grad)": lambda: tg.TableGather.apply(table_rg, ids),
        "table_lookup (table requires grad)": lambda: tg.table_lookup(table_rg, ids, True),
        "index_select": lambda: torch.index_select(table, 0, ids_in),
        "table[ids]": lambda: table[ids],
    }
    if hasattr(tg, "_count"):
        stages["counter under a lock"] = lambda: tg._count("gather")
    return {key: per_call_us(fn) for key, fn in stages.items()}



def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE),
                        help="checkout whose librecommender_tpu_torch is timed")
    parser.add_argument("--only", nargs="*", default=None)
    parser.add_argument("--label", default="this")
    parser.add_argument("--out", default=None, help="directory for a copy of the lines")
    parser.add_argument("--forms", action="store_true",
                        help="time the scan and the partitioned form of every shape")
    parser.add_argument("--gather", action="store_true",
                        help="time the table gather and its probes instead")
    parser.add_argument("--no-check", action="store_true",
                        help="skip the bit-equality check (for a copy whose "
                        "kernel is cut on purpose, to time a part of it)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: bench_torch_staged.py times the kernels on the GPU only")
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    smoke = _smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    import librecommender_tpu_torch

    print(f"[staged] {args.label}: {librecommender_tpu_torch.__file__} on {smi}",
          flush=True)
    from librecommender_tpu_torch.ops import _build

    _build.build("table_gather", verbose=True)
    if args.gather:
        return gather_main(args, smoke, smi)
    _build.build("row_scatter", verbose=True)
    lines = []
    for case in cases(smoke, args.forms):
        if args.only and not any(t in case[0] for t in args.only):
            continue
        for row in measure(smoke, not args.no_check, args.forms, *case):
            row.update(label=args.label, card=smi)
            lines.append(json.dumps(row))
            print(f"[staged] {lines[-1]}", flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"staged_{args.label}.jsonl").write_text("\n".join(lines) + "\n")
    return 0


def gather_main(args, smoke, smi):
    probe = probe_library(Path(args.root).resolve() / "librecommender_tpu_torch" / "build")
    lines = []

    def emit(row):
        row.update(label=args.label, card=smi)
        lines.append(json.dumps(row))
        print(f"[gather] {lines[-1]}", flush=True)

    for name, R, D, B, ragged, _ in smoke.TABLE_SHAPES:
        if not args.only or any(t in name for t in args.only):
            emit(measure_gather(smoke, probe, name, R, D, B, ragged))
    for name, R, D, B, _, _ in smoke.TABLE_SHAPES:
        if name in MAIN_GATHER:
            emit(dict(stages_us=wrapper_stages(smoke, R, D, B), shape=name))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"gather_{args.label}.jsonl").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
