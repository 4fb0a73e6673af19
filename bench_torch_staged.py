#!/usr/bin/env python3
"""Time the segment-sum and the scatter-add of librecommender_tpu_torch (one
ordered-add body, ``csrc/staged_add.cuh``) at every shape ``chip_smoke.py``
holds them at (its ``TABLE_SHAPES`` and ``scatter_cases()``), on one GPU.

    python3 bench_torch_staged.py [--root DIR] [--only TEXT ...] [--label L]
                                  [--out DIR] [--forms]

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
``--only`` keeps the shapes whose name contains one of the texts; ``--out``
also writes the lines to ``DIR/staged_<label>.jsonl``.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

#: the kernels of one call, by the names the profiler gives them
KERNEL_NAMES = ("::segsum_kernel", "::scatter_rows_kernel", "sum_partials_kernel",
                "partition_count", "partition_place")

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
            split = smoke.device_ms(call, KERNEL_NAMES)
            row = dict(
                shape=shape, n_rows=n_rows, D=D, N=N,
                plan=tg.staged_plan(n_rows, D, N),
                device_ms=sum(split.values()) if split else None,
                device_split=split, ms=smoke.time_ms(call))
            if not forms:
                def library():
                    return torch.zeros((n_rows, D), device="cuda").index_add_(
                        0, ids_long, rows_valid)

                row.update(enqueue_ms=smoke.enqueue_ms(call),
                           library_ms=smoke.time_ms(library),
                           library_device_ms=smoke.device_total_ms(library))
            out.append(row)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE),
                        help="checkout whose librecommender_tpu_torch is timed")
    parser.add_argument("--only", nargs="*", default=None)
    parser.add_argument("--label", default="this")
    parser.add_argument("--out", default=None, help="directory for a copy of the lines")
    parser.add_argument("--forms", action="store_true",
                        help="time the scan and the partitioned form of every shape")
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


if __name__ == "__main__":
    sys.exit(main())
