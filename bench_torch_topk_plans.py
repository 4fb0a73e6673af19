#!/usr/bin/env python3
"""Time the streaming top-k kernel of librecommender_tpu_torch under launch
plans other than the one ``ops/streaming_topk.plan`` picks, on one GPU.

    python3 bench_torch_topk_plans.py

For each shape it sweeps the number of item chunks (and, at the catalog
shape, the user rows a block holds), checks every result against the plain
PyTorch version, and prints one line per plan with the median milliseconds
of a call (CUDA events over 20 x 5 back-to-back calls). The plan's own choice
is marked. These sweeps set ``MIN_CHUNK`` and ``BLOCKS_PER_SM``.
"""
import statistics
import subprocess
import sys

import numpy as np
import torch


def chunking(st, N, n_chunks):
    """(chunk, n_chunks) as the plan rounds them: whole tiles, no empty
    chunk."""
    chunk = -(-N // n_chunks)
    chunk = -(-chunk // st.TILE_N) * st.TILE_N
    return chunk, -(-N // chunk)


def time_plan(st, users, items, k, rows, n_chunks):
    """Median ms of one kernel call under (rows, n_chunks); ids checked."""
    U, D = users.shape
    N = items.shape[0]
    P = st.plan(U, N, D, k, 1).P
    chunk, n_chunks = chunking(st, N, n_chunks)
    out_s = torch.empty((U, k), device="cuda")
    out_i = torch.empty((U, k), dtype=torch.int32, device="cuda")
    ws = torch.empty((U, n_chunks, k), dtype=torch.int64, device="cuda")
    fn = st._kernel()

    def call():
        err = fn(users.data_ptr(), items.data_ptr(), U, N, D, k, rows, P, chunk,
                 n_chunks, ws.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 5)
    ref_i, _ = st.streaming_topk_plain(users, items, k)
    if not bool((out_i == ref_i).all()):
        raise AssertionError(f"ids differ from the plain version: {U, N, D, k}")
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("no CUDA GPU: this sweep runs on the GPU only")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from librecommender_tpu_torch.ops import streaming_topk as st

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    users = torch.from_numpy(rng.standard_normal((256, 65), dtype=np.float32)).cuda()
    items = torch.from_numpy(
        rng.standard_normal((1_000_000, 65), dtype=np.float32)).cuda()
    cases = [  # (U, N, k, rows or None for the plan's, chunk counts)
        (256, 1_000_000, 32, 32, (9, 17, 25, 33, 66, 132)),
        (256, 1_000_000, 32, 16, (33, 66)),
        (256, 1_000_000, 109, None, (16, 17, 33)),  # a catalog recommend's over-fetch
        (1, 3706, 10, None, (1, 3, 5, 8, 15, 28)),
        (1, 3706, 158, None, (1, 3, 5, 8, 15)),
        (1, 3706, 343, None, (1, 3, 5, 8, 10, 15, 29)),
        (1, 3706, 2048, None, (1, 2, 4, 8)),
        (1, 3706, 1000, None, (1, 2, 4, 8, 15)),
        (1, 1_000_000, 10, None, (33, 66, 132, 264)),
        (4, 100_000, 2048, None, (2, 7, 13, 25, 49, 66)),
        (64, 20_000, 100, None, (20, 40, 53, 66, 79)),
    ]
    for U, N, k, rows, sweep in cases:
        u, it = users[:U].contiguous(), items[:N].contiguous()
        p = st.plan(U, N, 65, k, n_sm)
        r = rows or p.rows
        counts = {chunking(st, N, n)[1] for n in sweep} | {p.n_chunks}
        for n in sorted(counts):
            ms = time_plan(st, u, it, k, r, n)
            mark = "  <- plan" if (r, n) == (p.rows, p.n_chunks) else ""
            print(f"U={U} N={N} D=65 k={k} rows={r} n_chunks={n} "
                  f"ms={ms:.4f}{mark}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
