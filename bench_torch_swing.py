#!/usr/bin/env python3
"""Time Swing's pair pass (``csrc/swing.cu``) on one GPU at the shape of
``chip_smoke.py``'s phase 11 run alone: its ML-1M-sized planted data from
seed 0, split 80/20 per user (6040 users, 3706 items, 789,525 train rows).

    python3 bench_torch_swing.py [--runs N] [--fit]

Prints the card's name and power limit, what the pass did (pairs, list
entries, scratch bytes, chunks, tasks, hot rows, launches a call), whether
its int64 sums equal the exact fixed-point sums (each term ``w * 2^32``
rounded to an integer, summed by float64 products whose partial sums are
integers below 2^53, so exact in any order) bit for bit, its milliseconds
by CUDA events (median of ``--runs`` calls) and by device time per kernel
(torch.profiler), and one JSON line of them. ``--fit`` also times
``Swing.fit`` (top_k 20, alpha 1) on the data, on the card (the second of
two fits) and on the CPU (one fit, the plain pass), host clock.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from scipy.sparse import csr_matrix

import chip_smoke
from librecommender_tpu_torch.ops import _build, swing

ALPHA = 1.0


def phase11_data():
    """Phase 11's training data and its interaction lists on the card."""
    rng = np.random.default_rng(0)
    train, _, info = chip_smoke.training_data(chip_smoke.training_columns(rng))
    mat = train.sparse_interaction
    mat = csr_matrix((mat.data, mat.indices, mat.indptr),
                     shape=(info.n_users, info.n_items))
    return train, info, swing.interaction_lists(mat, "cuda")


def exact_sums(lists, n_items):
    """The pass's fixed-point sums of every row, worked out apart: for each
    user u, its partners v > u sharing c >= 2 items add the integer
    ``rint(w * 2^32)`` (w = 1 / (alpha + c) in float32) over the shared
    items' ordered pairs, in float64 products (float64, on the card)."""
    user_indptr, user_items, _, _ = lists
    n_users = user_indptr.shape[0] - 1
    ptr = user_indptr.cpu().tolist()
    users = torch.repeat_interleave(torch.arange(n_users, device="cuda"),
                                    user_indptr[1:] - user_indptr[:-1])
    x = torch.zeros(n_users, n_items, dtype=torch.float64, device="cuda")
    x[users, user_items.long()] = 1.0
    out = torch.zeros(n_items, n_items, dtype=torch.float64, device="cuda")
    alpha32 = torch.tensor(ALPHA, dtype=torch.float32, device="cuda")
    for u in range(n_users):
        items = user_items[ptr[u]:ptr[u + 1]].long()
        sub = x[u + 1:, items]
        c = sub.sum(dim=1)
        keep = c >= 2
        if len(items) < 2 or not bool(keep.any()):
            continue
        y = sub[keep]
        w = 1.0 / (alpha32 + c[keep].float())
        terms = torch.round(w.double() * 2.0 ** 32)
        out[items[:, None], items[None, :]] += y.T @ (terms[:, None] * y)
    out.fill_diagonal_(0.0)
    return out


def fit_seconds(train, info, device):
    """Host seconds of one ``Swing.fit`` on ``device``."""
    from librecommender_tpu_torch.models import Swing

    model = Swing("ranking", info, top_k=20, alpha=ALPHA, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t = time.perf_counter()
    model.fit(train, neg_sampling=True, verbose=0)
    if device != "cpu":
        torch.cuda.synchronize()
    return time.perf_counter() - t


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--fit", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA GPU: bench_torch_swing.py times the kernels on the GPU only")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    _build.build("swing", verbose=True)
    train, info, lists = phase11_data()
    n_users, n_items = info.n_users, info.n_items
    result = {"card": smi,
              "shape": f"{n_users} users x {n_items} items, {len(train)} rows"}

    def call():
        return swing.fixed_sums_cuda(lists, n_items, ALPHA, 0, n_items)

    got = call()
    torch.cuda.synchronize()
    swing.reset_launches()
    call()
    torch.cuda.synchronize()
    result["pass"] = dict(swing.last_pass)
    result["launches_a_call"] = dict(swing.kernel_launches)
    print(f"[pass] {json.dumps(result['pass'])}; launches a call "
          f"{json.dumps(result['launches_a_call'])}", flush=True)
    exact = exact_sums(lists, n_items)
    if float(exact.max()) >= 2.0 ** 53:
        raise SystemExit("exact sums reach 2^53: float64 no longer holds them")
    same = bool(torch.equal(got.double(), exact))
    result["bit_identical_to_exact"] = same
    print(f"[exact] int64 sums equal the exact fixed-point sums bit for bit: {same} "
          f"(nonzero cells {int((got != 0).sum())}, differing "
          f"{int((got.double() != exact).sum())})", flush=True)
    del got, exact
    result["ms"] = chip_smoke.time_ms(call, runs=args.runs, warmup=1)
    print(f"[time] {result['ms']:.3f} ms (events, median of {args.runs})", flush=True)
    per_call = {f"swing_{k}": n for k, n in result["launches_a_call"].items() if n}
    result["device_ms"], result["device_split"], result["launches_seen"] = (
        chip_smoke.device_ms(call, per_call, runs=3))
    result["device_ms_all"] = chip_smoke.device_total_ms(call, runs=3)
    print(f"[device] {result['device_ms']} ms, by kernel "
          f"{json.dumps(result['device_split'])}; every op of the call "
          f"{result['device_ms_all']}", flush=True)
    if args.fit:
        card = [fit_seconds(train, info, "cuda") for _ in range(2)]
        result["fit_s"] = {"card": card[1], "card_first": card[0],
                           "cpu": fit_seconds(train, info, "cpu")}
        print(f"[fit] Swing.fit {json.dumps(result['fit_s'])} s", flush=True)
    print(json.dumps(result))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
