#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (librecommender_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero when it fails:
  0. the card (nvidia-smi) and the kernel builds from csrc/ (one nvcc per
     CUDA source and g++ for the HNSW index's C++, five started together);
  1. the streaming top-k kernel against its plain PyTorch version at fixed
     shapes (a served request at k = 10, 53, 343 and 2048, the catalog,
     k=2048 over 100,000 items, exact ties, and runs of ties straddling
     position k, where ids must agree exactly), with kernel, plain and
     torch.topk times (CUDA events, median) and each pass's device time;
  1b. the table gather and segment-sum kernels against their plain versions
     (gather exact, segment-sum bit-equal to index_add_ on the CPU, two
     launches bit-equal) at the training paths' shapes (BPR's tables, DIN's
     16-row vocabulary, whose ids go in segments, GraphSage's neighbour
     gather, SGNS's negatives) and edge shapes, with
     kernel, plain and library times; one lazy-Adam update of each form timed
     at seven table sizes (the dense-pass gate);
  1c. the row scatter-add kernel against its plain version (bit-equal to
     index_add_ on the CPU, two launches bit-equal) at every shape DIN's step
     launches it at, the other sequence models' shapes and edge shapes,
     uniform and popularity-skewed ids, with kernel, plain and index_add_
     times; a lookup forward and backward through the gather and
     segment-sum kernels against plain indexing at six table sizes (the
     _train_lookup gate), and a sequence gather's through the scatter-add
     against plain indexing from 0.25 to 64 ids a row (the scatter gate);
  2. the serving main path: a BPR (embed_size=64) on an ML-1M-sized DataInfo,
     saved, loaded on the GPU and served over HTTP; every rec_list must match
     the same model loaded on the CPU, and the kernel's launch count must rise;
  3. one catalog-scale recommend_user (10,000 users x 1,000,000 items);
  4. the training path at full width on ML-1M-sized data with a planted
     structure: (a) GPU against CPU on the same batches, (b) same-seed fits
     bit-identical on the card, (c) the quickstart (fit, evaluate,
     recommend_user, save) on the card and on the CPU, AUCs within 0.01,
     with examples/s, per-step kernel times and the card's idle share;
  5. DIN at full width (embed_size=64, batch_size=16384, hidden_units
     (128, 64, 32), recent_num=10, pallas_grad_scatter on) on the same data
     with sex, age and genre features: (a) GPU against CPU on the same
     batches (the first step's gradients, parameters after one step, mean
     loss after 10), (b) same-seed
     fits bit-identical, (c) the scatter kernel on against off after 10 steps,
     (d) a fit with feat_agg_mode="concat", (e) fit, evaluate,
     recommend_user, save, load on the CPU and one served request, with
     examples/s, per-step times and the scatter's device time;
  6. YouTubeRanking, Transformer (bfloat16, one layer) and SIM (long history
     50, top-k 10, its gradient on) at the same width on the same data: (a)
     the first step's gradients and one step's parameters, GPU against CPU,
     (b) a fit on the card with each kernel's launches, examples/s, per-step
     times and the card's idle share, (c) evaluate's AUC on the card and on
     the CPU, (d) recommend_user against the CPU-loaded model, (e) SIM's
     request seq equal to the stored history against the static call, and SIM
     saved, loaded on the GPU and served over HTTP;
  7. FM, DeepFM, WideDeep (FTRL and Adam), AutoInt and NCF at DIN's width on
     the same data, 2 epochs: (a) the first step's gradients and one step's
     parameters, GPU against CPU, (b) a fit on the card with one gather and
     one segment-sum a step (none for NCF), examples/s, per-step times and
     the card's idle share, (c) evaluate's AUC on the card and on the CPU,
     (d) recommend_user against the CPU-loaded model, (e) FM's request-time
     paths: user_feats={} against the static call, predict(feats=...) and
     predict_data_with_feats against the CPU, one served request, and the
     recommendations after the same assign_user_features on both devices;
     then one JSON line of phase 7's numbers;
  8. SVD (lazy Adam), SVDpp (recent 30, the dense W form), RNN4Rec (gru and
     lstm, hidden 64), Caser and WaveNet (recent 10) at embed 64, batch
     16384, lr 0.001, 2 epochs, and ALS (implicit, reg 0.1, alpha 10), on
     phase 4's data: first the port's convolutions at Caser's and
     WaveNet's shapes, value and gradients against float64 under PyTorch's
     default cuDNN setting (TF32 on), within 1e-5; (a) the first step's
     gradients and one step's parameters, GPU against CPU (SVDpp: one step
     of the neighbour-gather form too; ALS: one user-side solve, its bucket
     gathers through the gather kernel exact against index_select), (b) a
     profiled fit of 16 steps (SVD: two same-seed fits, bit-identical), then
     a fit on the card with examples/s, per-step times and the card's idle
     share (ALS: one gather launch a bucket a side an epoch, an epoch's
     gathers timed against index_select), (c) evaluate's AUC on
     the card and on the CPU, (d) recommend_user against the CPU-loaded
     model, (e) RNN4Rec's request seq equal to the stored history against
     the static call and one served request; then one JSON line of phase
     8's numbers;
  9. YouTubeRetrieval (sampled softmax, 8192 shared negatives) and TwoTower
     (in-batch softmax, popularity correction) on phase 5's feature data,
     LightGCN (3 layers, dense bfloat16 adjacency) and NGCF (bpr, hidden
     (64, 64, 64), dense R: 256-wide embeddings) on phase 4's data, at embed
     64, 8192 rows a step, lr 0.001, 2 epochs: (a) the first step's
     gradients and one step's parameters, GPU against CPU from the same
     parameters, batches and draws (the shared negatives and SSL masks fed
     through the models' seams), and one step of YouTubeRetrieval's NCE,
     TwoTower's cfm SSL with lazy Adam in bfloat16 (held like the
     Transformer), LightGCN's and NGCF's edge lists and NGCF with AMSGrad;
     (b) a profiled fit of 16 steps, then a fit on the card with examples/s,
     per-step times, idle share and the top-k's launches; (c) evaluate's
     AUC (and NDCG, through the top-k) on the card and on the CPU; (d)
     recommend_user against the CPU-loaded model, and the top-k at each
     path's width (D = 65, 32, 64, 256) at a served request and an
     evaluate call against its plain version and torch.topk(u @ i.T); (e)
     TwoTower's recommend_user(user_feats=...) against the CPU and one
     served request; then one JSON line of phase 9's numbers;
 10. GraphSage (cross-entropy, 2 layers, 10 neighbours) and PinSage
     (max_margin, 10 walks of 2 hops) u2i on phase 5's feature data, so
     the node-feature projections run, and GraphSage i2i (bpr, 1638 start
     nodes a step, 10 walks of 5 hops: 81,900 walk pairs), Item2Vec (window
     5, 5 negatives, 10,000 pairs a step) and DeepWalk (10 walks of 10) on
     phase 4's data, at embed 64, lr 0.001: (a) the first step's gradients
     and one step's parameters, GPU against CPU from the same parameters,
     batches and draws (fed through the models' seams); (b) a profiled fit
     of 16 steps, Item2Vec's two same-seed fits
     (bit-identical), then the fit on the card with examples/s, per-step
     times, idle share and the gather's, segment-sum's and top-k's
     launches; (c) evaluate's AUC and NDCG on the card and on the CPU; (d)
     recommend_user against the CPU-loaded model, and for i2i and SGNS every
     user the mean of the consumed items; (e) GraphSage u2i served over
     HTTP; then one JSON line of phase 10's numbers;
 11. UserCF and ItemCF (cosine, k_sim 20) and Swing (top_k 20, alpha 1) on
     phase 4's data: (a) the searches on the card against the CPU's (ids
     equal but where two exact float64 similarities lie within 1e-5
     relative, values rtol 1e-5), a pearson and a jaccard item search too,
     two card fits bit-identical, each search's device ms against its flop
     bound; (b) Swing's full fit (each pair-pass kernel's launches
     counted, one line of the pass's pairs, list entries, scratch bytes and
     launches a fit), two fits bit-identical, the pass against its plain
     version on the fit's lists (every user) and the fit's lists against
     the plain scores' top-k;
     (c) evaluate's AUC and NDCG against the CPU within 0.01, recommend_user
     and predict (rtol 1e-6) against the model on the CPU holding the same
     lists; (d) retrain on the card: BPR and SVD fitted, saved, merged with
     a second period of new users and items, rebuilt (rows and moment rows
     grafted exactly) and refitted, a checkpoint resumed bit for bit, and
     UserCF's incremental update held to the C++'s contract (touched rows
     as a fresh search, untouched rows as their old lists merged with the
     fresh candidates, copied through where nothing changed them); then one
     JSON line of phase 11's numbers;
 12. ANN and knn retrieval: (a) BPR (embed 64) on phase 2's ML-1M-like
     data, init_ann("ivf") at its defaults (60 clusters, 20 Lloyd steps, a
     segment-sum each; n_probe 8) and recommend_user for every user, n_rec
     10: one Lloyd step on the card against the CPU's from the same
     centroids, two builds bit-identical, the search against the CPU's over
     the saved index, no consumed item but through the popular fill; the
     build seconds, a request's ms, recall@10 against the exact top-k, the
     users that reached the fill; (b) phase 3's catalog model, init_ann at
     1000 clusters over 1,000,000 items and a search of its 256 users at
     k=32 (the probe through the top-k, the candidates through the gather),
     device ms by kernel, recall@32 against the full scan, a Lloyd step and
     16 users' search against the CPU; (c) on (a)'s model init_ann("hnsw")
     (two builds byte-equal, save and load, a failing compiler raises) and
     init_knn approximate and exact under cosine and inner-product, the
     exact searches on the card against the CPU, overlaps beside JAX's
     test thresholds; 2.1, 2.2a and 2.2b held against their plain versions
     at the IVF shapes of (a) and (b); then one JSON line of phase 12's
     numbers;
 13. the HTTP serving tier (serving/), every kind from an artifact of
     serialization.py hydrated into a DictStore and served from the card:
     (a) the embed kind on phase 2's BPR, 32 users at n_rec 10 and 50 and
     an unknown one, every list equal but for near-ties to the JAX app's
     float64 arithmetic redone from the artifact and to the same artifact
     served from the CPU, 2.1 launched for every request; save_ivf_index
     (its Lloyd steps through 2.2b), the index loaded on the card searching
     as the built one; (b) the knn kind on phase 11's UserCF, ItemCF and
     Swing, lists equal to the JAX app's arithmetic, no consumed item; (c)
     the online kind and /candidates on phase 8's RNN4Rec (request seqs) and
     phase 5's DIN (request features), equal but for near-ties to the
     CPU-loaded model's recommend_user; (d) serving.benchmark.run_benchmark
     in a process of its own against the embed and model kinds, 2000
     requests at concurrency 1 and 16, rps and p50/p95/p99 ms on the host
     clock, a sample of concurrent answers equal to sequential ones; then
     one JSON line of phase 13's numbers.
The last line is {"ok": true, "device": {...}}; the line before it lists each
kernel with its launches on the main path, error, times and bound.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_F32_FLOPS = 67e12     # f32 FMA peak outside the tensor cores (H100 SXM)
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s (H100 SXM)
RTOL = 1e-5                # scores and near-tie rule, relative
TIMED_RUNS = 10


def log(*args):
    print(*args, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def time_ms(fn, runs=TIMED_RUNS, warmup=2):
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, runs=TIMED_RUNS, warmup=1):
    """Median milliseconds of ``fn()`` on the host clock, the card
    synchronised after each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def enqueue_ms(fn, runs=TIMED_RUNS, warmup=2):
    """Median milliseconds, host clock, of enqueueing ``fn()`` on an idle
    card (synchronised before each call, not after)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _self_device_us(evt):
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0.0) if us is None else us


def _is_kernel(evt):
    """Whether a profiler row is work on the card (a kernel or a copy), not
    the host operator that launched it and carries the same device time."""
    from torch.autograd import DeviceType

    return (getattr(evt, "device_type", None) == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def profiled(fn, warmup=False):
    """Run ``fn()`` under torch.profiler (CPU and CUDA); returns its
    key_averages(). With ``warmup``, ``fn()`` runs twice: first in a warm-up
    step whose records the profiler discards (its schedule's warm-up, for
    the start of a trace, which is skewed), then in the step returned."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if not warmup:
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        return prof.key_averages()
    done = []
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: done.append(p.key_averages())) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return done[0] if done else []


def device_ms(fn, launches, runs=TIMED_RUNS):
    """Device milliseconds a call of ``fn()`` spends in the kernels named in
    ``launches`` (a string each kernel's profiler row contains -> its
    launches a call), from torch.profiler: each kernel's mean over the
    launches the profile holds, times its launches a call. A profile taken
    late in a long process has been seen to hold fewer launches than were
    made (cause not found), so the profile starts with a warm-up step it
    discards, and any shortfall left is logged. Returns (total
    ms, {name: ms}, {name: {"seen": launches held, "made": launches
    made}}); the total is None when the profile held no launch of some
    named kernel that was launched, or more launches than ``launches`` says
    were made (a kernel of 0 launches a call, such as the top-k's second
    pass under a one-chunk plan, counts 0 ms)."""
    fn()

    def repeat():
        for _ in range(runs):
            fn()

    for _ in range(3):   # a profile now and then comes back empty
        us, seen = {}, dict.fromkeys(launches, 0)
        for evt in profiled(repeat, warmup=True):
            for name in launches:
                if name in evt.key and _self_device_us(evt) > 0:
                    us[name] = us.get(name, 0.0) + _self_device_us(evt)
                    seen[name] += evt.count
        if us:
            break
    held = {n: {"seen": seen[n], "made": runs * k} for n, k in launches.items()}
    split = {n: us[n] / seen[n] * launches[n] / 1e3 for n in us}
    short = {n: h for n, h in held.items() if h["seen"] != h["made"]}
    total = None if any((h["seen"] == 0 and h["made"] > 0) or h["seen"] > h["made"]
                        for h in held.values()) else sum(split.values())
    if short:
        log(f"[profile] launches the profile holds, of those made: {short}"
            + ("" if total is not None else "; device ms is null"))
    return total, split, held


def device_total_ms(fn, runs=TIMED_RUNS):
    """Device milliseconds per call of ``fn()`` in all its kernels and copies
    (a library call's own device time), from torch.profiler; None if the
    profiler saw no device time."""
    fn()

    def repeat():
        for _ in range(runs):
            fn()

    for _ in range(3):   # a profile now and then comes back empty
        us = sum(_self_device_us(evt) for evt in profiled(repeat, warmup=True)
                 if _is_kernel(evt))
        if us > 0:
            return us / runs / 1e3
    log("[profile] library call: no device rows, device ms is null")
    return None


def bound_ms(U, N, D, k):
    """Least time on an H100 SXM: the larger of the f32 operations at the
    CUDA-core peak and the bytes (inputs read once, outputs written once)
    at the HBM rate. Returns (ms, "operations" | "bytes")."""
    ops = 2.0 * U * N * D
    nbytes = 4.0 * (U * D + N * D) + 8.0 * U * k
    t_ops, t_bytes = ops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def score_tol(users, items, rows, ids):
    """Per entry, how far two f32 computations of the score of item
    ``ids[n]`` for user ``rows[n]`` may lie apart: rtol RTOL, or where that
    is smaller (scores near zero), the rounding bound of two f32 dot products
    summed in any order, 2 D 2**-24 sum_d |u_d i_d|."""
    u = users.double()[torch.as_tensor(rows, dtype=torch.long)]
    it = items.double()[torch.as_tensor(ids, dtype=torch.long)]
    exact = (u * it).sum(1).cpu().numpy()
    terms = (u * it).abs().sum(1).cpu().numpy()
    return exact, np.maximum(RTOL * np.abs(exact),
                             2.0 * users.shape[1] * 2.0**-24 * terms)


def check_topk(users, items, ids_k, sc_k, ids_p, sc_p, what, exact_ids=False):
    """Kernel vs plain: scores within ``score_tol``; ids equal except where
    the exact (float64) scores of the two ids are within it (never, with
    ``exact_ids``)."""
    ids_k, sc_k = ids_k.cpu().numpy(), sc_k.cpu().numpy()
    ids_p, sc_p = ids_p.cpu().numpy(), sc_p.cpu().numpy()
    if ids_k.shape != ids_p.shape or not np.isfinite(sc_k).all():
        fail(f"{what}: shape {ids_k.shape} vs {ids_p.shape} or non-finite scores")
    err = float(np.abs(sc_k - sc_p).max())
    rows = np.repeat(np.arange(ids_p.shape[0]), ids_p.shape[1])
    _, tol = score_tol(users, items, rows, ids_p.ravel())
    if not np.all(np.abs(sc_k - sc_p).ravel() <= tol):
        fail(f"{what}: scores differ beyond rtol {RTOL} and the f32 rounding "
             f"bound (max abs err {err})")
    rows, cols = np.nonzero(ids_k != ids_p)
    near_ties = 0
    if rows.size and exact_ids:
        fail(f"{what}: {rows.size} ids differ where ties must resolve exactly")
    if rows.size:
        ea, ta = score_tol(users, items, rows, ids_k[rows, cols])
        eb, tb = score_tol(users, items, rows, ids_p[rows, cols])
        if not np.all(np.abs(ea - eb) <= np.maximum(ta, tb)):
            fail(f"{what}: {rows.size} ids differ and are not near-ties")
        near_ties = int(rows.size)
    return err, near_ties


def make_inputs(rng, U, N, D, ties=0):
    """Normal users (U, D) and items (N, D) on the card; with ``ties``, dyadic
    values and every item row repeated about ``ties`` times at shuffled
    positions."""
    if ties:
        # dyadic values: every dot product is exact, so duplicated item rows
        # tie exactly in any summation order
        users = rng.integers(-4, 5, (U, D)).astype(np.float32) / 4
        base = rng.integers(-4, 5, (N // ties, D)).astype(np.float32) / 4
        items = np.repeat(base, ties, axis=0)[rng.permutation(N // ties * ties)]
        items = np.concatenate([items, base[: N - len(items)]])
    else:
        users = rng.standard_normal((U, D), dtype=np.float32)
        items = rng.standard_normal((N, D), dtype=np.float32)
    return torch.from_numpy(users).cuda(), torch.from_numpy(items).cuda()


def measure_kernel(st, users, items, k, what, exact_ids=False):
    """Compare the kernel with its plain version on one input and time the
    kernel, the plain version and torch.topk(users @ items.T, k)."""
    before = st.launches
    ids_k, sc_k = st.streaming_topk(users, items, k)
    launches = st.launches - before
    ids_p, sc_p = st.streaming_topk_plain(users, items, k)
    torch.cuda.synchronize()
    if launches != 1:
        fail(f"{what}: the kernel counted {launches} launches for one call")
    ids_equal = float((ids_k == ids_p).float().mean())
    err, near = check_topk(users, items, ids_k, sc_k, ids_p, sc_p, what,
                           exact_ids)
    U, D = users.shape
    N = items.shape[0]
    ms = time_ms(lambda: st.streaming_topk(users, items, k))
    # pass 2 merges the chunks' candidates where there is more than one chunk
    n_chunks = st.plan(U, N, D, k, torch.cuda.get_device_properties(
        users.device).multi_processor_count).n_chunks
    dev_ms, split, seen = device_ms(lambda: st.streaming_topk(users, items, k),
                                    {"topk_pass1": 1, "topk_pass2": int(n_chunks > 1)})
    plain_ms = time_ms(lambda: st.streaming_topk_plain(users, items, k), runs=10)
    lib_ms = time_ms(lambda: torch.topk(users @ items.T, k, dim=1))
    lib_dev_ms = device_total_ms(lambda: torch.topk(users @ items.T, k, dim=1))
    # the host's share: enqueueing a call on an idle card
    enq_ms = enqueue_ms(lambda: st.streaming_topk(users, items, k))
    lib_enq_ms = enqueue_ms(lambda: torch.topk(users @ items.T, k, dim=1))
    b_ms, b_by = bound_ms(U, N, D, k)
    row = dict(shape=dict(U=U, N=N, D=D, k=k), launches=launches,
               ids_equal=ids_equal, max_abs_err=err, near_ties=near,
               ms=ms, device_ms=dev_ms, device_split=split, launches_seen=seen,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dev_ms,
               enqueue_ms=enq_ms, library_enqueue_ms=lib_enq_ms,
               bound_ms=b_ms, bound_by=b_by)
    log(f"[kernel] {what} {json.dumps(row)}")
    log(f"[kernel] {what}: device ms by pass "
        + (", ".join(f"{n} {v:.4f}" for n, v in split.items()) or "not measured")
        + f"; events ms {ms:.4f} vs torch.topk(u @ i.T) {lib_ms:.4f} (device "
        f"{lib_dev_ms if lib_dev_ms is None else round(lib_dev_ms, 4)}); host "
        f"enqueue ms {enq_ms:.4f} vs {lib_enq_ms:.4f}")
    return row


def phase_card_and_build():
    """The card's name and power limit (returned), and the kernel build."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from concurrent.futures import ThreadPoolExecutor

    from librecommender_tpu_torch.ops import _build

    t0 = time.perf_counter()
    names = ("streaming_topk", "table_gather", "row_scatter", "swing")
    # the CUDA sources by nvcc and the HNSW index's host C++ by g++, at once
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(_build.build_host, "hnsw")
        paths = list(pool.map(lambda n: _build.build(n, verbose=True), names))
        paths.append(host.result())
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s")
    return smi


def phase_kernel(rng):
    from librecommender_tpu_torch.ops import streaming_topk as st

    # (what, U, N, D, k, copies of each item row: 0 for normal values)
    shapes = [
        ("one request, ML-1M catalog", 1, 3706, 65, 10, 0),
        ("one request, k=53", 1, 3706, 65, 53, 0),
        ("one request, k=343", 1, 3706, 65, 343, 0),
        ("one request, k=2048", 1, 3706, 65, 2048, 0),
        ("catalog", 256, 1_000_000, 65, 32, 0),
        ("ragged", 13, 1000, 32, 10, 0),
        ("k=2048", 4, 100_000, 65, 2048, 0),
        ("ties", 64, 20_000, 65, 100, 4),
        # about 60 copies of 62 rows: runs of equal scores straddle k
        ("boundary ties, one request", 1, 3706, 65, 343, 60),
        ("boundary ties, k=2048", 4, 100_000, 65, 2048, 600),
    ]
    for what, U, N, D, k, copies in shapes:
        users, items = make_inputs(rng, U, N, D, copies)
        measure_kernel(st, users, items, k, what, exact_ids=copies > 0)


def ml1m_like(rng, n_users=6040, n_items=3706, mean_per_user=165, rank=8):
    """An ML-1M-sized set of implicit interactions: 6040 users, 3706 items,
    about 1M distinct (user, item) pairs, at least 20 per user, drawn by
    popularity falling off by rank times a planted rank-8 user-item affinity
    (so that a trained model's AUC means something). Returns
    ``(counts, consumed)``: items per user, and each user's items."""
    counts = np.clip(rng.lognormal(np.log(mean_per_user) - 0.5, 1.0, n_users),
                     20, n_items // 2).astype(np.int64)
    pop = 1.0 / (np.arange(n_items) + 10.0) ** 0.9
    pop = pop[rng.permutation(n_items)]
    user_f = rng.standard_normal((n_users, rank)) * (1.5 / np.sqrt(rank))
    item_f = rng.standard_normal((n_items, rank))
    consumed = {}
    for u, c in enumerate(counts):
        logit = item_f @ user_f[u]
        p = pop * np.exp(logit - logit.max())
        consumed[u] = rng.choice(n_items, int(c), replace=False, p=p / p.sum()).tolist()
    return counts, consumed


def _data_info(counts, consumed, n_items):
    """DataInfo, built with the port's own constructor, of users consuming
    the items ``consumed[u]``."""
    from librecommender_tpu_torch.data import DataInfo

    users = np.repeat(np.arange(len(counts)), counts)
    items = np.concatenate([consumed[u] for u in range(len(counts))])
    # raw ids: users 1.., items 1..; label 1 (implicit feedback)
    rows = np.stack([users + 1, items + 1, np.ones(len(users))], axis=1)
    return DataInfo(
        interaction_data=rows, user_consumed=consumed,
        user_unique_vals=np.arange(1, len(counts) + 1),
        item_unique_vals=np.arange(1, n_items + 1),
    )


def check_recs(got, want, ref_model, user, what):
    """Raw-id lists must match; a position may differ only where the two
    items' exact (float64) scores for this user are within RTOL."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} recs vs {len(want)}")
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not diff:
        return 0
    info = ref_model.data_info
    uid = info.user2id.get(user, ref_model.n_users)
    u = ref_model.user_embeds_np[uid].astype(np.float64)
    for i in diff:
        sa = u @ ref_model.item_embeds_np[info.item2id[got[i]]].astype(np.float64)
        sb = u @ ref_model.item_embeds_np[info.item2id[want[i]]].astype(np.float64)
        if abs(sa - sb) > RTOL * max(abs(sa), abs(sb)):
            fail(f"{what}: position {i} differs ({got[i]} vs {want[i]}) "
                 f"and is not a near-tie ({sa} vs {sb})")
    return len(diff)


def http(url, payload=None):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            fail(f"{url}: HTTP {resp.status}")
        return json.loads(resp.read())


class ServerThread:
    """A server of ``kind`` on ``device`` in a thread, for a ``with`` block:
    its base URL, then shut down and joined (``.server`` is the server)."""

    def __init__(self, kind, store, device="cuda"):
        from librecommender_tpu_torch.serving import create_server

        self.server, port = create_server(kind, store, port=0, device=device)
        self.base = f"http://127.0.0.1:{port}"

    def __enter__(self):
        import threading

        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        return self.base

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        if self.thread.is_alive():
            fail(f"serving {self.server.kind}: the server thread did not stop")


def phase_serving(rng, workdir):
    """The main path: save a BPR(embed_size=64), serve it over HTTP from the
    GPU, and hold every answer against the same model loaded on the CPU.
    Returns the kernel's row and the model (phase 12 indexes it)."""
    from librecommender_tpu_torch.models import BPR
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops.topk import fetch_size
    from librecommender_tpu_torch.serving import DictStore

    t0 = time.perf_counter()
    info = _data_info(*ml1m_like(rng), 3706)
    model = BPR("ranking", info, embed_size=64, seed=int(rng.integers(1 << 30)),
                device="cuda")
    model.build_model()
    model.post_fit()
    model.save(workdir, "bpr")
    ref = BPR.load(workdir, "bpr", device="cpu")
    log(f"[serving] {info!r}; built, saved and loaded on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")

    store = DictStore()
    store.set("model_path", str(workdir))
    store.set("model_meta", {"model_name": "bpr"})
    known = [int(info.id2user[int(i)]) for i in rng.choice(info.n_users, 3, replace=False)]
    requests = [(u, n) for u in known for n in (10, 50)] + [(10**9, 10)]
    served = ServerThread("model", store)
    with served as base:
        if http(base + "/health") != {"status": "ok"}:
            fail("/health")
        st.reset_launches()
        latencies, near = [], 0
        for user, n_rec in requests:
            t = time.perf_counter()
            got = http(base + "/model/recommend", {"user": user, "n_rec": n_rec})
            latencies.append((time.perf_counter() - t) * 1e3)
            want = [int(i) for i in ref.recommend_user(user, n_rec)[user]]
            near += check_recs(got["rec_list"], want, ref, user,
                               f"user {user} n_rec {n_rec}")
        main_launches = st.launches
        gpu_model = served.server.model()
    if main_launches < len(requests):
        fail(f"{len(requests)} requests launched the kernel {main_launches} times")
    log(f"[serving] {len(requests)} requests, rec_lists equal to the CPU model's "
        f"({near} near-tie swaps), kernel launches {main_launches}; latency ms "
        f"(first includes loading the model): "
        + ", ".join(f"{x:.2f}" for x in latencies))

    # the kernel at the main path's shape: the first request's user row
    # against the catalog, at the k that request over-fetched
    user, n_rec = requests[0]
    uid = info.user2id[user]
    width = len(info.user_consumed[uid])
    k = fetch_size(n_rec, width if n_rec + width <= info.n_items else 0, info.n_items)
    row = measure_kernel(st, gpu_model.user_embeds[uid:uid + 1],
                         gpu_model.item_embeds[:-1], k, "main path, one request")
    row["main_path_launches"] = main_launches
    return row, model


def phase_catalog(rng):
    """One recommend_user over 256 users of a 10,000 x 1,000,000 BPR.
    Returns the model and the 256 raw users (phase 12 indexes them)."""
    from librecommender_tpu_torch.models import BPR
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops.topk import topk_from_embeddings

    n_users, n_items = 10_000, 1_000_000
    t0 = time.perf_counter()
    counts = rng.integers(20, 100, n_users)
    consumed = {u: rng.choice(n_items, int(c), replace=False).tolist()
                for u, c in enumerate(counts)}
    info = _data_info(counts, consumed, n_items)
    model = BPR("ranking", info, embed_size=64, seed=int(rng.integers(1 << 30)),
                device="cuda")
    model.build_model()
    model.set_embeddings()
    log(f"[catalog] {info!r}; set up in {time.perf_counter() - t0:.1f} s")
    users = [int(info.id2user[int(i)]) for i in rng.choice(n_users, 256, replace=False)]
    model.recommend_user(users[:2], 10)  # warm-up
    st.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    recs = model.recommend_user(users, 10, filter_consumed=True)
    ms = (time.perf_counter() - t) * 1e3
    launches = st.launches
    if launches < 1:
        fail("catalog recommend_user did not launch the kernel")
    sub = users[:8]
    uids = np.array([info.user2id[u] for u in sub])
    cpu_ids, _ = topk_from_embeddings(
        torch.from_numpy(model.user_embeds_np[uids]),
        torch.from_numpy(model.item_embeds_np[:-1]), 10,
        user_consumed=info.user_consumed, user_ids=uids)
    near = 0
    for r, u in enumerate(sub):
        want = [int(info.id2item[int(i)]) for i in cpu_ids[r]]
        near += check_recs([int(i) for i in recs[u]], want, model, u,
                           f"catalog user {u}")
    for u in users:
        rec_ids = {info.item2id[int(i)] for i in recs[u]}
        if rec_ids & set(info.user_consumed[info.user2id[u]]):
            fail(f"catalog user {u}: a consumed item was recommended")
    log(f"[catalog] recommend_user(256 users, n_rec=10, filter_consumed=True) "
        f"{ms:.2f} ms, {launches} kernel launch(es); 8 users equal to the CPU "
        f"plain path ({near} near-tie swaps)")
    return model, users


# ------------------------------------------------- table gather, segment-sum
# the port's kernels by name (PyTorch has a vectorized_gather_kernel of its own)
GATHER_NAMES = ("::gather_kernel", "::segsum_kernel")
# the last kernel of a segment-sum or scatter-add whose ids go in segments
PARTIALS = "sum_partials_kernel"
# the two kernels that partition the ids of a segment-sum or scatter-add
# (staged::partition_count, staged::partition_place)
PARTITION = "partition_"


def staged_launches(add, n_rows, D, N, partition=None):
    """The kernels one segment-sum or scatter-add call launches at these
    shapes (``add`` names its add kernel), each with its launches a call:
    the add; where the ids are partitioned, the place kernel and, with more
    than one chunk, the count kernel; with more than one segment, the sum
    of the partial tables."""
    from librecommender_tpu_torch.ops import table_gather as tg

    form = tg.staged_form(n_rows, D, N, partition)
    segs = tg.staged_plan(n_rows, D, N)[0][2]
    out = {add: 1, PARTITION: (1 + (form.n_chunks > 1)) * form.partition,
           PARTIALS: int(segs > 1)}
    return {name: n for name, n in out.items() if n}


def device_row(fn, launches):
    """A kernels-line row's device keys for ``fn()``: its device ms (null
    where the profile lost a kernel), by kernel, and the launches its
    profile held of those made."""
    total, split, held = device_ms(fn, launches)
    return dict(device_ms=total, device_split=split, launches_seen=held)


def table_bound_ms(kind, R, B, D, n_valid, n_distinct):
    """Least time on an H100 SXM for one call: the bytes each input is read
    and each output written once at the HBM rate (the gather reads B ids and
    the n_distinct table rows its valid ids touch, each once however often
    it is gathered, and writes B rows; the segment-sum reads B ids and B rows
    and writes all R rows), against the adds of the valid ids at the f32
    peak."""
    if kind == "gather":
        nbytes, ops = 4.0 * B + 4.0 * D * n_distinct + 4.0 * B * D, 0.0
    else:
        nbytes, ops = 4.0 * B + 4.0 * B * D + 4.0 * R * D, float(n_valid) * D
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, ops / H100_F32_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


# phase 1b: (name, R, D, B, ragged ids, bf16 values too). The gather and
# segment-sum at the training paths' shapes (the user table 6048 x 64 and the
# item table 3712 x 65 of BPR embed 64 at ML-1M, 8192 ids a lookup, and the
# item table at a batch of 32,768, where the ordered add's two forms meet;
# DIN's 16-row sparse vocabulary at a step's 2 x 16,384 field lookups and at
# the packed token table's 3707), a ragged shape with out-of-range and
# duplicate ids, parity/bench_scatter.py's four table sizes in f32 and bf16,
# a 1,000,000-row table, a 200,000-row one where a quarter of the ids
# are one id (256-row tiles with a hot row), and phase 10's two lookups:
# GraphSage's neighbour gather at ML-1M (3706 items x 10 picks into the
# 6048-row user side) and SGNS's negatives (10,000 x 5 into 3712 rows).
TABLE_SHAPES = [
    ("main path, user table", 6048, 64, 8192, False, True),
    ("main path, item table", 3712, 65, 8192, False, True),
    ("item table, batch 32,768", 3712, 65, 32_768, False, False),
    ("DIN sparse fields", 16, 64, 32_768, False, False),
    ("DIN token features", 16, 64, 3707, False, False),
    ("ragged", 131, 33, 77, True, True),
    ("bench_scatter V=3712", 3712, 64, 8192, False, True),
    ("bench_scatter V=6144", 6144, 64, 8192, False, True),
    ("bench_scatter V=16384", 16384, 64, 8192, False, True),
    ("bench_scatter V=131072", 131_072, 64, 8192, False, True),
    ("1M-row table", 1_000_000, 64, 16384, False, False),
    ("sparse tiles, a run of one id", 200_000, 64, 8192, True, False),
    ("GraphSage neighbour gather", 6048, 64, 37_060, False, False),
    ("SGNS negatives", 3712, 64, 50_000, False, False),
]


def table_ids(rng, R, B, ragged):
    """B ids into R rows, uniform; ragged: from [-3, R + 4) with the first
    quarter one id."""
    lo, hi = (-3, R + 4) if ragged else (0, R)
    ids = rng.integers(lo, hi, B).astype(np.int32)
    if ragged:
        ids[: B // 4] = ids[0]      # a run of duplicates
    return ids


def check_ordered_add(first, second, want, what):
    """Two launches of the segment-sum or scatter-add bit-equal, and bit-equal
    to the plain version (index_add_ on the CPU, per segment); returns the
    largest difference from the plain version."""
    err = float((first.cpu() - want).abs().max()) if first.numel() else 0.0
    if not torch.equal(first, second):
        fail(f"{what}: two launches differ")
    if not torch.equal(first.cpu(), want):
        fail(f"{what}: not bit-equal to its plain version, index_add_ on the CPU "
             f"(max abs err {err})")
    return err


def measure_table_kernels(rng, R, D, B, what, ragged=False, bf16=False,
                          data=None, kernels=("table_gather", "segment_sum")):
    """Hold the gather and the segment-sum (float32 values, and bf16 with
    ``bf16``) against their plain versions at one shape, and time each: the
    kernel (CUDA events, and device time by torch.profiler), the plain
    version (gather: torch ops on the card; segment-sum: index_add_ on the
    CPU, host clock, copies included) and the library call (index_select;
    index_add_ on the card, whose float atomics make it nondeterministic).
    ``data``: the (ids, table, vals) tensors on the card of a path's own
    call, in place of random ones; ``kernels``: which of the two to hold."""
    from librecommender_tpu_torch.ops import table_gather as tg

    if data is None:
        ids = torch.from_numpy(table_ids(rng, R, B, ragged)).cuda()
        table = torch.from_numpy(rng.standard_normal((R, D), dtype=np.float32)).cuda()
        vals = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).cuda()
    else:
        ids, table, vals = data
    valid = (ids >= 0) & (ids < R)
    n_valid = int(valid.sum())
    ids_long, ids_in = ids.long()[valid], ids.long().clamp(0, R - 1)
    n_distinct = int(torch.unique(ids_long).numel())
    vals_valid = None if vals is None else vals[valid]
    rows = {}

    if "table_gather" in kernels:   # the gather: exact
        before = tg.gather_launches
        out = tg.table_gather(table, ids)
        torch.cuda.synchronize()
        if tg.gather_launches != before + 1:
            fail(f"{what}: table_gather counted {tg.gather_launches - before} launches")
        plain = tg.table_gather_plain(table, ids)
        if not torch.equal(out, plain):
            fail(f"{what}: table_gather differs from its plain version")
        b_ms, b_by = table_bound_ms("gather", R, B, D, n_valid, n_distinct)
        rows["table_gather"] = dict(
            shape=dict(R=R, D=D, B=B), max_abs_err=0.0,
            ms=time_ms(lambda: tg.table_gather(table, ids)),
            **device_row(lambda: tg.table_gather(table, ids), {"::gather_kernel": 1}),
            plain_ms=time_ms(lambda: tg.table_gather_plain(table, ids)),
            enqueue_ms=enqueue_ms(lambda: tg.table_gather(table, ids)),
            library_ms=time_ms(lambda: torch.index_select(table, 0, ids_in)),
            library_device_ms=device_total_ms(lambda: torch.index_select(table, 0, ids_in)),
            library_enqueue_ms=enqueue_ms(lambda: torch.index_select(table, 0, ids_in)),
            bound_ms=b_ms, bound_by=b_by)

    if "segment_sum" in kernels:   # bit-equal to index_add_ on the CPU, twice
        for name, dtype in (("segment_sum", torch.float32),
                            ("segment_sum_bf16", torch.bfloat16))[: 2 if bf16 else 1]:
            counter = "segsum_bf16_launches" if dtype == torch.bfloat16 else "segsum_launches"
            before = getattr(tg, counter)
            first = tg.segment_sum(ids, vals, R, vals_dtype=dtype)
            second = tg.segment_sum(ids, vals, R, vals_dtype=dtype)
            torch.cuda.synchronize()
            if getattr(tg, counter) != before + 2:
                fail(f"{what}: {name} counted {getattr(tg, counter) - before} launches")
            err = check_ordered_add(first, second, tg.segment_sum_plain(
                ids, vals, R, vals_dtype=dtype), f"{what}: {name}")
            b_ms, b_by = table_bound_ms("segsum", R, B, D, n_valid, n_distinct)
            rows[name] = dict(
                shape=dict(R=R, D=D, B=B), plan=tg.staged_plan(R, D, B),
                max_abs_err=err,
                ms=time_ms(lambda: tg.segment_sum(ids, vals, R, vals_dtype=dtype)),
                **device_row(lambda: tg.segment_sum(ids, vals, R, vals_dtype=dtype),
                             staged_launches("::segsum_kernel", R, D, B)),
                enqueue_ms=enqueue_ms(
                    lambda: tg.segment_sum(ids, vals, R, vals_dtype=dtype)),
                plain_ms=host_ms(lambda: tg.segment_sum_plain(ids, vals, R, vals_dtype=dtype),
                                 runs=5),
                library_ms=time_ms(lambda: torch.zeros((R, D), device="cuda").index_add_(
                    0, ids_long, vals_valid)),
                library_device_ms=device_total_ms(
                    lambda: torch.zeros((R, D), device="cuda").index_add_(
                        0, ids_long, vals_valid)),
                bound_ms=b_ms, bound_by=b_by)
    for name, row in rows.items():
        log(f"[tables] {what} {name} {json.dumps(row)}")
    return rows


def phase_table_kernels(rng):
    """The gather and segment-sum at every shape of TABLE_SHAPES. Returns
    every shape's rows."""
    out = {}
    for what, R, D, B, ragged, bf16 in TABLE_SHAPES:
        out[what] = measure_table_kernels(rng, R, D, B, what, ragged, bf16)
    return out


def phase_adam_gate(rng):
    """One lazy-Adam update of each form (dense masked pass, row path) on the
    card, at ML-1M's two tables and larger ones, 16,384 touched ids (one BPR
    step's items at batch 8192), timed in turns (dense, rows, rows, dense;
    the mean of each form's two medians): the numbers behind
    DENSE_UPDATE_MAX_ROWS."""
    from librecommender_tpu_torch.ops.table_gather import segment_sum
    from librecommender_tpu_torch.training import sparse_optim as so

    results = []
    for R, D in ((3712, 65), (6048, 64), (16_384, 64), (65_536, 64),
                 (131_072, 64), (262_144, 64), (1_000_000, 64)):
        ids = torch.from_numpy(rng.integers(0, R, 16384)).cuda()
        vals = torch.from_numpy(rng.standard_normal((16384, D), dtype=np.float32)).cuda()
        grads = {"t": segment_sum(ids, vals, R)}
        params = {"t": torch.from_numpy(rng.standard_normal((R, D), dtype=np.float32)).cuda()}
        state = so.init_table_state(params, ("t",))

        def dense():
            so.dense_masked_adam_update(params, grads, state, ("t",), 1e-3)

        def rows():
            so.lazy_adam_update(params, grads, state, {"t": ids}, 1e-3)

        d1, r1, r2, d2 = (time_ms(f, runs=20) for f in (dense, rows, rows, dense))
        results.append(dict(R=R, D=D, touched=16384, dense_ms=(d1 + d2) / 2,
                            rows_ms=(r1 + r2) / 2, dense_runs=[d1, d2],
                            rows_runs=[r1, r2]))
        log(f"[adam] {json.dumps(results[-1])}")
    return results



# ------------------------------------------------------------ row scatter-add
def scatter_bound_ms(n_rows, D, N, n_valid):
    """Least time on an H100 SXM for one scatter-add: N ids and N rows read
    once and n_rows rows written once at the HBM rate, against the adds of the
    valid ids at the f32 peak."""
    nbytes = 4.0 * N + 4.0 * N * D + 4.0 * n_rows * D
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, float(n_valid) * D / H100_F32_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def popularity_ids(rng, n_rows, N, lo=0, hi=None):
    """N ids drawn as the training data draws items: popularity falling off
    by rank (``ml1m_like``'s law), over the ids [lo, hi)."""
    hi = n_rows if hi is None else hi
    pop = 1.0 / (np.arange(hi - lo) + 10.0) ** 0.9
    pop = pop[rng.permutation(hi - lo)]
    return (rng.choice(hi - lo, N, p=pop / pop.sum()) + lo).astype(np.int32)


# phase 1c: (name, n_rows, D, N, ids from, ids below), each with uniform ids
# and with ids drawn by popularity. The shapes a DIN step launches the
# scatter-add at (the history gather, 8192 rows x 10 positions into the
# 3712-row item table; the 16,384 targets, at D = 64 and at the packed
# tokens' 128), the packed-token history, the Transformer's history over its
# packed tokens, SIM's long history (8192 rows x 50 positions; its targets
# and short window are DIN's shapes, YouTubeRanking's history is DIN's), the
# JAX tests' two shapes, D = 33 with out-of-range ids and N = 0; then the
# packed table's own build, every id once.
SCATTER_SHAPES = [
    ("DIN history", 3712, 64, 81_920, 0, None),
    ("DIN targets", 3712, 64, 16_384, 0, None),
    ("DIN targets, packed tokens", 3712, 128, 16_384, 0, None),
    ("packed tokens", 3712, 128, 98_304, 0, None),
    ("Transformer history, packed tokens", 3712, 128, 81_920, 0, None),
    ("long history", 3712, 64, 409_600, 0, None),
    ("jax test", 371, 64, 5000, 0, None),
    ("jax test, ragged", 40, 8, 777, 0, 7),
    ("D=33, ids out of range", 50, 33, 4097, -6, 58),
    ("no ids", 12, 7, 0, 0, None),
]


# the share of SIM's long-history positions (50 before each training row of
# the ML-1M-sized data) that are padding, all on the item table's OOV row
# (3706): 0.18 of the data phases 4-6 draw
LONG_PAD_SHARE = 0.18


def scatter_cases():
    """Phase 1c's calls: (name, n_rows, D, N, ids from, ids below, ids kind)."""
    for what, n_rows, D, N, lo, hi in SCATTER_SHAPES:
        for kind in ("uniform", "popularity"):
            if N or kind == "uniform":
                yield f"{what}, {kind} ids", n_rows, D, N, lo, hi, kind
    yield "packed table build, every id once", 3712, 64, 3707, 0, None, "arange"
    # SIM's long history as its training data draws it: popularity ids and
    # LONG_PAD_SHARE of them on the one padding row
    yield "SIM long history, padded training draw", 3712, 64, 409_600, 0, 3706, "padded"


def scatter_ids(rng, n_rows, N, lo=0, hi=None, kind="uniform"):
    """N ids into n_rows rows: uniform over [lo, hi), by popularity, by
    popularity with LONG_PAD_SHARE of them on row ``hi`` (padded), or
    0, 1, ..., N - 1 (arange)."""
    if kind == "padded":
        ids = popularity_ids(rng, n_rows, N, lo, hi)
        ids[rng.random(N) < LONG_PAD_SHARE] = hi
        return ids
    if kind == "popularity":
        return popularity_ids(rng, n_rows, N, lo, hi)
    if kind == "arange":
        return np.arange(N, dtype=np.int32)
    return rng.integers(lo, n_rows if hi is None else hi, N).astype(np.int32)


def measure_scatter(rng, n_rows, D, N, what, lo=0, hi=None, ids_kind="uniform"):
    """Hold ``scatter_add_rows`` against its plain version at one shape (two
    launches bit-equal, and bit-equal to index_add_ on the CPU) and time it:
    the kernel (CUDA events, and device time by torch.profiler), the plain
    version (index_add_ on the CPU, host clock, copies included) and the
    library call (index_add_ on the card, float atomics). The segment-sum on
    the same inputs would run the same body (csrc/staged_add.cuh)."""
    from librecommender_tpu_torch.ops import row_scatter as rs
    from librecommender_tpu_torch.ops import table_gather as tg

    ids_np = scatter_ids(rng, n_rows, N, lo, hi, ids_kind)
    ids = torch.from_numpy(ids_np).cuda()
    rows = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32)).cuda()
    valid = (ids >= 0) & (ids < n_rows)
    n_valid = int(valid.sum())
    ids_long, rows_valid = ids.long()[valid], rows[valid]

    before = rs.launches
    first = rs.scatter_add_rows(ids, rows, n_rows)
    second = rs.scatter_add_rows(ids.long(), rows, n_rows)
    torch.cuda.synchronize()
    if rs.launches != before + 2:
        fail(f"{what}: scatter_add_rows counted {rs.launches - before} launches")
    err = check_ordered_add(first, second, rs.scatter_add_rows_plain(ids, rows, n_rows),
                            f"{what}: scatter_add_rows")
    counts = np.bincount(ids_np[(ids_np >= 0) & (ids_np < n_rows)], minlength=1)
    b_ms, b_by = scatter_bound_ms(n_rows, D, N, n_valid)
    row = dict(
        shape=dict(n_rows=n_rows, D=D, N=N), ids=ids_kind,
        max_ids_per_row=int(counts.max()), plan=tg.staged_plan(n_rows, D, N),
        max_abs_err=err,
        ms=time_ms(lambda: rs.scatter_add_rows(ids, rows, n_rows)),
        **device_row(lambda: rs.scatter_add_rows(ids, rows, n_rows),
                     staged_launches("::scatter_rows_kernel", n_rows, D, N)),
        enqueue_ms=enqueue_ms(lambda: rs.scatter_add_rows(ids, rows, n_rows)),
        plain_ms=host_ms(lambda: rs.scatter_add_rows_plain(ids, rows, n_rows), runs=3),
        library_ms=time_ms(lambda: torch.zeros((n_rows, D), device="cuda").index_add_(
            0, ids_long, rows_valid)),
        library_device_ms=device_total_ms(
            lambda: torch.zeros((n_rows, D), device="cuda").index_add_(
                0, ids_long, rows_valid)),
        bound_ms=b_ms, bound_by=b_by)
    log(f"[scatter] {what} {json.dumps(row)}")
    return row


def phase_scatter_kernel(rng):
    """The row scatter-add at every call of ``scatter_cases()``. Returns
    every call's row."""
    return {key: measure_scatter(rng, n_rows, D, N, key, lo, hi, kind)
            for key, n_rows, D, N, lo, hi, kind in scatter_cases()}


def phase_lookup_gate(rng):
    """One lookup's forward and backward through the gather and segment-sum
    kernels against plain indexing (whose backward on the card is index_put_
    with accumulate, checked here to repeat bit for bit), at 32,768 ids (a
    DIN step's two sparse fields x 16,384 rows) into tables from the 16 rows
    of the bench frame's sparse vocabulary up, timed in turns (kernel, plain,
    plain, kernel): the numbers behind FeatBase's LOOKUP_MAX_ROWS."""
    from librecommender_tpu_torch.ops.table_gather import table_lookup

    results = []
    B, D = 32_768, 64
    for R in (16, 256, 4096, 65_536, 262_144, 1_000_000):
        ids = torch.from_numpy(rng.integers(0, R, (B // 2, 2)).astype(np.int32)).cuda()
        cot = torch.from_numpy(rng.standard_normal((B // 2, 2, D), dtype=np.float32)).cuda()
        table = torch.from_numpy(
            rng.standard_normal((R, D), dtype=np.float32)).cuda().requires_grad_()

        def run(use_kernel):
            out = table_lookup(table, ids, use_kernel)
            return torch.autograd.grad((out * cot).sum(), table)[0]

        plain_a, plain_b = run(False), run(False)
        if not torch.equal(plain_a, plain_b):
            fail(f"lookup gate R={R}: plain indexing's backward does not repeat")
        # up to 2048 values a row, summed in two orders
        if not torch.allclose(run(True), plain_a, rtol=1e-4, atol=1e-3):
            fail(f"lookup gate R={R}: kernel and plain gradients differ")
        k1, p1, p2, k2 = (time_ms(lambda u=u: run(u), runs=20)
                          for u in (True, False, False, True))
        results.append(dict(R=R, D=D, ids=B, ids_per_row=B / R,
                            kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                            kernel_runs=[k1, k2], plain_runs=[p1, p2]))
        log(f"[lookup] {json.dumps(results[-1])}")
    return results


def phase_scatter_gate(rng):
    """A sequence gather's forward and backward through ``gather_rows`` (the
    scatter-add kernel) against plain indexing (whose backward on the card is
    index_put_ with accumulate) into DIN's 3712 x 64 item table, from 0.25 to
    64 ids a row drawn by popularity, timed in turns (kernel, plain, plain,
    kernel): the numbers behind row_scatter.GATE_IDS_PER_ROW."""
    from librecommender_tpu_torch.ops.row_scatter import gather_rows

    results = []
    R, D = 3712, 64
    table = torch.from_numpy(
        rng.standard_normal((R, D), dtype=np.float32)).cuda().requires_grad_()
    for per_row in (0.25, 0.5, 1, 2, 4, 8, 16, 32, 64):
        n = int(per_row * R) // 10 * 10
        ids = torch.from_numpy(popularity_ids(rng, R, n).reshape(-1, 10)).cuda()
        cot = torch.from_numpy(rng.standard_normal((n // 10, 10, D), dtype=np.float32)).cuda()

        def run(use_kernel):
            out = gather_rows(table, ids) if use_kernel else table[ids.long()]
            return torch.autograd.grad((out * cot).sum(), table)[0]

        if not torch.allclose(run(True), run(False), rtol=1e-4, atol=1e-3):
            fail(f"scatter gate {per_row} ids a row: kernel and plain gradients differ")
        k1, p1, p2, k2 = (time_ms(lambda u=u: run(u), runs=20)
                          for u in (True, False, False, True))
        results.append(dict(R=R, D=D, ids=n, ids_per_row=n / R,
                            kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                            kernel_runs=[k1, k2], plain_runs=[p1, p2]))
        log(f"[scatter gate] {json.dumps(results[-1])}")
    return results


# ---------------------------------------------------------------- training
def training_columns(rng):
    """The ML-1M-sized planted data as column dicts, split 80/20 per user by
    the port's split_by_ratio, with the three feature columns of
    bench.py's feature frame (sex and age by user, genre by item):
    (train, test)."""
    from librecommender_tpu_torch.data import split_by_ratio

    counts, consumed = ml1m_like(rng)
    users = np.repeat(np.arange(len(counts)), counts)
    items = np.concatenate([consumed[u] for u in range(len(counts))])
    sex = rng.choice(["m", "f"], len(counts))
    age = rng.integers(16, 60, len(counts))
    genre = rng.choice(["a", "b", "c", "d", "e", "f", "g"], 3706)
    data = {"user": users + 1, "item": items + 1, "label": np.ones(len(users)),
            "sex": sex[users], "age": (age[users] - 35.0) / 25.0,
            "genre": genre[items]}
    return split_by_ratio(data, test_size=0.2)


def training_data(columns):
    """(train, eval, info) of the id columns, built by DatasetPure."""
    from librecommender_tpu_torch.data import DatasetPure

    train, test = ({k: part[k] for k in ("user", "item", "label")}
                   for part in columns)
    train_data, info = DatasetPure.build_trainset(train)
    return train_data, DatasetPure.build_evalset(test), info


def _same_params(a, b, what, rtol=1e-4, atol=1e-5):
    for k in a:
        x, y = a[k], b[k]
        err = float(np.abs(x - y).max())
        if not np.allclose(x, y, rtol=rtol, atol=atol):
            fail(f"{what}: {k} differs beyond rtol {rtol}, atol {atol} "
                 f"(max abs err {err})")
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def phase_training(rng, workdir, columns):
    """The training path at full width: BPR(embed_size=64, batch_size=8192)
    on ML-1M-sized data. Returns the main path's kernel launches and the
    per-step numbers."""
    from librecommender_tpu_torch.evaluation import evaluate
    from librecommender_tpu_torch.models import BPR
    from librecommender_tpu_torch.ops import table_gather as tg

    t0 = time.perf_counter()
    train, evals, info = training_data(columns)
    n_train = len(train)
    log(f"[train] {info!r}; {n_train} train rows, {len(evals)} eval rows; "
        f"data made in {time.perf_counter() - t0:.1f} s")
    seed = int(rng.integers(1 << 30))

    def bpr(device, **extra):
        return BPR("ranking", info, embed_size=64, batch_size=8192, seed=seed,
                   device=device, **extra)

    init = bpr("cpu")
    init.build_model()
    init = init.params_to_arrays()

    # (a) GPU against CPU on the same batches: 10 steps, then one epoch
    steps = 10
    head = head_rows(train, steps * 8192)
    fitted = {}
    for data, name in ((head, "10 steps"), (train, "one epoch")):
        for device in ("cuda", "cpu"):
            m = bpr(device, n_epochs=1, sampler="unconsumed")
            m.params_from_arrays(init)
            tg.reset_launches()
            m.fit(data, neg_sampling=True, verbose=0, shuffle=False)
            torch.cuda.synchronize()
            if device == "cuda":
                n = -(-len(data) // 8192)
                if not tg.gather_launches == tg.segsum_launches == 3 * n:
                    fail(f"(a) {name}: {tg.gather_launches} gathers, "
                         f"{tg.segsum_launches} segment-sums for {n} steps")
            fitted[name, device] = m
    err10 = _same_params(fitted["10 steps", "cuda"].params_to_arrays(),
                         fitted["10 steps", "cpu"].params_to_arrays(),
                         "(a) 10 steps, GPU against CPU")
    la = fitted["one epoch", "cuda"].trainer.epoch_losses[0]
    lb = fitted["one epoch", "cpu"].trainer.epoch_losses[0]
    if abs(la - lb) > 1e-3 * abs(lb):
        fail(f"(a) one epoch: mean loss {la} on the GPU, {lb} on the CPU")
    log(f"[train] (a) GPU = CPU: params after {steps} steps within rtol 1e-4 "
        f"(max abs err {err10:.3g}); epoch mean loss {la:.6f} vs {lb:.6f}; "
        f"3 launches of each kernel a step")

    # (b) same seed, device negatives and shuffle: bit-identical on the card
    twins = []
    for _ in range(2):
        m = bpr("cuda", n_epochs=1)
        m.fit(train, neg_sampling=True, verbose=0)
        twins.append(m.params_to_arrays())
    for k in twins[0]:
        if not np.array_equal(twins[0][k], twins[1][k]):
            fail(f"(b) two same-seed fits differ in {k}")
    log("[train] (b) two same-seed fits on the card are bit-identical")

    # (c) the quickstart at full width, on the card and on the CPU
    metrics = ["roc_auc", "precision", "recall", "ndcg"]
    results, models = {}, {}
    for device in (None, "cpu"):
        m = BPR("ranking", info, embed_size=64, n_epochs=3, batch_size=8192,
                seed=seed, device=device)
        tg.reset_launches()
        t = time.perf_counter()
        m.fit(train, neg_sampling=True, verbose=0)
        fit_s = time.perf_counter() - t
        if device is None:
            torch.cuda.synchronize()
            launches = dict(gather=tg.gather_launches, segsum=tg.segsum_launches,
                            segsum_bf16=tg.segsum_bf16_launches)
            n_batches = -(-n_train // 8192)
            if not launches["gather"] == launches["segsum"] == 3 * 3 * n_batches:
                fail(f"(c) {launches} for 3 epochs of {n_batches} steps")
        results[device] = evaluate(m, evals, neg_sampling=True, metrics=metrics,
                                   sample_user_num=1000, seed=seed)
        models[device] = m
        log(f"[train] (c) {device or 'cuda'}: fit {fit_s:.1f} s, epochs "
            f"{[round(x, 4) for x in m.trainer.epoch_times]} s, losses "
            f"{[round(x, 5) for x in m.trainer.epoch_losses]}; {results[device]}")
    gpu, cpu = results[None], results["cpu"]
    if not all(np.isfinite(v) for r in results.values() for v in r.values()):
        fail(f"(c) non-finite metrics {results}")
    if abs(gpu["roc_auc"] - cpu["roc_auc"]) > 0.01:
        fail(f"(c) AUC {gpu['roc_auc']} on the GPU, {cpu['roc_auc']} on the CPU")
    if gpu["roc_auc"] <= 0.5:
        fail(f"(c) AUC {gpu['roc_auc']}: no better than chance")
    model = models[None]
    users = [int(info.id2user[int(i)]) for i in rng.choice(info.n_users, 4, replace=False)]
    recs = model.recommend_user(users, 10)
    model.save(workdir, "bpr_trained")
    back = BPR.load(workdir, "bpr_trained", device="cpu")
    near = 0
    for u in users:
        if len(recs[u]) != 10:
            fail(f"(c) user {u}: {len(recs[u])} recommendations")
        want = [int(i) for i in back.recommend_user(u, 10)[u]]
        near += check_recs([int(i) for i in recs[u]], want, back, u, f"(c) user {u}")
    log(f"[train] (c) AUC {gpu['roc_auc']:.4f} on the card, {cpu['roc_auc']:.4f} "
        f"on the CPU; recommend_user after save/load equal ({near} near-tie swaps)")

    # throughput (epochs after the first, host clock) and one profiled epoch
    n_batches = -(-n_train // 8192)
    steady = model.trainer.epoch_times[1:]
    ex_per_s = [n_train / t for t in steady]
    step_ms = 1e3 * statistics.mean(steady) / n_batches
    prof = epoch_profile(BPR("ranking", info, embed_size=64, n_epochs=1,
                             batch_size=8192, seed=seed, device="cuda"),
                         train, n_batches)
    summary = dict(examples_per_s=ex_per_s, step_ms=step_ms, **prof,
                   idle_share=(1.0 - prof["device_ms_per_step"] / step_ms
                               if step_ms > 0 else None),
                   steps_per_epoch=n_batches, launches=launches,
                   auc_gpu=gpu["roc_auc"], auc_cpu=cpu["roc_auc"])
    log(f"[train] {json.dumps(summary)}")
    return summary


# --------------------------------------------------------------------- DIN
FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
DIN_BATCH = 16_384   # positives and negatives: 8192 rows a step


def _din_scores64(model, uid):
    """One user's catalog logits from a float64 copy of a CPU model."""
    import copy

    ref = copy.copy(model)
    ref.net = copy.deepcopy(model.net).double()
    ref.feats = copy.copy(model.feats)
    for name in ("user_dense", "item_dense"):
        table = getattr(ref.feats, name)
        if table is not None:
            setattr(ref.feats, name, table.double())
    return ref._score_users(np.array([uid]))[0].numpy()


def check_din_recs(got, want, ref_model, user, what, rtol=RTOL):
    """Raw-id lists must match; a position may differ only where the two
    items' float64 logits for this user are within ``rtol`` (1e-5, relative
    to the larger, at least 1)."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} recs vs {len(want)}")
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not diff:
        return 0
    info = ref_model.data_info
    scores = _din_scores64(ref_model, info.user2id.get(user, ref_model.n_users))
    for i in diff:
        sa, sb = scores[info.item2id[got[i]]], scores[info.item2id[want[i]]]
        if abs(sa - sb) > rtol * max(1.0, abs(sa), abs(sb)):
            fail(f"{what}: position {i} differs ({got[i]} vs {want[i]}) "
                 f"and is not a near-tie ({sa} vs {sb})")
    return len(diff)


def first_batch(model, train, batch_size=DIN_BATCH):
    """The first batch of ``train`` as a fit of ``model`` draws it (8192 rows
    and their host-sampled negatives, in file order; a listwise model's rows
    alone), numpy arrays by key: the same for every model of one
    configuration and seed."""
    from librecommender_tpu_torch.batch.generator import (BatchGenerator,
                                                          adjust_batch_size)

    rows = adjust_batch_size(model, batch_size)
    gen = BatchGenerator(train, model.data_info, rows, paradigm=model.paradigm,
                         neg_sampling=model.paradigm != "listwise",
                         sampler="unconsumed", num_neg=1, seed=model.seed,
                         extras=model.batch_extras(train))
    batch = {k: v[:rows] for k, v in gen.epoch_arrays().items()}
    negs = gen.epoch_negatives()
    if negs is not None:
        batch["item_neg"] = negs[:rows]
    return batch


def first_step_grads(model, train, init, batch=None):
    """The gradients of ``loss_fn`` at the parameters ``init`` on the first
    batch of ``train`` (``first_batch``, drawn here unless given), as numpy
    arrays by parameter name; on the card through the gather, segment-sum
    and scatter-add kernels, as a fit's step runs them."""
    if batch is None:
        batch = first_batch(model, train)
    model.params_from_arrays(init)
    model._mxu_lookup = True   # as the trainer sets it for a fit
    batch = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    keys = list(model.net.keys())
    loss = model.loss_fn(model.net, batch)
    # zero for a parameter the loss does not reach, as the trainer takes it
    grads = torch.autograd.grad(loss, [model.net[k] for k in keys],
                                materialize_grads=True)
    model._mxu_lookup = False
    return float(loss.detach()), {k: g.cpu().numpy() for k, g in zip(keys, grads)}


def beyond(a, b, rtol=1e-4, atol=1e-5):
    """(max abs difference, entries beyond the tolerance, entries)."""
    worst, bad, total = 0.0, 0, 0
    for k in a:
        d = np.abs(a[k] - b[k])
        worst = max(worst, float(d.max()))
        bad += int((d > atol + rtol * np.abs(b[k])).sum())
        total += d.size
    return worst, bad, total


PROFILE_STEPS = 16   # steps of phases 5-9's profiled fits


def head_rows(train, n_rows):
    """The first ``n_rows`` rows of ``train`` (ids and labels): phases 5-9
    profile a fit of their first PROFILE_STEPS steps, since a profile records
    every operator and one of a whole epoch costs tens of seconds."""
    from librecommender_tpu_torch.data import TransformedSet

    return TransformedSet(*(x[:n_rows] for x in (
        train.user_indices, train.item_indices, train.labels)))


def epoch_profile(probe, train, n_batches, neg_sampling=True):
    """One profiled epoch of ``probe.fit``: device ms a step in all kernels
    and copies, in each kernel of the port, the ten costliest operators, and
    the kernel launches a step the host made."""
    stats = profiled(lambda: probe.fit(train, neg_sampling=neg_sampling, verbose=0))
    per_kernel, by_op = {}, {}
    total_us, launches_cpu = 0.0, 0
    for evt in stats:
        if evt.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches_cpu += evt.count
        if not _is_kernel(evt):
            continue
        us = _self_device_us(evt)
        total_us += us
        if us > 0:
            # summed: kernels whose names share the first 60 characters
            # (cuBLAS's tile variants) are one row
            key = evt.key[:60]
            by_op[key] = by_op.get(key, 0.0) + us / n_batches / 1e3
        for name in GATHER_NAMES + ("::scatter_rows_kernel", PARTITION, PARTIALS):
            if name in evt.key:
                per_kernel[name] = per_kernel.get(name, 0.0) + us / n_batches / 1e3
    return dict(device_ms_per_step=total_us / n_batches / 1e3,
                kernel_ms_per_step=per_kernel,
                top_device_ops_ms_per_step=sorted(by_op.items(),
                                                  key=lambda kv: -kv[1])[:10],
                kernel_launches_per_step=launches_cpu / n_batches)


def hold_grads(grads_g, grads_c, what):
    """Hold one step's gradients on the card against the CPU's, parameter by
    parameter (phase 5 (a) says why these limits): the difference's norm at
    most 1e-2 of the gradient's, no entry off by more than 0.1 of the
    parameter's largest gradient, at most 5% of the entries beyond rtol 1e-4
    + 1e-5 of that largest; a parameter whose gradient is zero but for
    rounding (below 1e-6 of the step's largest) within 1e-6 of that largest.
    Returns (worst, entries beyond, entries, the rounding-only parameters)."""
    largest = max(float(np.abs(g).max()) for g in grads_c.values())
    bad = total = 0
    worst = dict(norm=(0.0, ""), entry=(0.0, ""))
    rounding_only = []
    for k, want in grads_c.items():
        if not np.isfinite(grads_g[k]).all():
            fail(f"{what} gradient of {k} on the GPU is not finite")
        d = np.abs(grads_g[k].astype(np.float64) - want)
        top = float(np.abs(want).max())
        if top < 1e-6 * largest:
            rounding_only.append(k)
            if float(d.max()) > 1e-6 * largest:
                fail(f"{what} gradient of {k}: {d.max()} apart where the CPU's "
                     f"is {top}, the step's largest {largest}")
            continue
        bad += int((d > 1e-4 * np.abs(want) + 1e-5 * top).sum())
        total += d.size
        norm = float(np.linalg.norm(d) / np.linalg.norm(want.astype(np.float64)))
        worst["norm"] = max(worst["norm"], (norm, k))
        worst["entry"] = max(worst["entry"], (float(d.max()) / top, k))
    if (worst["norm"][0] > 1e-2 or worst["entry"][0] > 0.1 or bad > 0.05 * total):
        fail(f"{what} gradients, GPU against CPU: difference's norm "
             f"{worst['norm'][0]:.3g} of the gradient's in {worst['norm'][1]}, "
             f"entry off by {worst['entry'][0]:.3g} of the largest in "
             f"{worst['entry'][1]}, {bad} of {total} entries beyond rtol 1e-4")
    return worst, bad, total, rounding_only


def serve_once(workdir, name, user):
    """The saved model ``name`` served from the GPU: one POST
    /model/recommend for ``user``; (rec_list, ms with loading)."""
    from librecommender_tpu_torch.serving import DictStore

    store = DictStore()
    store.set("model_path", str(workdir))
    store.set("model_meta", {"model_name": name})
    with ServerThread("model", store) as base:
        t = time.perf_counter()
        got = http(base + "/model/recommend", {"user": user, "n_rec": 10})
        served_ms = (time.perf_counter() - t) * 1e3
    return got["rec_list"], served_ms


def phase_din(rng, workdir, columns):
    """DIN at bench.py's width (embed_size=64, batch_size=16384,
    hidden_units=(128, 64, 32), recent_num=10) on the ML-1M-sized feature
    data, with the sequence gathers' gradient on the row scatter-add kernel.
    Returns the kernels' launches on the main path (e) and the per-step
    numbers."""
    from librecommender_tpu_torch.data import DatasetFeat
    from librecommender_tpu_torch.evaluation import evaluate
    from librecommender_tpu_torch.models import DIN
    from librecommender_tpu_torch.ops import row_scatter as rs
    from librecommender_tpu_torch.ops import table_gather as tg

    t0 = time.perf_counter()
    train_cols, test_cols = columns
    train, info = DatasetFeat.build_trainset(train_cols, **FEAT_COLS)
    evals = DatasetFeat.build_evalset(test_cols)
    n_train = len(train)
    rows_a_step = DIN_BATCH // 2
    n_batches = -(-n_train // rows_a_step)
    log(f"[din] {info!r}; {n_train} train rows, {len(evals)} eval rows, sparse "
        f"vocabulary {int(info.sparse_oov[-1]) + 1}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    seed = int(rng.integers(1 << 30))

    def din(device, flag=True, **extra):
        m = DIN("ranking", info, embed_size=64, batch_size=DIN_BATCH,
                hidden_units=(128, 64, 32), recent_num=10, seed=seed,
                device=device, **extra)
        m.pallas_grad_scatter = flag
        return m

    def reset():
        rs.reset_launches()
        tg.reset_launches()

    def lookups(what, steps, per_step=1):
        """The sparse vocabulary's lookups of ``steps`` steps on the card
        went through the gather and the segment-sum kernels."""
        want = per_step * steps
        if not tg.gather_launches == tg.segsum_launches == want:
            fail(f"{what}: {tg.gather_launches} gathers and "
                 f"{tg.segsum_launches} segment-sums for {steps} steps, "
                 f"expected {want} of each")

    def finite(model, what):
        bad = [k for k, v in model.params_to_arrays().items()
               if not np.isfinite(v).all()]
        if bad or not np.isfinite(model.trainer.epoch_losses).all():
            fail(f"{what}: non-finite parameters {bad} or losses "
                 f"{model.trainer.epoch_losses}")

    init = din("cpu")
    init.build_model()
    init = init.params_to_arrays()

    # (a) GPU against CPU on the same batches, (c) the kernel on against off.
    # First the step's gradients themselves, from the same parameters and
    # batch, parameter by parameter: the difference's norm at most 1e-2 of
    # the gradient's, no entry off by more than 0.1 of the parameter's largest
    # gradient, at most 5% of the entries beyond rtol 1e-4 + 1e-5 of that
    # largest. A gradient of the wrong magnitude fails this; the parameter
    # checks below, after Adam's lr * g / (|g| + eps), would not see it. It
    # cannot be tighter: on most seeds no entry of a real gradient lies beyond
    # rtol 1e-4 and the norms agree to 1e-5, but where a unit's input is
    # within rounding of zero on one side only, that example's share moves
    # (through the layer norms, in every weight): one seed of eight had 1.6%
    # of the entries beyond and norms apart by up to 2e-3. A parameter whose
    # gradient is zero but for rounding (the attention's output bias under
    # the softmax; below 1e-6 of the step's largest gradient) is held to
    # 1e-6 of that largest instead.
    batch = first_batch(din("cpu"), train)
    reset()
    loss_g, grads_g = first_step_grads(din("cuda"), train, init, batch)
    torch.cuda.synchronize()
    if rs.launches != 2:
        fail(f"(a) gradients: {rs.launches} scatter launches for one step")
    lookups("(a) gradients", 1)
    loss_c, grads_c = first_step_grads(din("cpu"), train, init, batch)
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"(a) first loss {loss_g} on the GPU, {loss_c} on the CPU")
    worst, bad, total, rounding_only = hold_grads(grads_g, grads_c, "(a)")
    log(f"[din] (a) first step's gradients, GPU (through the three kernels) "
        f"against CPU: loss {loss_g:.7f} vs {loss_c:.7f}; by parameter, the "
        f"difference's norm at most {worst['norm'][0]:.3g} of the gradient's "
        f"({worst['norm'][1]}), an entry off by at most "
        f"{worst['entry'][0]:.3g} of the largest ({worst['entry'][1]}), "
        f"{bad} of {total} entries beyond rtol 1e-4 + 1e-5 of the largest; "
        f"zero but for rounding: {rounding_only}")

    # At this width the parameters after 10 steps cannot be held to rtol 1e-4,
    # atol 1e-5, not even between two runs on the CPU (whose index_put_ adds
    # in a changing order): a switched ReLU changes a gradient near Adam's
    # epsilon, Adam turns that into a step of up to lr in the rows of that
    # example, and the next steps spread it. So the parameters are held after
    # ONE step, where at most a few such switches have happened (at most 0.5%
    # of the entries beyond the tolerance, none by more than 2 lr), the 10
    # steps by their mean loss, and the spread after 10 steps is printed
    # beside the CPU's own.
    lr = 0.001
    fitted, losses = {}, {}
    runs = (("cuda", True, 1), ("cpu", True, 1), ("cuda", True, 10),
            ("cpu", True, 10), ("cpu", "again", 10), ("cuda", False, 10))
    for device, flag, steps in runs:
        head = head_rows(train, steps * rows_a_step)
        m = din(device, bool(flag), n_epochs=1, sampler="unconsumed", lr=lr)
        m.params_from_arrays(init)
        reset()
        m.fit(head, neg_sampling=True, verbose=0, shuffle=False)
        torch.cuda.synchronize()
        finite(m, f"(a) {device} flag {flag}")
        want = 2 * steps if (device == "cuda" and flag) else 0
        if rs.launches != want:
            fail(f"(a) {device}, flag {flag}: {rs.launches} scatter launches "
                 f"for {steps} steps, expected {want}")
        if device == "cuda":
            lookups(f"(a) flag {flag}", steps)
        fitted[device, flag, steps] = m.params_to_arrays()
        losses[device, flag, steps] = m.trainer.epoch_losses[0]
    seqs = m.batch_extras(head)["seq"]
    all_pad = int((seqs == info.n_items).all(axis=1).sum())
    if not all_pad:
        fail("(a) the 10 steps hold no all-pad history")
    for steps, tol in ((1, 1e-5), (10, 1e-4)):
        la, lb = losses["cuda", True, steps], losses["cpu", True, steps]
        if abs(la - lb) > tol * abs(lb):
            fail(f"(a) mean loss of {steps} step(s): {la} on the GPU, {lb} on the CPU")
    one = beyond(fitted["cuda", True, 1], fitted["cpu", True, 1])
    if one[1] > 0.005 * one[2] or one[0] > 2 * lr:
        fail(f"(a) after one step {one[1]} of {one[2]} entries differ beyond "
             f"rtol 1e-4, atol 1e-5 (max abs err {one[0]})")
    ten = beyond(fitted["cuda", True, 10], fitted["cpu", True, 10])
    ten_cpu = beyond(fitted["cpu", "again", 10], fitted["cpu", True, 10])
    err_c = _same_params(fitted["cuda", True, 10], fitted["cuda", False, 10],
                         "(c) scatter kernel on against off", rtol=1e-5, atol=1e-6)
    log(f"[din] (a) GPU against CPU from the same parameters and batches: after "
        f"1 step max abs err {one[0]:.3g}, {one[1]} of {one[2]} entries beyond "
        f"rtol 1e-4, atol 1e-5; mean loss {losses['cuda', True, 1]:.7f} vs "
        f"{losses['cpu', True, 1]:.7f}. After 10 steps mean loss "
        f"{losses['cuda', True, 10]:.7f} vs {losses['cpu', True, 10]:.7f}, max "
        f"abs err {ten[0]:.3g}, {ten[1]} entries beyond (two CPU runs: "
        f"{ten_cpu[0]:.3g}, {ten_cpu[1]}). {all_pad} of {len(seqs)} rows have "
        f"an all-pad history, every parameter and loss finite; 2 scatter "
        f"launches a step. (c) kernel on = off within rtol 1e-5, atol 1e-6 "
        f"(max abs err {err_c:.3g})")

    # (b) same seed, device negatives, shuffle and dropout: bit-identical
    twins = []
    for _ in range(2):
        m = din("cuda", n_epochs=1, dropout_rate=0.1)
        reset()
        m.fit(train, neg_sampling=True, verbose=0)
        if rs.launches != 2 * n_batches:
            fail(f"(b) {rs.launches} scatter launches for {n_batches} steps")
        lookups("(b)", n_batches)
        twins.append(m.params_to_arrays())
    for k in twins[0]:
        if not np.array_equal(twins[0][k], twins[1][k]):
            fail(f"(b) two same-seed fits differ in {k}")
    log("[din] (b) two same-seed fits on the card are bit-identical")

    # (d) feature-augmented tokens: the packed table, three scatters a step,
    # and the vocabulary looked up twice (the fields, the tokens' features)
    m = din("cuda", n_epochs=1, feat_agg_mode="concat")
    reset()
    m.fit(train, neg_sampling=True, verbose=0)
    torch.cuda.synchronize()
    finite(m, "(d) concat")
    if rs.launches != 3 * n_batches:
        fail(f"(d) {rs.launches} scatter launches for {n_batches} steps")
    lookups("(d)", n_batches, per_step=2)
    log(f"[din] (d) feat_agg_mode=concat: token width {m.token_dim}, epoch "
        f"{m.trainer.epoch_times[0]:.2f} s, loss {m.trainer.epoch_losses[0]:.5f}; "
        f"launches a step: scatter {rs.launches / n_batches:g}, gather "
        f"{tg.gather_launches / n_batches:g}, segment-sum "
        f"{tg.segsum_launches / n_batches:g}")

    # (e) the main path: fit, evaluate, recommend, save, load, serve
    reset()
    model = din(None, n_epochs=2)
    t = time.perf_counter()
    model.fit(train, neg_sampling=True, verbose=0)
    fit_s = time.perf_counter() - t
    torch.cuda.synchronize()
    finite(model, "(e)")
    if rs.launches != 2 * 2 * n_batches:
        fail(f"(e) {rs.launches} scatter launches for 2 epochs of {n_batches} steps")
    lookups("(e)", 2 * n_batches)
    metrics = ["roc_auc", "precision"]
    gpu = evaluate(model, evals, neg_sampling=True, metrics=metrics, k=10,
                   sample_user_num=256, seed=seed)
    users = [int(info.id2user[int(i)]) for i in rng.choice(info.n_users, 4, replace=False)]
    users.append(10**9)   # a cold user: the all-pad history, the OOV feature row
    recs = model.recommend_user(users, 10)
    model.save(workdir, "din")
    back = DIN.load(workdir, "din", device="cpu")
    cpu = evaluate(back, evals, neg_sampling=True, metrics=metrics, k=10,
                   sample_user_num=256, seed=seed)
    if not all(np.isfinite(v) for r in (gpu, cpu) for v in r.values()):
        fail(f"(e) non-finite metrics {gpu} {cpu}")
    for name in metrics:
        if abs(gpu[name] - cpu[name]) > 0.01:
            fail(f"(e) {name} {gpu[name]} on the GPU, {cpu[name]} on the CPU")
    if gpu["roc_auc"] <= 0.5:
        fail(f"(e) AUC {gpu['roc_auc']}: no better than chance")
    near = 0
    for u in users:
        if len(recs[u]) != 10:
            fail(f"(e) user {u}: {len(recs[u])} recommendations")
        want = [int(i) for i in back.recommend_user(u, 10)[u]]
        near += check_din_recs([int(i) for i in recs[u]], want, back, u, f"(e) user {u}")

    served, served_ms = serve_once(workdir, "din", users[0])
    want = [int(i) for i in back.recommend_user(users[0], 10)[users[0]]]
    near += check_din_recs(served, want, back, users[0], "(e) served")
    launches = dict(scatter=rs.launches, gather=tg.gather_launches,
                    segsum=tg.segsum_launches)
    log(f"[din] (e) fit {fit_s:.1f} s, epochs "
        f"{[round(x, 4) for x in model.trainer.epoch_times]} s, losses "
        f"{[round(x, 5) for x in model.trainer.epoch_losses]}; card {gpu}, the "
        f"saved model on the CPU {cpu}; recommend_user and one served request "
        f"({served_ms:.1f} ms with loading) equal to the CPU's ({near} near-tie "
        f"swaps); launches {launches}")

    # throughput (the epoch after the first, host clock) and a profiled fit
    # of the first PROFILE_STEPS steps
    steady = model.trainer.epoch_times[1:]
    step_ms = 1e3 * statistics.mean(steady) / n_batches
    prof = epoch_profile(din("cuda", n_epochs=1),
                         head_rows(train, PROFILE_STEPS * DIN_BATCH // 2),
                         PROFILE_STEPS)
    summary = dict(
        examples_per_s=[n_train / x for x in steady], step_ms=step_ms, **prof,
        idle_share=1.0 - prof["device_ms_per_step"] / step_ms if step_ms > 0 else None,
        steps_per_epoch=n_batches, launches=launches,
        auc_gpu=gpu["roc_auc"], auc_cpu=cpu["roc_auc"],
        precision_gpu=gpu["precision"], precision_cpu=cpu["precision"])
    log(f"[din] {json.dumps(summary)}")
    return summary


# ------------------------------------------------- the rest of the sequence family
# phase 6: name -> (model class, kwargs beside bench.py's width), each with
# the sequence gathers' gradient on the row scatter-add kernel
SEQ_FAMILY = {
    "youtube_ranking": ("YouTubeRanking", {}),
    "transformer": ("Transformer", dict(compute_dtype="bf16", num_tfm_layers=1)),
    "sim": ("SIM", dict(long_max_len=50, search_topk=10, long_history_grad=True)),
}
BF16_NEAR_TIE = 1e-2   # a few bfloat16 ulps of a logit: the Transformer's recs


def hold_by_reference(got, cpu, ref, what):
    """Both bfloat16 encoders approximate the float32 one: by parameter, the
    card's result may lie at most twice as far from the CPU's float32 result
    as the CPU's bfloat16 one does, plus 1e-3 of the float32 result's largest
    entry. Returns the largest ratio of the card's distance to that limit."""
    worst = (0.0, "")
    for k, r in ref.items():
        if not np.isfinite(got[k]).all():
            fail(f"{what}: {k} on the GPU is not finite")
        err_g = float(np.abs(got[k].astype(np.float64) - r).max())
        limit = 2 * float(np.abs(cpu[k].astype(np.float64) - r).max()) \
            + 1e-3 * float(np.abs(r).max())
        if err_g > limit:
            fail(f"{what}: {k} lies {err_g:.3g} from the CPU's float32 result, "
                 f"beyond {limit:.3g} (twice the CPU's bfloat16 distance)")
        worst = max(worst, (err_g / limit if limit else 0.0, k))
    return worst


def seq_model_path(name, train, evals, info, rng, workdir):
    """One model of phase 6 at bench.py's width: (a) the first step's
    gradients and the parameters after one step, card against CPU from the
    same parameters and batches; (b) a 2-epoch fit on the card (the main
    path: the kernels' launch counts, examples/s, one profiled epoch);
    (c) evaluate's AUC on the card and of the saved model on the CPU, within
    0.01; (d) recommend_user on the card against the CPU-loaded model;
    (e) for SIM, a request seq equal to the stored history against the
    static call, and the saved model loaded on the GPU and served over HTTP.
    Returns the path's numbers."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.ops import row_scatter as rs
    from librecommender_tpu_torch.ops import table_gather as tg

    cls_name, extra = SEQ_FAMILY[name]
    cls = getattr(models, cls_name)
    bf16 = extra.get("compute_dtype") == "bf16"
    seed = int(rng.integers(1 << 30))
    rows_a_step = DIN_BATCH // 2
    n_train = len(train)
    n_batches = -(-n_train // rows_a_step)
    lr = 0.001
    tag = f"[seq {name}]"
    t_path = time.perf_counter()

    def make(device, **kw):
        m = cls("ranking", info, embed_size=64, batch_size=DIN_BATCH,
                hidden_units=(128, 64, 32), recent_num=10, seed=seed,
                device=device, **{**extra, **kw})
        m.pallas_grad_scatter = True
        return m

    def reset():
        rs.reset_launches()
        tg.reset_launches()

    def launched(what):
        got = dict(scatter=rs.launches, gather=tg.gather_launches,
                   segsum=tg.segsum_launches)
        if min(got.values()) == 0:
            fail(f"{tag} {what}: a kernel of the path did not launch: {got}")
        return got

    def one_step(device, **kw):
        head = head_rows(train, rows_a_step)
        m = make(device, n_epochs=1, sampler="unconsumed", lr=lr, **kw)
        m.params_from_arrays(init)
        m.fit(head, neg_sampling=True, verbose=0, shuffle=False)
        return m.params_to_arrays(), m.trainer.epoch_losses[0]

    init = make("cpu")
    init.build_model()
    init = init.params_to_arrays()

    # (a) the first step, card against CPU
    batch = first_batch(make("cpu"), train)
    reset()
    loss_g, grads_g = first_step_grads(make("cuda"), train, init, batch)
    torch.cuda.synchronize()
    step_launches = launched("(a) first step")
    loss_c, grads_c = first_step_grads(make("cpu"), train, init, batch)
    one_g, _ = one_step("cuda")
    one_c, _ = one_step("cpu")
    if bf16:
        loss_32, grads_32 = first_step_grads(make("cpu", compute_dtype="f32"),
                                             train, init, batch)
        one_32, _ = one_step("cpu", compute_dtype="f32")
        if abs(loss_g - loss_32) > 2 * abs(loss_c - loss_32) + 1e-5 * abs(loss_32):
            fail(f"{tag} (a) first loss {loss_g} on the GPU, {loss_c} on the CPU, "
                 f"{loss_32} in float32")
        g_worst = hold_by_reference(grads_g, grads_c, grads_32, f"{tag} (a) gradients")
        p_worst = hold_by_reference(one_g, one_c, one_32, f"{tag} (a) one step")
        held = (f"bfloat16: card and CPU against the CPU's float32 (loss "
                f"{loss_g:.7f}, {loss_c:.7f}, {loss_32:.7f}); gradients at most "
                f"{g_worst[0]:.3g} of the limit ({g_worst[1]}), one step's "
                f"parameters at most {p_worst[0]:.3g} ({p_worst[1]})")
    else:
        if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
            fail(f"{tag} (a) first loss {loss_g} on the GPU, {loss_c} on the CPU")
        worst, bad, total, rounding_only = hold_grads(grads_g, grads_c, f"{tag} (a)")
        one = beyond(one_g, one_c)
        if one[1] > 0.005 * one[2] or one[0] > 2 * lr:
            fail(f"{tag} (a) after one step {one[1]} of {one[2]} entries differ "
                 f"beyond rtol 1e-4, atol 1e-5 (max abs err {one[0]})")
        held = (f"loss {loss_g:.7f} vs {loss_c:.7f}; gradients: the difference's "
                f"norm at most {worst['norm'][0]:.3g} of the gradient's "
                f"({worst['norm'][1]}), an entry off by at most "
                f"{worst['entry'][0]:.3g} of the largest ({worst['entry'][1]}), "
                f"{bad} of {total} entries beyond rtol 1e-4; zero but for "
                f"rounding: {rounding_only}; after one step max abs err "
                f"{one[0]:.3g}, {one[1]} of {one[2]} entries beyond rtol 1e-4, "
                f"atol 1e-5")
    log(f"{tag} (a) first step, GPU (launches {step_launches}) against CPU: {held}")

    # (b) the main path's fit on the card
    reset()
    model = make(None, n_epochs=2)
    t = time.perf_counter()
    model.fit(train, neg_sampling=True, verbose=0)
    fit_s = time.perf_counter() - t
    torch.cuda.synchronize()
    launches = launched("(b) fit")
    bad = [k for k, v in model.params_to_arrays().items() if not np.isfinite(v).all()]
    if bad or not np.isfinite(model.trainer.epoch_losses).all():
        fail(f"{tag} (b) non-finite parameters {bad} or losses "
             f"{model.trainer.epoch_losses}")
    steady = model.trainer.epoch_times[1:]
    step_ms = 1e3 * statistics.mean(steady) / n_batches
    prof = epoch_profile(make("cuda", n_epochs=1),
                         head_rows(train, PROFILE_STEPS * rows_a_step), PROFILE_STEPS)

    # (c) evaluate on the card and, saved, on the CPU; (d) recommend_user
    rtol = BF16_NEAR_TIE if bf16 else RTOL
    auc_g, auc_c, back, users, _, near = saved_model_checks(
        model, cls, name, evals, info, rng, workdir, seed, tag,
        lambda *args: check_din_recs(*args, rtol))

    # (e) SIM: a request seq equal to each user's stored history gives the
    # static call's ids; the saved model served from the GPU
    served_ms = None
    if name == "sim":
        uids = [info.user2id[u] for u in users[:-1]]
        stored = [[int(i) for i in model.user_consumed[uid]] for uid in uids]
        static = model.recommend_user(uids, 10, inner_id=True)
        dynamic = model.recommend_user(uids, 10, inner_id=True, seq=stored)
        for uid in uids:
            if not np.array_equal(static[uid], dynamic[uid]):
                fail(f"{tag} (e) user {uid}: seq= the stored history gives "
                     f"{dynamic[uid]}, the static call {static[uid]}")
        log(f"{tag} (e) recommend_user(seq=stored history) equals the static "
            f"call for {len(uids)} users")
        served, served_ms = serve_once(workdir, name, users[0])
        want = [int(i) for i in back.recommend_user(users[0], 10)[users[0]]]
        near += check_din_recs(served, want, back, users[0],
                               f"{tag} (e) served", rtol)

    pad_share = {key: float((seqs == info.n_items).mean())
                 for key, seqs in model.batch_extras(train).items()}
    summary = dict(
        examples_per_s=[n_train / x for x in model.trainer.epoch_times],
        step_ms=step_ms, **prof,
        idle_share=1.0 - prof["device_ms_per_step"] / step_ms if step_ms > 0 else None,
        steps_per_epoch=n_batches, launches=launches,
        launches_per_step={k: v / (2 * n_batches) for k, v in launches.items()},
        fit_s=fit_s, losses=model.trainer.epoch_losses, auc_gpu=auc_g,
        auc_cpu=auc_c, near_tie_swaps=near, served_ms=served_ms,
        history_pad_share=pad_share,
        path_s=time.perf_counter() - t_path)
    log(f"{tag} {json.dumps(summary)}")
    return summary


def phase_sequence_family(rng, workdir, columns):
    """YouTubeRanking, Transformer (bfloat16, one layer) and SIM (long
    history 50, top-k 10, the long history's gradient on) at bench.py's width
    on phase 5's feature data. Returns each path's numbers."""
    from librecommender_tpu_torch.data import DatasetFeat

    t0 = time.perf_counter()
    train_cols, test_cols = columns
    train, info = DatasetFeat.build_trainset(train_cols, **FEAT_COLS)
    evals = DatasetFeat.build_evalset(test_cols)
    log(f"[seq] {len(train)} train rows, {len(evals)} eval rows; built in "
        f"{time.perf_counter() - t0:.1f} s")
    return {name: seq_model_path(name, train, evals, info, rng, workdir)
            for name in SEQ_FAMILY}


# ------------------------------------------------------------ the feature family
# phase 7: name -> (model class, kwargs beside DIN's width); each model's
# JAX defaults otherwise (AutoInt att_embed_size (8, 8, 8) with 2 heads,
# WideDeep lr {"wide": 0.01, "deep": 1e-4})
FEAT_FAMILY = {
    "fm": ("FM", {}),
    "deepfm": ("DeepFM", dict(hidden_units=(128, 64, 32))),
    "wide_deep": ("WideDeep", dict(hidden_units=(128, 64, 32))),
    "autoint": ("AutoInt", {}),
    "ncf": ("NCF", dict(hidden_units=(128, 64, 32))),
}


def request_time_paths(model, back, test_cols, users, workdir, tag):
    """Phase 7 (e) on FM: request-time features on the card against the
    saved model on the CPU. Returns the near-tie swaps and the served ms."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.prediction import predict_data_with_feats

    static = model.recommend_user(users, 10)
    dynamic = model.recommend_user(users, 10, user_feats={})
    for u in users:
        if not np.array_equal(static[u], dynamic[u]):
            fail(f"{tag} (e) user {u}: user_feats={{}} gives {dynamic[u]}, the "
                 f"static call {static[u]}")
    pairs = [(users[0], {"sex": "f", "age": 0.5}), (users[1], {"sex": "?"}),
             (users[-1], {"age": -1.0})]
    for u, feats in pairs:
        item = int(model.data_info.id2item[7])
        got, want = model.predict(u, item, feats=feats), back.predict(u, item, feats=feats)
        if abs(got - want) > RTOL * abs(want):
            fail(f"{tag} (e) predict(feats={feats}) {got} on the GPU, {want} on "
                 f"the CPU")
    rows = {k: v[:4096] for k, v in test_cols.items()}
    got = predict_data_with_feats(model, rows, batch_size=1024)
    want = predict_data_with_feats(back, rows, batch_size=1024)
    if not np.allclose(got, want, rtol=RTOL, atol=0):
        fail(f"{tag} (e) predict_data_with_feats: max abs err "
             f"{np.abs(got - want).max()} at rtol {RTOL}")
    served, served_ms = serve_once(workdir, "fm", users[0])
    want = [int(i) for i in back.recommend_user(users[0], 10)[users[0]]]
    near = check_din_recs(served, want, back, users[0], f"{tag} (e) served")
    # the same feature update on the GPU's model and the CPU's: both rebuild
    # their feature tables at the next call
    card = models.FM.load(workdir, "fm", device="cuda")
    update = {"user": np.array(users[:-1]),
              "sex": np.array(["f", "m", "f", "m"][:len(users) - 1], dtype=object),
              "age": np.linspace(-1.0, 1.0, len(users) - 1)}
    card.data_info.assign_user_features(update)
    back.data_info.assign_user_features(update)
    after = card.recommend_user(users, 10)
    for u in users:
        want = [int(i) for i in back.recommend_user(u, 10)[u]]
        near += check_din_recs([int(i) for i in after[u]], want, back, u,
                               f"{tag} (e) after assign_user_features, user {u}")
    if card.feats.version != card.data_info.feature_version:
        fail(f"{tag} (e) the card's feature tables were not rebuilt")
    log(f"{tag} (e) user_feats={{}} equals the static call; predict(feats=...) "
        f"and predict_data_with_feats ({len(got)} rows) equal the CPU's at rtol "
        f"{RTOL}; one served request ({served_ms:.1f} ms with loading) and the "
        f"recommendations after assign_user_features equal the CPU's ({near} "
        f"near-tie swaps)")
    return near, served_ms


def feat_model_path(name, train, evals, info, test_cols, rng, workdir):
    """One model of phase 7 at DIN's width: (a) the first step's gradients
    and the parameters after one step, card against CPU from the same
    parameters and batches; (b) a 2-epoch fit on the card (the main path:
    one gather and one segment-sum a step, none for NCF; examples/s, one
    profiled epoch); (c) evaluate's AUC on the card and of the saved model on
    the CPU, within 0.01; (d) recommend_user on the card against the
    CPU-loaded model; (e) for FM, the request-time paths. Returns the path's
    numbers."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.ops import table_gather as tg

    cls_name, extra = FEAT_FAMILY[name]
    cls = getattr(models, cls_name)
    seed = int(rng.integers(1 << 30))
    rows_a_step = DIN_BATCH // 2
    n_train = len(train)
    n_batches = -(-n_train // rows_a_step)
    per_step = 0 if name == "ncf" else 1
    tag = f"[feat {name}]"
    t_path = time.perf_counter()
    part_s, t_part = {}, [t_path]

    def lap(part):
        """Host seconds of ``part`` of the path, for the summary."""
        now = time.perf_counter()
        part_s[part] = now - t_part[0]
        t_part[0] = now

    def make(device, **kw):
        return cls("ranking", info, embed_size=64, batch_size=DIN_BATCH,
                   seed=seed, device=device, **{**extra, **kw})

    def launched(what, steps):
        got = dict(gather=tg.gather_launches, segsum=tg.segsum_launches)
        if not got["gather"] == got["segsum"] == per_step * steps:
            fail(f"{tag} {what}: {got} for {steps} steps, expected "
                 f"{per_step * steps} of each")
        return got

    lr = make("cpu").lr
    lr_max = max(lr.values()) if isinstance(lr, dict) else lr

    def one_step(device):
        head = head_rows(train, rows_a_step)
        m = make(device, n_epochs=1, sampler="unconsumed")
        m.params_from_arrays(init)
        m.fit(head, neg_sampling=True, verbose=0, shuffle=False)
        return m.params_to_arrays()

    init = make("cpu")
    init.build_model()
    init = init.params_to_arrays()

    # (a) the first step, card against CPU
    batch = first_batch(make("cpu"), train)
    tg.reset_launches()
    loss_g, grads_g = first_step_grads(make("cuda"), train, init, batch)
    torch.cuda.synchronize()
    launched("(a) first step", 1)
    loss_c, grads_c = first_step_grads(make("cpu"), train, init, batch)
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"{tag} (a) first loss {loss_g} on the GPU, {loss_c} on the CPU")
    worst, bad, total, rounding_only = hold_grads(grads_g, grads_c, f"{tag} (a)")
    one = beyond(one_step("cuda"), one_step("cpu"))
    if one[1] > 0.005 * one[2] or one[0] > 2 * lr_max:
        fail(f"{tag} (a) after one step {one[1]} of {one[2]} entries differ "
             f"beyond rtol 1e-4, atol 1e-5 (max abs err {one[0]})")
    log(f"{tag} (a) first step, GPU against CPU: loss {loss_g:.7f} vs "
        f"{loss_c:.7f}; gradients: the difference's norm at most "
        f"{worst['norm'][0]:.3g} of the gradient's ({worst['norm'][1]}), an "
        f"entry off by at most {worst['entry'][0]:.3g} of the largest "
        f"({worst['entry'][1]}), {bad} of {total} entries beyond rtol 1e-4; "
        f"zero but for rounding: {rounding_only}; after one step max abs err "
        f"{one[0]:.3g}, {one[1]} of {one[2]} entries beyond rtol 1e-4, atol 1e-5")
    lap("a")

    # (b) the main path's fit on the card
    tg.reset_launches()
    model = make(None, n_epochs=2)
    t = time.perf_counter()
    model.fit(train, neg_sampling=True, verbose=0)
    fit_s = time.perf_counter() - t
    torch.cuda.synchronize()
    launches = launched("(b) fit", 2 * n_batches)
    bad = [k for k, v in model.params_to_arrays().items() if not np.isfinite(v).all()]
    if bad or not np.isfinite(model.trainer.epoch_losses).all():
        fail(f"{tag} (b) non-finite parameters {bad} or losses "
             f"{model.trainer.epoch_losses}")
    step_ms = 1e3 * model.trainer.epoch_times[1] / n_batches
    prof = epoch_profile(make("cuda", n_epochs=1),
                         head_rows(train, PROFILE_STEPS * rows_a_step), PROFILE_STEPS)
    lap("b")

    # (c) evaluate on the card and, saved, on the CPU; (d) recommend_user
    auc_g, auc_c, back, users, _, near = saved_model_checks(
        model, cls, name, evals, info, rng, workdir, seed, tag, check_din_recs)
    lap("c, d")

    # (e) FM: request-time features, batched prediction with features, a
    # feature update, one served request
    served_ms = None
    if name == "fm":
        swaps, served_ms = request_time_paths(model, back, test_cols, users,
                                              workdir, tag)
        near += swaps
        lap("e")

    summary = dict(
        examples_per_s=n_train / model.trainer.epoch_times[1],
        step_ms=step_ms, **prof,
        idle_share=1.0 - prof["device_ms_per_step"] / step_ms if step_ms > 0 else None,
        steps_per_epoch=n_batches, launches=launches,
        launches_per_step={k: v / (2 * n_batches) for k, v in launches.items()},
        fit_s=fit_s, losses=model.trainer.epoch_losses, auc_gpu=auc_g,
        auc_cpu=auc_c, near_tie_swaps=near, served_ms=served_ms,
        path_s=time.perf_counter() - t_path, part_s=part_s)
    log(f"{tag} {json.dumps(summary)}")
    return summary


def phase_feature_family(rng, workdir, columns):
    """FM, DeepFM, WideDeep, AutoInt and NCF at DIN's width (embed_size=64,
    batch_size=16384, hidden_units=(128, 64, 32)) on phase 5's feature data,
    2 epochs each. Returns each path's numbers and prints phase 7's
    summary."""
    from librecommender_tpu_torch.data import DatasetFeat

    t0 = time.perf_counter()
    train_cols, test_cols = columns
    train, info = DatasetFeat.build_trainset(train_cols, **FEAT_COLS)
    evals = DatasetFeat.build_evalset(test_cols)
    log(f"[feat] {len(train)} train rows, {len(evals)} eval rows; built in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {name: feat_model_path(name, train, evals, info, test_cols, rng, workdir)
             for name in FEAT_FAMILY}
    log(json.dumps({"phase7_feature_family": {name: {
        key: row[key] for key in ("launches_per_step", "step_ms",
                                  "device_ms_per_step", "idle_share",
                                  "examples_per_s", "auc_gpu", "auc_cpu")}
        for name, row in paths.items()}, "phase7_s": time.perf_counter() - t0}))
    return paths


# ----------------------------------------------------- the embedding family
# phase 8: name -> (model class, kwargs beside embed_size=64,
# batch_size=16384, lr=0.001); each model's JAX defaults otherwise (Caser 2
# horizontal filters a height and 4 vertical, WaveNet 1 block of 4 layers, 16
# filters)
EMBED_FAMILY = {
    "svd": ("SVD", dict(sparse_optimizer=True)),
    "svdpp": ("SVDpp", dict(recent_num=30)),
    "rnn4rec_gru": ("RNN4Rec", dict(hidden_units=(64,), recent_num=10)),
    "rnn4rec_lstm": ("RNN4Rec", dict(rnn_type="lstm", hidden_units=(64,),
                                     recent_num=10)),
    "caser": ("Caser", dict(recent_num=10)),
    "wave_net": ("WaveNet", dict(recent_num=10)),
}
EMBED_LR = 0.001


def saved_model_checks(model, cls, name, evals, info, rng, workdir, seed, tag,
                       check=check_recs, metrics=("roc_auc",)):
    """Phases 6 to 9, (c) and (d): evaluate's AUC on the card and of the
    model saved and loaded on the CPU, within 0.01 (``metrics`` beside it
    computed, not held); recommend_user for four users and a cold one (the
    all-pad histories, the OOV rows) on the card against the CPU-loaded
    model, each list held by ``check``. Returns (AUC on the card, on the
    CPU, the CPU-loaded model, the users, the card's recommendations,
    near-tie swaps)."""
    from librecommender_tpu_torch.evaluation import evaluate

    gpu = evaluate(model, evals, neg_sampling=True, metrics=list(metrics),
                   sample_user_num=256, seed=seed)
    model.save(workdir, name)
    back = cls.load(workdir, name, device="cpu")
    cpu = evaluate(back, evals, neg_sampling=True, metrics=list(metrics),
                   sample_user_num=256, seed=seed)
    if len(metrics) > 1:
        log(f"{tag} (c) evaluate on the card {json.dumps(gpu)}, on the CPU "
            f"{json.dumps(cpu)}")
    auc_g, auc_c = gpu["roc_auc"], cpu["roc_auc"]
    if not (np.isfinite(auc_g) and np.isfinite(auc_c)) or abs(auc_g - auc_c) > 0.01:
        fail(f"{tag} (c) AUC {auc_g} on the GPU, {auc_c} on the CPU")
    if auc_g <= 0.5:
        fail(f"{tag} (c) AUC {auc_g}: no better than chance")
    users = [int(info.id2user[int(i)])
             for i in rng.choice(info.n_users, 4, replace=False)]
    users.append(10**9)   # a cold user
    recs = model.recommend_user(users, 10)
    near = 0
    for u in users:
        if len(recs[u]) != 10:
            fail(f"{tag} (d) user {u}: {len(recs[u])} recommendations")
        want = [int(i) for i in back.recommend_user(u, 10)[u]]
        near += check([int(i) for i in recs[u]], want, back, u,
                      f"{tag} (d) user {u}")
    return auc_g, auc_c, back, users, recs, near


def conv_precision(rng):
    """The port's convolutions at phase 8's shapes on the card under
    PyTorch's default cuDNN setting, TF32 on: Caser's horizontal convs of
    heights 1 to 10 over 64 channels and WaveNet's width-2 causal convs at
    dilations 1 to 8, each at 8192 rows of 10 steps. The value and both
    gradients are held against float64 on the CPU: float32 lands near 1e-6
    of the largest entry, TF32 near 1e-4 to 1e-3, so the limit is 1e-5. The
    flag must be as it was after. Returns each case's worst error, and plain
    cuDNN's forward under the default for the record."""
    import torch.nn.functional as F

    from librecommender_tpu_torch.ops import nn

    if not torch.backends.cudnn.allow_tf32:
        fail("[embed conv] cuDNN's TF32 is off before the check: not the default")
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    cases = [(f"caser h{h}", h, 64, 2, 1) for h in range(1, 11)]
    cases += [(f"wave_net d{d}", 2, 64 if d == 1 else 16, 16, d) for d in (1, 2, 4, 8)]
    out = {}
    for what, width, c_in, c_out, dilation in cases:
        params = nn.init_conv1d(gen, width, c_in, c_out)
        x = torch.randn(8192, 10, c_in, generator=gen)
        causal = what.startswith("wave_net")

        def run(device, dtype):
            xs = x.to(device, dtype, copy=True).requires_grad_()
            w = params["w"].to(device, dtype, copy=True).requires_grad_()
            p = {"w": w, "b": params["b"].to(device, dtype)}
            y = (nn.causal_conv1d(p, xs, dilation=dilation) if causal
                 else nn.conv1d(p, xs, dilation=dilation))
            r = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
            (y * r.to(device, dtype)).sum().backward()
            return [t.detach().cpu().double() for t in (y, xs.grad, w.grad)]

        got, want = run("cuda", torch.float32), run("cpu", torch.float64)
        err = max(float((g - t).abs().max() / t.abs().max())
                  for g, t in zip(got, want))
        xin = x.cuda().transpose(1, 2)
        if causal:
            xin = F.pad(xin, (dilation * (width - 1), 0))
        plain = F.conv1d(xin, params["w"].cuda().permute(2, 1, 0),
                         dilation=dilation).transpose(1, 2) + params["b"].cuda()
        plain_err = float((plain.double().cpu() - want[0]).abs().max()
                          / want[0].abs().max())
        if err > 1e-5:
            fail(f"[embed conv] {what}: the port's conv is {err:.3g} of the largest "
                 f"entry off float64 (plain cuDNN under TF32: {plain_err:.3g})")
        out[what] = dict(err=err, plain_tf32_forward_err=plain_err)
    if not torch.backends.cudnn.allow_tf32:
        fail("[embed conv] the port's conv left cuDNN's TF32 off")
    log(f"[embed conv] the port's convs, value and gradients, against float64: "
        f"{json.dumps(out)}")
    return out


def embed_model_path(name, train, evals, info, rng, workdir):
    """One SGD-trained model of phase 8 at the ported paths' width: (a) the
    first step's gradients and the parameters after one step, card against
    CPU from the same parameters and batches (SVDpp: also one step of the
    neighbour-gather form); (b) a profiled fit of the first PROFILE_STEPS
    steps, SVD's two same-seed fits (bit-identical), then a 2-epoch fit on
    the card (examples/s); (c) evaluate's AUC on the card and of the saved
    model on the CPU, within 0.01; (d) recommend_user on the card against
    the CPU-loaded model; (e) for RNN4Rec (gru), a request seq equal to the
    stored history against the static call, and the saved model loaded on
    the GPU and served over HTTP. The main path, the 2-epoch fit to (e), is
    counted: each kernel's launches, and the fit's alone. Returns the path's
    numbers."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops import table_gather as tg

    cls_name, extra = EMBED_FAMILY[name]
    cls = getattr(models, cls_name)
    seed = int(rng.integers(1 << 30))
    rows_a_step = DIN_BATCH // 2
    n_train = len(train)
    n_batches = -(-n_train // rows_a_step)
    tag = f"[embed {name}]"
    t_path = time.perf_counter()
    part_s, t_part = {}, [t_path]

    def lap(part):
        now = time.perf_counter()
        part_s[part] = now - t_part[0]
        t_part[0] = now

    def make(device, **kw):
        return cls("ranking", info, embed_size=64, batch_size=DIN_BATCH,
                   lr=EMBED_LR, seed=seed, device=device, **{**extra, **kw})

    def one_step(device, **kw):
        head = head_rows(train, rows_a_step)
        m = make(device, n_epochs=1, sampler="unconsumed", **kw)
        m.params_from_arrays(init)
        m.fit(head, neg_sampling=True, verbose=0, shuffle=False)
        return m.params_to_arrays()

    def held_step(what, **kw):
        one = beyond(one_step("cuda", **kw), one_step("cpu", **kw))
        if one[1] > 0.005 * one[2] or one[0] > 2 * EMBED_LR:
            fail(f"{tag} (a) {what}: after one step {one[1]} of {one[2]} entries "
                 f"differ beyond rtol 1e-4, atol 1e-5 (max abs err {one[0]})")
        return (f"{what}: after one step max abs err {one[0]:.3g}, {one[1]} of "
                f"{one[2]} entries beyond rtol 1e-4, atol 1e-5")

    init = make("cpu")
    init.build_model()
    init = init.params_to_arrays()

    # (a) the first step, card against CPU
    batch = first_batch(make("cpu"), train)
    loss_g, grads_g = first_step_grads(make("cuda"), train, init, batch)
    loss_c, grads_c = first_step_grads(make("cpu"), train, init, batch)
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"{tag} (a) first loss {loss_g} on the GPU, {loss_c} on the CPU")
    worst, bad, total, rounding_only = hold_grads(grads_g, grads_c, f"{tag} (a)")
    steps = [held_step("default form")]
    if name == "svdpp":
        steps.append(held_step("neighbour-gather form", dense_adj_limit=0))
    log(f"{tag} (a) first step, GPU against CPU: loss {loss_g:.7f} vs "
        f"{loss_c:.7f}; gradients: the difference's norm at most "
        f"{worst['norm'][0]:.3g} of the gradient's ({worst['norm'][1]}), an "
        f"entry off by at most {worst['entry'][0]:.3g} of the largest "
        f"({worst['entry'][1]}), {bad} of {total} entries beyond rtol 1e-4; "
        f"zero but for rounding: {rounding_only}; " + "; ".join(steps))
    lap("a")

    # (b) a profiled fit of the first PROFILE_STEPS steps (a profile records
    # every operator: one of the epoch's first steps costs ten times less
    # than one of a whole epoch) and SVD's same-seed fits, before the main
    # path and not counted in it
    prof = epoch_profile(make("cuda", n_epochs=1),
                         head_rows(train, PROFILE_STEPS * rows_a_step), PROFILE_STEPS)
    if name == "svd":
        twins = []
        for _ in range(2):
            m = make("cuda", n_epochs=1)
            m.fit(train, neg_sampling=True, verbose=0)
            twins.append(m.params_to_arrays())
        for k in twins[0]:
            if not np.array_equal(twins[0][k], twins[1][k]):
                fail(f"{tag} (b) two same-seed fits differ in {k}")
        log(f"{tag} (b) two same-seed fits on the card are bit-identical")

    # the main path's fit on the card: its kernels counted from here to (e)
    st.reset_launches()
    tg.reset_launches()
    model = make(None, n_epochs=2)
    t = time.perf_counter()
    model.fit(train, neg_sampling=True, verbose=0)
    fit_s = time.perf_counter() - t
    torch.cuda.synchronize()
    fit_launches = dict(topk=st.launches, gather=tg.gather_launches,
                        segsum=tg.segsum_launches)
    bad = [k for k, v in model.params_to_arrays().items() if not np.isfinite(v).all()]
    if bad or not np.isfinite(model.trainer.epoch_losses).all():
        fail(f"{tag} (b) non-finite parameters {bad} or losses "
             f"{model.trainer.epoch_losses}")
    step_ms = 1e3 * model.trainer.epoch_times[1] / n_batches
    lap("b")

    # (c) evaluate on the card and, saved, on the CPU; (d) recommend_user
    auc_g, auc_c, back, users, recs, near = saved_model_checks(
        model, cls, name, evals, info, rng, workdir, seed, tag)
    lap("c, d")

    # (e) RNN4Rec: a request seq equal to the stored history gives the static
    # ids (but for near-ties: one user's forward against a chunk's); the
    # saved model served from the GPU
    served_ms = None
    if name == "rnn4rec_gru":
        for u in users[:-1]:
            uid = info.user2id[u]
            history = [int(info.id2item[i]) for i in info.user_consumed[uid]]
            got = [int(i) for i in model.recommend_user(u, 10, seq=history)[u]]
            near += check_recs(got, [int(i) for i in recs[u]], model, u,
                               f"{tag} (e) user {u}, seq= the stored history")
        served, served_ms = serve_once(workdir, name, users[0])
        want = [int(i) for i in back.recommend_user(users[0], 10)[users[0]]]
        near += check_recs(served, want, back, users[0], f"{tag} (e) served")
        log(f"{tag} (e) recommend_user(seq=stored history) equals the static "
            f"call for {len(users) - 1} users; one served request "
            f"({served_ms:.1f} ms with loading)")
        lap("e")
    torch.cuda.synchronize()
    launches = dict(topk=st.launches, gather=tg.gather_launches,
                    segsum=tg.segsum_launches)
    if launches["topk"] == 0:
        fail(f"{tag} the main path launched no top-k: {launches}")

    summary = dict(
        examples_per_s=n_train / model.trainer.epoch_times[1],
        step_ms=step_ms, **prof,
        idle_share=1.0 - prof["device_ms_per_step"] / step_ms if step_ms > 0 else None,
        steps_per_epoch=n_batches, launches=launches, fit_launches=fit_launches,
        fit_s=fit_s, losses=model.trainer.epoch_losses, auc_gpu=auc_g,
        auc_cpu=auc_c, near_tie_swaps=near, served_ms=served_ms,
        path_s=time.perf_counter() - t_path, part_s=part_s)
    log(f"{tag} {json.dumps(summary)}")
    return summary


def als_gather_times(model, buckets_by_side):
    """The gathers of one ALS epoch at its bucket shapes: kernel (CUDA
    events) and index_select times summed over the buckets, the kernel's
    device time by torch.profiler, and the bound (each bucket's ids and the
    distinct rows they touch read once, its rows written once)."""
    from librecommender_tpu_torch.ops import table_gather as tg

    out = dict(ms=0.0, device_ms=0.0, library_ms=0.0, bound_ms=0.0,
               shapes=[], bound_by="bytes")
    for other_key, buckets in buckets_by_side:
        other = model.net[other_key].detach()
        R, D = other.shape
        for L, _, ids, _ in buckets:
            flat = ids.reshape(-1)
            flat_long = flat.long()
            n_distinct = int(torch.unique(flat).numel())
            b_ms, b_by = table_bound_ms("gather", R, flat.numel(), D,
                                        flat.numel(), n_distinct)
            out["ms"] += time_ms(lambda: tg.table_gather(other, flat))
            dev = device_ms(lambda: tg.table_gather(other, flat),
                            {"::gather_kernel": 1})[0]
            out["device_ms"] = None if None in (dev, out["device_ms"]) else (
                out["device_ms"] + dev)
            out["library_ms"] += time_ms(lambda: torch.index_select(other, 0, flat_long))
            out["bound_ms"] += b_ms
            out["shapes"].append([other_key, R, D, int(ids.shape[0]), int(L)])
    return out


def als_path(train, evals, info, rng, workdir):
    """ALS (implicit, reg 0.1, alpha 10, embed 64): (a) one user-side solve
    card against CPU from the same tables, every bucket's gather through
    kernel 2.2a exact against index_select; (b) a 2-epoch fit on the card,
    one gather launch a bucket a side an epoch, each epoch's gathers timed
    against index_select at the same shapes, one profiled epoch; (c)
    evaluate's AUC on the card and of the saved model on the CPU, within
    0.01; (d) recommend_user against the CPU-loaded model. Returns the
    path's numbers."""
    from librecommender_tpu_torch.evaluation import evaluate
    from librecommender_tpu_torch.models import ALS
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops import table_gather as tg

    seed = int(rng.integers(1 << 30))
    tag = "[embed als]"
    t_path = time.perf_counter()

    def make(device, **kw):
        return ALS("ranking", info, embed_size=64, reg=0.1, alpha=10, seed=seed,
                   device=device, **kw)

    init = make("cpu")
    init.build_model()
    init = init.params_to_arrays()

    # (a) one user-side solve, card against CPU; the gathers exact
    solved = {}
    for device in ("cuda", "cpu"):
        m = make(device)
        m.params_from_arrays(init)
        user_buckets, item_buckets = m.side_buckets(train)
        if device == "cuda":
            other = m.net["item_embed"].detach()
            for L, _, ids, _ in user_buckets:
                flat = ids.reshape(-1)
                if not torch.equal(tg.table_gather(other, flat),
                                   torch.index_select(other, 0, flat.long())):
                    fail(f"{tag} (a) the gather of bucket L={L} differs from "
                         f"index_select")
            tg.reset_launches()
        m.solve_side("user_embed", "item_embed", user_buckets)
        if device == "cuda":
            torch.cuda.synchronize()
            if tg.gather_launches != len(user_buckets):
                fail(f"{tag} (a) {tg.gather_launches} gathers for "
                     f"{len(user_buckets)} buckets")
        solved[device] = {"user_embed": m.params_to_arrays()["user_embed"]}
    worst, bad, total = beyond(solved["cuda"], solved["cpu"])
    top = float(np.abs(solved["cpu"]["user_embed"]).max())
    if bad > 0.005 * total or worst > 1e-3 * top:
        fail(f"{tag} (a) user solve: {bad} of {total} entries beyond rtol 1e-4, "
             f"atol 1e-5; max abs err {worst} (largest entry {top})")
    log(f"{tag} (a) one user-side solve, GPU against CPU: max abs err "
        f"{worst:.3g} (largest entry {top:.3g}), {bad} of {total} entries beyond "
        f"rtol 1e-4, atol 1e-5; {len(user_buckets)} bucket gathers exact against "
        f"index_select")

    # (b) the main path's fit on the card; its kernels counted from here
    st.reset_launches()
    tg.reset_launches()
    model = make(None, n_epochs=2)
    t = time.perf_counter()
    model.fit(train, neg_sampling=True, verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    user_buckets, item_buckets = model.side_buckets(train)
    n_buckets = len(user_buckets) + len(item_buckets)
    if tg.gather_launches != 2 * n_buckets:
        fail(f"{tag} (b) {tg.gather_launches} gathers for 2 epochs of "
             f"{n_buckets} buckets")
    bad = [k for k, v in model.params_to_arrays().items() if not np.isfinite(v).all()]
    if bad:
        fail(f"{tag} (b) non-finite parameters {bad}")

    # (c) evaluate on the card and, saved, on the CPU; (d) recommend_user
    auc_g, auc_c, _, _, _, near = saved_model_checks(
        model, ALS, "als", evals, info, rng, workdir, seed, tag)
    torch.cuda.synchronize()
    # the main path's launches: the fit's gathers, the top-k of post_fit and (d)
    launches = dict(topk=st.launches, gather=tg.gather_launches,
                    segsum=tg.segsum_launches)
    if launches["topk"] == 0:
        fail(f"{tag} the main path launched no top-k: {launches}")

    # an epoch's solves timed and profiled, and its gathers timed alone
    def one_epoch():
        model.solve_side("user_embed", "item_embed", user_buckets)
        model.solve_side("item_embed", "user_embed", item_buckets)

    epoch_ms = host_ms(one_epoch, runs=3)
    by_op, device_us, gather_us = {}, 0.0, 0.0
    for evt in profiled(one_epoch):
        if not _is_kernel(evt):
            continue
        us = _self_device_us(evt)
        device_us += us
        if "::gather_kernel" in evt.key:
            gather_us += us
        if us > 0:
            by_op[evt.key[:60]] = us / 1e3
    gathers = als_gather_times(model, (("item_embed", user_buckets),
                                       ("user_embed", item_buckets)))
    log(f"{tag} (b) fit {fit_s:.2f} s; an epoch {epoch_ms:.1f} ms host, "
        f"{device_us / 1e3:.2f} ms device, of which the {n_buckets} gathers "
        f"{gather_us / 1e3:.3f} ms; the epoch's gathers timed alone "
        f"{json.dumps(gathers)}")
    summary = dict(
        fit_s=fit_s, epoch_host_ms=epoch_ms, epoch_device_ms=device_us / 1e3,
        epoch_gather_device_ms=gather_us / 1e3, buckets=n_buckets,
        gathers_per_epoch=n_buckets, epoch_gathers=gathers,
        top_device_ops_ms_per_epoch=sorted(by_op.items(), key=lambda kv: -kv[1])[:8],
        idle_share=1.0 - device_us / 1e3 / epoch_ms if epoch_ms > 0 else None,
        launches=launches, auc_gpu=auc_g, auc_cpu=auc_c, near_tie_swaps=near,
        path_s=time.perf_counter() - t_path)
    log(f"{tag} {json.dumps(summary)}")
    return summary


def phase_embed_family(rng, workdir, columns):
    """SVD (lazy Adam), SVDpp (recent 30, the dense W form), RNN4Rec (gru and
    lstm, hidden 64), Caser and WaveNet (recent 10) at embed 64, batch 16384,
    lr 0.001, 2 epochs, and ALS (implicit), on phase 4's pure data. Returns
    each path's numbers and prints phase 8's summary."""
    t0 = time.perf_counter()
    conv = conv_precision(rng)
    train, evals, info = training_data(columns)
    log(f"[embed] {len(train)} train rows, {len(evals)} eval rows; built in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {name: embed_model_path(name, train, evals, info, rng, workdir)
             for name in EMBED_FAMILY}
    paths["als"] = als_path(train, evals, info, rng, workdir)
    keys = ("kernel_launches_per_step", "step_ms", "device_ms_per_step",
            "idle_share", "examples_per_s", "auc_gpu", "auc_cpu", "launches",
            "fit_launches")
    row = {name: {k: p[k] for k in keys if k in p} for name, p in paths.items()}
    als = paths["als"]
    row["als"].update(epoch_host_ms=als["epoch_host_ms"],
                      epoch_device_ms=als["epoch_device_ms"],
                      epoch_gather_device_ms=als["epoch_gather_device_ms"],
                      epoch_gathers_ms=als["epoch_gathers"]["ms"],
                      epoch_index_select_ms=als["epoch_gathers"]["library_ms"],
                      epoch_gathers_bound_ms=als["epoch_gathers"]["bound_ms"])
    log(json.dumps({"phase8_embed_family": row, "conv_precision": conv,
                    "phase8_s": time.perf_counter() - t0}))
    return paths


# ------------------------------------------- the retrieval and graph family
# phase 9: name -> (model class, data, kwargs beside embed_size=64,
# batch_size=8192, lr=0.001), the widths of bench.py:219-258; each model's
# JAX defaults otherwise (YouTubeRetrieval's 8192 shared negatives a step are
# its default, the batch size)
RETRIEVAL_GRAPH = {
    "youtube_retrieval": ("YouTubeRetrieval", "feat", dict(
        loss_type="sampled_softmax", hidden_units=(128, 64, 32), recent_num=10)),
    "two_tower": ("TwoTower", "feat", dict(
        loss_type="softmax", hidden_units=(128, 64, 32), use_correction=True)),
    "lightgcn": ("LightGCN", "pure", dict(n_layers=3)),
    "ngcf": ("NGCF", "pure", dict(loss_type="bpr", hidden_units=(64, 64, 64))),
}
# the other forms each path's one-step check runs
RETRIEVAL_GRAPH_FORMS = {
    "youtube_retrieval": {"nce": dict(loss_type="nce")},
    "two_tower": {"cfm, lazy Adam, bfloat16": dict(
        ssl_pattern="cfm", sparse_optimizer=True, compute_dtype="bf16")},
    "lightgcn": {"edges": dict(dense_adj_limit=0)},
    "ngcf": {"edges": dict(dense_adj_limit=0), "AMSGrad": dict(amsgrad=True)},
}
PHASE9_BATCH = 8192
PHASE9_LR = 0.001


def feed_draws(model, draws):
    """Fix the draws of ``model``'s loss (phase 9 (a)): YouTubeRetrieval's
    shared negatives and TwoTower's SSL field masks, the same tensors on the
    card and the CPU, through the models' seams."""
    if "negatives" in draws:
        neg = draws["negatives"]
        model._shared_negatives = lambda n: neg[:n].to(model.device)
    if "masks" in draws:
        masks = draws["masks"]
        model._ssl_masks = lambda F: tuple(m.to(model.device) for m in masks)
    return model


def check_topk_widths(model, users, what):
    """The top-k at a path's width on the card, outside its counted run:
    one served request (U = 1) and one of evaluate's calls (as many users as
    fit 8192 scores) at k = 10 plus the widest consumed row, each against
    the plain version with kernel, plain and torch.topk(u @ i.T) times, and
    the ids of all ``users`` at once against torch.topk(u @ i.T) itself.
    Returns the two measured rows and the near-tie swaps."""
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops.topk import fetch_size

    info = model.data_info
    uids = [info.user2id[u] for u in users]
    items = model.item_embeds[:-1]
    n_items = info.n_items

    def k_for(rows):
        width = max(len(info.user_consumed[u]) for u in rows)
        return fetch_size(10, width if 10 + width <= n_items else 0, n_items)

    per_call = max(1, 8192 // n_items)
    rows = {}
    for kind, sel in (("served", uids[:1]), ("evaluate", uids[:per_call])):
        u = model.user_embeds[torch.as_tensor(sel, device=model.device)]
        rows[kind] = measure_kernel(st, u, items, k_for(sel),
                                    f"{what} {kind}, D={u.shape[1]}")
    u = model.user_embeds[torch.as_tensor(uids, device=model.device)]
    k = k_for(uids)
    ids_k, sc_k = st.streaming_topk(u, items, k)
    sc_l, ids_l = torch.topk(u @ items.T, k, dim=1)
    torch.cuda.synchronize()
    err, near = check_topk(u, items, ids_k, sc_k, ids_l.int(), sc_l,
                           f"{what} against torch.topk(u @ i.T)")
    log(f"{what}: the kernel's ids for {len(uids)} users at D={u.shape[1]}, "
        f"k={k} equal torch.topk(u @ i.T)'s but for {near} near-ties (max "
        f"score err {err:.3g})")
    return rows, near


def request_features_check(model, back, users, workdir, tag):
    """Phase 9 (e), TwoTower: recommend_user(user_feats=...) on the card
    against the CPU-loaded model (a position may differ only where the two
    items' float64 scores under the request's user vector are within RTOL),
    and the saved model loaded on the GPU and served over HTTP. Returns the
    near-tie swaps and the served ms."""
    info = back.data_info
    near = 0
    for feats in ({"sex": "f", "age": 0.5}, {"sex": "?"}, {"age": -1.0}):
        got = model.recommend_user(users, 10, user_feats=feats)
        want = back.recommend_user(users, 10, user_feats=feats)
        for u in users:
            vec = back.dyn_user_embedding(u, user_feats=feats).astype(np.float64)
            for i, (a, b) in enumerate(zip(got[u], want[u])):
                if a == b:
                    continue
                sa = vec @ back.item_embeds_np[info.item2id[a]].astype(np.float64)
                sb = vec @ back.item_embeds_np[info.item2id[b]].astype(np.float64)
                if abs(sa - sb) > RTOL * max(abs(sa), abs(sb)):
                    fail(f"{tag} (e) user {u}, user_feats={feats}: position {i} "
                         f"differs ({a} vs {b}) and is not a near-tie")
                near += 1
            if len(got[u]) != 10:
                fail(f"{tag} (e) user {u}: {len(got[u])} recommendations")
    served, served_ms = serve_once(workdir, "two_tower", users[0])
    want = [int(i) for i in back.recommend_user(users[0], 10)[users[0]]]
    near += check_recs(served, want, back, users[0], f"{tag} (e) served")
    log(f"{tag} (e) recommend_user(user_feats=...) equals the CPU's for "
        f"{len(users)} users and 3 feature sets ({near} near-tie swaps); one "
        f"served request ({served_ms:.1f} ms with loading)")
    return near, served_ms


def retrieval_graph_path(name, data, rng, workdir):
    """One model of phase 9 at bench.py's width: (a) the first step's
    gradients and the parameters after one step, card against CPU from the
    same parameters, batches and draws, and one step of each other form;
    (b) a profiled fit of PROFILE_STEPS steps, then a 2-epoch fit on the
    card (examples/s, idle share, the top-k's launches after it); (c)
    evaluate's AUC (and NDCG, through the top-k) on the card and of the saved
    model on the CPU, AUC within 0.01; (d) recommend_user on the card against
    the CPU-loaded model; (e) for TwoTower, request-time user features and
    one served request. The main path, the 2-epoch fit to (e), is counted.
    The top-k at the path's width is then checked and timed outside it.
    Returns the path's numbers."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.ops import streaming_topk as st

    cls_name, kind, extra = RETRIEVAL_GRAPH[name]
    train, evals, info = data[kind]
    cls = getattr(models, cls_name)
    seed = int(rng.integers(1 << 30))
    n_train = len(train)
    n_batches = -(-n_train // PHASE9_BATCH)
    tag = f"[retrieval-graph {name}]"
    t_path = time.perf_counter()
    part_s, t_part = {}, [t_path]

    def lap(part):
        now = time.perf_counter()
        part_s[part] = now - t_part[0]
        t_part[0] = now

    def make(device, **kw):
        return cls("ranking", info, embed_size=64, batch_size=PHASE9_BATCH,
                   lr=PHASE9_LR, seed=seed, device=device, **{**extra, **kw})

    listwise = make("cpu").paradigm == "listwise"
    init = make("cpu")
    init.build_model()
    init = init.params_to_arrays()
    draws = {}
    if cls_name == "YouTubeRetrieval":
        draws["negatives"] = torch.from_numpy(
            rng.integers(0, info.n_items, PHASE9_BATCH))
    elif cls_name == "TwoTower":
        probe = make("cpu", ssl_pattern="cfm")
        probe.build_model()
        draws["masks"] = probe._ssl_masks(len(probe.feats.item_sparse_pos))

    def one_step(device, **kw):
        m = make(device, n_epochs=1, sampler="unconsumed", **kw)
        m.params_from_arrays(init)
        feed_draws(m, draws)
        m.fit(head_rows(train, PHASE9_BATCH), neg_sampling=not listwise, verbose=0,
              shuffle=False)
        return m.params_to_arrays()

    def held_step(what, **kw):
        if kw.get("compute_dtype") == "bf16":
            worst = hold_by_reference(
                one_step("cuda", **kw), one_step("cpu", **kw),
                one_step("cpu", **{**kw, "compute_dtype": "f32"}),
                f"{tag} (a) {what}, one step")
            return (f"{what}: one step's parameters at most {worst[0]:.3g} of "
                    f"the bfloat16 limit ({worst[1]})")
        one = beyond(one_step("cuda", **kw), one_step("cpu", **kw))
        if one[1] > 0.005 * one[2] or one[0] > 2 * PHASE9_LR:
            fail(f"{tag} (a) {what}: after one step {one[1]} of {one[2]} entries "
                 f"differ beyond rtol 1e-4, atol 1e-5 (max abs err {one[0]})")
        return (f"{what}: after one step max abs err {one[0]:.3g}, {one[1]} of "
                f"{one[2]} entries beyond rtol 1e-4, atol 1e-5")

    # (a) the first step, card against CPU
    batch = first_batch(make("cpu"), train, PHASE9_BATCH)
    loss_g, grads_g = first_step_grads(feed_draws(make("cuda"), draws), train,
                                       init, batch)
    loss_c, grads_c = first_step_grads(feed_draws(make("cpu"), draws), train,
                                       init, batch)
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"{tag} (a) first loss {loss_g} on the GPU, {loss_c} on the CPU")
    worst, bad, total, rounding_only = hold_grads(grads_g, grads_c, f"{tag} (a)")
    steps = [held_step("default form")]
    steps += [held_step(what, **kw)
              for what, kw in RETRIEVAL_GRAPH_FORMS[name].items()]
    log(f"{tag} (a) first step, GPU against CPU: loss {loss_g:.7f} vs "
        f"{loss_c:.7f}; gradients: the difference's norm at most "
        f"{worst['norm'][0]:.3g} of the gradient's ({worst['norm'][1]}), an "
        f"entry off by at most {worst['entry'][0]:.3g} of the largest "
        f"({worst['entry'][1]}), {bad} of {total} entries beyond rtol 1e-4; "
        f"zero but for rounding: {rounding_only}; " + "; ".join(steps))
    lap("a")

    # (b) a profiled fit of the first PROFILE_STEPS steps, not counted
    prof = epoch_profile(make("cuda", n_epochs=1),
                         head_rows(train, PROFILE_STEPS * PHASE9_BATCH), PROFILE_STEPS,
                         neg_sampling=not listwise)

    # the main path on the card: the top-k counted from here to (e)
    st.reset_launches()
    model = make(None, n_epochs=2)
    t = time.perf_counter()
    model.fit(train, neg_sampling=not listwise, verbose=0)
    fit_s = time.perf_counter() - t
    torch.cuda.synchronize()
    fit_launches = st.launches
    bad = [k for k, v in model.params_to_arrays().items() if not np.isfinite(v).all()]
    if bad or not np.isfinite(model.trainer.epoch_losses).all():
        fail(f"{tag} (b) non-finite parameters {bad} or losses "
             f"{model.trainer.epoch_losses}")
    step_ms = 1e3 * model.trainer.epoch_times[1] / n_batches
    lap("b")

    # (c) evaluate on the card and, saved, on the CPU; (d) recommend_user
    auc_g, auc_c, back, users, recs, near = saved_model_checks(
        model, cls, name, evals, info, rng, workdir, seed, tag,
        metrics=("roc_auc", "ndcg"))
    lap("c, d")

    # (e) TwoTower: request-time user features; the saved model served
    served_ms = None
    if cls_name == "TwoTower":
        swaps, served_ms = request_features_check(model, back, users, workdir, tag)
        near += swaps
        lap("e")
    torch.cuda.synchronize()
    launches = st.launches
    if launches == 0 or fit_launches == 0:
        fail(f"{tag} the main path launched the top-k {launches} times "
             f"({fit_launches} by the end of the fit)")

    # the top-k at this path's width, outside the counted run
    topk, swaps = check_topk_widths(model, users[:-1], tag)
    near += swaps
    lap("top-k")
    summary = dict(
        width=int(model.item_embeds.shape[1]),
        examples_per_s=n_train / model.trainer.epoch_times[1],
        step_ms=step_ms, **prof,
        idle_share=1.0 - prof["device_ms_per_step"] / step_ms if step_ms > 0 else None,
        steps_per_epoch=n_batches, launches=dict(topk=launches),
        fit_launches=dict(topk=fit_launches), fit_s=fit_s,
        losses=model.trainer.epoch_losses, auc_gpu=auc_g, auc_cpu=auc_c,
        near_tie_swaps=near, served_ms=served_ms, topk=topk,
        path_s=time.perf_counter() - t_path, part_s=part_s)
    log(f"{tag} {json.dumps(summary)}")
    return summary


def phase_retrieval_graph(rng, workdir, columns):
    """YouTubeRetrieval (sampled softmax) and TwoTower (in-batch softmax) on
    phase 5's feature data, LightGCN (dense bfloat16 adjacency) and NGCF
    (bpr, dense R) on phase 4's pure data, at embed 64, batch 8192, lr 0.001,
    2 epochs each. Returns each path's numbers and prints phase 9's
    summary."""
    from librecommender_tpu_torch.data import DatasetFeat

    t0 = time.perf_counter()
    train_cols, test_cols = columns
    feat_train, feat_info = DatasetFeat.build_trainset(train_cols, **FEAT_COLS)
    data = {"feat": (feat_train, DatasetFeat.build_evalset(test_cols), feat_info),
            "pure": training_data(columns)}
    log(f"[retrieval-graph] {len(feat_train)} train rows; built in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {name: retrieval_graph_path(name, data, rng, workdir)
             for name in RETRIEVAL_GRAPH}
    keys = ("width", "kernel_launches_per_step", "step_ms", "device_ms_per_step",
            "idle_share", "examples_per_s", "auc_gpu", "auc_cpu", "launches",
            "fit_launches", "top_device_ops_ms_per_step")
    row = {name: {k: p[k] for k in keys} for name, p in paths.items()}
    for name, p in paths.items():
        row[name]["topk_ms"] = {kind: dict(shape=r["shape"], ms=r["ms"],
                                           device_ms=r["device_ms"],
                                           library_ms=r["library_ms"],
                                           bound_ms=r["bound_ms"])
                                for kind, r in p["topk"].items()}
    log(json.dumps({"phase9_retrieval_graph": row,
                    "phase9_s": time.perf_counter() - t0}))
    return paths


# --------------------------------- the item-to-item graph and word2vec family
# phase 10: name -> (model class, data, batch size, epochs, kwargs beside
# embed_size=64 and lr 0.001); the i2i batch is 81,920 pairs, 1638 start
# nodes a step (81,920 / num_neg 1 / 10 walks / 5 hops), and Item2Vec's
# window is parity/run_ours.py's 5 (its default, the whole list, is O(len^2)
# a user on the host)
SAGE_W2V = {
    "graphsage_u2i": ("GraphSage", "feat", 8192, 2, dict(
        loss_type="cross_entropy", num_layers=2, num_neighbors=10)),
    "pinsage_u2i": ("PinSage", "feat", 8192, 2, dict(
        loss_type="max_margin", num_neighbors=10, num_walks=10,
        neighbor_walk_len=2)),
    "graphsage_i2i": ("GraphSage", "pure", 81_920, 1, dict(
        loss_type="bpr", paradigm="i2i", num_walks=10, sample_walk_len=5)),
    "item2vec": ("Item2Vec", "pure", 10_000, 1, dict(window_size=5, num_neg=5)),
    "deepwalk": ("DeepWalk", "pure", 10_000, 1, dict(
        n_walks=10, walk_length=10, window_size=5)),
}
PHASE10_LR = 0.001
SAGE_SEAMS = ("_start_nodes", "_walk_slots", "_neg_proposals")


def record_sage_draws(model, batch):
    """The draws of one ``loss_fn`` call of ``model`` on the CPU (start
    nodes, walk slots, negative proposals, neighbour picks), in order."""
    drawn = []
    for seam in SAGE_SEAMS:
        def record(*args, plain=getattr(model, seam)):
            drawn.append(plain(*args))
            return drawn[-1]
        setattr(model, seam, record)
    model.loss_fn(model.net, {k: torch.from_numpy(v) for k, v in batch.items()})
    return drawn


def feed_sage_draws(model, draws):
    """Make ``model``'s draws those of ``draws``, in order, on its device."""
    queue = list(draws)
    for seam in SAGE_SEAMS:
        setattr(model, seam, lambda *args: queue.pop(0).to(model.device))
    return model


def w2v_first_batch(model):
    """The first batch of ``model``'s fit (its pairs, then the first
    epoch's permutation, from the fit's generator) and the (centers,
    contexts) pairs a fit trains on."""
    np_rng = np.random.default_rng(model.seed)
    centers, contexts = model._skipgram_pairs(model._corpus(), np_rng)
    take = np_rng.permutation(len(centers))[: model.batch_size]
    return ({"center": centers[take].astype(np.int64),
             "context": contexts[take].astype(np.int64)}, (centers, contexts))


def sage_w2v_path(name, data, rng, workdir):
    """One model of phase 10 at embed 64: (a) the first step's gradients and
    the parameters after one step, card against CPU from the same
    parameters, batch and draws (fed through the seams); (b) a profiled fit
    of PROFILE_STEPS steps, Item2Vec's two same-seed
    fits (bit-identical), then the fit on the card; (c) evaluate's AUC and
    NDCG (through the top-k) on the card and of the saved model on the CPU,
    AUC within 0.01; (d) recommend_user against the CPU-loaded model, and for
    the i2i and SGNS paths every user's exported embedding the mean of the
    consumed items'; (e) GraphSage u2i loaded on the GPU and served. The main
    path, the fit to (e), is counted. Returns the path's numbers."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops import table_gather as tg

    cls_name, kind, batch_size, epochs, extra = SAGE_W2V[name]
    train, evals, info = data[kind]
    cls = getattr(models, cls_name)
    w2v = cls_name in ("Item2Vec", "DeepWalk")
    seed = int(rng.integers(1 << 30))
    tag = f"[sage-w2v {name}]"
    t_path = time.perf_counter()
    part_s, t_part = {}, [t_path]

    def lap(part):
        now = time.perf_counter()
        part_s[part] = now - t_part[0]
        t_part[0] = now

    def make(device, **kw):
        rate = dict(learning_rate=PHASE10_LR) if w2v else dict(lr=PHASE10_LR)
        return cls("ranking", info, embed_size=64, batch_size=batch_size, seed=seed,
                   device=device, **rate, **{**extra, **kw})

    init = make("cpu")
    init.build_model()
    init = init.params_to_arrays()

    # (a) the first step, card against CPU, from the same batch and draws
    probe = make("cpu")
    if w2v:
        batch, pairs = w2v_first_batch(probe)
        rows_a_step, n_batches = batch_size, -(-len(pairs[0]) // batch_size)
        u = torch.from_numpy(rng.random((batch_size, probe.num_neg), dtype=np.float32))

        def fed(model):
            model._uniforms = lambda shape: u.to(model.device)
            return model
    else:
        batch = first_batch(probe, train, batch_size)
        rows_a_step = len(batch["weight"])
        n_batches = -(-len(train) // rows_a_step)
        probe.params_from_arrays(init)
        draws = record_sage_draws(probe, batch)

        def fed(model):
            return feed_sage_draws(model, draws)
    loss_g, grads_g = first_step_grads(fed(make("cuda")), train, init, batch)
    loss_c, grads_c = first_step_grads(fed(make("cpu")), train, init, batch)
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"{tag} (a) first loss {loss_g} on the GPU, {loss_c} on the CPU")
    worst, bad, total, rounding_only = hold_grads(grads_g, grads_c, f"{tag} (a)")

    def one_step(device):
        if w2v:   # the fit's Adam on the first step's gradients
            m = fed(make(device))
            grads = first_step_grads(m, train, init, batch)[1]
            opt = torch.optim.Adam(list(m.net.values()), lr=PHASE10_LR, eps=1e-8)
            for k, p in m.net.items():
                p.grad = torch.from_numpy(grads[k]).to(m.device)
            opt.step()
        else:     # the trainer's first step on first_batch's rows
            host = {} if extra.get("paradigm") == "i2i" else dict(sampler="unconsumed")
            m = fed(make(device, n_epochs=1, **host))
            m.params_from_arrays(init)
            m.fit(head_rows(train, rows_a_step), neg_sampling=True, verbose=0,
                  shuffle=False)
        return m.params_to_arrays()

    one = beyond(one_step("cuda"), one_step("cpu"))
    if one[1] > 0.005 * one[2] or one[0] > 2 * PHASE10_LR:
        fail(f"{tag} (a) after one step {one[1]} of {one[2]} entries differ beyond "
             f"rtol 1e-4, atol 1e-5 (max abs err {one[0]})")
    log(f"{tag} (a) first step, GPU against CPU: loss {loss_g:.7f} vs "
        f"{loss_c:.7f}; gradients: the difference's norm at most "
        f"{worst['norm'][0]:.3g} of the gradient's ({worst['norm'][1]}), an "
        f"entry off by at most {worst['entry'][0]:.3g} of the largest "
        f"({worst['entry'][1]}), {bad} of {total} entries beyond rtol 1e-4; "
        f"zero but for rounding: {rounding_only}; after one step max abs err "
        f"{one[0]:.3g}, {one[1]} of {one[2]} entries beyond rtol 1e-4, atol 1e-5")
    lap("a")

    # (b) a profiled fit of PROFILE_STEPS steps (an SGNS fit's of the first
    # pairs: it draws its own from the corpus, here given) and Item2Vec's
    # same-seed fits, before the main path and not counted in it
    probe = make("cuda", n_epochs=1)
    if w2v:
        head = tuple(a[: PROFILE_STEPS * batch_size] for a in pairs)
        probe._corpus = list
        probe._skipgram_pairs = lambda corpus, np_rng: head
    prof = epoch_profile(probe, head_rows(train, PROFILE_STEPS * rows_a_step),
                         PROFILE_STEPS)
    if name == "item2vec":
        twins = []
        for _ in range(2):
            m = make("cuda", n_epochs=1)
            m.fit(train, neg_sampling=True, verbose=0)
            twins.append(m.params_to_arrays())
        for k in twins[0]:
            if not np.array_equal(twins[0][k], twins[1][k]):
                fail(f"{tag} (b) two same-seed fits differ in {k}")
        log(f"{tag} (b) two same-seed fits on the card are bit-identical")

    # the main path on the card: its kernels counted from here to (e)
    st.reset_launches()
    tg.reset_launches()
    model = make(None, n_epochs=epochs)
    t = time.perf_counter()
    model.fit(train, neg_sampling=True, verbose=0)
    fit_s = time.perf_counter() - t
    torch.cuda.synchronize()
    fit_launches = dict(topk=st.launches, gather=tg.gather_launches,
                        segsum=tg.segsum_launches)
    bad = [k for k, v in model.params_to_arrays().items() if not np.isfinite(v).all()]
    if bad or not np.isfinite(model.trainer.epoch_losses).all():
        fail(f"{tag} (b) non-finite parameters {bad} or losses "
             f"{model.trainer.epoch_losses}")
    step_ms = 1e3 * model.trainer.epoch_times[-1] / n_batches
    lap("b")

    # (c) evaluate on the card and, saved, on the CPU; (d) recommend_user
    auc_g, auc_c, back, users, recs, near = saved_model_checks(
        model, cls, name, evals, info, rng, workdir, seed, tag,
        metrics=("roc_auc", "ndcg"))
    if w2v or model.graph_paradigm == "i2i":
        items = model.item_embeds_np
        for uid, consumed in info.user_consumed.items():
            want = items[np.asarray(consumed)].mean(axis=0)
            if not np.allclose(model.user_embeds_np[uid], want, rtol=1e-5, atol=1e-6):
                fail(f"{tag} (d) user {uid}: not the mean of the consumed items")
        log(f"{tag} (d) every user's embedding is the mean of the consumed items'")
    lap("c, d")

    # (e) GraphSage u2i: the saved model served from the GPU
    served_ms = None
    if name == "graphsage_u2i":
        served, served_ms = serve_once(workdir, name, users[0])
        want = [int(i) for i in back.recommend_user(users[0], 10)[users[0]]]
        near += check_recs(served, want, back, users[0], f"{tag} (e) served")
        log(f"{tag} (e) one served request ({served_ms:.1f} ms with loading)")
        lap("e")
    torch.cuda.synchronize()
    launches = dict(topk=st.launches, gather=tg.gather_launches,
                    segsum=tg.segsum_launches)
    if min(launches.values()) == 0 or min(fit_launches.values()) == 0:
        fail(f"{tag} the main path did not launch every kernel: {launches} "
             f"({fit_launches} by the end of the fit)")
    summary = dict(
        examples_per_s=(n_batches * rows_a_step if w2v else len(train))
        / model.trainer.epoch_times[-1],
        step_ms=step_ms, **prof,
        idle_share=1.0 - prof["device_ms_per_step"] / step_ms if step_ms > 0 else None,
        steps_per_epoch=n_batches, rows_a_step=rows_a_step, launches=launches,
        fit_launches=fit_launches, fit_s=fit_s, losses=model.trainer.epoch_losses,
        auc_gpu=auc_g, auc_cpu=auc_c, near_tie_swaps=near, served_ms=served_ms,
        path_s=time.perf_counter() - t_path, part_s=part_s)
    log(f"{tag} {json.dumps(summary)}")
    return summary


def phase_sage_w2v(rng, workdir, columns):
    """GraphSage (cross-entropy) and PinSage (max_margin) u2i on phase 5's
    feature data, GraphSage i2i (bpr), Item2Vec and DeepWalk on phase 4's
    pure data, at embed 64, lr 0.001. Returns each path's numbers and prints
    phase 10's summary."""
    from librecommender_tpu_torch.data import DatasetFeat

    t0 = time.perf_counter()
    train_cols, test_cols = columns
    feat_train, feat_info = DatasetFeat.build_trainset(train_cols, **FEAT_COLS)
    data = {"feat": (feat_train, DatasetFeat.build_evalset(test_cols), feat_info),
            "pure": training_data(columns)}
    log(f"[sage-w2v] {len(feat_train)} train rows; built in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {name: sage_w2v_path(name, data, rng, workdir) for name in SAGE_W2V}
    keys = ("rows_a_step", "steps_per_epoch", "kernel_launches_per_step", "step_ms",
            "device_ms_per_step", "kernel_ms_per_step", "idle_share",
            "examples_per_s", "auc_gpu", "auc_cpu", "launches", "fit_launches",
            "top_device_ops_ms_per_step", "path_s")
    row = {name: {k: p[k] for k in keys} for name, p in paths.items()}
    log(json.dumps({"phase10_sage_w2v": row, "phase10_s": time.perf_counter() - t0}))
    return paths


# ------------------------------------------------------------------ phase 11
CF_FAMILY = {"UserCF": dict(k_sim=20), "ItemCF": dict(k_sim=20),
             "Swing": dict(top_k=20, alpha=1.0)}
CF_NEAR_TIE = 1e-5


def exact_sims_card(entity, kind):
    """Float64 similarities of every row pair of a CSR, on the card (the
    C++'s preprocessing and products in float64)."""
    x = entity.tocsr()
    lengths = np.diff(x.indptr)
    rows = torch.as_tensor(np.repeat(np.arange(x.shape[0]), lengths), device="cuda")
    cols = torch.as_tensor(x.indices.astype(np.int64), device="cuda")
    vals = torch.as_tensor(x.data.astype(np.float64), device="cuda")
    dense = torch.zeros(x.shape, dtype=torch.float64, device="cuda")
    if kind == "jaccard":
        dense[rows, cols] = 1.0
        common = dense @ dense.T
        nnz = dense.sum(1)
        return common / (nnz[:, None] + nnz[None, :] - common).clamp(min=1e-300)
    if kind == "pearson":
        means = torch.zeros(x.shape[0], dtype=torch.float64, device="cuda")
        means.index_add_(0, rows, vals)
        means /= torch.as_tensor(np.maximum(lengths, 1), device="cuda")
        vals = vals - means[rows]
    dense[rows, cols] = vals
    dense /= dense.norm(dim=1, keepdim=True).clamp(min=1e-10)
    return dense @ dense.T


def near_tie_ids(got, want, exact, what):
    """Ids equal except where both are ids whose exact scores in the row lie
    within CF_NEAR_TIE relative; returns the number of near-tie swaps."""
    rows, slots = np.nonzero(got != want)
    if not rows.size:
        return 0
    a, b = got[rows, slots], want[rows, slots]
    if (a < 0).any() or (b < 0).any():
        fail(f"{what}: a neighbour list is shorter on one side")
    r = torch.as_tensor(rows, device=exact.device)
    sa = exact[r, torch.as_tensor(a, device=exact.device).long()].cpu().numpy()
    sb = exact[r, torch.as_tensor(b, device=exact.device).long()].cpu().numpy()
    if not np.all(np.abs(sa - sb) <= CF_NEAR_TIE * np.maximum(np.abs(sb), 1e-12)):
        fail(f"{what}: {rows.size} ids differ and are not near-ties")
    return int(rows.size)


def check_sims(card, cpu, exact, what):
    """(a)'s rule: ids by the near-tie rule, values rtol 1e-5."""
    near = near_tie_ids(card[0], cpu[0], exact, what)
    if not np.allclose(card[1], cpu[1], rtol=RTOL, atol=1e-6):
        fail(f"{what}: similarities differ beyond rtol {RTOL} (max abs err "
             f"{float(np.abs(card[1] - cpu[1]).max())})")
    return near


def sims_device_ms(entity, kind, k):
    """The similarity search's device ms on the card (its products, masks and
    sort), and its flop bound: the (n x d) @ (d x n) products, the common
    counts' in float32 at the CUDA-core peak and the values' (not jaccard's)
    in float64 at the same 67 TFLOP/s (the FP64 tensor-core peak)."""
    from librecommender_tpu_torch.utils.similarities import topk_similarities

    n, d = entity.shape
    ms = device_total_ms(lambda: topk_similarities(entity, kind, k, device="cuda"),
                         runs=2)
    products = 1 if kind == "jaccard" else 2
    return ms, products * 2.0 * n * n * d / H100_F32_FLOPS * 1e3


def swing_adds(lists, n_items):
    """The adds the pair pass makes on these lists: the sum over user pairs
    u < v sharing c >= 2 items of c (c - 1), counted with one float64
    product of the 0/1 interaction matrix on the lists' device."""
    user_indptr, user_items, _, _ = lists
    device = user_items.device
    n_users = user_indptr.shape[0] - 1
    users = torch.repeat_interleave(torch.arange(n_users, device=device),
                                    user_indptr[1:] - user_indptr[:-1])
    x = torch.zeros(n_users, n_items, dtype=torch.float64, device=device)
    x[users, user_items.long()] = 1.0
    c = torch.triu(x @ x.T, diagonal=1)
    return float((c * (c - 1) * (c >= 2)).sum())


def swing_bound_ms(lists, n_items):
    """Least time of the pair pass on an H100 SXM: its adds (sum over user
    pairs of c (c - 1)) at the CUDA-core peak against the bytes (the four
    lists read once, the (n_items, n_items) 8-byte sums written once) at the
    HBM rate. Returns (ms, bound_by, adds)."""
    adds = swing_adds(lists, n_items)
    nbytes = sum(t.numel() * t.element_size() for t in lists) + 8.0 * n_items ** 2
    t_ops, t_bytes = adds / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", adds
    return t_bytes * 1e3, "bytes", adds


def cf_fit(name, info, train, device):
    from librecommender_tpu_torch import models

    model = getattr(models, name)("ranking", info, device=device, **CF_FAMILY[name])
    t = time.perf_counter()
    model.fit(train, neg_sampling=True, verbose=0)
    if device == "cuda":
        torch.cuda.synchronize()
    return model, time.perf_counter() - t


def cf_quality(name, card, cpu_fit, evals, info, rng, seed):
    """(c): evaluate's AUC and NDCG on the card and on the CPU within 0.01;
    recommend_user's ids and predict (rtol 1e-6) against the model on the
    CPU holding the card's lists."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.evaluation import evaluate

    metrics = ["roc_auc", "ndcg"]
    got = evaluate(card, evals, neg_sampling=True, metrics=metrics,
                   sample_user_num=1000, seed=seed)
    want = evaluate(cpu_fit, evals, neg_sampling=True, metrics=metrics,
                    sample_user_num=1000, seed=seed)
    for m in metrics:
        if not (np.isfinite(got[m]) and abs(got[m] - want[m]) <= 0.01):
            fail(f"[cf {name}] (c) {m} {got[m]} on the card, {want[m]} on the CPU")
    if got["roc_auc"] <= 0.5:
        fail(f"[cf {name}] (c) AUC {got['roc_auc']}: no better than chance")
    same = getattr(models, name)("ranking", info, device="cpu", **CF_FAMILY[name])
    same.set_cf_state(card.sim_ids, card.sim_vals, card.interaction)
    same.post_fit()
    users = [int(info.id2user[int(i)]) for i in rng.choice(info.n_users, 300,
                                                             replace=False)]
    users.append(10**9)   # a cold user
    recs, back = card.recommend_user(users, 10), same.recommend_user(users, 10)
    for u in users:
        if len(recs[u]) != 10 or not np.array_equal(recs[u], back[u]):
            fail(f"[cf {name}] (c) user {u}: {list(recs[u])} on the card, "
                 f"{list(back[u])} on the CPU")
    pu = rng.choice(info.n_users, 20_000)
    pi = rng.choice(info.n_items, 20_000)
    p_card = card.predict(pu, pi, inner_id=True)
    p_cpu = same.predict(pu, pi, inner_id=True)
    if not np.allclose(p_card, p_cpu, rtol=1e-6, atol=0.0):
        fail(f"[cf {name}] (c) predict differs beyond rtol 1e-6 (max abs err "
             f"{float(np.abs(p_card - p_cpu).max())})")
    return {"auc_gpu": got["roc_auc"], "auc_cpu": want["roc_auc"],
            "ndcg_gpu": got["ndcg"], "ndcg_cpu": want["ndcg"]}


def retrain_split(columns):
    """Phase 4's train columns cut in two periods: the first the rows of the
    users up to 5800 on the items up to 3600 (raw ids); the second the rows
    of the users above 5800 and a third of the rows of 300 old users, so
    that most old users stay untouched. The other old users' rows on the
    items above 3600 are in neither."""
    train = {k: columns[0][k] for k in ("user", "item", "label")}
    user, item = train["user"], train["item"]
    new_user = user > 5800
    r = np.random.default_rng(11)
    picked = np.isin(user, r.choice(np.unique(user[~new_user]), 300, replace=False))
    first = ~new_user & (item <= 3600)
    second = new_user | (picked & (r.random(len(user)) < 1 / 3))
    return ({k: v[first] for k, v in train.items()},
            {k: v[second] for k, v in train.items()})


def retrain_embed(name, first, second, workdir):
    """(d) for BPR (lazy Adam) and SVD (Adam): fit, save, merge_trainset,
    rebuild_model; old rows and moment rows grafted exactly; then a fit on
    the second period; and a checkpoint restored bit for bit."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.data import DatasetPure

    cls = getattr(models, name)
    kw = dict(embed_size=64, n_epochs=1, batch_size=8192, lr=0.001)
    train, info = DatasetPure.build_trainset(first)
    model = cls("ranking", info, **kw)
    ckpt = Path(workdir) / f"ckpt_{name}"
    model.fit(train, neg_sampling=True, verbose=0, checkpoint_dir=ckpt)
    model.save(workdir, f"retrain_{name}")
    old_params, old_leaves = model.params_to_arrays(), model.trainer.opt_state_leaves()
    new_train, new_info = DatasetPure.merge_trainset(second, info)
    if not (new_info.n_users > info.n_users and new_info.n_items > info.n_items):
        fail(f"[retrain {name}] merge_trainset added no users or items")
    model2 = cls("ranking", new_info, **{**kw, "n_epochs": 0})
    model2.rebuild_model(workdir, f"retrain_{name}")
    model2.fit(new_train, neg_sampling=True, verbose=0)   # grafts the moments
    grafted = model2.params_to_arrays()
    leaves = model2.trainer.opt_state_leaves()
    rows = {"user_embed": info.n_users, "item_embed": info.n_items,
            "user_bias": info.n_users, "item_bias": info.n_items}
    checked = 0
    for (key, _), old, new in zip(model2.trainer.opt_state.layout, old_leaves, leaves):
        if key is None:
            if not np.array_equal(old, new):
                fail(f"[retrain {name}] a step count changed in the graft")
            continue
        n = rows[key.rsplit("/", 1)[-1]]
        if not np.array_equal(old[:n], new[:n]):
            fail(f"[retrain {name}] moment rows of {key} not grafted exactly")
        checked += 1
    for key, n in rows.items():
        if key in old_params and not np.array_equal(old_params[key][:n],
                                                    grafted[key][:n]):
            fail(f"[retrain {name}] rows of {key} not grafted exactly")
    model2.n_epochs = 1
    t = time.perf_counter()
    model2.fit(new_train, neg_sampling=True, verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    if not np.isfinite(model2.trainer.epoch_losses).all():
        fail(f"[retrain {name}] non-finite loss after the rebuild")
    resumed = cls("ranking", info, **{**kw, "n_epochs": 0})
    if resumed.load_checkpoint(ckpt) != 1:
        fail(f"[retrain {name}] checkpoint epoch")
    resumed.fit(train, neg_sampling=True, verbose=0)
    for key, v in resumed.params_to_arrays().items():
        if not np.array_equal(v, old_params[key]):
            fail(f"[retrain {name}] checkpoint parameter {key} not restored")
    for i, (a, b) in enumerate(zip(resumed.trainer.opt_state_leaves(), old_leaves)):
        if not np.array_equal(a, b):
            fail(f"[retrain {name}] checkpoint optimizer leaf {i} not restored")
    log(f"[retrain {name}] rows and {checked} moment leaves grafted exactly, "
        f"checkpoint restored bit for bit, refit {fit_s:.2f} s")
    return {"moment_leaves_grafted": checked, "refit_s": fit_s}


def untouched_lists(old_ids, old_vals, touched, exact, merged, n_rows):
    """The lists the C++ contract gives the untouched old rows after an
    update, worked out apart from the port: each row's old entries that name
    no touched row, merged with the touched rows that share an item with it
    and whose similarity (``exact``, float64) beats the old list's last
    where that list is full and names no touched row, by similarity then
    lower id, all as float32 (the lists' type). Returns (rows, ids, values,
    rows the contract copies through whatever the float32 rounding)."""
    k = old_ids.shape[1]
    rows = np.setdiff1d(np.arange(old_ids.shape[0]), touched)
    oi, ov = old_ids[rows], old_vals[rows]
    is_touched = np.zeros(n_rows, bool)
    is_touched[touched] = True
    listed = np.cumprod(oi >= 0, axis=1).astype(bool)
    stale = listed & is_touched[np.maximum(oi, 0)]
    refers = stale.any(axis=1)
    least = np.where((listed.sum(axis=1) == k) & ~refers, ov[:, -1], -np.inf)
    ex = exact[torch.as_tensor(rows, device=exact.device)][
        :, torch.as_tensor(touched, device=exact.device)].cpu().numpy()
    b = merged.tocsr().copy()
    b.data[:] = 1.0
    shares = (b[rows] @ b[touched].T).toarray() >= 1
    ex32 = ex.astype(np.float32)
    enter = shares & (ex32 > least[:, None])
    kept = listed & ~stale
    vals = np.concatenate([np.where(kept, ov, -np.inf), np.where(enter, ex32, -np.inf)], 1)
    ids = np.concatenate([np.where(kept, oi, -1), np.broadcast_to(touched, ex.shape)], 1)
    order = np.lexsort((ids, -vals), axis=1)[:, :k]
    want_vals = np.take_along_axis(vals, order, 1)
    valid = np.isfinite(want_vals)
    want_ids = np.where(valid, np.take_along_axis(ids, order, 1), -1)
    margin = CF_NEAR_TIE * np.abs(least) + 1e-7
    copied = ~refers & ~(shares & (ex > (least - margin)[:, None])).any(axis=1)
    return rows, want_ids, np.where(valid, want_vals, 0.0), copied


def retrain_user_cf(first, second, workdir):
    """(d) for UserCF: the incremental update after merge_trainset, held to
    the C++ contract: touched rows as a fresh search on the merged data,
    untouched rows as :func:`untouched_lists` (ids by the near-tie rule,
    values rtol 1e-5) and bit for bit their old lists where the contract
    copies them through, every listed value the pair's similarity on the
    merged data (rtol 1e-5)."""
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.data import DatasetPure
    from librecommender_tpu_torch.utils.similarities import topk_similarities

    train, info = DatasetPure.build_trainset(first)
    model, _ = cf_fit("UserCF", info, train, "cuda")
    model.save(workdir, "retrain_ucf")
    new_train, new_info = DatasetPure.merge_trainset(second, info)
    inc = models.UserCF("ranking", new_info, **CF_FAMILY["UserCF"])
    inc.rebuild_model(workdir, "retrain_ucf")
    t = time.perf_counter()
    inc.fit(new_train, neg_sampling=True, verbose=0)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t
    fresh = topk_similarities(inc.interaction, "cosine", 20, device="cuda")
    exact = exact_sims_card(inc.interaction, "cosine")
    touched = np.unique(new_train.user_indices)
    near = near_tie_ids(inc.sim_ids[touched], fresh[0][touched], exact[
        torch.as_tensor(touched, device="cuda")], "[retrain ucf] touched rows")
    if not np.allclose(inc.sim_vals[touched], fresh[1][touched], rtol=RTOL, atol=1e-6):
        fail("[retrain ucf] touched rows' similarities differ from a fresh search")
    rows, want_ids, want_vals, copied = untouched_lists(
        model.sim_ids, model.sim_vals, touched, exact, inc.interaction, new_info.n_users)
    near_old = near_tie_ids(inc.sim_ids[rows], want_ids, exact[
        torch.as_tensor(rows, device="cuda")], "[retrain ucf] untouched rows")
    if not np.allclose(inc.sim_vals[rows], want_vals, rtol=RTOL, atol=1e-6):
        fail("[retrain ucf] untouched rows' similarities differ from the contract's")
    same = rows[copied]
    if not (np.array_equal(inc.sim_ids[same], model.sim_ids[same])
            and np.array_equal(inc.sim_vals[same], model.sim_vals[same])):
        fail("[retrain ucf] a row the contract copies through changed")
    r, j = np.nonzero(inc.sim_ids >= 0)
    want = exact[torch.as_tensor(r, device="cuda"),
                 torch.as_tensor(inc.sim_ids[r, j], device="cuda").long()].cpu().numpy()
    if not np.allclose(inc.sim_vals[r, j], want, rtol=RTOL, atol=1e-6):
        fail("[retrain ucf] a listed similarity is not the merged data's")
    recs = inc.recommend_user([int(new_info.id2user[new_info.n_users - 1])], 10)
    if len(next(iter(recs.values()))) != 10:
        fail("[retrain ucf] a new user got fewer than 10 recommendations")
    log(f"[retrain ucf] {len(touched)} touched rows of {new_info.n_users}: update "
        f"{update_s:.2f} s, touched rows as a fresh search ({near} near-tie swaps), "
        f"{len(rows)} untouched rows as the contract's ({near_old} near-tie swaps), "
        f"{len(same)} of them copied through bit for bit, every listed value the "
        "merged data's")
    return {"touched_rows": int(len(touched)), "untouched_rows": int(len(rows)),
            "copied_through": int(len(same)), "update_s": update_s,
            "near_ties": near, "untouched_near_ties": near_old}


def phase_cf_retrain(rng, workdir, columns):
    """UserCF, ItemCF (cosine, k_sim 20) and Swing (top_k 20, alpha 1) on
    phase 4's data: (a) similarities on the card against the CPU (and a
    pearson and a jaccard search), two card fits bit-identical; (b) Swing's
    full-size fit timed, two fits bit-identical, its pair-pass kernels
    against their plain version on the fit's lists; (c) evaluate, recommend_user
    and predict on the card against the CPU; (d) retrain on the card: BPR,
    SVD and UserCF saved, merged, rebuilt and refitted, a checkpoint
    resumed. Returns phase 11's numbers; Swing's are the kernel line's."""
    from librecommender_tpu_torch.models import Swing
    from librecommender_tpu_torch.ops import swing
    from librecommender_tpu_torch.utils.similarities import topk_similarities

    t0 = time.perf_counter()

    def stamp():
        return f"[{time.perf_counter() - t0:6.1f} s]"

    train, evals, info = training_data(columns)
    out, models_card, models_cpu = {}, {}, {}
    # (a) similarities
    for name in ("UserCF", "ItemCF"):
        card, fit_s = cf_fit(name, info, train, "cuda")
        again, _ = cf_fit(name, info, train, "cuda")
        if not (np.array_equal(card.sim_ids, again.sim_ids)
                and np.array_equal(card.sim_vals, again.sim_vals)):
            fail(f"[cf {name}] (a) two card fits differ")
        cpu, cpu_s = cf_fit(name, info, train, "cpu")
        entity = card._entity()
        near = check_sims((card.sim_ids, card.sim_vals), (cpu.sim_ids, cpu.sim_vals),
                          exact_sims_card(entity, "cosine"), f"[cf {name}] (a)")
        ms, bound = sims_device_ms(entity, "cosine", 20)
        models_card[name], models_cpu[name] = card, cpu
        out[name] = {"fit_s": fit_s, "cpu_fit_s": cpu_s, "near_ties": near,
                     "sims_device_ms": ms, "sims_bound_ms": bound,
                     "entity_shape": list(entity.shape)}
        log(f"{stamp()} [cf {name}] (a) card fit {fit_s:.3f} s (CPU {cpu_s:.2f} s), "
            f"{near} near-tie swaps, search {ms} device ms against a float32 "
            f"bound of {bound:.3f} ms; two card fits bit-identical")
    items = models_card["ItemCF"]._entity()
    for kind in ("pearson", "jaccard"):
        card = topk_similarities(items, kind, 20, device="cuda")
        if not all(np.array_equal(a, b) for a, b in zip(
                card, topk_similarities(items, kind, 20, device="cuda"))):
            fail(f"[cf {kind}] (a) two card searches differ")
        cpu = topk_similarities(items, kind, 20, device="cpu")
        near = check_sims(card, cpu, exact_sims_card(items, kind), f"[cf {kind}] (a)")
        ms, bound = sims_device_ms(items, kind, 20)
        out[f"items_{kind}"] = {"near_ties": near, "sims_device_ms": ms,
                                "sims_bound_ms": bound}
        log(f"{stamp()} [cf {kind}] (a) item search on the card as on the CPU ({near} "
            f"near-tie swaps), {ms} device ms against {bound:.3f} ms")
    # (b) Swing: the main path, Swing's fit at full size, its launches counted
    swing.reset_launches()
    card, fit_s = cf_fit("Swing", info, train, "cuda")
    launches, by_kernel = swing.launches, dict(swing.kernel_launches)
    fit_pass = dict(swing.last_pass)
    missing = [name for name, n in by_kernel.items() if n < 1]
    if missing:
        fail(f"[cf Swing] (b) the fit launched no {', '.join(missing)} kernel")
    log(f"{stamp()} [cf Swing] (b) the fit's pass: {fit_pass['pairs']} pairs, "
        f"{fit_pass['entries']} list entries, {fit_pass['scratch_bytes']} scratch "
        f"bytes, {fit_pass['chunks']} user chunks, {fit_pass['tasks']} row tasks "
        f"({fit_pass['hot_rows']} hot rows in {fit_pass['hot_slices']} slices); "
        f"launches a fit {json.dumps(by_kernel)}")
    again, _ = cf_fit("Swing", info, train, "cuda")
    if not (np.array_equal(card.sim_ids, again.sim_ids)
            and np.array_equal(card.sim_vals, again.sim_vals)):
        fail("[cf Swing] (b) two card fits differ")
    # the kernels against their plain version on the fit's own lists (every
    # user: more users than the walks' grid has blocks), and the fit's lists
    # against the plain scores' top-k
    lists = swing.interaction_lists(card.interaction, "cuda")
    got = swing.swing_pairs(lists, info.n_items, 1.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = swing.swing_pairs_plain(lists, info.n_items, 1.0, (0, info.n_items))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=RTOL, atol=0.0):
        fail(f"[cf Swing] (b) kernel scores differ from the plain version's "
             f"(max abs err {err})")
    p_ids, p_vals = (a.cpu().numpy() for a in swing.topk_of_scores(want, 20))
    near = near_tie_ids(card.sim_ids, p_ids, want, "[cf Swing] (b) fit's ids")
    if not np.allclose(card.sim_vals, p_vals, rtol=RTOL, atol=0.0):
        fail("[cf Swing] (b) the fit's scores differ from the plain scores' top-k "
             f"(max abs err {float(np.abs(card.sim_vals - p_vals).max())})")
    del got, want
    ms = time_ms(lambda: swing.swing_pairs(lists, info.n_items, 1.0), runs=3, warmup=1)
    swing.reset_launches()
    swing.swing_pairs(lists, info.n_items, 1.0)
    per_call = {f"swing_{name}": n for name, n in swing.kernel_launches.items() if n}
    dev_ms, dev, seen = device_ms(lambda: swing.swing_pairs(lists, info.n_items, 1.0),
                                  per_call, runs=3)
    bound, bound_by, adds = swing_bound_ms(lists, info.n_items)
    # the CPU's Swing holds the card's lists: the plain pass above holds them
    # to the plain scores
    models_card["Swing"] = card
    cpu = Swing("ranking", info, device="cpu", **CF_FAMILY["Swing"])
    cpu.set_cf_state(card.sim_ids, card.sim_vals, card.interaction)
    cpu.post_fit()
    models_cpu["Swing"] = cpu
    out["Swing"] = {"fit_s": fit_s, "launches": launches}
    kernel = dict(launches=launches, launches_by_kernel=by_kernel, max_abs_err=err,
                  ms=ms, device_ms=dev_ms, device_split=dev, launches_seen=seen,
                  plain_ms=plain_ms, bound_ms=bound,
                  bound_by=bound_by, library_ms=None, adds=adds, near_ties=near,
                  fit_s=fit_s, fit_pass=fit_pass,
                  shape=f"{info.n_users} users x {info.n_items} items, "
                        f"{len(train)} rows")
    log(f"{stamp()} [cf Swing] (b) full fit {fit_s:.3f} s; kernels as plain on every "
        f"user (max abs err {err:.3g}), fit's lists as the plain top-k ({near} "
        f"near-tie swaps); pass {ms:.2f} ms ({dev_ms} device, {dev}), plain "
        f"{plain_ms:.1f} ms (one run), for {adds:.4g} adds, bound {bound:.3f} ms "
        f"({bound_by}); two card fits bit-identical")
    # (c) quality against the CPU
    for name in ("UserCF", "ItemCF", "Swing"):
        out[name].update(cf_quality(name, models_card[name], models_cpu[name],
                                    evals, info, rng, seed=3))
        log(f"{stamp()} [cf {name}] (c) {json.dumps(out[name])}")
    # (d) retrain on the card
    first, second = retrain_split(columns)
    retrain = {name: retrain_embed(name, first, second, workdir)
               for name in ("BPR", "SVD")}
    retrain["UserCF"] = retrain_user_cf(first, second, workdir)
    summary = {"phase11_cf_retrain": {"cf": out, "swing_pairs": kernel,
                                      "retrain": retrain},
               "phase11_s": time.perf_counter() - t0}
    log(json.dumps(summary))
    return kernel, models_card


# ------------------------------------------- phase 12: ANN and knn retrieval
ANN_N_REC = 10
CATALOG_K = 32
KNN_QUERIES = 64        # users and items whose knn lists are compared
SEARCH_CHECK_USERS = 2048
RECALL_USERS = 1024     # users whose exact top-10 the IVF lists are held to
JAX_HNSW_OVERLAP = 7    # tests/test_hnsw.py:98,114: >= 7 of 10 shared
JAX_KNN_SYMDIFF = 1     # tests/test_knn_embed_reference.py:35-36


def kernel_counts():
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops import table_gather as tg

    return {"topk": st.launches, "gather": tg.gather_launches,
            "segsum": tg.segsum_launches}


def drive(fn):
    """Run one main-path call with every kernel count set to 0 just before
    it; returns (its result, each kernel's launches in it)."""
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops import table_gather as tg

    st.reset_launches()
    tg.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kernel_counts()


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def lloyd_step_check(items, centroids, what):
    """One Lloyd step on the card against the same step on the CPU from the
    same centroids: assignments equal but where the two clusters' float64
    cosines lie within RTOL relative; the cluster sums of the card's
    assignment within rtol RTOL or, near zero, 2**-22 times the sum of
    their terms' magnitudes (each device normalizes the rows itself).
    Returns (rows assigned apart, max abs err of the sums)."""
    from librecommender_tpu_torch.ops.table_gather import segment_sum_plain
    from librecommender_tpu_torch.retrieval import ivf

    n_clusters = centroids.shape[0]
    normed = ivf.normalize_rows(items)
    assign = ivf.assign_clusters(normed, centroids)
    _, sums, counts = ivf.update_centroids(normed, centroids, assign)
    normed_c, cent_c = ivf.normalize_rows(items.cpu()), centroids.cpu()
    assign_c = ivf.assign_clusters(normed_c, cent_c)
    a = assign.cpu()
    rows = torch.nonzero(a != assign_c)[:, 0]
    if rows.numel():
        cos = normed_c[rows].double() @ cent_c.double().T
        r = torch.arange(rows.numel())
        ca, cb = cos[r, a[rows]], cos[r, assign_c[rows]]
        if not bool(((ca - cb).abs() <= RTOL * torch.maximum(ca.abs(), cb.abs())).all()):
            fail(f"{what}: {rows.numel()} rows assigned apart on the card and the "
                 "CPU, not all near-ties")
    _, sums_c, counts_c = ivf.update_centroids(normed_c, cent_c, a)
    if not torch.equal(counts.cpu(), counts_c):
        fail(f"{what}: cluster counts differ")
    got, want = sums.cpu().numpy(), sums_c.numpy()
    terms = segment_sum_plain(a, normed_c.abs(), n_clusters).numpy()
    diff = np.abs(got - want)
    if not np.all(diff <= np.maximum(RTOL * np.abs(want), 2.0**-22 * terms)):
        fail(f"{what}: cluster sums differ beyond rtol {RTOL} (max abs err "
             f"{float(diff.max())})")
    return int(rows.numel()), float(diff.max())


def search_check(card, cpu, queries, k, n_probe, what):
    """The card's IVF search against the CPU's over the same index: padding
    equal, ids equal but where the two ids' float64 scores lie within RTOL
    relative, scores within ``score_tol``. Returns (near-tie swaps, max abs
    err)."""
    ids, sc = card.search(queries, k, n_probe)
    ids_c, sc_c = cpu.search(queries.cpu(), k, n_probe)
    q, items = queries.cpu(), cpu.item_embeds
    if not np.array_equal(ids < 0, ids_c < 0):
        fail(f"{what}: the padded slots differ between the card and the CPU")
    rows, slots = np.nonzero(ids != ids_c)
    if rows.size:
        ea, _ = score_tol(q, items, rows, ids[rows, slots])
        eb, _ = score_tol(q, items, rows, ids_c[rows, slots])
        if not np.all(np.abs(ea - eb) <= RTOL * np.maximum(np.abs(ea), np.abs(eb))):
            fail(f"{what}: {rows.size} ids differ and are not near-ties")
    same = (ids == ids_c) & (ids >= 0)
    rows_s, slots_s = np.nonzero(same)
    _, tol = score_tol(q, items, rows_s, ids[rows_s, slots_s])
    diff = np.abs(sc[same] - sc_c[same])
    if not np.all(diff <= tol):
        fail(f"{what}: scores differ beyond rtol {RTOL} and the f32 rounding bound")
    return int(rows.size), float(diff.max()) if diff.size else 0.0


def ann_fill_check(model, recs, users, fetch, what):
    """Every user's list is the index's unconsumed candidates in order, then,
    where fewer than n_rec remain, the popular fill (which does not filter
    consumed items, as in the JAX package): so no consumed item comes back
    but through the fill. Returns how many users reached the fill."""
    from librecommender_tpu_torch.recommendation.cold_start import popular_recommendations

    info = model.data_info
    uids = np.array([info.user2id[u] for u in users])
    ids, _ = model.ann.search(model.user_embeds[torch.as_tensor(uids, device="cuda")],
                              fetch, **model._ann_search_kw)
    filled = 0
    for r, (user, uid) in enumerate(zip(users, uids)):
        consumed = set(info.user_consumed[int(uid)])
        picked = [int(i) for i in ids[r] if i >= 0 and i not in consumed][:ANN_N_REC]
        got = [info.item2id[int(i)] for i in recs[user]]
        if got[: len(picked)] != picked:
            fail(f"{what}: user {user}'s list is not the index's unconsumed candidates")
        if len(picked) < ANN_N_REC:
            filled += 1
            pops = popular_recommendations(info, inner_id=True,
                                           n_rec=ANN_N_REC + len(picked))
            if not set(got[len(picked):]) <= {int(p) for p in pops}:
                fail(f"{what}: user {user}'s fill is not the popular items")
        elif set(got) & consumed:
            fail(f"{what}: user {user} got a consumed item outside the fill")
    return filled


def mean_overlap(got, want, users, k):
    return float(np.mean([len({int(i) for i in got[u]} & {int(i) for i in want[u]}) / k
                          for u in users]))


def ivf_kernel_rows(rng, index, queries, what):
    """2.1 at the probe's shape, 2.2a at the candidates' (the first user
    chunk of a search), 2.2b at the cluster sums', each against its plain
    version and timed (``measure_kernel``, ``measure_table_kernels``)."""
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.retrieval import ivf

    n, D = index.item_embeds.shape
    C, L = index.lists.shape
    rows = {"streaming_topk": measure_kernel(st, queries, index.centroids, 8,
                                             f"ivf probe, {what}")}
    step = max(1, ivf.SEARCH_CHUNK_BYTES // (8 * L * D * 4))
    top_c, _ = st.streaming_topk(queries[:step], index.centroids, 8)
    members = index.lists[top_c.long()].reshape(-1)
    rows.update(measure_table_kernels(
        rng, n, D, members.numel(), f"ivf candidates, {what}",
        data=(members, index.item_embeds, None), kernels=("table_gather",)))
    normed = ivf.normalize_rows(index.item_embeds)
    assign = ivf.assign_clusters(normed, index.centroids)
    rows.update(measure_table_kernels(
        rng, C, D, n, f"ivf cluster sums, {what}", data=(assign, None, normed),
        kernels=("segment_sum",)))
    return rows


def phase_ann_knn(rng, workdir, model, catalog):
    """(a) phase 2's BPR (embed 64) on its ML-1M-like data:
    ``init_ann("ivf")`` at its defaults and ``recommend_user`` for every
    user; (b) phase 3's catalog model: the IVF index over 1,000,000 items
    and a search of 256 users at k = 32; (c) on (a)'s model, the HNSW index
    and the knn searches, approximate and exact under both similarities.
    Returns phase 12's numbers: each kernel's launches on its main paths
    and its rows at the IVF shapes."""
    from librecommender_tpu_torch.models import BPR
    from librecommender_tpu_torch.ops import _build
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.retrieval import IVFIndex
    from librecommender_tpu_torch.retrieval import hnsw as hnsw_mod
    from librecommender_tpu_torch.retrieval import ivf

    t0 = time.perf_counter()

    def stamp():
        return f"[{time.perf_counter() - t0:6.1f} s]"

    workdir = Path(workdir)
    launches, summary, shapes = {}, {}, {}

    # (a) the IVF index on BPR at ML-1M width
    info = model.data_info
    users = [int(info.id2user[u]) for u in range(info.n_users)]
    # the exact top-10 of the first RECALL_USERS users, in calls of 256: the
    # consumed filter's host mask is users x fetch x widest consumed list
    exact = {}
    for lo in range(0, RECALL_USERS, 256):
        exact.update(model.recommend_user(users[lo:lo + 256], ANN_N_REC))
    log(f"{stamp()} [ann ivf] {info!r}, BPR embed 64 and the exact top-10 of "
        f"{RECALL_USERS} users")
    t = time.perf_counter()
    index, build = drive(lambda: model.init_ann("ivf"))
    build_s = time.perf_counter() - t
    n_clusters = max(4, int(np.sqrt(info.n_items)))   # 60 at ML-1M
    if index.centroids.shape[0] != n_clusters or build["segsum"] != 20:
        fail(f"[ann ivf] C={index.centroids.shape[0]} clusters, {build['segsum']} "
             f"segment-sums: expected {n_clusters} and one a Lloyd step (20)")
    t = time.perf_counter()
    recs, serve = drive(lambda: model.recommend_user(users, ANN_N_REC))
    rec_s = time.perf_counter() - t
    launches["ann_ivf"] = add_counts(dict(build), serve)
    if min(launches["ann_ivf"].values()) < 1:
        fail(f"[ann ivf] a kernel did not launch: {launches['ann_ivf']}")
    again = IVFIndex.build(model.item_embeds[:-1], seed=model.seed, device="cuda")
    if not (torch.equal(again.centroids, index.centroids)
            and torch.equal(again.lists, index.lists)):
        fail("[ann ivf] two builds from one seed differ")
    items = model.item_embeds[:-1]
    start = ivf.normalize_rows(items)[
        ivf.initial_indices(info.n_items, n_clusters, model.seed).cuda()]
    moved, sums_err = lloyd_step_check(items, start, "[ann ivf] Lloyd step")
    index.save(workdir / "ivf")
    cpu_index = IVFIndex.load(workdir / "ivf", device="cpu")
    fetch = ANN_N_REC + max(len(c) for c in info.user_consumed.values())
    near, search_err = search_check(index, cpu_index,
                                    model.user_embeds[:SEARCH_CHECK_USERS], fetch, 8,
                                    "[ann ivf] search")
    filled = ann_fill_check(model, recs, users, fetch, "[ann ivf]")
    recall = mean_overlap(recs, exact, users[:RECALL_USERS], ANN_N_REC)
    one = users[0]
    req_ms = time_ms(lambda: model.recommend_user(one, ANN_N_REC))
    req_dev = device_total_ms(lambda: model.recommend_user(one, ANN_N_REC))
    summary["ann_ivf"] = dict(
        build_s=build_s, recommend_all_s=rec_s, n_clusters=n_clusters,
        longest_list=int(index.lists.shape[1]), fetch=fetch,
        request_ms=req_ms, request_device_ms=req_dev, recall_at_10=recall,
        users_reaching_fill=filled, lloyd_rows_apart=moved,
        lloyd_sums_max_abs_err=sums_err, search_near_ties=near,
        search_max_abs_err=search_err, launches=launches["ann_ivf"])
    log(f"{stamp()} [ann ivf] build {build_s:.3f} s ({n_clusters} clusters, "
        f"longest list {index.lists.shape[1]}), recommend_user for {len(users)} users "
        f"{rec_s:.2f} s; a request {req_ms:.3f} ms events, {req_dev} ms device; "
        f"recall@10 against the exact top-k ({RECALL_USERS} users) {recall:.4f}; "
        f"{filled} users reached "
        f"the popular fill (fetch {fetch}); launches {json.dumps(launches['ann_ivf'])}")
    log(f"{stamp()} [ann ivf] checks: a Lloyd step card = CPU ({moved} near-tie "
        f"rows, sums max abs err {sums_err:.3g}), two builds bit-identical, the "
        f"search card = CPU over the saved index ({SEARCH_CHECK_USERS} users, "
        f"{near} near-tie swaps, max abs err {search_err:.3g}), no consumed item "
        "but through the fill")
    uid = info.user2id[one]
    shapes["ML-1M"] = ivf_kernel_rows(rng, index, model.user_embeds[uid:uid + 1],
                                      "ML-1M, one request")

    # (b) the catalog: 1,000,000 items
    cat_model, cat_users = catalog
    cinfo = cat_model.data_info
    queries = cat_model.user_embeds[torch.as_tensor(
        [cinfo.user2id[u] for u in cat_users], device="cuda")]
    t = time.perf_counter()
    cindex, cbuild = drive(lambda: cat_model.init_ann("ivf"))
    cbuild_s = time.perf_counter() - t
    C = cindex.centroids.shape[0]
    if C != max(4, int(np.sqrt(cinfo.n_items))):   # 1000 at 1,000,000 items
        fail(f"[ann ivf catalog] {C} clusters for {cinfo.n_items} items")
    (ids, _), csearch = drive(lambda: cindex.search(queries, CATALOG_K, 8))
    launches["ann_ivf_catalog"] = add_counts(dict(cbuild), csearch)
    if min(launches["ann_ivf_catalog"].values()) < 1:
        fail(f"[ann ivf catalog] a kernel did not launch: {launches['ann_ivf_catalog']}")
    full, _ = st.streaming_topk(queries, cat_model.item_embeds[:-1], CATALOG_K)
    full = full.cpu().numpy()
    crecall = float(np.mean([len(set(ids[r]) & set(full[r])) / CATALOG_K
                             for r in range(len(ids))]))
    search_ms = time_ms(lambda: cindex.search(queries, CATALOG_K, 8))
    step = max(1, ivf.SEARCH_CHUNK_BYTES
               // (8 * cindex.lists.shape[1] * cindex.item_embeds.shape[1] * 4))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pass2 = sum(st.plan(min(step, len(cat_users) - lo), C,
                        cindex.item_embeds.shape[1], 8, sms).n_chunks > 1
                for lo in range(0, len(cat_users), step))
    search_dev, search_split, _ = device_ms(
        lambda: cindex.search(queries, CATALOG_K, 8),
        {"topk_pass1": csearch["topk"], "topk_pass2": pass2,
         "::gather_kernel": csearch["gather"]})
    search_dev_all = device_total_ms(lambda: cindex.search(queries, CATALOG_K, 8))
    cstart = ivf.normalize_rows(cat_model.item_embeds[:-1])[
        ivf.initial_indices(cinfo.n_items, C, cat_model.seed).cuda()]
    cmoved, csums_err = lloyd_step_check(cat_model.item_embeds[:-1], cstart,
                                         "[ann ivf catalog] Lloyd step")
    cpu_cindex = IVFIndex(cindex.item_embeds.cpu(), cindex.centroids.cpu(),
                          cindex.lists.cpu(), cindex.counts.cpu(), device="cpu")
    cnear, cerr = search_check(cindex, cpu_cindex, queries[:16], CATALOG_K, 8,
                               "[ann ivf catalog] search")
    summary["ann_ivf_catalog"] = dict(
        build_s=cbuild_s, n_clusters=C, longest_list=int(cindex.lists.shape[1]),
        search_ms=search_ms, search_device_ms=search_dev_all,
        search_kernels_device_ms=search_dev, search_device_split=search_split,
        recall_at_32=crecall, lloyd_rows_apart=cmoved,
        lloyd_sums_max_abs_err=csums_err, search_near_ties=cnear,
        search_max_abs_err=cerr, launches=launches["ann_ivf_catalog"])
    log(f"{stamp()} [ann ivf catalog] build {cbuild_s:.3f} s ({C} clusters, "
        f"longest list {cindex.lists.shape[1]}); search of 256 users at k=32 "
        f"{search_ms:.3f} ms events, {search_dev_all} ms device (kernels "
        f"{search_split}); recall@32 against the full scan {crecall:.4f}; a Lloyd "
        f"step card = CPU ({cmoved} near-tie rows, sums max abs err "
        f"{csums_err:.3g}); search card = CPU on 16 users ({cnear} near-tie swaps); "
        f"launches {json.dumps(launches['ann_ivf_catalog'])}")
    shapes["catalog"] = ivf_kernel_rows(rng, cindex, queries, "catalog")
    cat_model.ann = None
    del cindex, cpu_cindex

    # (c) HNSW and knn on (a)'s model
    model.save(workdir, "bpr_ann")
    ref = BPR.load(workdir, "bpr_ann", device="cpu")
    sub = users[:256]
    t = time.perf_counter()
    hindex = model.init_ann("hnsw")
    hbuild_s = time.perf_counter() - t
    if hindex.blob() != hnsw_mod.HNSWIndex.build(
            model.item_embeds_np[:-1], M=16, ef_construction=200,
            seed=model.seed).blob():
        fail("[ann hnsw] two builds give different graphs")
    hrecs = model.recommend_user(sub, ANN_N_REC)
    h_ms = host_ms(lambda: model.recommend_user(sub, ANN_N_REC), runs=3)
    overlaps = [len({int(i) for i in hrecs[u]} & {int(i) for i in exact[u]})
                for u in sub]
    hindex.save(workdir / "hnsw")
    loaded = hnsw_mod.HNSWIndex.load(workdir / "hnsw")
    q = model.user_embeds_np[[info.user2id[u] for u in sub]]
    if not all(np.array_equal(a, b) for a, b in zip(
            loaded.search(q, ANN_N_REC), hindex.search(q, ANN_N_REC))):
        fail("[ann hnsw] the saved and loaded graph searches differently")
    model.ann = None
    saved = (_build.GXX, _build.BUILD_DIR, _build._loaded)
    try:
        _build.GXX = str(workdir / "no-such-g++")
        _build.BUILD_DIR = workdir / "failing_build"
        _build._loaded = {}
        hnsw_mod.hnsw_lib.cache_clear()
        try:
            hnsw_mod.HNSWIndex.build(model.item_embeds_np[:8])
        except RuntimeError:
            pass
        else:
            fail("[ann hnsw] a build with a missing compiler did not raise")
    finally:
        _build.GXX, _build.BUILD_DIR, _build._loaded = saved
        hnsw_mod.hnsw_lib.cache_clear()
    summary["ann_hnsw"] = dict(
        build_s=hbuild_s, recommend_256_ms=h_ms,
        overlap_with_exact_mean=float(np.mean(overlaps)),
        overlap_with_exact_min=int(min(overlaps)),
        users_at_jax_threshold=int(sum(o >= JAX_HNSW_OVERLAP for o in overlaps)))
    log(f"{stamp()} [ann hnsw] build {hbuild_s:.3f} s, two builds byte-equal, "
        f"saved and loaded searches equal, a missing compiler raises; "
        f"recommend_user(256 users) {h_ms:.2f} ms host; overlap with the exact "
        f"top-10 mean {np.mean(overlaps):.2f}, min {min(overlaps)} "
        f"({summary['ann_hnsw']['users_at_jax_threshold']} of 256 users at JAX's "
        f">= {JAX_HNSW_OVERLAP} of 10)")

    ku, ki = users[:KNN_QUERIES], [int(info.id2item[i]) for i in range(KNN_QUERIES)]
    knn, launches["knn"] = {}, {}

    def lists(m):
        return ([m.search_knn_users(u, 10) for u in ku],
                [m.search_knn_items(i, 10) for i in ki])

    for sim in ("cosine", "inner-product"):
        t = time.perf_counter()
        model.init_knn(approximate=True, sim_type=sim)
        kbuild_s = time.perf_counter() - t
        t = time.perf_counter()
        approx = lists(model)
        approx_ms = (time.perf_counter() - t) * 1e3 / (2 * KNN_QUERIES)
        model.init_knn(approximate=False, sim_type=sim)
        t = time.perf_counter()
        card, counts = drive(lambda: lists(model))
        exact_ms = (time.perf_counter() - t) * 1e3 / (2 * KNN_QUERIES)
        add_counts(launches["knn"], counts)
        if counts["topk"] != 2 * KNN_QUERIES:
            fail(f"[knn {sim}] {counts['topk']} top-k launches for "
                 f"{2 * KNN_QUERIES} exact searches")
        ref.init_knn(approximate=False, sim_type=sim)
        cpu = lists(ref)
        near = 0
        for side, got_lists, want_lists, raws in (
                ("user", card[0], cpu[0], ku), ("item", card[1], cpu[1], ki)):
            base = ref._knn_space(side).astype(np.float64)
            to_inner = info.user2id if side == "user" else info.item2id
            for raw, got, want in zip(raws, got_lists, want_lists):
                qv = base[to_inner[raw]]
                for a, b in zip(got, want):
                    if a != b:
                        sa, sb = base[to_inner[a]] @ qv, base[to_inner[b]] @ qv
                        if abs(sa - sb) > RTOL * max(abs(sa), abs(sb)):
                            fail(f"[knn {sim}] exact {side} {raw}: card and CPU "
                                 f"differ ({a} vs {b}) and are not near-ties")
                        near += 1
        symdiff = [len(set(a) ^ set(e)) for a, e in zip(approx[0] + approx[1],
                                                        card[0] + card[1])]
        knn[sim] = dict(build_s=kbuild_s, approx_search_ms=approx_ms,
                        exact_search_ms=exact_ms, near_ties=near,
                        symdiff_mean=float(np.mean(symdiff)),
                        symdiff_max=int(max(symdiff)),
                        within_jax_threshold=int(sum(d <= JAX_KNN_SYMDIFF
                                                     for d in symdiff)))
        log(f"{stamp()} [knn {sim}] HNSW graphs built in {kbuild_s:.3f} s; a "
            f"search {approx_ms:.3f} ms approximate (host), {exact_ms:.3f} ms exact "
            f"(card, host clock); exact card = CPU ({near} near-tie swaps); "
            f"approximate against exact: symmetric difference mean "
            f"{np.mean(symdiff):.2f}, max {max(symdiff)}, "
            f"{knn[sim]['within_jax_threshold']} of {len(symdiff)} lists within "
            f"JAX's <= {JAX_KNN_SYMDIFF}")
    summary["knn"] = knn
    summary["launches"] = launches
    log(json.dumps({"phase12_ann_knn": summary, "phase12_s": time.perf_counter() - t0}))
    return {"launches": launches, "shapes": shapes}


# ------------------------------------------- phase 13: the HTTP serving tier
TIER_USERS = 32          # known users a kind is asked for, at each n_rec
TIER_N_RECS = (10, 50)
TIER_ONLINE_USERS = 8
TIER_CANDIDATES_K = 50
TIER_LOAD_REQUESTS = 2000
TIER_CONCURRENCY = (1, 16)
TIER_SAMPLE = 64         # concurrent answers held to the sequential ones


def post_all(base, route, payloads, answer="rec_list"):
    """Each payload's answer, in turn; (answers, host ms of each)."""
    out, ms = [], []
    for p in payloads:
        t = time.perf_counter()
        out.append(http(base + route, p)[answer])
        ms.append((time.perf_counter() - t) * 1e3)
    return out, ms


def hydrated(loader, path):
    from librecommender_tpu_torch import serving

    store = serving.DictStore()
    getattr(serving, loader)(path, store)
    return store


def artifact_maps(path):
    """(user2id, id2item, consumed, n_items) of an artifact directory, as the
    JSON files hold them (string keys)."""
    with open(Path(path) / "id_mapping.json") as f:
        ids = json.load(f)
    with open(Path(path) / "user_consumed.json") as f:
        consumed = json.load(f)
    with open(Path(path) / "model_meta.json") as f:
        n_items = json.load(f)["n_items"]
    return ids["user2id"], ids["id2item"], consumed, n_items


def jax_top(scores, n_rec, n_items):
    """The JAX app's ranking (librecommender_tpu/serving/app.py:72-74)."""
    take = min(n_rec, n_items - 1)
    top = np.argpartition(-scores, take)[:n_rec]
    return top[np.argsort(-scores[top])]


def jax_embed_lists(path, payloads):
    """The JAX app's embed arithmetic (librecommender_tpu/serving/app.py:86-108)
    redone in numpy float64 from the artifact: per payload (raw ids, the
    float64 scores, consumed items scored -inf)."""
    user2id, id2item, consumed, n_items = artifact_maps(path)
    with np.load(Path(path) / "embeddings.npz") as arrays:
        user_embed = arrays["user_embed"].astype(float)
        item_embed = arrays["item_embed"].astype(float)[:n_items]
    out = []
    for p in payloads:
        uid = user2id.get(str(p["user"]))
        cons = set(consumed.get(str(uid), []) if uid is not None else [])
        scores = item_embed @ user_embed[uid if uid is not None else -1]
        if cons:
            scores[list(cons)] = -np.inf
        top = jax_top(scores, p.get("n_rec", 10), n_items)
        out.append(([id2item.get(str(int(t)), int(t)) for t in top], scores, cons))
    return out


def jax_knn_lists(path, payloads):
    """The JAX app's knn arithmetic (librecommender_tpu/serving/app.py:40-83)
    redone from the artifact's arrays: raw ids per payload."""
    user2id, id2item, consumed, n_items = artifact_maps(path)
    with np.load(Path(path) / "knn_sims.npz") as sims:
        cf_mode = str(sims["cf_mode"][0])
        sim_ids, sim_vals = sims["sim_ids"], sims["sim_vals"]
    with np.load(Path(path) / "interaction.npz") as inter:
        indptr, indices = inter["indptr"], inter["indices"]
        data = inter["data"].astype(np.float64)

    def row(r):
        valid = sim_ids[r] >= 0
        return [(int(i), float(s)) for i, s in zip(sim_ids[r][valid], sim_vals[r][valid])]

    out = []
    for p in payloads:
        uid = user2id.get(str(p["user"]))
        if uid is None:
            out.append([])
            continue
        scores = np.zeros(n_items)
        if cf_mode == "user":
            for nbr, sim in row(uid):
                s, e = indptr[nbr], indptr[nbr + 1]
                np.add.at(scores, indices[s:e], sim * data[s:e])
        else:
            flat = [q for i in indices[indptr[uid]:indptr[uid + 1]] for q in row(i)]
            if flat:
                np.add.at(scores, np.array([q[0] for q in flat], np.int64),
                          np.array([q[1] for q in flat], np.float64))
        scores[list(set(consumed.get(str(uid), [])))] = -np.inf
        n_rec = p.get("n_rec", 10)
        top = [int(t) for t in jax_top(scores, n_rec, n_items)
               if np.isfinite(scores[t])][:n_rec]
        out.append([id2item.get(str(t), t) for t in top])
    return out


def check_near_lists(got, want, scores, to_inner, what, masked=()):
    """Lists of equal length; a position may differ only where both items'
    float64 ``scores`` lie within RTOL relative (at least 1e-12), or both are
    ``masked`` (inner ids the reference scores -inf). Returns the swaps."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} items vs {len(want)}")
    swaps = 0
    for pos, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        ia, ib = to_inner(a), to_inner(b)
        if ia in masked and ib in masked:
            continue
        sa, sb = scores[ia], scores[ib]
        if abs(sa - sb) > RTOL * max(abs(sa), abs(sb), 1e-12):
            fail(f"{what}: position {pos} differs ({a} vs {b}) and is not a "
                 f"near-tie ({sa} vs {sb})")
        swaps += 1
    return swaps


def seq_scores64(model, user, seq, inner_id=False):
    """A sequence model's float64 catalog scores for the user vector it
    computes from ``seq`` (bias column appended where the table has one)."""
    embed = model.dyn_user_embedding(user, seq=seq, inner_id=inner_id)
    if model.item_embeds_np.shape[1] == embed.shape[0] + 1:
        embed = np.concatenate([embed, np.ones(1, np.float32)])
    return model.item_embeds_np[:-1].astype(np.float64) @ embed.astype(np.float64)


def feat_scores64(model, uid, user_feats):
    """A feature model's float64 catalog logits for inner user ``uid`` with
    the request's ``user_feats``, from a float64 copy of a CPU model."""
    import copy

    ref = copy.copy(model)
    ref.net = copy.deepcopy(model.net).double()
    ref.feats = copy.copy(model.feats)
    for name in ("user_dense", "item_dense"):
        table = getattr(ref.feats, name)
        if table is not None:
            setattr(ref.feats, name, table.double())
    overrides = {}
    if ref.feats.user_sparse is not None:
        overrides["user_sparse_row"] = ref.feats.build_user_sparse_row(
            uid, user_feats)[None]
    if ref.feats.user_dense is not None:
        overrides["user_dense_row"] = np.asarray(
            ref.feats.build_user_dense_row(uid, user_feats), np.float64)[None]
    return ref._score_users(np.array([uid]), overrides)[0].numpy()


def concurrent_equal(base, route, payloads, want, what):
    """``payloads`` posted from 16 threads at once answer as they did one at
    a time (``want``)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(16) as pool:
        got = list(pool.map(lambda p: http(base + route, p), payloads))
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        fail(f"{what}: {bad} of {len(want)} concurrent answers differ from the "
             "sequential ones")


def tier_embed(workdir, model, users):
    """(a) the embed kind: the artifact of phase 2's BPR served from the card
    and from the CPU, against JAX's arithmetic; then its IVF index."""
    from librecommender_tpu_torch import serving
    from librecommender_tpu_torch.retrieval.ivf import IVFIndex

    path = serving.save_embed(Path(workdir) / "tier_embed", model)
    payloads = [{"user": u, "n_rec": n} for u in users for n in TIER_N_RECS]
    payloads.append({"user": 10**9, "n_rec": 10})   # unknown: the OOV row
    store = hydrated("embed2store", path)
    with ServerThread("embed", store) as base:
        (card, ms), counts = drive(lambda: post_all(base, "/embed/recommend", payloads))
    with ServerThread("embed", store, device="cpu") as base:
        cpu, _ = post_all(base, "/embed/recommend", payloads)
    if counts["topk"] < len(payloads):
        fail(f"[tier embed] {len(payloads)} requests launched 2.1 {counts['topk']} times")
    item2id = {v: int(k) for k, v in artifact_maps(path)[1].items()}
    near = {"jax": 0, "cpu": 0}
    for p, g, c, (w, scores, cons) in zip(payloads, card, cpu,
                                          jax_embed_lists(path, payloads)):
        what = f"[tier embed] user {p['user']} n_rec {p['n_rec']}"
        near["jax"] += check_near_lists(g, w, scores, item2id.get, what + " vs JAX",
                                        masked=cons)
        near["cpu"] += check_near_lists(g, c, scores, item2id.get, what + " vs CPU",
                                        masked=cons)
        if len(g) + len(cons) <= model.n_items and {item2id[i] for i in g} & cons:
            fail(f"{what}: a consumed item was recommended")
    # the IVF index: built on the card (the Lloyd steps' segment-sums), saved,
    # loaded on the card, and searched as the built one
    ivf_path = Path(workdir) / "tier_ivf"
    t = time.perf_counter()
    index, build_counts = drive(lambda: serving.save_ivf_index(ivf_path, model))
    build_s = time.perf_counter() - t
    if build_counts["segsum"] < 1:
        fail(f"[tier embed] save_ivf_index launched no segment-sum: {build_counts}")
    loaded = IVFIndex.load(ivf_path, device="cuda")
    queries = model.user_embeds[: 256]
    n_probe = json.loads((ivf_path / "ivf_config.json").read_text())["n_probe"]
    want = index.search(queries, 10, n_probe)
    got, search_counts = drive(lambda: loaded.search(queries, 10, n_probe))
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail("[tier embed] the loaded IVF index searches apart from the built one")
    log(f"[tier embed] {len(payloads)} requests from the card: equal to JAX's "
        f"float64 arithmetic ({near['jax']} near-tie swaps) and to the CPU server "
        f"({near['cpu']}); 2.1 launches {counts['topk']}; ms p50 "
        f"{statistics.median(ms[1:]):.3f} (first, with the tables' upload, "
        f"{ms[0]:.1f}); save_ivf_index {build_s:.3f} s ({build_counts}), the loaded "
        f"index's search equal to the built one's ({search_counts})")
    return path, payloads, dict(
        requests=len(payloads), near_ties=near, first_ms=ms[0],
        p50_ms=statistics.median(ms[1:]), launches=counts,
        ivf_build_s=build_s, ivf_build_launches=build_counts,
        ivf_search_launches=search_counts)


def tier_knn(workdir, cf_models, users):
    """(b) the knn kind: UserCF's, ItemCF's and Swing's artifacts served
    against JAX's arithmetic redone from the artifact; no consumed item."""
    from librecommender_tpu_torch import serving

    out = {}
    payloads = [{"user": u, "n_rec": n} for u in users for n in TIER_N_RECS]
    payloads.append({"user": 10**9, "n_rec": 10})
    for name, model in cf_models.items():
        path = serving.save_knn(Path(workdir) / f"tier_knn_{name}", model)
        t = time.perf_counter()
        store = hydrated("knn2store", path)
        hydrate_s = time.perf_counter() - t
        with ServerThread("knn", store) as base:
            got, ms = post_all(base, "/knn/recommend", payloads)
        want = jax_knn_lists(path, payloads)
        if got != want:
            bad = sum(g != w for g, w in zip(got, want))
            fail(f"[tier knn {name}] {bad} of {len(payloads)} lists differ from "
                 "JAX's arithmetic")
        info = model.data_info
        for p, g in zip(payloads, got):
            uid = info.user2id.get(p["user"])
            if uid is not None and {info.item2id[i] for i in g} & set(
                    info.user_consumed[uid]):
                fail(f"[tier knn {name}] user {p['user']}: a consumed item")
        if not got[-1] == []:
            fail(f"[tier knn {name}] the unknown user got {got[-1]}")
        out[name] = dict(hydrate_s=hydrate_s, first_ms=ms[0],
                         p50_ms=statistics.median(ms[1:]),
                         mean_len=float(np.mean([len(g) for g in got[:-1]])))
        log(f"[tier knn {name}] {len(payloads)} lists equal to JAX's arithmetic, no "
            f"consumed item; hydrated in {hydrate_s:.2f} s; ms p50 "
            f"{out[name]['p50_ms']:.3f} (first {ms[0]:.1f})")
    return out


def tier_online(rng, workdir):
    """(c) the online kind and /candidates: phase 8's RNN4Rec with request
    seqs and phase 5's DIN with request features, served from the card,
    against the model loaded on the CPU."""
    from librecommender_tpu_torch import models, serving

    out = {}
    for name, cls, key in (("rnn4rec_gru", "RNN4Rec", "seq"), ("din", "DIN", "user_feats")):
        ref = getattr(models, cls).load(workdir, name, device="cpu")
        path = serving.save_online(Path(workdir) / f"tier_online_{name}", ref)
        info = ref.data_info
        uids = rng.choice(info.n_users, TIER_ONLINE_USERS, replace=False)
        payloads, cands = [], []
        for r, uid in enumerate(uids):
            if key == "seq":   # another user's last items and an unknown id
                other = info.user_consumed[int(uids[r - 1])]
                value = [int(info.id2item[i]) for i in other[-10:]] + [-1]
            else:
                value = {"sex": ("f", "m")[r % 2], "age": float(r - 4) / 4.0}
            payloads.append({"user": int(info.id2user[int(uid)]), "n_rec": 10,
                             key: value})
            cands.append({"user_inner": int(uid), "k": TIER_CANDIDATES_K, key: value})
        with ServerThread("online", hydrated("online2store", path)) as base:
            (got, ms), counts = drive(lambda: post_all(base, "/online/recommend",
                                                       payloads))
            (got_c, ms_c), counts_c = drive(lambda: post_all(
                base, "/candidates", cands, answer="candidates"))
        near = 0
        for p, c, g, gc in zip(payloads, cands, got, got_c):
            uid = c["user_inner"]
            if key == "seq":
                want = ref.recommend_user(p["user"], 10, seq=p["seq"])[p["user"]]
                scores = seq_scores64(ref, p["user"], p["seq"])
                mapped = [info.item2id[i] for i in p["seq"] if i in info.item2id]
                want_c = ref.recommend_user(uid, TIER_CANDIDATES_K, inner_id=True,
                                            filter_consumed=False, seq=mapped)[uid]
                scores_c = seq_scores64(ref, uid, mapped, inner_id=True)
            else:
                feats = p["user_feats"]
                want = ref.recommend_user(p["user"], 10, user_feats=feats)[p["user"]]
                scores = scores_c = feat_scores64(ref, uid, feats)
                want_c = ref.recommend_user(uid, TIER_CANDIDATES_K, inner_id=True,
                                            filter_consumed=False,
                                            user_feats=feats)[uid]
            what = f"[tier online {name}] user {p['user']}"
            near += check_near_lists(g, [int(i) for i in want], scores,
                                     info.item2id.get, what)
            near += check_near_lists(gc, [int(i) for i in want_c], scores_c,
                                     int, what + " /candidates")
        if key == "seq" and (counts["topk"] < len(payloads)
                             or counts_c["topk"] < len(cands)):
            fail(f"[tier online {name}] 2.1 launches {counts['topk']} and "
                 f"{counts_c['topk']} for {len(payloads)} requests each")
        out[name] = dict(near_ties=near, first_ms=ms[0], p50_ms=statistics.median(ms[1:]),
                         candidates_p50_ms=statistics.median(ms_c), launches=counts,
                         candidates_launches=counts_c)
        log(f"[tier online {name}] {len(payloads)} requests with {key} and "
            f"{len(cands)} /candidates equal to the CPU-loaded model's "
            f"recommend_user ({near} near-tie swaps); launches {counts} and "
            f"{counts_c}; ms p50 {out[name]['p50_ms']:.3f} and "
            f"{out[name]['candidates_p50_ms']:.3f} (first {ms[0]:.1f})")
    return out


def tier_load(workdir, model, embed_path, payloads):
    """(d) serving.benchmark.run_benchmark, from a process of its own (so
    that the client's threads do not share the server's interpreter lock),
    against the embed kind and the model kind (phase 2's BPR) on the card at
    each concurrency; a sample of concurrent answers equal to the sequential
    ones."""
    import multiprocessing

    from librecommender_tpu_torch import serving
    from librecommender_tpu_torch.serving.benchmark import run_benchmark

    model_path = serving.save_online(Path(workdir) / "tier_model", model)
    out = {}
    with multiprocessing.get_context("spawn").Pool(1) as client:
        for kind, loader, path in (("embed", "embed2store", embed_path),
                                   ("model", "online2store", model_path)):
            route = f"/{kind}/recommend"
            with ServerThread(kind, hydrated(loader, path)) as base:
                sample = payloads[:TIER_SAMPLE]
                want = [http(base + route, p) for p in sample]   # warms the cache
                concurrent_equal(base, route, sample, want, f"[tier load {kind}]")
                for c in TIER_CONCURRENCY:
                    res, counts = drive(lambda: client.apply(run_benchmark, (
                        base + route, payloads, TIER_LOAD_REQUESTS, c)))
                    if counts["topk"] < TIER_LOAD_REQUESTS:
                        fail(f"[tier load {kind}] {TIER_LOAD_REQUESTS} requests "
                             f"launched 2.1 {counts['topk']} times")
                    out[f"{kind}_c{c}"] = dict(res, launches=counts)
                    log(f"[tier load {kind}] concurrency {c}: {json.dumps(res)}; "
                        f"launches {counts}")
    return out


def phase_serving_tier(rng, workdir, model, cf_models):
    """(a) the embed kind on phase 2's BPR, its IVF index; (b) the knn kind on
    phase 11's UserCF, ItemCF and Swing; (c) the online kind and /candidates
    on phase 8's RNN4Rec and phase 5's DIN; (d) the load generator against
    the embed and model kinds. Returns each kernel's launches by path."""
    t0 = time.perf_counter()
    info = model.data_info
    users = [int(info.id2user[int(i)])
             for i in rng.choice(info.n_users, TIER_USERS, replace=False)]
    embed_path, payloads, embed = tier_embed(workdir, model, users)
    knn = tier_knn(workdir, cf_models, users)
    online = tier_online(rng, workdir)
    load = tier_load(workdir, model, embed_path,
                     [p for p in payloads if p["n_rec"] == 10])
    launches = {"tier_embed": embed["launches"],
                "tier_ivf_build": embed["ivf_build_launches"],
                "tier_ivf_search": embed["ivf_search_launches"]}
    for name, row in online.items():
        launches[f"tier_online_{name}"] = add_counts(
            dict(row["launches"]), row["candidates_launches"])
    for path, row in load.items():
        launches[f"tier_load_{path}"] = row["launches"]
    summary = {"phase13_serving_tier": dict(embed=embed, knn=knn, online=online,
                                            load=load, launches=launches),
               "phase13_s": time.perf_counter() - t0}
    log(json.dumps(summary))
    return launches


def main():
    import tempfile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("no CUDA GPU: chip_smoke.py drives the port on the GPU only")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(args.seed)

    smi = phase_card_and_build()
    log(smi)
    phase_kernel(rng)
    tables = phase_table_kernels(rng)
    phase_adam_gate(rng)
    scatter = phase_scatter_kernel(rng)
    phase_lookup_gate(rng)
    phase_scatter_gate(rng)
    # saved models live in the checkout (ignored by git) and go at exit
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=here, prefix="smoke_",
                                     suffix="_artifacts") as workdir:
        main_row, served = phase_serving(rng, workdir)
        catalog = phase_catalog(rng)
        columns = training_columns(rng)
        train = phase_training(rng, workdir, columns)
        din = phase_din(rng, workdir, columns)
        seq = phase_sequence_family(rng, workdir, columns)
        feat = phase_feature_family(rng, workdir, columns)
        embed = phase_embed_family(rng, workdir, columns)
        retrieval = phase_retrieval_graph(rng, workdir, columns)
        sage_w2v = phase_sage_w2v(rng, workdir, columns)
        swing_row, cf_models = phase_cf_retrain(rng, workdir, columns)
        ann = phase_ann_knn(rng, workdir, served, catalog)
        del catalog
        tier = phase_serving_tier(rng, workdir, served, cf_models)
        del served, cf_models
    source = "librecommender_tpu_torch/csrc/table_gather.cu"
    item = tables["main path, item table"]
    # the top-k's main paths: the served requests (phase 2), phases 8's,
    # 9's and 10's fits, evaluations and recommendations, phase 12's IVF
    # probes and exact knn searches, and phase 13's serving tier
    topk_launches = {"serving": main_row["main_path_launches"]}
    for family in (embed, retrieval, sage_w2v):
        topk_launches.update({name: row["launches"]["topk"]
                              for name, row in family.items()})
    for paths in (ann["launches"], tier):
        topk_launches.update({path: n["topk"] for path, n in paths.items()})

    def ivf_shapes(name):
        """Phase 12's rows of one kernel at the IVF shapes."""
        return {where: rows[name] for where, rows in ann["shapes"].items()}

    kernels = [dict(
        name="streaming_topk", route="cuda",
        source="librecommender_tpu_torch/csrc/streaming_topk.cu",
        replaces="librecommender_tpu/ops/pallas_topk.py:37",
        launches=sum(topk_launches.values()), launches_by_path=topk_launches,
        max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], device_ms=main_row["device_ms"],
        device_split=main_row["device_split"],
        launches_seen=main_row["launches_seen"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        library_device_ms=main_row["library_device_ms"],
        enqueue_ms=main_row["enqueue_ms"], shape=main_row["shape"],
        phase9_widths={name: {kind: {k: r[k] for k in (
            "shape", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")} for kind, r in row["topk"].items()}
            for name, row in retrieval.items()},
        ivf_shapes=ivf_shapes("streaming_topk"),
    )]
    def by_path(key, *paths, family=()):
        """Each main path's launches of one kernel: BPR's fit (phase 4c),
        DIN's (phase 5e), the sequence family's fits (phase 6 (b)), and the
        feature family's (phase 7 (b)), the embedding family's (phase 8 (b)
        to (e)) and the graph and word2vec family's (phase 10 (b) to (e))
        where given."""
        out = {name: path["launches"][key] for name, path in paths}
        for rows in (seq, *family):
            out.update({name: row["launches"][key] for name, row in rows.items()})
        return out

    for name, replaces, key in (
        ("table_gather", "librecommender_tpu/ops/mxu_gather.py:65", "gather"),
        ("segment_sum", "librecommender_tpu/ops/mxu_gather.py:83", "segsum"),
    ):
        launches = by_path(key, ("bpr", train), ("din", din),
                           family=(feat, embed, sage_w2v))
        for paths in (ann["launches"], tier):
            launches.update({path: n[key] for path, n in paths.items() if n.get(key)})
        # phase 10's two lookup shapes beside the main path's item table
        extra = {"at_shapes": {what: tables[what][name] for what in (
            "GraphSage neighbour gather", "SGNS negatives")}}
        if name == "table_gather":   # ALS's bucket gathers, one epoch's
            extra["als_epoch"] = embed["als"]["epoch_gathers"]
        extra["ivf_shapes"] = ivf_shapes(name)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=sum(launches.values()),
                            launches_by_path=launches, **item[name], **extra))
    # the bf16 input type serves parity/bench_scatter.py, not the training
    # path: its launches there are 0, its numbers are at V=3712
    bench = tables["bench_scatter V=3712"]["segment_sum_bf16"]
    kernels.append(dict(name="segment_sum_bf16", route="cuda", source=source,
                        replaces="parity/bench_scatter.py:41",
                        launches=train["launches"]["segsum_bf16"],
                        on_main_path=False, **bench))
    # the scatter-add at DIN's history gather, ids drawn by popularity as the
    # training data draws them; launches from the DIN main path (phase 5e)
    # and the sequence family's (phase 6 (b))
    launches = by_path("scatter", ("din", din))
    kernels.append(dict(name="scatter_add_rows", route="cuda",
                        source="librecommender_tpu_torch/csrc/row_scatter.cu",
                        replaces="librecommender_tpu/ops/pallas_scatter.py:26",
                        launches=sum(launches.values()), launches_by_path=launches,
                        **scatter["DIN history, popularity ids"]))
    # Swing's pair pass: launches from phase 11's full-size fit, timed there
    # with its plain version on the same lists (no PyTorch call computes it)
    kernels.append(dict(name="swing_pairs", route="cuda",
                        source="librecommender_tpu_torch/csrc/swing.cu",
                        replaces="librecommender_tpu/native/similarities.cpp:396",
                        **swing_row))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
