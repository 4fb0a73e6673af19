#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (librecommender_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero when it fails:
  0. the card (nvidia-smi) and the kernel builds from csrc/ (one nvcc per
     source, started together);
  1. the streaming top-k kernel against its plain PyTorch version at fixed
     shapes (a served request at k = 10, 53, 343 and 2048, the catalog,
     k=2048 over 100,000 items, exact ties, and runs of ties straddling
     position k, where ids must agree exactly), with kernel, plain and
     torch.topk times (CUDA events, median) and each pass's device time;
  1b. the table gather and segment-sum kernels against their plain versions
     (gather exact, segment-sum bit-equal to index_add_ on the CPU, two
     launches bit-equal) at the training paths' shapes (BPR's tables, DIN's
     16-row vocabulary, whose ids go in segments) and edge shapes, with
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
     examples/s, per-step times and the scatter's device time.
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


def profiled(fn):
    """Run ``fn()`` under torch.profiler (CPU and CUDA); returns its
    key_averages()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms(fn, names=("topk_pass1", "topk_pass2"), runs=TIMED_RUNS):
    """Device milliseconds per call in each kernel whose name contains one of
    ``names``, from torch.profiler; empty if the profiler saw no device
    time."""
    fn()

    def repeat():
        for _ in range(runs):
            fn()

    split = {}
    for attempt in range(1, 4):   # a profile now and then comes back empty
        for evt in profiled(repeat):
            for name in names:
                if name in evt.key:
                    split[name] = split.get(name, 0.0) + _self_device_us(evt) / runs / 1e3
        if split:
            break
    if attempt > 1 or not split:
        log(f"[profile] {names}: {attempt} profile(s) taken, device rows "
            f"{'found' if split else 'not found: device_ms is null'}")
    return split


def device_total_ms(fn, runs=TIMED_RUNS):
    """Device milliseconds per call of ``fn()`` in all its kernels and copies
    (a library call's own device time), from torch.profiler; None if the
    profiler saw no device time."""
    fn()

    def repeat():
        for _ in range(runs):
            fn()

    for _ in range(3):   # a profile now and then comes back empty
        us = sum(_self_device_us(evt) for evt in profiled(repeat) if _is_kernel(evt))
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
    split = device_ms(lambda: st.streaming_topk(users, items, k))
    plain_ms = time_ms(lambda: st.streaming_topk_plain(users, items, k), runs=10)
    lib_ms = time_ms(lambda: torch.topk(users @ items.T, k, dim=1))
    lib_dev_ms = device_total_ms(lambda: torch.topk(users @ items.T, k, dim=1))
    # the host's share: enqueueing a call on an idle card
    enq_ms = enqueue_ms(lambda: st.streaming_topk(users, items, k))
    lib_enq_ms = enqueue_ms(lambda: torch.topk(users @ items.T, k, dim=1))
    b_ms, b_by = bound_ms(U, N, D, k)
    row = dict(shape=dict(U=U, N=N, D=D, k=k), launches=launches,
               ids_equal=ids_equal, max_abs_err=err, near_ties=near,
               ms=ms, device_ms=sum(split.values()) if split else None,
               device_split=split, plain_ms=plain_ms, library_ms=lib_ms,
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
    names = ("streaming_topk", "table_gather", "row_scatter")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(lambda n: _build.build(n, verbose=True), names))
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


def phase_serving(rng, workdir):
    """The main path: save a BPR(embed_size=64), serve it over HTTP from the
    GPU, and hold every answer against the same model loaded on the CPU."""
    import threading

    from librecommender_tpu_torch.models import BPR
    from librecommender_tpu_torch.ops import streaming_topk as st
    from librecommender_tpu_torch.ops.topk import fetch_size
    from librecommender_tpu_torch.serving import DictStore, create_server

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
    server, port = create_server("model", store, port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    known = [int(info.id2user[int(i)]) for i in rng.choice(info.n_users, 3, replace=False)]
    requests = [(u, n) for u in known for n in (10, 50)] + [(10**9, 10)]
    try:
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
        gpu_model = server.model()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        fail("server thread did not stop")
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
    return row


def phase_catalog(rng):
    """One recommend_user over 256 users of a 10,000 x 1,000,000 BPR."""
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


# ------------------------------------------------- table gather, segment-sum
# the port's kernels by name (PyTorch has a vectorized_gather_kernel of its own)
GATHER_NAMES = ("::gather_kernel", "::segsum_kernel")
# the last kernel of a segment-sum or scatter-add whose ids go in segments
PARTIALS = "sum_partials_kernel"
# the two kernels that partition the ids of a segment-sum or scatter-add
# (staged::partition_count, staged::partition_place)
PARTITION = "partition_"
# every kernel of one segment-sum or scatter-add call
SEGSUM_NAMES = ("::segsum_kernel", PARTITION, PARTIALS)
SCATTER_NAMES = ("::scatter_rows_kernel", PARTITION, PARTIALS)


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
# a 1,000,000-row table, and a 200,000-row one where a quarter of the ids
# are one id (256-row tiles with a hot row).
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


def measure_table_kernels(rng, R, D, B, what, ragged=False, bf16=False):
    """Hold the gather and the segment-sum (float32 values, and bf16 with
    ``bf16``) against their plain versions at one shape, and time each: the
    kernel (CUDA events, and device time by torch.profiler), the plain
    version (gather: torch ops on the card; segment-sum: index_add_ on the
    CPU, host clock, copies included) and the library call (index_select;
    index_add_ on the card, whose float atomics make it nondeterministic)."""
    from librecommender_tpu_torch.ops import table_gather as tg

    ids = torch.from_numpy(table_ids(rng, R, B, ragged)).cuda()
    table = torch.from_numpy(rng.standard_normal((R, D), dtype=np.float32)).cuda()
    vals = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).cuda()
    valid = (ids >= 0) & (ids < R)
    n_valid = int(valid.sum())
    ids_long, ids_in = ids.long()[valid], ids.long().clamp(0, R - 1)
    n_distinct = int(torch.unique(ids_long).numel())
    vals_valid = vals[valid]
    rows = {}

    # the gather: exact
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
        device_ms=sum(device_ms(lambda: tg.table_gather(table, ids),
                                ("::gather_kernel",)).values()) or None,
        plain_ms=time_ms(lambda: tg.table_gather_plain(table, ids)),
        enqueue_ms=enqueue_ms(lambda: tg.table_gather(table, ids)),
        library_ms=time_ms(lambda: torch.index_select(table, 0, ids_in)),
        library_device_ms=device_total_ms(lambda: torch.index_select(table, 0, ids_in)),
        library_enqueue_ms=enqueue_ms(lambda: torch.index_select(table, 0, ids_in)),
        bound_ms=b_ms, bound_by=b_by)

    # the segment-sum: bit-equal to index_add_ on the CPU, twice
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
            device_ms=sum(device_ms(
                lambda: tg.segment_sum(ids, vals, R, vals_dtype=dtype),
                SEGSUM_NAMES).values()) or None,
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
# tokens' 128), the packed-token history, the long-history shape of
# bench.py's SIM, the JAX tests' two shapes, D = 33 with out-of-range ids and
# N = 0; then the packed table's own build, every id once.
SCATTER_SHAPES = [
    ("DIN history", 3712, 64, 81_920, 0, None),
    ("DIN targets", 3712, 64, 16_384, 0, None),
    ("DIN targets, packed tokens", 3712, 128, 16_384, 0, None),
    ("packed tokens", 3712, 128, 98_304, 0, None),
    ("long history", 3712, 64, 409_600, 0, None),
    ("jax test", 371, 64, 5000, 0, None),
    ("jax test, ragged", 40, 8, 777, 0, 7),
    ("D=33, ids out of range", 50, 33, 4097, -6, 58),
    ("no ids", 12, 7, 0, 0, None),
]


def scatter_cases():
    """Phase 1c's calls: (name, n_rows, D, N, ids from, ids below, ids kind)."""
    for what, n_rows, D, N, lo, hi in SCATTER_SHAPES:
        for kind in ("uniform", "popularity"):
            if N or kind == "uniform":
                yield f"{what}, {kind} ids", n_rows, D, N, lo, hi, kind
    yield "packed table build, every id once", 3712, 64, 3707, 0, None, "arange"


def scatter_ids(rng, n_rows, N, lo=0, hi=None, kind="uniform"):
    """N ids into n_rows rows: uniform over [lo, hi), by popularity, or
    0, 1, ..., N - 1 (arange)."""
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
        device_ms=sum(device_ms(lambda: rs.scatter_add_rows(ids, rows, n_rows),
                                SCATTER_NAMES).values()) or None,
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
    from librecommender_tpu_torch.data import TransformedSet
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
    head = TransformedSet(train.user_indices[: steps * 8192],
                          train.item_indices[: steps * 8192],
                          train.labels[: steps * 8192])
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
    probe = BPR("ranking", info, embed_size=64, n_epochs=1, batch_size=8192,
                seed=seed, device="cuda")
    stats = profiled(lambda: probe.fit(train, neg_sampling=True, verbose=0))
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
            by_op[evt.key[:60]] = us / n_batches / 1e3
        for name in GATHER_NAMES + (PARTITION,):
            if name in evt.key:
                per_kernel[name] = per_kernel.get(name, 0.0) + us / n_batches / 1e3
    device_step_ms = total_us / n_batches / 1e3
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = 1.0 - device_step_ms / step_ms if step_ms > 0 else None
    summary = dict(examples_per_s=ex_per_s, step_ms=step_ms,
                   device_ms_per_step=device_step_ms, kernel_ms_per_step=per_kernel,
                   top_device_ops_ms_per_step=top_ops,
                   kernel_launches_per_step=launches_cpu / n_batches,
                   idle_share=idle, steps_per_epoch=n_batches, launches=launches,
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


def check_din_recs(got, want, ref_model, user, what):
    """Raw-id lists must match; a position may differ only where the two
    items' float64 logits for this user are within 1e-5 (relative to the
    larger, at least 1)."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} recs vs {len(want)}")
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not diff:
        return 0
    info = ref_model.data_info
    scores = _din_scores64(ref_model, info.user2id.get(user, ref_model.n_users))
    for i in diff:
        sa, sb = scores[info.item2id[got[i]]], scores[info.item2id[want[i]]]
        if abs(sa - sb) > RTOL * max(1.0, abs(sa), abs(sb)):
            fail(f"{what}: position {i} differs ({got[i]} vs {want[i]}) "
                 f"and is not a near-tie ({sa} vs {sb})")
    return len(diff)


def din_first_step_grads(model, train, init):
    """The gradients of ``loss_fn`` at the parameters ``init`` on the first
    batch of ``train`` (8192 rows and their host-sampled negatives, in file
    order), as numpy arrays by parameter name; on the card through the
    gather, segment-sum and scatter-add kernels, as a fit's step runs them."""
    from librecommender_tpu_torch.batch.generator import (BatchGenerator,
                                                          adjust_batch_size)

    model.params_from_arrays(init)
    model._mxu_lookup = True   # as the trainer sets it for a fit
    rows = adjust_batch_size(model, DIN_BATCH)
    gen = BatchGenerator(train, model.data_info, rows, paradigm=model.paradigm,
                         neg_sampling=True, sampler="unconsumed", num_neg=1,
                         seed=model.seed, extras=model.batch_extras(train))
    batch = {k: torch.from_numpy(v[:rows]).to(model.device)
             for k, v in gen.epoch_arrays().items()}
    batch["item_neg"] = torch.from_numpy(gen.epoch_negatives()[:rows]).to(model.device)
    keys = list(model.net.keys())
    loss = model.loss_fn(model.net, batch)
    grads = torch.autograd.grad(loss, [model.net[k] for k in keys])
    model._mxu_lookup = False
    return float(loss.detach()), {k: g.cpu().numpy() for k, g in zip(keys, grads)}


def phase_din(rng, workdir, columns):
    """DIN at bench.py's width (embed_size=64, batch_size=16384,
    hidden_units=(128, 64, 32), recent_num=10) on the ML-1M-sized feature
    data, with the sequence gathers' gradient on the row scatter-add kernel.
    Returns the kernels' launches on the main path (e) and the per-step
    numbers."""
    import threading

    from librecommender_tpu_torch.data import DatasetFeat, TransformedSet
    from librecommender_tpu_torch.evaluation import evaluate
    from librecommender_tpu_torch.models import DIN
    from librecommender_tpu_torch.ops import row_scatter as rs
    from librecommender_tpu_torch.ops import table_gather as tg
    from librecommender_tpu_torch.serving import DictStore, create_server

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
    reset()
    loss_g, grads_g = din_first_step_grads(din("cuda"), train, init)
    torch.cuda.synchronize()
    if rs.launches != 2:
        fail(f"(a) gradients: {rs.launches} scatter launches for one step")
    lookups("(a) gradients", 1)
    loss_c, grads_c = din_first_step_grads(din("cpu"), train, init)
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"(a) first loss {loss_g} on the GPU, {loss_c} on the CPU")
    largest = max(float(np.abs(g).max()) for g in grads_c.values())
    bad = total = 0
    worst = dict(norm=(0.0, None), entry=(0.0, None))
    rounding_only = []
    for k, want in grads_c.items():
        if not np.isfinite(grads_g[k]).all():
            fail(f"(a) gradient of {k} on the GPU is not finite")
        d = np.abs(grads_g[k].astype(np.float64) - want)
        top = float(np.abs(want).max())
        if top < 1e-6 * largest:
            rounding_only.append(k)
            if float(d.max()) > 1e-6 * largest:
                fail(f"(a) gradient of {k}: {d.max()} apart where the CPU's "
                     f"is {top}, the step's largest {largest}")
            continue
        bad += int((d > 1e-4 * np.abs(want) + 1e-5 * top).sum())
        total += d.size
        norm = float(np.linalg.norm(d) / np.linalg.norm(want.astype(np.float64)))
        worst["norm"] = max(worst["norm"], (norm, k))
        worst["entry"] = max(worst["entry"], (float(d.max()) / top, k))
    if (worst["norm"][0] > 1e-2 or worst["entry"][0] > 0.1 or bad > 0.05 * total):
        fail(f"(a) gradients, GPU against CPU: difference's norm "
             f"{worst['norm'][0]:.3g} of the gradient's in {worst['norm'][1]}, "
             f"entry off by {worst['entry'][0]:.3g} of the largest in "
             f"{worst['entry'][1]}, {bad} of {total} entries beyond rtol 1e-4")
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
    def beyond(a, b, rtol=1e-4, atol=1e-5):
        """(max abs difference, entries beyond the tolerance, entries)."""
        worst, bad, total = 0.0, 0, 0
        for k in a:
            d = np.abs(a[k] - b[k])
            worst = max(worst, float(d.max()))
            bad += int((d > atol + rtol * np.abs(b[k])).sum())
            total += d.size
        return worst, bad, total

    lr = 0.001
    fitted, losses = {}, {}
    runs = (("cuda", True, 1), ("cpu", True, 1), ("cuda", True, 10),
            ("cpu", True, 10), ("cpu", "again", 10), ("cuda", False, 10))
    for device, flag, steps in runs:
        head = TransformedSet(*(x[: steps * rows_a_step] for x in (
            train.user_indices, train.item_indices, train.labels)))
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

    store = DictStore()
    store.set("model_path", str(workdir))
    store.set("model_meta", {"model_name": "din"})
    server, port = create_server("model", store, port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        t = time.perf_counter()
        got = http(f"http://127.0.0.1:{port}/model/recommend",
                   {"user": users[0], "n_rec": 10})
        served_ms = (time.perf_counter() - t) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        fail("(e) server thread did not stop")
    want = [int(i) for i in back.recommend_user(users[0], 10)[users[0]]]
    near += check_din_recs(got["rec_list"], want, back, users[0], "(e) served")
    launches = dict(scatter=rs.launches, gather=tg.gather_launches,
                    segsum=tg.segsum_launches)
    log(f"[din] (e) fit {fit_s:.1f} s, epochs "
        f"{[round(x, 4) for x in model.trainer.epoch_times]} s, losses "
        f"{[round(x, 5) for x in model.trainer.epoch_losses]}; card {gpu}, the "
        f"saved model on the CPU {cpu}; recommend_user and one served request "
        f"({served_ms:.1f} ms with loading) equal to the CPU's ({near} near-tie "
        f"swaps); launches {launches}")

    # throughput (the epoch after the first, host clock) and one profiled epoch
    steady = model.trainer.epoch_times[1:]
    step_ms = 1e3 * statistics.mean(steady) / n_batches
    probe = din("cuda", n_epochs=1)
    stats = profiled(lambda: probe.fit(train, neg_sampling=True, verbose=0))
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
            by_op[evt.key[:60]] = us / n_batches / 1e3
        for name in GATHER_NAMES + ("::scatter_rows_kernel", PARTITION, PARTIALS):
            if name in evt.key:
                per_kernel[name] = per_kernel.get(name, 0.0) + us / n_batches / 1e3
    device_step_ms = total_us / n_batches / 1e3
    summary = dict(
        examples_per_s=[n_train / x for x in steady], step_ms=step_ms,
        device_ms_per_step=device_step_ms, kernel_ms_per_step=per_kernel,
        top_device_ops_ms_per_step=sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        kernel_launches_per_step=launches_cpu / n_batches,
        idle_share=1.0 - device_step_ms / step_ms if step_ms > 0 else None,
        steps_per_epoch=n_batches, launches=launches,
        auc_gpu=gpu["roc_auc"], auc_cpu=cpu["roc_auc"],
        precision_gpu=gpu["precision"], precision_cpu=cpu["precision"])
    log(f"[din] {json.dumps(summary)}")
    return summary


def main():
    import tempfile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("no CUDA GPU: chip_smoke.py drives the port on the GPU only")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        main_row = phase_serving(rng, workdir)
        phase_catalog(rng)
        columns = training_columns(rng)
        train = phase_training(rng, workdir, columns)
        din = phase_din(rng, workdir, columns)
    source = "librecommender_tpu_torch/csrc/table_gather.cu"
    item = tables["main path, item table"]
    kernels = [dict(
        name="streaming_topk", route="cuda",
        source="librecommender_tpu_torch/csrc/streaming_topk.cu",
        replaces="librecommender_tpu/ops/pallas_topk.py:37",
        launches=main_row["main_path_launches"],
        max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], device_ms=main_row["device_ms"],
        device_split=main_row["device_split"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        library_device_ms=main_row["library_device_ms"],
        enqueue_ms=main_row["enqueue_ms"], shape=main_row["shape"],
    )]
    for name, replaces, launches in (
        ("table_gather", "librecommender_tpu/ops/mxu_gather.py:65",
         (train["launches"]["gather"], din["launches"]["gather"])),
        ("segment_sum", "librecommender_tpu/ops/mxu_gather.py:83",
         (train["launches"]["segsum"], din["launches"]["segsum"])),
    ):
        # launches: BPR's fit (phase 4c) and DIN's (phase 5e)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=sum(launches),
                            launches_by_path=dict(bpr=launches[0], din=launches[1]),
                            **item[name]))
    # the bf16 input type serves parity/bench_scatter.py, not the training
    # path: its launches there are 0, its numbers are at V=3712
    bench = tables["bench_scatter V=3712"]["segment_sum_bf16"]
    kernels.append(dict(name="segment_sum_bf16", route="cuda", source=source,
                        replaces="parity/bench_scatter.py:41",
                        launches=train["launches"]["segsum_bf16"],
                        on_main_path=False, **bench))
    # the scatter-add at DIN's history gather, ids drawn by popularity as the
    # training data draws them; launches from the DIN main path (phase 5e)
    kernels.append(dict(name="scatter_add_rows", route="cuda",
                        source="librecommender_tpu_torch/csrc/row_scatter.cu",
                        replaces="librecommender_tpu/ops/pallas_scatter.py:26",
                        launches=din["launches"]["scatter"],
                        **scatter["DIN history, popularity ids"]))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
