#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (librecommender_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero when it fails:
  0. the card (nvidia-smi) and the kernel builds from csrc/ (one nvcc per
     source, started together);
  1. the streaming top-k kernel against its plain PyTorch version at fixed
     shapes, with kernel, plain and torch.topk times (CUDA events, median);
  1b. the table gather and segment-sum kernels against their plain versions
     (gather exact, segment-sum bit-equal to index_add_ on the CPU, two
     launches bit-equal) at the training path's shapes and edge shapes, with
     kernel, plain and library times; one lazy-Adam update of each form timed
     at seven table sizes (the dense-pass gate);
  2. the serving main path: a BPR (embed_size=64) on an ML-1M-sized DataInfo,
     saved, loaded on the GPU and served over HTTP; every rec_list must match
     the same model loaded on the CPU, and the kernel's launch count must rise;
  3. one catalog-scale recommend_user (10,000 users x 1,000,000 items);
  4. the training path at full width on ML-1M-sized data with a planted
     structure: (a) GPU against CPU on the same batches, (b) same-seed fits
     bit-identical on the card, (c) the quickstart (fit, evaluate,
     recommend_user, save) on the card and on the CPU, AUCs within 0.01,
     with examples/s, per-step kernel times and the card's idle share.
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


def _self_device_us(evt):
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0.0) if us is None else us


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
    for evt in profiled(repeat):
        for name in names:
            if name in evt.key:
                split[name] = split.get(name, 0.0) + _self_device_us(evt) / runs / 1e3
    return split


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


def check_topk(users, items, ids_k, sc_k, ids_p, sc_p, what, exact_ids=False):
    """Kernel vs plain: scores to RTOL; ids equal except where the exact
    (float64) scores of the two ids differ by less than RTOL relative
    (never, with ``exact_ids``)."""
    ids_k, sc_k = ids_k.cpu().numpy(), sc_k.cpu().numpy()
    ids_p, sc_p = ids_p.cpu().numpy(), sc_p.cpu().numpy()
    if ids_k.shape != ids_p.shape or not np.isfinite(sc_k).all():
        fail(f"{what}: shape {ids_k.shape} vs {ids_p.shape} or non-finite scores")
    err = float(np.abs(sc_k - sc_p).max())
    if not np.all(np.abs(sc_k - sc_p) <= RTOL * np.abs(sc_p) + 1e-30):
        fail(f"{what}: scores differ beyond rtol {RTOL} (max abs err {err})")
    rows, cols = np.nonzero(ids_k != ids_p)
    near_ties = 0
    if rows.size and exact_ids:
        fail(f"{what}: {rows.size} ids differ where ties must resolve exactly")
    if rows.size:
        u = users.double().cpu().numpy()
        it = items.double()
        a = it[torch.as_tensor(ids_k[rows, cols], dtype=torch.long)].cpu().numpy()
        b = it[torch.as_tensor(ids_p[rows, cols], dtype=torch.long)].cpu().numpy()
        ea, eb = (u[rows] * a).sum(1), (u[rows] * b).sum(1)
        if not np.all(np.abs(ea - eb) <= RTOL * np.maximum(np.abs(ea), np.abs(eb))):
            fail(f"{what}: {rows.size} ids differ and are not near-ties")
        near_ties = int(rows.size)
    return err, near_ties


def make_inputs(rng, U, N, D, ties=False):
    if ties:
        # dyadic values: every dot product is exact, so duplicated item rows
        # tie exactly in any summation order
        users = rng.integers(-4, 5, (U, D)).astype(np.float32) / 4
        base = rng.integers(-4, 5, (N // 4, D)).astype(np.float32) / 4
        items = np.repeat(base, 4, axis=0)[rng.permutation(N // 4 * 4)]
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
    b_ms, b_by = bound_ms(U, N, D, k)
    row = dict(shape=dict(U=U, N=N, D=D, k=k), launches=launches,
               ids_equal=ids_equal, max_abs_err=err, near_ties=near,
               ms=ms, device_ms=sum(split.values()) if split else None,
               device_split=split, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=b_ms, bound_by=b_by)
    log(f"[kernel] {what} {json.dumps(row)}")
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
    names = ("streaming_topk", "table_gather")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(lambda n: _build.build(n, verbose=True), names))
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s")
    return smi


def phase_kernel(rng):
    from librecommender_tpu_torch.ops import streaming_topk as st

    shapes = [
        ("one request, ML-1M catalog", 1, 3706, 65, 10, False),
        ("catalog", 256, 1_000_000, 65, 32, False),
        ("ragged", 13, 1000, 32, 10, False),
        ("k=2048", 4, 100_000, 65, 2048, False),
        ("ties", 64, 20_000, 65, 100, True),
    ]
    for what, U, N, D, k, ties in shapes:
        users, items = make_inputs(rng, U, N, D, ties)
        measure_kernel(st, users, items, k, what, exact_ids=ties)


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
GATHER_NAMES = ("gather_kernel", "segsum_kernel")


def table_bound_ms(kind, R, B, D, n_valid):
    """Least time on an H100 SXM for one call: the bytes each input is read
    and each output written once at the HBM rate (the gather reads B ids and
    B rows and writes B rows; the segment-sum reads B ids and B rows and
    writes all R rows), against the adds of the valid ids at the f32 peak."""
    if kind == "gather":
        nbytes, ops = 4.0 * B + 8.0 * B * D, 0.0
    else:
        nbytes, ops = 4.0 * B + 4.0 * B * D + 4.0 * R * D, float(n_valid) * D
    t_bytes, t_ops = nbytes / H100_HBM_BYTES, ops / H100_F32_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def measure_table_kernels(rng, R, D, B, what, ragged=False, bf16=False):
    """Hold the gather and the segment-sum (float32 values, and bf16 with
    ``bf16``) against their plain versions at one shape, and time each: the
    kernel (CUDA events, and device time by torch.profiler), the plain
    version (gather: torch ops on the card; segment-sum: index_add_ on the
    CPU, host clock, copies included) and the library call (index_select;
    index_add_ on the card, whose float atomics make it nondeterministic)."""
    from librecommender_tpu_torch.ops import table_gather as tg

    lo, hi = (-3, R + 4) if ragged else (0, R)
    ids_np = rng.integers(lo, hi, B).astype(np.int32)
    if ragged:
        ids_np[: B // 4] = ids_np[0]      # a run of duplicates
    ids = torch.from_numpy(ids_np).cuda()
    table = torch.from_numpy(rng.standard_normal((R, D), dtype=np.float32)).cuda()
    vals = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).cuda()
    valid = (ids >= 0) & (ids < R)
    n_valid = int(valid.sum())
    ids_long, ids_in = ids.long()[valid], ids.long().clamp(0, R - 1)
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
    b_ms, b_by = table_bound_ms("gather", R, B, D, n_valid)
    rows["table_gather"] = dict(
        shape=dict(R=R, D=D, B=B), max_abs_err=0.0,
        ms=time_ms(lambda: tg.table_gather(table, ids)),
        device_ms=sum(device_ms(lambda: tg.table_gather(table, ids),
                                ("gather_kernel",)).values()) or None,
        plain_ms=time_ms(lambda: tg.table_gather_plain(table, ids)),
        library_ms=time_ms(lambda: torch.index_select(table, 0, ids_in)),
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
        if not torch.equal(first, second):
            fail(f"{what}: two {name} launches differ")
        want = tg.segment_sum_plain(ids, vals, R, vals_dtype=dtype)
        err = float((first.cpu() - want).abs().max())
        if not torch.equal(first.cpu(), want):
            fail(f"{what}: {name} is not bit-equal to index_add_ on the CPU "
                 f"(max abs err {err})")
        b_ms, b_by = table_bound_ms("segsum", R, B, D, n_valid)
        rows[name] = dict(
            shape=dict(R=R, D=D, B=B), max_abs_err=err,
            ms=time_ms(lambda: tg.segment_sum(ids, vals, R, vals_dtype=dtype)),
            device_ms=sum(device_ms(
                lambda: tg.segment_sum(ids, vals, R, vals_dtype=dtype),
                ("segsum_kernel",)).values()) or None,
            plain_ms=host_ms(lambda: tg.segment_sum_plain(ids, vals, R, vals_dtype=dtype),
                             runs=5),
            library_ms=time_ms(lambda: torch.zeros((R, D), device="cuda").index_add_(
                0, ids_long, vals_valid)),
            bound_ms=b_ms, bound_by=b_by)
    for name, row in rows.items():
        log(f"[tables] {what} {name} {json.dumps(row)}")
    return rows


def phase_table_kernels(rng):
    """The gather and segment-sum at the training path's shapes (the user
    table 6048 x 64 and the item table 3712 x 65 of BPR embed 64 at ML-1M,
    8192 ids a lookup), a ragged shape with out-of-range and duplicate ids,
    parity/bench_scatter.py's four table sizes in f32 and bf16, and a
    1,000,000-row table. Returns the item-table rows (the main path's)."""
    shapes = [
        ("main path, user table", 6048, 64, 8192, False, True),
        ("main path, item table", 3712, 65, 8192, False, True),
        ("ragged", 131, 33, 77, True, True),
        ("bench_scatter V=3712", 3712, 64, 8192, False, True),
        ("bench_scatter V=6144", 6144, 64, 8192, False, True),
        ("bench_scatter V=16384", 16384, 64, 8192, False, True),
        ("bench_scatter V=131072", 131_072, 64, 8192, False, True),
        ("1M-row table", 1_000_000, 64, 16384, False, False),
    ]
    out = {}
    for what, R, D, B, ragged, bf16 in shapes:
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


# ---------------------------------------------------------------- training
def training_data(rng):
    """The ML-1M-sized planted data as a column dict, split 80/20 per user by
    the port's split_by_ratio, built by DatasetPure: (train, eval, info)."""
    from librecommender_tpu_torch.data import DatasetPure, split_by_ratio

    counts, consumed = ml1m_like(rng)
    users = np.repeat(np.arange(len(counts)), counts) + 1
    items = np.concatenate([consumed[u] for u in range(len(counts))]) + 1
    data = {"user": users, "item": items, "label": np.ones(len(users))}
    train, test = split_by_ratio(data, test_size=0.2)
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


def phase_training(rng, workdir):
    """The training path at full width: BPR(embed_size=64, batch_size=8192)
    on ML-1M-sized data. Returns the main path's kernel launches and the
    per-step numbers."""
    from librecommender_tpu_torch.data import TransformedSet
    from librecommender_tpu_torch.evaluation import evaluate
    from librecommender_tpu_torch.models import BPR
    from librecommender_tpu_torch.ops import table_gather as tg

    t0 = time.perf_counter()
    train, evals, info = training_data(rng)
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
        us = _self_device_us(evt)
        total_us += us
        if evt.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches_cpu += evt.count
        if us > 0:
            by_op[evt.key[:60]] = us / n_batches / 1e3
        for name in GATHER_NAMES:
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
    # saved models live in the checkout (ignored by git) and go at exit
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=here, prefix="smoke_",
                                     suffix="_artifacts") as workdir:
        main_row = phase_serving(rng, workdir)
        phase_catalog(rng)
        train = phase_training(rng, workdir)
    source = "librecommender_tpu_torch/csrc/table_gather.cu"
    item = tables["main path, item table"]
    kernels = [dict(
        name="streaming_topk", route="cuda",
        source="librecommender_tpu_torch/csrc/streaming_topk.cu",
        replaces="librecommender_tpu/ops/pallas_topk.py:37",
        launches=main_row["main_path_launches"],
        max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], device_ms=main_row["device_ms"],
        plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"], shape=main_row["shape"],
    )]
    for name, replaces, launches in (
        ("table_gather", "librecommender_tpu/ops/mxu_gather.py:65",
         train["launches"]["gather"]),
        ("segment_sum", "librecommender_tpu/ops/mxu_gather.py:83",
         train["launches"]["segsum"]),
    ):
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches, **item[name]))
    # the bf16 input type serves parity/bench_scatter.py, not the training
    # path: its launches there are 0, its numbers are at V=3712
    bench = tables["bench_scatter V=3712"]["segment_sum_bf16"]
    kernels.append(dict(name="segment_sum_bf16", route="cuda", source=source,
                        replaces="parity/bench_scatter.py:41",
                        launches=train["launches"]["segsum_bf16"],
                        on_main_path=False, **bench))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
