#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (librecommender_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero when it fails:
  0. the card (nvidia-smi) and the kernel build from csrc/ by nvcc;
  1. the streaming top-k kernel against its plain PyTorch version at fixed
     shapes, with kernel, plain and torch.topk times (CUDA events, median);
  2. the serving main path: a BPR (embed_size=64) on an ML-1M-sized DataInfo,
     saved, loaded on the GPU and served over HTTP; every rec_list must match
     the same model loaded on the CPU, and the kernel's launch count must rise;
  3. one catalog-scale recommend_user (10,000 users x 1,000,000 items).
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


def device_ms(fn, runs=TIMED_RUNS):
    """Device milliseconds per call in each streaming top-k kernel (pass 1,
    pass 2), from torch.profiler; empty if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        for name in ("topk_pass1", "topk_pass2"):
            if name in evt.key:
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = getattr(evt, "self_cuda_time_total", 0.0)
                split[name] = split.get(name, 0.0) + us / runs / 1e3
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
    from librecommender_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build("streaming_topk", verbose=True)
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
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


def ml1m_like(rng, n_users=6040, n_items=3706, mean_per_user=165):
    """An ML-1M-sized DataInfo (6040 users, 3706 items, about 1M distinct
    interactions, at least 20 per user, popularity falling off by rank)."""
    counts = np.clip(rng.lognormal(np.log(mean_per_user) - 0.5, 1.0, n_users),
                     20, n_items // 2).astype(np.int64)
    pop = 1.0 / (np.arange(n_items) + 10.0) ** 0.9
    pop = pop[rng.permutation(n_items)]
    pop /= pop.sum()
    return _data_info(rng, counts, pop, n_items)


def _data_info(rng, counts, pop, n_items):
    """DataInfo, built with the port's own constructor, of users consuming
    ``counts`` distinct items each, drawn by popularity ``pop`` (uniform
    when None)."""
    from librecommender_tpu_torch.data import DataInfo

    consumed = {u: rng.choice(n_items, int(c), replace=False, p=pop).tolist()
                for u, c in enumerate(counts)}
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
    info = ml1m_like(rng)
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
    info = _data_info(rng, counts, None, n_items)
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

    log(phase_card_and_build())
    phase_kernel(rng)
    # the saved model lives in the checkout (ignored by git) and goes at exit
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=here, prefix="smoke_",
                                     suffix="_artifacts") as workdir:
        main_row = phase_serving(rng, workdir)
    phase_catalog(rng)
    kernel = dict(
        name="streaming_topk", route="cuda",
        source="librecommender_tpu_torch/csrc/streaming_topk.cu",
        replaces="librecommender_tpu/ops/pallas_topk.py:37",
        launches=main_row["main_path_launches"],
        max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], device_ms=main_row["device_ms"],
        plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"], shape=main_row["shape"],
    )
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
