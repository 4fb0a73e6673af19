"""Serving latency and throughput, from the standard library alone.

    python -m librecommender_tpu_torch.serving.benchmark \\
        --url http://127.0.0.1:8000 --endpoint /embed/recommend \\
        --n-requests 2000 --concurrency 16 --users 1 2 3

Counterpart of ``librecommender_tpu/serving/benchmark.py`` (aiohttp there),
with its flags and its result's keys. ``concurrency`` worker threads post
the payloads in turn with ``http.client`` until ``n_requests`` are
answered; an answer other than 200 raises. A request's latency runs from
opening its connection to reading the whole answer: the server speaks
HTTP/1.0 (``BaseHTTPRequestHandler``'s default) and closes the connection
after each answer, so every request pays a TCP connection set-up on the
host.
"""
import argparse
import http.client
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import urlsplit

import numpy as np

TIMEOUT_S = 120.0   # a request's socket timeout


def _post(parts, body):
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", parts.path or "/", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"POST {parts.path}: HTTP {resp.status} {data[:200]!r}")
    return data


def run_benchmark(url, payloads, n_requests, concurrency):
    """Post ``n_requests`` payloads (in turn from ``payloads``) to ``url``
    from ``concurrency`` threads. Returns ``{"requests", "wall_s", "rps",
    "p50_ms", "p95_ms", "p99_ms"}``."""
    parts = urlsplit(url)
    bodies = [json.dumps(p).encode() for p in payloads]
    turns = iter(range(n_requests))
    lock = threading.Lock()

    def worker():
        latencies = []
        while True:
            with lock:
                idx = next(turns, None)
            if idx is None:
                return latencies
            t0 = time.perf_counter()
            _post(parts, bodies[idx % len(bodies)])
            latencies.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(concurrency) as pool:
        futures = [pool.submit(worker) for _ in range(concurrency)]
        latencies = [x for f in futures for x in f.result()]
    wall = time.perf_counter() - t0
    lat = np.asarray(latencies) * 1000.0
    return {
        "requests": len(lat),
        "wall_s": round(wall, 2),
        "rps": round(len(lat) / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "p99_ms": round(float(np.percentile(lat, 99)), 2),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="http://127.0.0.1:8000")
    parser.add_argument("--endpoint", default="/embed/recommend")
    parser.add_argument("--n-requests", type=int, default=1000)
    parser.add_argument("--concurrency", type=int, default=16)
    parser.add_argument("--n-rec", type=int, default=10)
    parser.add_argument("--users", type=int, nargs="+", default=[1])
    args = parser.parse_args()
    payloads = [{"user": u, "n_rec": args.n_rec} for u in args.users]
    result = run_benchmark(args.url + args.endpoint, payloads, args.n_requests,
                           args.concurrency)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
