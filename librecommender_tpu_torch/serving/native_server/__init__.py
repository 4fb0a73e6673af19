"""The native C++ serving tier: its HTTP server, load generator and runner.

Counterpart of ``librecommender_tpu/serving/native_server/__init__.py``. The
sources (``csrc/server.cpp`` over ``csrc/model_runtime.hpp`` and
``csrc/jaxpr_interp.hpp``, ``csrc/benchmark.cpp``, ``csrc/interp_cli.cpp``)
are the port's copies of the JAX package's. Each is built with ``g++`` and
the JAX package's flags for it at first use into
``librecommender_tpu_torch/build/``, keyed on the sources' and the flags'
hash (``ops/_build.build_host_program``); a failed build raises.

- ``export_native`` writes the flat binary artifacts the server loads, file
  for file as the JAX package writes them, from a port model's host arrays
  (and with ``programs=True`` its scoring programs,
  ``serving/native_program.py``);
- ``start_native_server`` runs the server on them: it answers
  ``/embed/recommend`` (a scan of the item matrix, or an IVF probe),
  ``/knn/recommend``, and ``/model/recommend`` and ``/online/recommend``
  by running the exported programs in-process, or by a hop to the port's
  HTTP app's ``/candidates`` (``backend=``);
- ``build_benchmark`` builds the keep-alive load generator;
- ``run_program`` runs one program in the interpreter's runner.
"""
import json
import socket
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ...ops._build import CLIENT_FLAGS, SERVER_FLAGS, build_host_program


def build_server():
    """The HTTP server's executable, built on first use."""
    return build_host_program("server", headers=("model_runtime.hpp",
                                                 "jaxpr_interp.hpp"),
                              flags=SERVER_FLAGS)


def build_interp_cli():
    """The runner's executable, built on first use."""
    return build_host_program("interp_cli", headers=("jaxpr_interp.hpp",))


def build_benchmark():
    """The load generator's executable, built on first use. Usage:
    ``benchmark <host> <port> <path> <n_threads> <n_requests> [max_user]``;
    prints one JSON line (n_ok, n_fail, req_per_s, latency percentiles)."""
    return build_host_program("benchmark", flags=CLIENT_FLAGS)


def _host(x, dtype):
    """``x`` (a tensor on any device or an array) as a C-ordered numpy array
    of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype)


def export_native(path, model, ivf=False, n_ivf_clusters=None, n_probe=8,
                  programs=True, tile_size=None, topk_via_interpreter=False,
                  device=None):
    """Write the flat binary artifacts the C++ server loads; returns ``path``.

    Item ids must be integers (MovieLens-style); other id types serve
    through the HTTP app. The files are the JAX package's, key for key and
    byte for byte from the same arrays.

    - ``ivf=True`` also exports an IVF index over the item embeddings
      (``retrieval/ivf.IVFIndex.build`` on ``device``, ``None`` the card;
      ``n_ivf_clusters`` its default where None); the server then answers
      /embed/recommend by probing ``n_probe`` clusters;
    - ``programs=True`` also exports the model's scoring programs
      (``serving/native_program.export_native_programs``, ``tile_size`` its
      tile width), which the server runs in-process for /model and /online;
    - ``topk_via_interpreter=True`` rebuilds the /model static top-K table
      through the server's interpreter (``server --build-topk``), one
      catalog pass a user, so that the table agrees with its live tiled
      scoring to the bit.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    data_info = model.data_info
    if programs:
        from ..native_program import export_native_programs

        export_native_programs(path, model, tile_size=tile_size)
    meta = {"n_items": int(model.n_items), "n_users": int(model.n_users)}
    if ivf:
        from ...retrieval.ivf import IVFIndex

        index = IVFIndex.build(
            _host(model.item_embeds_np, np.float32)[: model.n_items],
            n_clusters=n_ivf_clusters, seed=getattr(model, "seed", 0),
            device=device,
        )
        cent = _host(index.centroids, np.float32)
        lists = _host(index.lists, np.int32)
        np.asarray(cent.shape, np.int64).tofile(path / "ivf_centroids_shape.bin")
        cent.tofile(path / "ivf_centroids.bin")
        np.asarray(lists.shape, np.int64).tofile(path / "ivf_lists_shape.bin")
        lists.tofile(path / "ivf_lists.bin")
        meta["ivf_n_probe"] = int(n_probe)

    with open(path / "user2id.json", "w") as f:
        json.dump({str(u): int(i) for u, i in data_info.user2id.items()}, f)
    id2item = np.asarray(
        [int(data_info.id2item[i]) for i in range(model.n_items)], np.int64
    )
    id2item.tofile(path / "id2item_ints.bin")

    # consumed lists as CSR
    indptr = [0]
    indices = []
    for u in range(model.n_users):
        consumed = data_info.user_consumed.get(u, [])
        indices.extend(int(i) for i in consumed)
        indptr.append(len(indices))
    np.asarray(indptr, np.int64).tofile(path / "consumed_indptr.bin")
    np.asarray(indices, np.int32).tofile(path / "consumed_indices.bin")

    if getattr(model, "user_embeds_np", None) is not None:
        ue = _host(model.user_embeds_np, np.float32)
        ie = _host(model.item_embeds_np, np.float32)
        np.asarray(ue.shape, np.int64).tofile(path / "user_embed_shape.bin")
        ue.tofile(path / "user_embed.bin")
        np.asarray(ie.shape, np.int64).tofile(path / "item_embed_shape.bin")
        ie.tofile(path / "item_embed.bin")
    if getattr(model, "sim_ids", None) is not None:
        sim_ids = _host(model.sim_ids, np.int32)
        np.asarray(sim_ids.shape, np.int64).tofile(path / "sims_shape.bin")
        sim_ids.tofile(path / "sim_ids.bin")
        _host(model.sim_vals, np.float32).tofile(path / "sim_vals.bin")
        meta["cf_mode"] = model.cf_mode
        inter = model.interaction
        _host(inter.indptr, np.int64).tofile(path / "inter_indptr.bin")
        _host(inter.indices, np.int32).tofile(path / "inter_indices.bin")
        _host(inter.data, np.float32).tofile(path / "inter_data.bin")
    with open(path / "native_meta.json", "w") as f:
        json.dump(meta, f)
    if topk_via_interpreter and programs:
        subprocess.run([str(build_server()), str(path), "--build-topk"],
                       check=True, capture_output=True)
    return path


def free_port():
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_native_server(artifact_dir, port=None, n_threads=4, timeout=10.0,
                        backend=None):
    """Launch the server on ``artifact_dir``; returns (process, port) once it
    accepts connections. Stop it with ``process.kill()`` and
    ``process.wait()``.

    ``backend``: optional ``(host, port)`` of the port's HTTP app
    (``serving/app.py``, kind model or online): the server then answers
    /model/recommend and /online/recommend of artifacts without programs by
    asking its ``/candidates`` for ``n_rec`` plus the user's consumed count
    and dropping the consumed ones."""
    binary = build_server()
    port = port or free_port()
    cmd = [str(binary), str(artifact_dir), str(port), str(n_threads)]
    if backend is not None:
        cmd += [str(backend[0]), str(backend[1])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.5):
                return proc, port
        except OSError:
            if proc.poll() is not None:
                out = proc.stdout.read()
                raise RuntimeError(f"native server died: {out}")
            time.sleep(0.05)
    proc.kill()
    proc.wait()
    raise TimeoutError("native server did not start")


def run_program(path, name, *inputs, cli=None, reps=1, timeout=600):
    """Run ``{name}.program.json`` of ``path`` on ``inputs`` with the runner
    (``cli``: a runner's path, default this package's).

    Inputs go in as the program declares them: float32 rows, int32 ids.
    Returns (outputs, stderr): float outputs as float32, integer ones as
    int64 arrays. ``reps`` > 1 runs the program that many times, and the
    runner prints its mean time on stderr (``exec_us_per_rep``)."""
    cli = build_interp_cli() if cli is None else cli
    path = Path(path)
    with tempfile.TemporaryDirectory(prefix="interp_io_") as io_dir:
        io = Path(io_dir)
        for k, a in enumerate(inputs):
            arr = np.asarray(a)
            arr = arr.astype(np.float32 if arr.dtype.kind == "f" else np.int32)
            arr.tofile(io / f"input_{k}.bin")
        cmd = [str(cli), str(path / f"{name}.program.json"),
               str(path / f"{name}.blob.bin"), str(io)]
        if reps > 1:
            cmd.append(str(reps))
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"interp_cli failed on {name} ({res.returncode}): "
                               f"{res.stderr}")
        meta = json.loads((io / "outputs.json").read_text())
        outs = [
            np.fromfile(io / f"output_{k}.bin",
                        dtype=np.float32 if m["dtype"] == "f32" else np.int64
                        ).reshape(m["shape"])
            for k, m in enumerate(meta)
        ]
    return outs, res.stderr
