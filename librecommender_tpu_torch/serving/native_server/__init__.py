"""The runner of the C++ interpreter for the port's native programs.

Counterpart of ``build_interp_cli`` in
``librecommender_tpu/serving/native_server/__init__.py``. The runner
(``csrc/interp_cli.cpp`` over ``csrc/jaxpr_interp.hpp``, the port's copies of
the JAX package's sources) loads a ``{name}.program.json`` and its
``{name}.blob.bin`` (``serving/native_program.py``), reads the inputs from
files, runs the program and writes the outputs; it is built with ``g++`` and
the JAX package's flags at first use into ``librecommender_tpu_torch/build/``,
keyed on the sources' hash (``ops/_build.build_host_program``). A failed
build raises.

The native HTTP server that runs these programs in-process is not ported yet.
"""
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ...ops._build import build_host_program


def build_interp_cli():
    """The runner's executable, built on first use."""
    return build_host_program("interp_cli", headers=("jaxpr_interp.hpp",))


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
