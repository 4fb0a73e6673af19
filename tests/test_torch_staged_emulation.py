"""The ordered-add body of the port's segment-sum and scatter-add
(``librecommender_tpu_torch/csrc/staged_add.cuh``), built with g++ and run on
the CPU through ``tests/staged_emulation/cuda_names.h``: one thread per CUDA
thread, block and warp barriers, cp.async copies that land only at the wait
that covers them.

Two things are held here, where there is no GPU:

- the launcher's own count of the workspace and of the shared memory
  (``staged::plan``) equals the wrapper's (``table_gather.staged_form``) at
  every shape the plan tests name, and a buffer one byte short is refused;
- the partition is a stable sort of the valid ids by bucket, and the add's
  result is bit-equal to the plain version (``ordered_add_plain``, with bf16
  rounding ``segment_sum_plain``), at small shapes that reach every path of
  the body: several chunks and one, segments, 256-row tiles, a hot row, rows
  only 4-byte aligned, column tiles, bucket state spilled to the workspace,
  int64 and out-of-range ids, no ids.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from librecommender_tpu_torch.ops import table_gather as tg

from .test_torch_row_scatter import SCATTER_FORMS
from .test_torch_table_gather import SEGSUM_FORMS

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "tests" / "staged_emulation" / "staged_emulation.cpp"
CSRC = ROOT / "librecommender_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the emulation")
    binary = tmp_path_factory.mktemp("staged_emulation") / "staged_emulation"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-pthread", "-I", str(CSRC), str(SOURCE),
         "-o", str(binary)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return binary


def _partitioned_shapes():
    """Every (n_rows, D, N) of the plan tests, partitioned as the wrapper
    would or forced to (the partition takes any shape)."""
    shapes = set(SCATTER_FORMS)
    shapes |= {(R, D, N) for (R, D), by_n in SEGSUM_FORMS.items() for N in by_n}
    return sorted(shapes)


def _plan_query(n_rows, D, N, form, work_bytes):
    _, cols, seg_len, groups = tg.staged_plan(n_rows, D, N)
    return f"{N} {D} {n_rows} {cols} {seg_len} {groups} {form.chunk} {work_bytes}\n"


def test_launcher_plan_matches_the_wrappers_form(emulation):
    """``staged::plan`` counts the same workspace, add and place shared memory,
    buckets and chunks as ``staged_form``, and refuses a workspace one byte
    short of it (N > 0), at every shape of the plan tests."""
    shapes = [s for s in _partitioned_shapes() if s[2] > 0]
    forms = [tg.staged_form(*s, partition=True) for s in shapes]
    queries = "".join(_plan_query(*s, f, f.work_bytes) + _plan_query(*s, f, f.work_bytes - 1)
                      for s, f in zip(shapes, forms))
    proc = subprocess.run([str(emulation), "plan"], input=queries,
                          capture_output=True, text=True, check=True)
    lines = proc.stdout.split("\n")
    for i, (shape, form) in enumerate(zip(shapes, forms)):
        rc, smem, place, count, spill, work, nb, chunks = map(int, lines[2 * i].split())
        assert rc == 0, shape
        assert (smem, place, bool(spill), work, nb, chunks) == (
            form.smem, form.place_smem, not form.on_chip, form.work_bytes,
            form.buckets, form.n_chunks), shape
        assert count == (4 * nb if form.on_chip else 0), shape
        assert int(lines[2 * i + 1].split()[0]) != 0, f"{shape}: a short workspace was taken"


# (n_rows, D, N, ids from, ids below, hot, chunk, groups, bf16, int64,
# misalign): chunk 0 and groups 0 take the plan's; hot > 0 puts that many
# ids on row 3, hot < 0 alternates rows 3 and 19 (two rows of one warp in a
# 256-row tile) over the first -hot ids
EMULATED = [
    (100, 64, 5000, 0, 100, 900, 2048, 0, False, False, False),    # chunks, hot row
    (100, 64, 5000, 0, 100, 300, 2048, 0, True, True, False),      # bf16, int64
    (100, 64, 5000, 0, 100, 1500, 0, 0, False, False, False),      # one chunk, hot
    (70, 65, 3000, 0, 70, 0, 1024, 0, False, False, False),        # D = 65: 4-byte copies
    (80, 64, 3000, 0, 80, 0, 1024, 0, False, False, True),         # 16-byte rows, unaligned
    (50, 33, 4097, -6, 58, 0, 512, 0, False, False, False),        # out of range, segments
    (20, 300, 1500, 0, 20, 200, 512, 0, False, False, False),      # column tiles
    (20, 300, 900, 0, 20, 0, 512, 0, True, False, True),           # column tiles, 4-byte
    (16, 64, 6000, 0, 16, 0, 1024, 0, False, False, False),        # 16 rows: segments
    (40, 16, 4097, 0, 3, 0, 2048, 0, False, False, False),         # a chunk ends in a bucket
    (12, 7, 777, 0, 12, 0, 512, 0, False, False, False),           # D = 7
    (9000, 64, 700, -3, 9003, 40, 512, 16, False, False, False),   # 256-row tiles
    (900, 8, 1200, 0, 900, 0, 512, 4, True, True, False),          # 64-row tiles, bf16
    (900, 64, 1500, 0, 900, -1200, 0, 4, False, False, False),     # two rows of a warp
    (900, 40, 1500, 0, 900, -900, 512, 4, True, True, False),      # the same, bf16
    (20000, 32, 3000, 0, 20000, 2500, 0, 16, False, False, False),  # hot run, 256-row tiles
    (30_000, 4, 13_000, 0, 30_000, 30, 12_288, 1, False, False, False),  # state spilled
    (30_000, 4, 1300, -2, 30_000, 30, 12_288, 1, False, True, False),  # spilled, one chunk
    (12, 7, 0, 0, 12, 0, 0, 0, False, False, False),               # no ids
]


@pytest.mark.parametrize(
    "n_rows,D,N,lo,hi,hot,chunk,groups,bf16,int64,misalign", EMULATED)
def test_emulated_body_is_a_stable_partition_and_bit_equal(
        emulation, tmp_path, n_rows, D, N, lo, hi, hot, chunk, groups, bf16,
        int64, misalign):
    rng = np.random.default_rng(N * 7 + D)
    ids = rng.integers(lo, hi, N).astype(np.int64 if int64 else np.int32)
    if hot > 0:
        ids[(np.arange(min(hot, N)) * 7) % max(N, 1)] = 3
    elif hot < 0:
        ids[:-hot] = np.where(np.arange(-hot) % 3 > 0, 3, 19)
    rows = rng.standard_normal((N, D), dtype=np.float32)
    ids.tofile(tmp_path / "ids.bin")
    rows.tofile(tmp_path / "rows.bin")

    (row_tiles, _, segs), cols, seg_len, plan_groups = tg.staged_plan(n_rows, D, N)
    groups = groups or plan_groups
    tile_rows = tg.TILE * groups
    row_tiles = -(-n_rows // tile_rows)
    nb = segs * row_tiles
    chunk = chunk or tg.staged_form(n_rows, D, N, partition=True).chunk
    _, _, work, _ = tg.partition_layout(N, nb, chunk)
    vec = 4 if D % 4 == 0 and not misalign else 1
    proc = subprocess.run(
        [str(emulation), "run", str(tmp_path), str(N), str(D), str(n_rows),
         str(cols), str(seg_len), str(groups), str(chunk), str(vec), str(int(bf16)),
         str(int(int64)), str(work), str(int(misalign))],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[0]) == 0

    out = torch.from_numpy(np.fromfile(tmp_path / "out.bin", np.float32)).view(n_rows, D)
    ids_t, rows_t = torch.from_numpy(ids), torch.from_numpy(rows)
    want = tg.segment_sum_plain(ids_t, rows_t, n_rows,
                                torch.bfloat16 if bf16 else torch.float32)
    assert torch.equal(out, want)
    if N == 0:
        return
    id64 = ids_t.long()
    valid = (id64 >= 0) & (id64 < n_rows)
    n = torch.arange(N)
    bucket = (n // seg_len) * row_tiles + id64.clamp(0, n_rows - 1) // tile_rows
    order = n[valid][torch.sort(bucket[valid], stable=True).indices]
    pos = torch.from_numpy(np.fromfile(tmp_path / "pos.bin", np.int32)).long()
    sub = torch.from_numpy(np.fromfile(tmp_path / "sub.bin", np.int32)).long()
    bstart = torch.from_numpy(np.fromfile(tmp_path / "bstart.bin", np.int32)).long()
    assert torch.equal(pos, order)
    assert torch.equal(sub, id64[order] % tile_rows)
    want_start = torch.zeros(nb + 1, dtype=torch.long)
    want_start[1:] = torch.cumsum(torch.bincount(bucket[valid], minlength=nb), 0)
    assert torch.equal(bstart, want_start)
