"""The table gather's body of the port (``librecommender_tpu_torch/csrc/
gather_rows.cuh``), built with g++ and run on the CPU through
``tests/staged_emulation/cuda_names.h``: one thread per CUDA thread, 16-byte
loads and stores that abort on an address that is not 16-byte aligned.

Two things are held here, where there is no GPU:

- the C launcher's plan (``gather::plan``: grid, vectors a thread has in
  flight, whole 16-byte vectors of output, the floats after them) equals
  the wrapper's
  (``table_gather.gather_plan``), which the bench uses to time probes at
  the kernel's grid;
- the body's output is bit-equal to the plain version
  (``table_gather_plain``) at D = 65, 64, 33, 3, 2 and 1, with int32 and int64
  ids, ids below 0 and past the table, B of 0, 1 and not a multiple of 4
  (floats after the last whole vector), more vectors than the grid's
  threads (its grid-stride loop), a 16-row table, and a table one float
  past a 16-byte boundary (4-byte loads at D = 64). The output starts filled
  with NaN, so a float the body does not write fails the comparison.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from librecommender_tpu_torch.ops import table_gather as tg

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "tests" / "staged_emulation" / "gather_emulation.cpp"
CSRC = ROOT / "librecommender_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the emulation")
    binary = tmp_path_factory.mktemp("gather_emulation") / "gather_emulation"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-pthread", "-I", str(CSRC), str(SOURCE),
         "-o", str(binary)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return binary


# (B, D, sms): the main paths' lookups on a card of 132 multiprocessors
# (BPR's tables, DIN's vocabulary and token table), the other shapes of
# chip_smoke.TABLE_SHAPES, and edge shapes on cards of 1 and 2
PLAN_SHAPES = [
    (8192, 65, 132), (8192, 64, 132), (32_768, 64, 132), (3707, 64, 132),
    (32_768, 65, 132), (77, 33, 132), (16_384, 64, 132), (0, 65, 132),
    (1, 1, 132), (3, 1, 1), (1003, 1, 1), (5000, 65, 1), (777, 33, 2),
    (4099, 3, 7), (1 << 20, 128, 132), (100_000, 2, 114),
]


def test_launcher_plan_matches_the_wrappers_plan(emulation):
    queries = "".join(f"100 {B} {D} {sms}\n" for B, D, sms in PLAN_SHAPES)
    proc = subprocess.run([str(emulation), "plan"], input=queries,
                          capture_output=True, text=True, check=True)
    for line, (B, D, sms) in zip(proc.stdout.splitlines(), PLAN_SHAPES):
        rc, grid, vectors, tail, batch = map(int, line.split())
        want = tg.gather_plan(B, D, sms)
        assert rc == 0, (B, D, sms)
        assert (grid, batch, vectors, tail) == (
            want.grid, want.batch, want.vectors, want.tail), (B, D, sms)
        assert want.threads == tg.GATHER_THREADS
        assert 1 <= grid <= sms * tg.GATHER_BLOCKS_PER_SM
        assert 4 * vectors + tail == B * D


# (R, B, D, sms, int64 ids, table one float past a boundary, ids from, ids
# below)
EMULATED = [
    (100, 5000, 65, 1, False, False, -5, 110),     # 4-byte loads, grid-stride
    (100, 5000, 64, 1, True, False, -5, 110),      # 16-byte loads, grid-stride
    (100, 4999, 64, 2, False, True, 0, 100),       # D = 64 off a boundary
    (50, 777, 33, 2, True, False, -3, 60),         # D = 33, a float after the vectors
    (3712, 8192, 65, 132, False, False, 0, 3712),  # BPR's item table, 520 blocks
    (16, 4096, 64, 132, True, False, 0, 16),       # a 16-row vocabulary
    (7, 1003, 1, 1, False, False, -2, 10),         # D = 1: four rows a vector
    (9, 3001, 2, 3, True, False, -1, 12),          # D = 2
    (11, 2999, 3, 1, False, True, -1, 13),         # D = 3, three floats after
    (131, 77, 33, 132, True, False, -3, 135),      # chip_smoke's ragged shape
    (7, 1, 1, 1, False, False, 0, 7),              # B = 1, D = 1: one float
    (7, 1, 65, 1, True, False, 0, 7),              # B = 1
    (7, 0, 65, 1, False, False, 0, 7),             # no ids
]


@pytest.mark.parametrize("R,B,D,sms,int64,misalign,lo,hi", EMULATED)
def test_emulated_gather_is_bit_equal(emulation, tmp_path, R, B, D, sms, int64,
                                      misalign, lo, hi):
    rng = np.random.default_rng(B * 7 + D)
    ids = rng.integers(lo, hi, B).astype(np.int64 if int64 else np.int32)
    if B > 8:   # ids at the type's ends, and a run of one id
        info = np.iinfo(ids.dtype)
        ids[:3] = (info.min, info.max, R)
        ids[5:B // 4] = ids[5]
    table = rng.standard_normal((R, D), dtype=np.float32)
    ids.tofile(tmp_path / "ids.bin")
    table.tofile(tmp_path / "table.bin")
    proc = subprocess.run(
        [str(emulation), "run", str(tmp_path), str(R), str(B), str(D), str(sms),
         str(int(int64)), str(int(misalign))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rc, grid, form, batch = map(int, proc.stdout.split())
    plan = tg.gather_plan(B, D, sms)
    assert rc == 0 and (grid, batch) == (plan.grid, plan.batch)
    assert form == (0 if D % 4 == 0 and not misalign else 1 if D >= 4 else 2)
    out = torch.from_numpy(np.fromfile(tmp_path / "out.bin", np.float32)).view(B, D)
    want = tg.table_gather_plain(torch.from_numpy(table), torch.from_numpy(ids))
    assert torch.equal(out, want)
