"""The bodies of Swing's pair pass (``librecommender_tpu_torch/csrc/
swing_pass.cuh``), built with g++ behind the C interface of ``csrc/swing.cu``
(``tests/staged_emulation/swing_emulation.cpp``) and run on the CPU through
``tests/staged_emulation/cuda_names.h``: one thread per CUDA thread, block
and warp barriers, the warp collectives.

The wrapper's own pipeline (``ops/swing._swing_sums``: the walks, the host's
user chunks and row tasks, the placement, the rows pass) drives them on CPU
tensors, at small shapes that reach every path: lists longer than a warp,
a hot row cut into slices, column tiles, user chunks of a small scratch
budget, a row block, partners in several tiles, no pairs. Each result is held bit for
bit to the int64 sums of the same fixed-point terms computed in numpy, and
those to the plain version (float64 sums of the float32 weights).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from librecommender_tpu_torch.ops import swing

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "tests" / "staged_emulation" / "swing_emulation.cpp"
CSRC = ROOT / "librecommender_tpu_torch" / "csrc"
# SMs the planning assumes for the emulated card
SMS = 2


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the emulation")
    lib = tmp_path_factory.mktemp("swing_emulation") / "libswing_emulation.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-I", str(CSRC),
         str(SOURCE), "-o", str(lib)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return swing._Kernels(ctypes.CDLL(str(lib)))


def _lists(n_users, n_items, density, seed, hot_item=None):
    m = sp.random(n_users, n_items, density=density, random_state=seed,
                  format="lil", dtype=np.float32)
    if hot_item is not None:   # in every user's list
        m[:, hot_item] = 1.0
    m = m.tocsr()
    m.data[:] = 1.0
    return swing.interaction_lists(m, "cpu")


def _fixed_sums(lists, n_items, alpha, begin, end):
    """The pass's int64 sums in numpy: round(float32 w * 2^32) a term, summed
    over each user pair's shared items (int64 products are exact)."""
    ptr, items = lists[0].numpy(), lists[1].numpy()
    n_users = len(ptr) - 1
    x = np.zeros((n_users, n_items), np.int64)
    x[np.repeat(np.arange(n_users), np.diff(ptr)), items] = 1
    out = np.zeros((n_items, n_items), np.int64)
    for u in range(n_users):
        y = x[u] * x[u + 1:]
        c = y.sum(1)
        y, c = y[c >= 2], c[c >= 2]
        if len(c):
            w = np.float32(1.0) / (np.float32(alpha) + c.astype(np.float32))
            terms = np.rint(w.astype(np.float64) * 2.0 ** 32).astype(np.int64)
            out += y.T @ (terms[:, None] * y)
    np.fill_diagonal(out, 0)
    return out[begin:end]


def _check(kernels, lists, n_items, alpha, rows=None):
    begin, end = (0, n_items) if rows is None else rows
    swing.reset_launches()
    got, stats = swing._swing_sums(lists, n_items, alpha, begin, end, kernels, SMS, None)
    want = _fixed_sums(lists, n_items, alpha, begin, end)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = swing.swing_pairs_plain(lists, n_items, alpha, (begin, end)).numpy()
    terms = np.ceil(plain * (alpha + n_items))
    assert (np.abs(want / 2.0 ** 32 - plain) <= 1e-7 * plain + terms * 2.0 ** -32).all()
    return stats


def _launched(chunks):
    return {"walk_count": 1, "walk_write": chunks, "rows": chunks}


@pytest.mark.parametrize("n_users,n_items,density,alpha", [
    (40, 30, 0.2, 1.0), (12, 70, 0.7, 0.5)])
def test_emulated_pass_equals_fixed_point_sums(kernels, n_users, n_items, density,
                                               alpha):
    """One chunk, one tile a row; the second shape's lists and shared items
    run past a warp's 32 lanes."""
    lists = _lists(n_users, n_items, density, 0)
    stats = _check(kernels, lists, n_items, alpha)
    assert stats["chunks"] == 1 and stats["hot_rows"] == 0
    assert swing.kernel_launches == _launched(1)
    assert stats["pairs"] > 0 and stats["tasks"] == int(
        (_fixed_sums(lists, n_items, alpha, 0, n_items) != 0).any(1).sum())


def test_emulated_partner_tiles(kernels, monkeypatch):
    """Partners counted 7 at a time: a user's partners span several tiles,
    each found in the items' user lists by the warp's search."""
    monkeypatch.setattr(swing, "PARTNER_TILE", 7)
    stats = _check(kernels, _lists(45, 30, 0.25, 2), 30, 1.0)
    assert stats["pairs"] > 7 * 45


def test_emulated_hot_row_slices(kernels, monkeypatch):
    """An item in every list: its row's bucket is cut into slices, whose
    partial rows combine by atomics."""
    monkeypatch.setattr(swing, "MIN_SLICE_ADDS", 1)
    stats = _check(kernels, _lists(60, 40, 0.1, 3, hot_item=5), 40, 1.0)
    assert stats["hot_rows"] >= 1 and stats["hot_slices"] > 1


def test_emulated_column_tiles(kernels, monkeypatch):
    """Rows wider than a tile are summed in column tiles, each walking the
    row's bucket again."""
    monkeypatch.setattr(swing, "TILE_COLS", 16)
    stats = _check(kernels, _lists(50, 40, 0.25, 3), 40, 1.0)
    assert stats["col_tiles"] == 3
    assert swing.kernel_launches == _launched(1)


def test_emulated_user_chunks(kernels, monkeypatch):
    """A scratch budget of a few users' lists cuts the users into chunks,
    each adding its rows into the output."""
    monkeypatch.setattr(swing, "SCRATCH_BYTES", 6000)
    stats = _check(kernels, _lists(50, 40, 0.25, 4), 40, 2.0)
    assert stats["chunks"] >= 4
    assert swing.kernel_launches == _launched(stats["chunks"])


def test_emulated_row_block(kernels, monkeypatch):
    """Rows 3:9 of 40: only pairs sharing an item among them are listed, and
    only their rows are filed, in two chunks of users."""
    lists = _lists(50, 40, 0.25, 5)
    whole = _check(kernels, lists, 40, 1.0)
    monkeypatch.setattr(swing, "SCRATCH_BYTES", whole["entries"] * 12 // 2)
    stats = _check(kernels, lists, 40, 1.0, rows=(3, 9))
    assert stats["pairs"] < whole["pairs"] and stats["tasks"] <= 2 * 6
    assert swing.kernel_launches == _launched(stats["chunks"])


def test_emulated_pass_without_pairs(kernels):
    """No user pair shares two items: only the count walk runs, and the
    scores are zero."""
    stats = _check(kernels, _lists(30, 20, 0.02, 6), 20, 1.0)
    assert stats["pairs"] == 0 and stats["chunks"] == 0
    assert swing.kernel_launches == {"walk_count": 1, "walk_write": 0, "rows": 0}
