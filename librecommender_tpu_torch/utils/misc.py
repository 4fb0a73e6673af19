"""Small shared helpers: colored printing, block timing and the tables' row
alignment.

Counterpart of ``colorize`` and ``time_block`` in
``librecommender_tpu/utils/misc.py`` and of ``aligned_rows`` in
``librecommender_tpu/parallel/mesh.py``.
"""
import time
from contextlib import contextmanager

_ANSI = {
    "red": 31,
    "green": 32,
    "yellow": 33,
    "blue": 34,
    "magenta": 35,
    "cyan": 36,
    "white": 37,
}


def colorize(string, color, bold=False, highlight=False):
    """Wrap ``string`` in ANSI color codes (``highlight``: background)."""
    code = _ANSI.get(color, 37)
    if highlight:
        code += 10  # ANSI background color offset
    prefix = f"\033[{'1;' if bold else ''}{code}m"
    return f"{prefix}{string}\033[0m"


@contextmanager
def time_block(block_name="block", verbose=1):
    """Print the wall-clock time a block took (when ``verbose > 0``)."""
    if verbose > 0:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            print(colorize(f"{block_name} elapsed: {elapsed:.3f}s", "green"))
    else:
        yield


# Table rows are rounded up to this multiple (the JAX package's ROW_ALIGN),
# so saved parameters have the same shapes in both packages.
ROW_ALIGN = 8


def aligned_rows(n_ids):
    """Table rows for ``n_ids`` real ids + 1 OOV row, aligned to ROW_ALIGN."""
    return -(-(n_ids + 1) // ROW_ALIGN) * ROW_ALIGN
