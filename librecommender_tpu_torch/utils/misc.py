"""Small shared helpers: colored printing and block timing.

Counterpart of ``colorize`` and ``time_block`` in
``librecommender_tpu/utils/misc.py``.
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
