"""Small shared helpers: colored printing, timing, parameter counting and
the tables' row alignment.

Counterpart of ``colorize``, ``time_func``, ``time_block`` and
``count_params`` in ``librecommender_tpu/utils/misc.py`` and of
``aligned_rows`` in ``librecommender_tpu/parallel/mesh.py``.
"""
import functools
import math
import time
from contextlib import contextmanager

from .save_load import flatten_tree

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


def time_func(func):
    """Decorator printing a function's elapsed wall-clock time."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        try:
            return func(*args, **kwargs)
        finally:
            elapsed = time.perf_counter() - start
            print(colorize(f"{func.__name__} elapsed: {elapsed:.3f}s", "green"))

    return wrapper


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


def count_params(params):
    """Print and return the number of scalars in ``params``: a module (such
    as a model's ``net``) or a tree of dicts and lists of arrays or tensors."""
    if hasattr(params, "parameters"):
        leaves = list(params.parameters())
    else:
        leaves = list(flatten_tree(params).values())
    total = sum(math.prod(leaf.shape) for leaf in leaves)
    print(colorize(f"total params: {total:,}", "cyan"))
    return total


# Table rows are rounded up to this multiple (the JAX package's ROW_ALIGN),
# so saved parameters have the same shapes in both packages.
ROW_ALIGN = 8


def aligned_rows(n_ids):
    """Table rows for ``n_ids`` real ids + 1 OOV row, aligned to ROW_ALIGN."""
    return -(-(n_ids + 1) // ROW_ALIGN) * ROW_ALIGN
