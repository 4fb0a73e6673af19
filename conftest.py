"""Build the JAX package's native libraries once, before pytest-xdist starts
its workers.

``librecommender_tpu.native`` compiles ``_similarities.so`` and ``_hnsw.so``
at first use, keyed on a ``.build_hash`` sidecar. Without this hook every
worker that collects a test module calling ``get_lib()`` finds no current
hash and runs its own ``g++ -o`` on the same path; a worker that loads the
library while another linker rewrites it fails and keeps the numpy fallback
for its whole run. Built here, in the controller (or in a run without
xdist), the sidecars are current when the workers start, and they only load
the libraries.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    from librecommender_tpu.native import get_hnsw_lib, get_lib

    get_lib()
    get_hnsw_lib()
