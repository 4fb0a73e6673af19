"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. A library is
built at first use and cached under ``librecommender_tpu_torch/build/``,
keyed on a hash of its source, the headers beside it (``csrc/*.cuh``) and the
flags, so a fresh checkout builds on its first call and later calls load.

Host C++ (``csrc/*.cpp``: the HNSW index) is built beside them by ``g++``
with the JAX package's native flags into the same directory, keyed on a hash
of its source, the compiler and the flags (``build_host`` / ``load_host``);
a host program (the interpreter's runner ``interp_cli``, the HTTP server
``server`` and its load generator ``benchmark``) likewise, keyed on its
source, the headers it includes and its own flags (``build_host_program``).
Every build lands in a file of its own process and is moved into place
whole, so processes that build at once never run or load a part-written
file. A failed build raises: nothing falls back to another path.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# the JAX package's flags for its native C++ (librecommender_tpu/native), so
# that both packages compile the HNSW source alike
GXX = "g++"
HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
              "-std=c++17")

# the JAX package's flags for its interpreter's runner, its HTTP server and
# its load generator (librecommender_tpu/serving/native_server)
PROGRAM_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-fopenmp",
                 "-std=c++17")
SERVER_FLAGS = (*PROGRAM_FLAGS, "-pthread")
CLIENT_FLAGS = ("-O3", "-std=c++17", "-pthread")

_lock = threading.Lock()
_loaded = {}


BUILD_DIR = Path(__file__).resolve().parent.parent / "build"


def find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with the CUDA toolkit "
            "on the machine with the GPU (PATH or /usr/local/cuda/bin)"
        )
    return nvcc


def library_path(name):
    """Path of the shared library for ``csrc/{name}.cu`` at its current hash."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(src.read_bytes() for src in sources)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name, verbose=False):
    """Compile ``csrc/{name}.cu`` unless a library for its hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    tmp = _tmp_path(out)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    stderr = _compile(cmd, f"nvcc failed for {name}.cu")
    if verbose and stderr:
        print(stderr)
    os.replace(tmp, out)
    return out


def host_library_path(name):
    """Path of the shared library for ``csrc/{name}.cpp`` at the hash of its
    source, the compiler and ``HOST_FLAGS``."""
    digest = hashlib.sha256(
        (CSRC / f"{name}.cpp").read_bytes()
        + " ".join((GXX, *HOST_FLAGS)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-host-{digest}.so"


def build_host(name):
    """Compile ``csrc/{name}.cpp`` with ``g++`` unless a library for its hash
    exists; raises if the compiler is missing or fails."""
    out = host_library_path(name)
    if out.exists():
        return out
    tmp = _tmp_path(out)
    cmd = [GXX, *HOST_FLAGS, str(CSRC / f"{name}.cpp"), "-o", str(tmp)]
    try:
        _compile(cmd, f"{GXX} failed for {name}.cpp")
    except FileNotFoundError as err:
        raise RuntimeError(f"{GXX} not found: {name}.cpp is built with the "
                           "host's C++ compiler") from err
    os.replace(tmp, out)
    return out


def host_program_path(name, headers=(), flags=PROGRAM_FLAGS):
    """Path of the executable for ``csrc/{name}.cpp`` at the hash of its
    source, the ``headers`` it includes, the compiler and ``flags``."""
    sources = [CSRC / f"{name}.cpp", *(CSRC / h for h in headers)]
    digest = hashlib.sha256(
        b"".join(src.read_bytes() for src in sources)
        + " ".join((GXX, *flags)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}"


def build_host_program(name, headers=(), flags=PROGRAM_FLAGS):
    """Compile ``csrc/{name}.cpp`` into an executable with ``g++`` and
    ``flags`` unless one for its hash exists; raises if the compiler is
    missing or fails."""
    out = host_program_path(name, headers, flags)
    if out.exists():
        return out
    tmp = _tmp_path(out)
    cmd = [GXX, *flags, str(CSRC / f"{name}.cpp"), "-o", str(tmp)]
    try:
        _compile(cmd, f"{GXX} failed for {name}.cpp")
    except FileNotFoundError as err:
        raise RuntimeError(f"{GXX} not found: {name}.cpp is built with the "
                           "host's C++ compiler") from err
    os.replace(tmp, out)
    return out


def _tmp_path(out):
    """A file beside ``out`` that only this process writes: the build lands
    there, then ``os.replace`` moves it into place whole, so processes that
    build one library at once never load a part-written file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    return out.with_suffix(f".{os.getpid()}.tmp")


def _compile(cmd, what):
    """Run a compiler command; its stderr, or RuntimeError if it failed."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} ({proc.returncode}):\n{proc.stderr}")
    return proc.stderr


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/{name}.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


def load_host(name):
    """The ``ctypes.CDLL`` of ``csrc/{name}.cpp``, built on first use."""
    key = f"{name}.cpp"
    with _lock:
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(str(build_host(name)))
        return _loaded[key]
