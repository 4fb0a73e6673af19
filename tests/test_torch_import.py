"""The PyTorch port stands alone: it imports with jax (and pandas, aiohttp)
blocked, pulls in nothing of librecommender_tpu, and its entry points refuse
to fall back to the CPU when no GPU is there and the caller did not ask."""
import subprocess
import sys
import textwrap

import pytest
import torch

_IMPORT_ALL = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    for blocked in ("jax", "jaxlib", "pandas", "aiohttp"):
        sys.modules[blocked] = None
    import librecommender_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(
        m for m in sys.modules
        if m == "librecommender_tpu" or m.startswith("librecommender_tpu.")
    )
    assert not leaked, leaked
    print(len(names))
    """
)


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module of the slice was imported
    assert int(out.stdout.strip()) >= 15


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")


def test_resolve_device_refuses_cpu_fallback():
    from librecommender_tpu_torch import resolve_device

    _no_gpu()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_refuse_cpu_fallback(tmp_path):
    import numpy as np

    from librecommender_tpu_torch.data import DataInfo
    from librecommender_tpu_torch.models import BPR
    from librecommender_tpu_torch.serving import DictStore, create_server

    _no_gpu()
    rows = np.array([[1, 10, 1.0], [2, 11, 1.0], [2, 10, 1.0]])
    info = DataInfo(
        interaction_data=rows, user_consumed={0: [0], 1: [1, 0]},
        user_unique_vals=np.array([1, 2]), item_unique_vals=np.array([10, 11]),
    )
    with pytest.raises(RuntimeError):
        BPR("ranking", info)
    model = BPR("ranking", info, device="cpu")
    model.build_model()
    model.post_fit()
    model.save(tmp_path, "bpr")
    with pytest.raises(RuntimeError):
        BPR.load(tmp_path, "bpr")
    assert BPR.load(tmp_path, "bpr", device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError):
        create_server("model", DictStore())
