"""The PyTorch port stands alone: it imports with jax, optax, pandas,
scikit-learn, aiohttp and grpc blocked, pulls in nothing of librecommender_tpu, and its entry points refuse
to fall back to the CPU when no GPU is there and the caller did not ask."""
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

_IMPORT_ALL = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    for blocked in ("jax", "jaxlib", "optax", "pandas", "sklearn", "aiohttp",
                    "grpc"):
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
    print(" ".join(names))
    """
)

# the modules the feature and sequence slice added
_FEATURE_SLICE = (
    "bases.feat_base", "bases.seq_base", "batch.sequence",
    "feature.column_mapping", "feature.multi_sparse", "feature.unique",
    "models.din", "ops.embeddings", "ops.features", "ops.nn", "ops.row_scatter",
)
# the modules the rest of the sequence family added
_SEQUENCE_SLICE = ("models.sim", "models.transformer", "models.youtube_ranking")
# the modules the feature family added
_FEATURE_FAMILY = (
    "feature.update", "models.autoint", "models.deepfm", "models.fm",
    "models.ncf", "models.wide_deep", "prediction", "training.optimizers",
)
# the modules the embedding and dynamic-embedding slice added
_EMBED_FAMILY = (
    "bases.dyn_embed_base", "graph", "graph.adjacency", "models.als",
    "models.caser", "models.rnn4rec", "models.svd", "models.svdpp",
    "models.wave_net",
)
# the modules the retrieval and graph slice added
_RETRIEVAL_GRAPH = (
    "bases.graph_base", "models.lightgcn", "models.ngcf", "models.two_tower",
    "models.youtube_retrieval",
)
# the modules the item-to-item graph and word2vec slice added
_SAGE_W2V = (
    "bases.w2v_base", "graph.walks", "models.deepwalk", "models.graphsage",
    "models.item2vec", "models.pinsage", "sampling.skipgram",
)

# the modules the neighbourhood CF and retrain slice added
_CF_RETRAIN = (
    "bases.cf_base", "models.aliases", "models.item_cf", "models.swing",
    "models.user_cf", "ops.swing", "training.opt_state", "training.rebuild",
    "utils.similarities",
)

# the modules the ANN and knn retrieval and host-layer slice added
_RETRIEVAL_HOST = (
    "data.processing", "retrieval", "retrieval.hnsw", "retrieval.ivf",
    "utils.constants", "utils.exceptions",
)

# the modules the HTTP serving tier added
_SERVING_TIER = ("serving.benchmark", "serving.launch", "serving.serialization")


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module of the slices was imported
    names = out.stdout.split()
    assert len(names) >= 98
    for module in (_FEATURE_SLICE + _SEQUENCE_SLICE + _FEATURE_FAMILY + _EMBED_FAMILY
                   + _RETRIEVAL_GRAPH + _SAGE_W2V + _CF_RETRAIN + _RETRIEVAL_HOST
                   + _SERVING_TIER):
        assert f"librecommender_tpu_torch.{module}" in names


def test_cf_models_and_aliases_are_exported():
    """The three neighbourhood models and the four aliases, under the JAX
    package's names."""
    from librecommender_tpu_torch import models

    for name in ("UserCF", "ItemCF", "Swing", "GraphSageDGL", "PinSageDGL",
                 "RsUserCF", "RsItemCF"):
        assert name in models.__all__ and hasattr(models, name)
    assert issubclass(models.RsUserCF, models.UserCF)
    assert issubclass(models.PinSageDGL, models.PinSage)


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


def _small_trainset(feats=False):
    """(train, info) of 1,500 random interactions of 50 users and 80 items,
    with ``feats`` a user and an item sparse feature."""
    from librecommender_tpu_torch.data import DatasetFeat, DatasetPure

    rng = np.random.default_rng(0)
    users, items = rng.integers(0, 50, 1500), rng.integers(0, 80, 1500)
    cols = {"user": users, "item": items, "label": np.ones(1500)}
    if not feats:
        return DatasetPure.build_trainset(cols)
    cols.update(sex=np.array(["m", "f"])[users % 2],
                genre=np.array(["a", "b", "c"])[items % 3])
    return DatasetFeat.build_trainset(cols, user_col=["sex"], item_col=["genre"],
                                      sparse_col=["sex", "genre"], dense_col=[])


@pytest.mark.cuda
@pytest.mark.parametrize("cls,feats,kw,launches", [
    # two layers' neighbour gathers, then the user, positive and negative rows
    ("GraphSage", False, dict(loss_type="cross_entropy"), (5, 5)),
    # and the user and item sparse-feature lookups of the projections
    ("GraphSage", True, dict(loss_type="cross_entropy"), (7, 7)),
    # two layers of both sides' neighbour gathers, then anchors, positives
    # and negatives; the last user layer does not reach the loss, so its
    # gather has no backward
    ("GraphSage", False, dict(loss_type="bpr", paradigm="i2i", num_walks=3,
                              sample_walk_len=2), (7, 6)),
    # two layers' walk-neighbourhood gathers, then the three batch lookups
    ("PinSage", False, dict(loss_type="max_margin"), (5, 5)),
])
def test_sage_step_launches_the_gather_and_segment_sum_kernels(cls, feats, kw,
                                                               launches):
    """A training step's lookups on the card go through the gather kernel,
    their gradient through the segment-sum kernel (``launches``: gathers,
    segment-sums); loss and gradients are the CPU's from the same
    parameters and draws (rtol 1e-4, atol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from librecommender_tpu_torch import models
    from librecommender_tpu_torch.ops import table_gather as tg

    train, info = _small_trainset(feats)
    n = 16
    batch = {"user": torch.as_tensor(train.user_indices[:n]),
             "item": torch.as_tensor(train.item_indices[:n]),
             "label": torch.ones(n), "weight": torch.ones(n),
             "item_neg": torch.as_tensor(train.item_indices[n:2 * n])[:, None]}
    draws, out, init = [], {}, None
    for device in ("cuda", "cpu"):
        model = getattr(models, cls)("ranking", info, embed_size=8, seed=5,
                                     device=device, **kw)
        model.build_model()
        if init is None:
            init = model.params_to_arrays()
        model.params_from_arrays(init)
        model._mxu_lookup = True
        for seam in ("_start_nodes", "_walk_slots", "_neg_proposals"):
            if device == "cuda":   # record the card's draws
                def record(*args, plain=getattr(model, seam)):
                    draws.append(plain(*args))
                    return draws[-1]
                setattr(model, seam, record)
            else:                  # and feed them to the CPU
                setattr(model, seam, lambda *args: fed.pop(0).cpu())
        fed = list(draws)
        tg.reset_launches()
        loss = model.loss_fn(model.net, {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(model.net.values()),
                                    materialize_grads=True)
        if device == "cuda":
            torch.cuda.synchronize()
            assert (tg.gather_launches, tg.segsum_launches) == launches
        out[device] = (loss.item(), [g.cpu() for g in grads])
    assert not fed
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_sgns_step_launches_the_gather_and_segment_sum_kernels():
    """An SGNS fit on the card: three gathers and three segment-sums a step
    (centers, contexts, negatives), two same-seed fits bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from librecommender_tpu_torch.models import Item2Vec
    from librecommender_tpu_torch.ops import table_gather as tg

    train, info = _small_trainset()
    runs = []
    for _ in range(2):
        model = Item2Vec("ranking", info, embed_size=8, window_size=3,
                         batch_size=512, n_epochs=1, device="cuda")
        tg.reset_launches()
        model.fit(train, neg_sampling=True, verbose=0)
        torch.cuda.synchronize()
        steps = -(-len(model._skipgram_pairs(
            model._corpus(), np.random.default_rng(model.seed))[0]) // 512)
        assert (tg.gather_launches, tg.segsum_launches) == (3 * steps, 3 * steps)
        runs.append(model.params_to_arrays())
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k])
