"""AOT serving artifacts via ``torch.export``: the SavedModel analog.

Counterpart of ``librecommender_tpu/serving/export_model.py``. The JAX
package exports two scoring entry points as StableHLO programs with a
symbolic batch dimension; here the same entry points of a port model are
exported with ``torch.export`` (a batch ``Dim("b")``) and saved as ``.pt2``:

* ``predict``:   (params, users (b,), items (b,)) -> logits (b,)
* ``score_all``: (params, users (b,)) -> logits (b, n_items)

beside the parameters (``{name}_export_params.npz``, the flat layout of
``utils/save_load.flatten_tree``, the JAX package's keys) and a JSON meta
with the JAX package's keys. ``load_exported`` rebuilds a scorer from those
files alone, with no model class, on the card unless the caller asks for the
CPU, and applies the model's output transform (sigmoid for ranking, the
clip for rating) as ``model.predict`` does. The dynamic-embedding models
(RNN4Rec, Caser, WaveNet, YouTubeRetrieval) export their user tower
``(params, users (b,), seqs (b, L)) -> (b, D)`` instead, beside the item
matrix (``save_exported_dyn`` / ``load_exported_dyn``).

The parameters are program inputs; feature tables, stored histories and
other state the forward reads are lifted into the program as constants, so
an artifact is self-contained. A ``.pt2`` is not a ``.stablehlo``: neither
package loads the other's programs, while the params ``.npz``, the items
``.npz`` and the meta ``.json`` are the same files, key for key.

Every entry point is traced with ``train=False``, where the table lookups of
both packages are plain indexing: the gather and scatter kernels run only in
a fit (the trainer sets ``_mxu_lookup``; ``pallas_grad_scatter`` acts on
gradients), so no ctypes launch sits inside a traced function. Ids go to the
programs as int64, the dtype they were traced with. A traced convolution
(Caser's, WaveNet's ``ops/nn.conv1d``) keeps ``F.conv1d`` but not the
context that holds cuDNN to float32 around it, so the scorers run their
programs inside that context (``ops/nn.cudnn_float32``), as the model
runs its convolutions. ``ExportedDynScorer``
ranks its user vectors against the item matrix through the streaming top-k
(``ops/streaming_topk.py``), one launch a call on the card.
"""
import json
from pathlib import Path

import numpy as np
import torch
from torch.export import Dim
from torch.export.passes import move_to_device_pass

from ..device import resolve_device
from ..ops.nn import cudnn_float32
from ..ops.streaming_topk import streaming_topk
from ..ops.topk import topk_from_scores


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _flat_params(model):
    """The parameters as program inputs: ``{npz key: tensor}``, detached."""
    return {k: v.detach() for k, v in model.net.items()}


def _export(file, fn, args):
    """Export ``fn(params, *batched)`` with a symbolic batch ``b`` on the
    leading dim of every argument after the parameters; save it as ``file``."""
    b = Dim("b")
    params = args[0]
    dynamic = ({k: None for k in params}, *({0: b} for _ in args[1:]))
    with torch.no_grad():
        ep = torch.export.export(_Program(fn), args,
                                 dynamic_shapes={"args": dynamic},
                                 strict=False)
    torch.export.save(ep, file)
    return ep


def _save_params(path, name, params):
    np.savez(path / f"{name}_export_params.npz",
             **{k: v.to("cpu", torch.float32).numpy() for k, v in params.items()})


def _examples(model):
    """Two users (a batch of 2 keeps the batch symbolic in the trace)."""
    return torch.arange(2, dtype=torch.int64, device=model.device)


def save_exported_dyn(path, name, model):
    """Online-serving export for the dynamic-embedding models: the user tower
    ``(params, users (b,), seqs (b, L)) -> (b, D)`` with a symbolic batch,
    plus the item matrix (bias folded in as a last column) and the stored
    recent histories (row ``n_users`` is the cold row)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    model._sync_feature_tables()
    params = _flat_params(model)
    users = _examples(model)
    seqs = model.recent_seq_table[users]

    def user_repr(p, u, s):
        return model._user_repr(model._tree(p), u, s, False)

    _export(path / f"{name}_user_repr.pt2", user_repr, (params, users, seqs))
    _save_params(path, name, params)
    tree = model._tree(params)
    item_repr = model._item_repr(tree)[: model.n_items].to("cpu").numpy()
    bias = model._item_bias(tree)
    if bias is not None:
        item_repr = np.hstack(
            [item_repr, bias[: model.n_items, None].to("cpu").numpy()])
    np.savez(
        path / f"{name}_export_items.npz",
        item_repr=item_repr,
        recent_seq=model.recent_seq_table.to("cpu").numpy().astype(np.int32),
    )
    meta = {
        "model_name": model.model_name,
        "task": model.task,
        "kind": "dyn_embed",
        "n_users": int(model.n_users),
        "n_items": int(model.n_items),
        "max_seq_len": int(model.max_seq_len),
        "pad_id": int(model.pad_id),
        "has_bias": bias is not None,
    }
    (path / f"{name}_export_meta.json").write_text(json.dumps(meta))


def save_exported(path, name, model):
    """Write ``{name}_predict.pt2``, ``{name}_score_all.pt2``,
    ``{name}_export_params.npz`` and ``{name}_export_meta.json``. The
    dynamic-embedding models dispatch to :func:`save_exported_dyn`."""
    if hasattr(model, "dyn_user_embedding"):
        return save_exported_dyn(path, name, model)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    model._sync_feature_tables()
    params = _flat_params(model)
    users = _examples(model)
    n_items = model.n_items

    def predict(p, u, i):
        return model._forward(model._tree(p), {"user": u, "item": i},
                              train=False)

    def score_all(p, u):
        tree = model._tree(p)
        if hasattr(model, "_score_catalog"):
            # the model's catalog scorer shares each user's sequence work
            # across the items
            return model._score_catalog(tree, u)
        logits = model._forward(tree, model._catalog_pair_inputs(u),
                                train=False)
        return logits.reshape(u.shape[0], n_items)

    # two tensors: one passed twice would export as one aliased input
    _export(path / f"{name}_predict.pt2", predict,
            (params, users, users.clone()))
    _export(path / f"{name}_score_all.pt2", score_all, (params, users))
    _save_params(path, name, params)
    meta = {
        "model_name": model.model_name,
        "task": model.task,
        "n_users": int(model.n_users),
        "n_items": int(n_items),
    }
    if model.task == "rating":
        meta["lower_bound"] = float(model.lower_bound)
        meta["upper_bound"] = float(model.upper_bound)
    (path / f"{name}_export_meta.json").write_text(json.dumps(meta))


def _load_program(file, device):
    """An exported program moved to ``device`` as a callable module; raises
    if a tensor of it is left elsewhere."""
    ep = torch.export.load(file)
    ep = move_to_device_pass(ep, device)
    held = [*ep.state_dict.values(),
            *(v for v in ep.constants.values() if isinstance(v, torch.Tensor))]
    stray = {str(t.device) for t in held if t.device != device}
    if stray:
        raise RuntimeError(f"{file}: tensors left on {sorted(stray)}, not {device}")
    return ep.module(), held


def _load_params(path, name, device):
    with np.load(path / f"{name}_export_params.npz") as data:
        return {k: torch.as_tensor(data[k], device=device) for k in data.files}


def _device_of(device):
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Scorer:
    """What both scorers share: the device, the held tensors, id inputs."""

    def _ids(self, ids):
        return torch.as_tensor(np.asarray(ids).reshape(-1), dtype=torch.int64,
                               device=self.device)

    def devices(self):
        """The devices of every tensor the scorer holds (parameters and the
        programs' constants)."""
        return {t.device for t in self._held}


class ExportedScorer(_Scorer):
    """Scores from the AOT artifacts alone (inner ids in, numpy out)."""

    def __init__(self, predict_fn, score_fn, params, meta, device, held):
        self._predict = predict_fn
        self._score_all = score_fn
        self._params = params
        self.meta = meta
        self.device = device
        self._held = [*params.values(), *held]

    def _transform(self, logits):
        if self.meta["task"] == "rating":
            return np.clip(logits.cpu().numpy(), self.meta["lower_bound"],
                           self.meta["upper_bound"])
        return torch.sigmoid(logits).cpu().numpy()

    @torch.no_grad()
    def predict(self, users, items):
        users, items = self._ids(users), self._ids(items)
        with cudnn_float32():
            return self._transform(self._predict(self._params, users, items))

    @torch.no_grad()
    def score_all_tensor(self, users):
        """(b,) user inner ids -> (b, n_items) logits on the device."""
        users = self._ids(users)
        with cudnn_float32():
            return self._score_all(self._params, users)

    def score_all(self, users):
        """(b,) user inner ids -> (b, n_items) raw logits (numpy)."""
        return self.score_all_tensor(users).cpu().numpy()

    def recommend(self, users, n_rec):
        """The top ``n_rec`` inner item ids of each user, best first (ties
        to the lower id)."""
        ids, _ = topk_from_scores(self.score_all_tensor(users), None, int(n_rec))
        return ids.cpu().numpy()


def load_exported(path, name, device=None):
    """An ``ExportedScorer`` from ``save_exported``'s files on ``device``
    (None: the card; raises without one)."""
    path = Path(path)
    device = _device_of(device)
    predict_fn, held_p = _load_program(path / f"{name}_predict.pt2", device)
    score_fn, held_s = _load_program(path / f"{name}_score_all.pt2", device)
    params = _load_params(path, name, device)
    meta = json.loads((path / f"{name}_export_meta.json").read_text())
    return ExportedScorer(predict_fn, score_fn, params, meta, device,
                          held_p + held_s)


class ExportedDynScorer(_Scorer):
    """Scores from the dyn artifacts: the user tower and the item matrix."""

    def __init__(self, repr_fn, params, item_repr, meta, recent_seq, device,
                 held):
        self._repr = repr_fn
        self._params = params
        self.item_repr = item_repr
        self.recent_seq = recent_seq
        self.meta = meta
        self.device = device
        self._held = [*params.values(), item_repr, *held]
        if recent_seq is not None:
            self._held.append(recent_seq)

    @torch.no_grad()
    def user_embedding_tensor(self, users, seqs=None):
        """(b,) inner user ids and optional (b, L) padded inner-id histories
        -> (b, D[+1 bias column]) user vectors on the device. Without
        ``seqs`` the stored recent histories are used (unknown ids get the
        cold row); an items file without them gives every user a history
        of padding, as the JAX package's scorer does."""
        users = self._ids(users)
        if seqs is None and self.recent_seq is not None:
            rows = users.clamp(0, self.recent_seq.shape[0] - 1)
            seqs = self.recent_seq[rows]
        elif seqs is None:
            seqs = torch.full((users.shape[0], self.meta["max_seq_len"]),
                              self.meta["pad_id"], dtype=torch.int64,
                              device=self.device)
        else:
            seqs = torch.as_tensor(np.asarray(seqs), dtype=torch.int64,
                                   device=self.device)
        with cudnn_float32():
            out = self._repr(self._params, users, seqs)
        if self.meta["has_bias"]:
            out = torch.cat([out, out.new_ones((out.shape[0], 1))], dim=1)
        return out

    def user_embedding(self, users, seqs=None):
        return self.user_embedding_tensor(users, seqs).cpu().numpy()

    def score_all(self, users, seqs=None):
        u = self.user_embedding_tensor(users, seqs)
        return (u @ self.item_repr.T).cpu().numpy()

    def recommend(self, users, n_rec, seqs=None):
        """The top ``n_rec`` inner item ids of each user, through the
        streaming top-k of ``U @ item_repr.T`` (one launch on the card)."""
        u = self.user_embedding_tensor(users, seqs)
        ids, _ = streaming_topk(u, self.item_repr, int(n_rec))
        return ids.cpu().numpy()


def load_exported_dyn(path, name, device=None):
    """An ``ExportedDynScorer`` from ``save_exported_dyn``'s files on
    ``device`` (None: the card; raises without one)."""
    path = Path(path)
    device = _device_of(device)
    repr_fn, held = _load_program(path / f"{name}_user_repr.pt2", device)
    params = _load_params(path, name, device)
    with np.load(path / f"{name}_export_items.npz") as data:
        item_repr = torch.as_tensor(data["item_repr"], dtype=torch.float32,
                                    device=device)
        recent_seq = (torch.as_tensor(data["recent_seq"], dtype=torch.int64,
                                      device=device)
                      if "recent_seq" in data else None)
    meta = json.loads((path / f"{name}_export_meta.json").read_text())
    return ExportedDynScorer(repr_fn, params, item_repr, meta, recent_seq,
                             device, held)
