"""DataInfo: id maps, feature tables, consumed lists and the popular-item
order, in numpy.

Counterpart of ``librecommender_tpu/data/data_info.py``, with ``OldInfo``
and ``store_old_info`` (the snapshot ``merge_trainset`` keeps for
``rebuild_model``). ``save``/``load`` write and read the same
files as the JAX package, so either package loads the other's DataInfo. The
interaction table is an ``(n, 3)`` array of (user, item, label) rows, not a
pandas DataFrame; ``InteractionData`` gives it the ``.user`` / ``.item`` /
``.label`` columns the models read.
"""
import inspect
import json
from collections import namedtuple
from dataclasses import dataclass, fields
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Iterable, List

import numpy as np

from .columns import column, column_names, last_rows

Feature = namedtuple("Feature", ["name", "index"])

EmptyFeature = Feature(name=[], index=[])


@dataclass
class MultiSparseInfo:
    """Info of multi-sparse fields: offsets into the expanded sparse columns,
    field sizes, per-field OOV index, and padding values."""

    field_offset: Iterable[int]
    field_len: Iterable[int]
    feat_oov: np.ndarray
    pad_val: Dict[str, Any]


class InteractionData:
    """(n, 3) interaction rows with (user, item, label) column access."""

    def __init__(self, rows):
        rows = rows.rows if isinstance(rows, InteractionData) else np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] != 3:
            raise ValueError(f"interaction data must be (n, 3), got {rows.shape}")
        self.rows = rows

    @property
    def user(self):
        return self.rows[:, 0]

    @property
    def item(self):
        return self.rows[:, 1]

    @property
    def label(self):
        return self.rows[:, 2]

    def __len__(self):
        return len(self.rows)

    def to_numpy(self):
        return self.rows


class DataInfo:
    """Id mappings, consumed lists and unique feature tables.

    The constructor takes the JAX package's arguments, in its order, so the
    saved npz has the same keys. ``user_sparse_unique``/``item_sparse_unique``
    and the dense tables get one trailing OOV row (:meth:`add_oovs`).
    """

    def __init__(
        self,
        col_name_mapping=None,
        interaction_data=None,
        user_sparse_unique=None,
        user_dense_unique=None,
        item_sparse_unique=None,
        item_dense_unique=None,
        user_consumed=None,
        item_consumed=None,
        user_unique_vals=None,
        item_unique_vals=None,
        sparse_unique_vals=None,
        sparse_offset=None,
        sparse_oov=None,
        multi_sparse_unique_vals=None,
        multi_sparse_combine_info=None,
        seed=42,
    ):
        self.all_args = {
            k: v for k, v in locals().items() if k not in ("self", "__class__")
        }
        self.col_name_mapping = col_name_mapping
        self.interaction_data = (
            None if interaction_data is None else InteractionData(interaction_data)
        )
        self.user_sparse_unique = user_sparse_unique
        self.user_dense_unique = user_dense_unique
        self.item_sparse_unique = item_sparse_unique
        self.item_dense_unique = item_dense_unique
        self.user_consumed = user_consumed
        self.item_consumed = item_consumed
        self.user_unique_vals = user_unique_vals
        self.item_unique_vals = item_unique_vals
        self.sparse_unique_vals = sparse_unique_vals
        self.sparse_offset = sparse_offset
        self.sparse_oov = sparse_oov
        self.multi_sparse_unique_vals = multi_sparse_unique_vals
        self.multi_sparse_combine_info = multi_sparse_combine_info
        self.seed = seed
        self.sparse_idx_mapping = DataInfo.map_sparse_vals(
            sparse_unique_vals, multi_sparse_unique_vals
        )
        self.np_rng = np.random.default_rng(seed)
        self._user2id = None
        self._item2id = None
        self._id2user = None
        self._id2item = None
        self._popular_items = None
        self.old_info = None  # set by merge_trainset, for rebuild_model
        self.add_oovs()

    # bumped on every assign_*_features, so that models rebuild their device
    # copies of the unique feature tables (FeatureTables snapshots it)
    feature_version = 0

    def assign_user_features(self, user_data):
        """Update stored user feature rows from a column mapping with a
        ``user`` column (the last row of a repeated user wins)."""
        self._assign_features(user_data, "user")

    def assign_item_features(self, item_data):
        """Update stored item feature rows from a column mapping with an
        ``item`` column (the last row of a repeated item wins)."""
        self._assign_features(item_data, "item")

    def _assign_features(self, data, side):
        from ..feature.update import (
            get_row_id_masks,
            update_new_dense_feats,
            update_new_sparse_feats,
        )

        if side not in column_names(data):
            raise ValueError(f"Data must contain `{side}` column.")
        self.feature_version += 1
        data = last_rows(data, side)
        row_idx, id_mask = get_row_id_masks(
            column(data, side), getattr(self, f"{side}_unique_vals"))
        sparse = f"{side}_sparse_unique"
        setattr(self, sparse, update_new_sparse_feats(
            data, row_idx, id_mask, getattr(self, sparse),
            self.sparse_unique_vals, self.multi_sparse_unique_vals,
            getattr(self, f"{side}_sparse_col"), self.col_name_mapping,
            self.sparse_offset,
        ))
        dense = f"{side}_dense_unique"
        setattr(self, dense, update_new_dense_feats(
            data, row_idx, id_mask, getattr(self, dense),
            getattr(self, f"{side}_dense_col"),
        ))

    @staticmethod
    def map_sparse_vals(sparse_unique_vals, multi_sparse_unique_vals):
        """``{column: {raw value: ordinal index}}`` over both kinds of sparse
        column, or None without sparse features."""
        if sparse_unique_vals is None and multi_sparse_unique_vals is None:
            return None
        mapping = {}
        for uniques in (sparse_unique_vals, multi_sparse_unique_vals):
            if uniques is not None:
                for col, vals in uniques.items():
                    mapping[col] = {v: i for i, v in enumerate(vals)}
        return mapping

    # ------------------------------------------------------------------ stats
    @property
    def global_mean(self):
        return self.interaction_data.label.mean()

    @property
    def min_max_rating(self):
        return self.interaction_data.label.min(), self.interaction_data.label.max()

    @property
    def n_users(self):
        return len(self.user_unique_vals)

    @property
    def n_items(self):
        return len(self.item_unique_vals)

    @property
    def data_size(self):
        return len(self.interaction_data)

    def __repr__(self):
        density = 100 * self.data_size / (self.n_users * self.n_items)
        return (
            f"n_users: {self.n_users}, n_items: {self.n_items}, "
            f"data density: {density:.4f} %"
        )

    # ------------------------------------------------------------- column info
    def _feature(self, family):
        if not self.col_name_mapping or family not in self.col_name_mapping:
            return EmptyFeature
        return Feature(
            name=list(self.col_name_mapping[family].keys()),
            index=list(self.col_name_mapping[family].values()),
        )

    @property
    def sparse_col(self):
        return self._feature("sparse_col")

    @property
    def dense_col(self):
        return self._feature("dense_col")

    @property
    def user_sparse_col(self):
        return self._feature("user_sparse_col")

    @property
    def user_dense_col(self):
        return self._feature("user_dense_col")

    @property
    def item_sparse_col(self):
        return self._feature("item_sparse_col")

    @property
    def item_dense_col(self):
        return self._feature("item_dense_col")

    # ---------------------------------------------------------------- id maps
    @property
    def user2id(self):
        if self._user2id is None:
            self._user2id = {u: i for i, u in enumerate(self.user_unique_vals)}
        return self._user2id

    @property
    def item2id(self):
        if self._item2id is None:
            self._item2id = {v: i for i, v in enumerate(self.item_unique_vals)}
        return self._item2id

    @property
    def id2user(self):
        if self._id2user is None:
            self._id2user = {i: u for u, i in self.user2id.items()}
        return self._id2user

    @property
    def id2item(self):
        if self._id2item is None:
            self._id2item = {i: v for v, i in self.item2id.items()}
        return self._id2item

    def add_oovs(self):
        """Append one OOV row to every unique feature table: each sparse
        column's OOV index, or the dense column mean."""

        def _concat_oov(uniques, cols=None):
            if uniques is None:
                return None
            oov = self.sparse_oov[cols] if cols else np.mean(uniques, axis=0)
            return np.vstack([uniques, oov])

        self.user_sparse_unique = _concat_oov(
            self.user_sparse_unique, self.user_sparse_col.index
        )
        self.item_sparse_unique = _concat_oov(
            self.item_sparse_unique, self.item_sparse_col.index
        )
        self.user_dense_unique = _concat_oov(self.user_dense_unique)
        self.item_dense_unique = _concat_oov(self.item_dense_unique)

    # ------------------------------------------------------------ cold start
    @property
    def popular_items(self):
        if self._popular_items is None:
            self._popular_items = self._get_popular_items(100)
        return self._popular_items

    def _get_popular_items(self, num):
        """Items by distinct-user count, most first, in the JAX package's
        order: its pandas ``groupby("item").count()`` lists items sorted,
        and ``sort_values(ascending=False)`` (``nargsort``, quicksort) sorts
        the reversed counts ascending and reverses the result."""
        users, items = self.interaction_data.user, self.interaction_data.item
        _, u_code = np.unique(users, return_inverse=True)
        item_vals, i_code = np.unique(items, return_inverse=True)
        pairs = np.unique(u_code.astype(np.int64) * len(item_vals) + i_code)
        counts = np.bincount(pairs % len(item_vals), minlength=len(item_vals))
        order = np.arange(len(counts))[::-1][counts[::-1].argsort(kind="quicksort")]
        selected = item_vals[order[::-1]].tolist()[:num]
        if len(selected) < num and self.old_info is not None:
            selected.extend(self.old_info.popular_items[: num - len(selected)])
        return selected

    # ------------------------------------------------------------- persistence
    def save(self, path, model_name):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        if self.col_name_mapping is not None:
            with open(path / f"{model_name}_data_info_name_mapping.json", "w") as f:
                json.dump(self.col_name_mapping, f, separators=(",", ":"), indent=4)
        # consumed dicts {inner_id: [inner ids]} persist as CSR npz
        for attr in ("user_consumed", "item_consumed"):
            consumed = getattr(self, attr)
            if consumed is not None:
                keys = np.fromiter(consumed.keys(), np.int64, len(consumed))
                indptr = np.zeros(len(consumed) + 1, np.int64)
                chunks = []
                for i, k in enumerate(keys):
                    vals = np.asarray(consumed[k], np.int64)
                    chunks.append(vals)
                    indptr[i + 1] = indptr[i] + len(vals)
                indices = (
                    np.concatenate(chunks) if chunks else np.empty(0, np.int64)
                )
                np.savez(
                    path / f"{model_name}_{attr}.npz",
                    keys=keys, indptr=indptr, indices=indices,
                )

        arrays = {}
        arg_names = inspect.signature(self.__init__).parameters.keys()
        for arg in arg_names:
            val = self.all_args.get(arg)
            if arg in ("col_name_mapping", "user_consumed", "item_consumed") or val is None:
                continue
            if arg == "interaction_data":
                arrays[arg] = self.interaction_data.to_numpy()
            elif arg == "sparse_unique_vals":
                for col, vals in val.items():
                    arrays["unique_" + str(col)] = np.asarray(vals)
            elif arg == "multi_sparse_unique_vals":
                for col, vals in val.items():
                    arrays["munique_" + str(col)] = np.asarray(vals)
            elif arg == "multi_sparse_combine_info":
                # npz pickles this object; a plain namespace of the four
                # fields loads in either package without importing the other
                arrays[arg] = SimpleNamespace(
                    **{f.name: getattr(val, f.name) for f in fields(MultiSparseInfo)}
                )
            else:
                arrays[arg] = val
        np.savez_compressed(path / f"{model_name}_data_info", **arrays)

    @classmethod
    def load(cls, path, model_name):
        path = Path(path)
        if not path.exists():
            raise OSError(f"file folder {path} doesn't exist...")
        kwargs = {}
        name_mapping_path = path / f"{model_name}_data_info_name_mapping.json"
        if name_mapping_path.exists():
            with open(name_mapping_path) as f:
                kwargs["col_name_mapping"] = json.load(f)
        for attr in ("user_consumed", "item_consumed"):
            p = path / f"{model_name}_{attr}.npz"
            if p.exists():
                with np.load(p) as csr:
                    keys, indptr, idx = csr["keys"], csr["indptr"], csr["indices"]
                kwargs[attr] = {
                    int(k): idx[indptr[i]:indptr[i + 1]].tolist()
                    for i, k in enumerate(keys)
                }
        # raw ids that are strings, and the multi-sparse info, are saved as
        # object arrays, which npz stores pickled: the format both packages
        # share requires it (a multi-sparse DataInfo saved by the JAX package
        # unpickles that package's class, so it loads only where it is
        # installed)
        info = dict(np.load(path / f"{model_name}_data_info.npz", allow_pickle=True))
        for arg, val in info.items():
            if arg == "multi_sparse_combine_info":
                obj = val.item()
                kwargs[arg] = MultiSparseInfo(
                    *(getattr(obj, f.name) for f in fields(MultiSparseInfo))
                )
            elif arg == "seed":
                kwargs[arg] = val.item()
            elif arg.startswith("unique_"):
                kwargs.setdefault("sparse_unique_vals", {})[arg[7:]] = val
            elif arg.startswith("munique_"):
                kwargs.setdefault("multi_sparse_unique_vals", {})[arg[8:]] = val
            else:
                kwargs[arg] = val
        return cls(**kwargs)


@dataclass
class OldInfo:
    """Snapshot of the previous DataInfo, used by ``rebuild_model`` to graft
    old embedding rows into a model built on an enlarged vocabulary."""

    n_users: int
    n_items: int
    sparse_len: List[int]
    sparse_oov: List[int]
    popular_items: List[Any]


def store_old_info(data_info):
    sparse_len, sparse_oov = [], []
    sparse_unique = data_info.sparse_unique_vals
    multi_sparse_unique = data_info.multi_sparse_unique_vals
    for i, col in enumerate(data_info.sparse_col.name):
        if sparse_unique is not None and col in sparse_unique:
            sparse_len.append(len(sparse_unique[col]))
            sparse_oov.append(data_info.sparse_oov[i])
        elif multi_sparse_unique is not None and col in multi_sparse_unique:
            sparse_len.append(len(multi_sparse_unique[col]))
            sparse_oov.append(data_info.sparse_oov[i])
        elif (
            multi_sparse_unique is not None
            and "multi_sparse" in data_info.col_name_mapping
            and col in data_info.col_name_mapping["multi_sparse"]
        ):
            # sub-columns after the first in a multi-sparse field are redundant
            sparse_len.append(-1)
    return OldInfo(
        data_info.n_users,
        data_info.n_items,
        sparse_len,
        sparse_oov,
        data_info.popular_items,
    )
