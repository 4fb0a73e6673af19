"""Checks run before training, unknown-id detection, the sequence-mode
contract and the feature fields' sizes.

Counterpart of ``librecommender_tpu/utils/validate.py``.
"""
import numpy as np

from .misc import colorize


def check_unknown(model, user, item):
    """Positions whose user or item is the OOV id (``n_users`` /
    ``n_items``): (count, sorted positions, user, item)."""
    unknown = sorted(set(np.where(user == model.n_users)[0])
                     | set(np.where(item == model.n_items)[0]))
    if unknown:
        print(colorize(f"Detect {len(unknown)} unknown interaction(s), "
                       f"position: {unknown}", "red"))
    return len(unknown), unknown, user, item


def check_unknown_user(data_info, user, inner_id=False):
    """Split users into known inner ids and unknown (cold) users."""
    known_user_ids, unknown_users = [], []
    users = [user] if np.isscalar(user) else user
    for u in users:
        if inner_id:
            if 0 <= u < data_info.n_users:
                known_user_ids.append(u)
            else:
                unknown_users.append(u)
        elif u in data_info.user2id:
            known_user_ids.append(data_info.user2id[u])
        else:
            print(colorize(f"Detect unknown user: {u}", "red"))
            unknown_users.append(u)
    return known_user_ids, unknown_users


def check_seq_mode(recent_num, random_num):
    """("recent" | "random", sequence length) from a sequence model's
    ``recent_num`` / ``random_num``; recent 10 when both are None."""
    for name, num in (("recent", recent_num), ("random", random_num)):
        if num is not None:
            if not isinstance(num, int):
                raise TypeError(f"{name}_num must be integer")
            return name, num
    return "recent", 10


def sparse_feat_size(data_info):
    """Total size of the flat sparse-embedding index space (incl. OOV rows)."""
    sizes = []
    if data_info.user_sparse_unique is not None:
        sizes.append(np.max(data_info.user_sparse_unique))
    if data_info.item_sparse_unique is not None:
        sizes.append(np.max(data_info.item_sparse_unique))
    return int(max(sizes)) + 1 if sizes else 0


def check_sparse_indices(data_info):
    return bool(data_info.sparse_col.name)


def check_dense_values(data_info):
    return bool(data_info.dense_col.name)


def sparse_field_size(data_info):
    return len(data_info.sparse_col.name)


def dense_field_size(data_info):
    return len(data_info.dense_col.name)


def check_multi_sparse(data_info, multi_sparse_combiner):
    """The combiner a model uses for multi-sparse fields: the given one
    where the data has such fields, else "normal"."""
    if data_info.multi_sparse_combine_info and multi_sparse_combiner is not None:
        if multi_sparse_combiner not in ("normal", "sum", "mean", "sqrtn"):
            raise ValueError(
                f"unsupported multi_sparse_combiner type: {multi_sparse_combiner}"
            )
        return multi_sparse_combiner
    return "normal"


def check_fitting(model, train_data, eval_data, neg_sampling, k):
    check_neg_sampling(model, neg_sampling)
    check_labels(model, train_data.labels, neg_sampling)
    check_retrain_loaded_model(model)
    check_eval(eval_data, k, model.n_items)


def check_neg_sampling(model, neg_sampling):
    if not isinstance(neg_sampling, bool):
        raise TypeError(
            f"`neg_sampling` in `fit()` must be bool, got `{neg_sampling}`. "
            f"Set `model.fit(..., neg_sampling=True)` if your data is implicit"
            f"(i.e., `task` is ranking) and ONLY contains positive labels. "
            f"Otherwise, negative sampling is not needed."
        )
    if model.task == "rating" and neg_sampling:
        raise ValueError("`rating` task should not use negative sampling")
    if is_listwise_training(model):
        if neg_sampling:
            raise ValueError(
                f"listwise loss (`{model.loss_type}`) samples negatives "
                f"internally; use `neg_sampling=False`"
            )
        return
    if (
        hasattr(model, "loss_type")
        and model.loss_type in ("bpr", "max_margin")
        and not neg_sampling
    ):
        raise ValueError(f"`{model.loss_type}` loss must use negative sampling.")
    sampler = getattr(model, "sampler", "random")
    if (
        model.task == "ranking"
        and getattr(model, "loss_type", "") == "focal"
        and (not neg_sampling or sampler is None)
    ):
        raise ValueError(
            "`focal` loss requires negative sampling with a valid sampler"
        )
    allowed = ("random", "popular", "unconsumed")
    if getattr(model, "graph_paradigm", None) == "i2i":
        # walk-pair negatives may also be other rows' positives
        allowed = ("random", "popular", "out-batch")
    if neg_sampling and sampler not in allowed:
        raise ValueError(
            f"unknown sampler for negative sampling: {sampler!r}; "
            f"choose one of {allowed}"
        )


def check_labels(model, labels, neg_sampling):
    if is_listwise_training(model):
        return  # implicit positives; labels unused
    if model.task == "ranking" and not neg_sampling:
        unique_labels = np.unique(labels)
        if (
            len(unique_labels) != 2
            or min(unique_labels) != 0.0
            or max(unique_labels) != 1.0
        ):
            raise ValueError(
                f"For `ranking` task without negative sampling, labels in data "
                f"must be 0 and 1, got unique labels: {unique_labels}"
            )


def check_retrain_loaded_model(model):
    if getattr(model, "loaded", False):
        raise RuntimeError(
            "Loaded model doesn't support retraining, use `rebuild_model` instead. "
            "Or construct a new model from scratch."
        )


def check_eval(eval_data, k, n_items):
    if eval_data is not None and k > n_items:
        raise ValueError(f"eval `k` {k} exceeds num of items {n_items}")


def is_listwise_training(model):
    # item-to-item graph models take the listwise batches (positives only;
    # walk pairs and negatives drawn on the device) but train on sampled
    # negatives
    return (getattr(model, "paradigm", "") == "listwise"
            and getattr(model, "graph_paradigm", None) != "i2i")
