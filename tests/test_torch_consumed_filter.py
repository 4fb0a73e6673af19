"""The consumed filter of the port's ``topk_from_embeddings`` (``ops/topk``)
against the JAX package's and the earlier broadcast form, and its memory.

The filter looks each candidate up in its row's sorted consumed ids, so its
memory grows as users x (fetch + consumed), where the broadcast form it
replaced built a users x fetch x consumed mask on the host (3.7 MB a user at
1800 consumed items). Ids equal exactly; scores rtol 1e-5 against JAX (two
f32 dot products summed in different orders) and bit-equal against the
broadcast form (the same candidates)."""
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

RTOL = 1e-5
N_ITEMS, DIM, N_REC, N_CONSUMED = 3706, 64, 10, 1800
PEAK_LIMIT_MB = 256


def _case(n_users, seed=0):
    """Users and items from a seed, 1800 consumed items a user, and a last
    user whose consumed list leaves fewer than n_rec items (the
    can't-filter passthrough)."""
    rng = np.random.default_rng(seed)
    users = rng.normal(size=(n_users, DIM)).astype(np.float32)
    items = rng.normal(size=(N_ITEMS, DIM)).astype(np.float32)
    consumed = {u: rng.choice(N_ITEMS, N_CONSUMED, replace=False).tolist()
                for u in range(n_users - 1)}
    consumed[n_users - 1] = list(range(N_ITEMS - N_REC + 1))
    return users, items, consumed


def _broadcast_filter(user_embeds, item_embeds, n_rec, consumed):
    """The filter as the port had it: a (U, fetch, C) mask on the host."""
    from librecommender_tpu_torch.ops.streaming_topk import streaming_topk
    from librecommender_tpu_torch.ops.topk import fetch_size

    n_users, n_items = user_embeds.shape[0], item_embeds.shape[0]
    width = int((consumed >= 0).sum(axis=1).max())
    ids, scores = streaming_topk(user_embeds, item_embeds,
                                 fetch_size(n_rec, width, n_items))
    ids, scores = ids.numpy(), scores.numpy()
    keep = ~(ids[:, :, None] == consumed[:, None, :]).any(-1)
    out_i = np.zeros((n_users, n_rec), np.int32)
    out_s = np.full((n_users, n_rec), -np.inf, np.float32)
    for r in range(n_users):
        sel = np.flatnonzero(keep[r])[:n_rec]
        out_i[r, : len(sel)] = ids[r, sel]
        out_s[r, : len(sel)] = scores[r, sel]
    return out_i, out_s


def test_filter_matches_jax_and_the_broadcast_form():
    from librecommender_tpu.ops.topk import topk_from_embeddings as jax_topk
    from librecommender_tpu_torch.ops.topk import pad_consumed, topk_from_embeddings

    users, items, consumed = _case(64)
    uids = np.arange(len(users))
    ids, scores = topk_from_embeddings(
        torch.from_numpy(users), torch.from_numpy(items), N_REC,
        user_consumed=consumed, user_ids=uids)
    want_ids, want_scores = jax_topk(users, items, N_REC, user_consumed=consumed,
                                     user_ids=uids)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_allclose(scores, np.asarray(want_scores), rtol=RTOL)
    pad = pad_consumed(consumed, uids, n_rec=N_REC, n_items=N_ITEMS)
    old_ids, old_scores = _broadcast_filter(
        torch.from_numpy(users), torch.from_numpy(items), N_REC, pad)
    np.testing.assert_array_equal(ids, old_ids)
    np.testing.assert_array_equal(scores, old_scores)
    for u in range(len(users) - 1):
        assert not set(ids[u]) & set(consumed[u])
    # the passthrough row keeps consumed items among its recommendations
    assert set(ids[-1]) & set(consumed[len(users) - 1])


def test_filter_underfills_as_before(monkeypatch):
    """Where the over-fetch is capped (``MAX_FETCH``) and consumed items fill
    it, a row keeps -inf scores past its kept candidates, as the broadcast
    form left them."""
    from librecommender_tpu_torch.ops import topk

    monkeypatch.setattr(topk, "MAX_FETCH", 6)
    rng = np.random.default_rng(1)
    users = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    items = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    pad = np.full((3, 8), -1, np.int32)
    ranked = torch.sort(users @ items.T, dim=1, descending=True,
                        stable=True).indices.numpy()
    pad[0, :5] = ranked[0, :5]      # 5 of the 6 fetched consumed: 1 is left
    pad[1, :2] = ranked[1, 4:6]     # 2 of them: all 4 slots fill
    got = topk._streaming_topk(users, items, 4, pad)
    want = _broadcast_filter(users, items, 4, pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.isinf(got[1][0, 1:]).all() and np.isfinite(got[1][1:]).all()
    assert not set(got[0][1]) & set(pad[1])


_PEAK = textwrap.dedent(
    """
    import json, resource, sys
    import numpy as np
    import torch
    sys.path.insert(0, {root!r})
    from tests.test_torch_consumed_filter import _case
    from librecommender_tpu_torch.ops.topk import topk_from_embeddings

    torch.set_num_threads(1)
    users, items, consumed = _case({n_users})
    uids = np.arange(len(users))
    u, i = torch.from_numpy(users), torch.from_numpy(items)
    # a small call first, so that what any call sets up is in the baseline
    topk_from_embeddings(u[:2], i, {n_rec}, user_consumed=consumed, user_ids=uids[:2])
    base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    ids, _ = topk_from_embeddings(u, i, {n_rec}, user_consumed=consumed,
                                  user_ids=uids)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(json.dumps({{"rise_mb": (peak - base) / 1024, "shape": list(ids.shape)}}))
    """
)


@pytest.mark.parametrize("n_users", [1024])
def test_filter_peak_memory(n_users):
    """The call's peak resident memory at 1024 users x 1800 consumed items,
    torch's tensors and numpy's arrays both: the rise of ru_maxrss over the
    process's peak before the call, in a fresh process."""
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    out = subprocess.run(
        [sys.executable, "-c", _PEAK.format(root=root, n_users=n_users, n_rec=N_REC)],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["shape"] == [n_users, N_REC]
    assert res["rise_mb"] < PEAK_LIMIT_MB, res
