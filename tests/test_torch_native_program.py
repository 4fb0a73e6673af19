"""The port's native programs (``serving/native_program.py``) in the C++
interpreter, against the port's models and the JAX package's programs, on
the CPU.

The port's scoring functions, lowered from ``torch.export`` to the JAX
package's op-list format, are run unchanged by the JAX package's own
runner (``librecommender_tpu.serving.native_server.build_interp_cli``) and
by the port's copy (``librecommender_tpu_torch.serving.native_server``), for
DeepFM, DIN, SIM, Transformer (f32), RNN4Rec (GRU), Caser and TwoTower built
from the same (trained-looking) parameters in both packages. Both runners'
outputs are held to the port model's and to the JAX package's program at
rtol 2e-4, atol 2e-5: the JAX zoo's tolerance for the interpreter against
XLA (``tests/serving/test_export_zoo.py``), whose exp, tanh and logistic are
a polynomial to 8.3e-8 and whose sums run in another order.
``export_native_programs`` writes the JAX package's file set and
``runtime_meta.json`` for a feature, a ``dyn_feats`` and a ``dyn`` model; a
few lowering rules are checked op by op; an ATen op with no rule raises.
"""
import json
import os

import numpy as np
import pytest
import torch

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.data import DatasetFeat, DatasetPure
from librecommender_tpu_torch.ops import streaming_topk as st
from librecommender_tpu_torch.serving import native_program as tnp
from librecommender_tpu_torch.serving.native_server import (
    build_interp_cli,
    run_program,
)

FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
SMALL = dict(embed_size=8, batch_size=256, seed=3)
HIDDEN = dict(hidden_units=(16, 8))
SEQ = dict(recent_num=5)
RTOL, ATOL = 2e-4, 2e-5
NEAR_TIE = 1e-5

# name -> (frame, kwargs beside SMALL)
CASES = {
    "DeepFM": ("feat", HIDDEN),
    "DIN": ("feat", {**HIDDEN, **SEQ}),
    "SIM": ("feat", {**HIDDEN, **SEQ, "long_max_len": 8, "search_topk": 3}),
    "Transformer": ("feat", {**HIDDEN, **SEQ, "compute_dtype": "f32"}),
    "RNN4Rec": ("pure", SEQ),
    "Caser": ("pure", SEQ),
    "TwoTower": ("feat", HIDDEN),
}


def as_columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def pair(name, pure_frames, feat_frames):
    """JAX's model with its initialisation moved by N(0, 0.1) noise and the
    port's holding the same parameters, both post-fit."""
    import jax

    from librecommender_tpu import models as jmodels
    from librecommender_tpu.data import DatasetFeat as JDatasetFeat
    from librecommender_tpu.data import DatasetPure as JDatasetPure
    from librecommender_tpu.utils.save_load import flatten_tree, unflatten_tree

    kind, kw = CASES[name]
    train = (pure_frames if kind == "pure" else feat_frames)[0]
    if kind == "pure":
        _, j_info = JDatasetPure.build_trainset(train)
        _, t_info = DatasetPure.build_trainset(as_columns(train))
    else:
        _, j_info = JDatasetFeat.build_trainset(train, **FEAT_COLS)
        _, t_info = DatasetFeat.build_trainset(as_columns(train), **FEAT_COLS)
    jm = getattr(jmodels, name)("ranking", j_info, **SMALL, **kw)
    jm.build_model()
    rng = np.random.default_rng(5)
    jm.params = jax.tree.map(jax.numpy.asarray, unflatten_tree({
        k: np.asarray(v) + rng.normal(scale=0.1, size=np.shape(v)).astype(np.float32)
        for k, v in flatten_tree(jax.device_get(jm.params)).items()}))
    jm.post_fit()
    tm = getattr(tmodels, name)("ranking", t_info, device="cpu", **SMALL, **kw)
    tm.params_from_arrays(jax.device_get(jm.params))
    tm.post_fit()
    return jm, tm, t_info


def scoring_fns(name, jm, tm, info):
    """(the JAX function, the port's, example inputs, the port model's
    output) of the model's native scoring program: one user's catalog
    scores, or user vectors from the stored histories."""
    uid = 4
    tree = tm._tree({k: v.detach() for k, v in tm.net.items()})
    if name == "TwoTower":
        users = np.array([uid], np.int32)
        want = tm.user_tower(tree, torch.as_tensor(users).long()).numpy()
        return (lambda u: jm.user_tower(jm.params, u),
                lambda u: tm.user_tower(tree, u), [users], want)
    if CASES[name][0] == "pure":
        users = np.array([uid, 7], np.int32)
        seqs = tm.recent_seq_table[torch.as_tensor(users).long()].numpy()
        seqs = seqs.astype(np.int32)
        want = tm._embed_users(torch.as_tensor(users).long(),
                               torch.as_tensor(seqs).long()).numpy()
        jm._ensure_repr_fn()
        return (lambda u, s: jm._user_repr(jm.params, u, s, False, None),
                lambda u, s: tm._user_repr(tree, u, s, False),
                [users, seqs], want)
    users = np.array([uid], np.int32)
    want = tm._score_users(users).numpy()
    jm._ensure_inference_fns()
    if hasattr(jm, "_score_catalog"):
        j_fn = lambda u: jm._score_catalog(jm.params, u, 1)  # noqa: E731
    else:
        j_fn = lambda u: jm._recommend_fn.__wrapped__(jm.params, u, 1)  # noqa: E731
    if hasattr(tm, "_score_catalog"):
        t_fn = lambda u: tm._score_catalog(tree, u)  # noqa: E731
    else:
        t_fn = lambda u: tm._forward(  # noqa: E731
            tree, tm._catalog_pair_inputs(u), train=False).reshape(1, tm.n_items)
    return j_fn, t_fn, [users], want


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_programs_run_in_both_interpreters(name, pure_frames, feat_frames,
                                                tmp_path):
    from librecommender_tpu.serving import native_program as jnp_
    from librecommender_tpu.serving.native_server import (
        build_interp_cli as jax_cli,
    )

    jm, tm, info = pair(name, pure_frames, feat_frames)
    j_fn, t_fn, inputs, want = scoring_fns(name, jm, tm, info)
    tnp.save_program(tmp_path / "port", "p", t_fn, *inputs)
    jnp_.save_program(tmp_path / "jax", "p", j_fn, *inputs)
    j_cli = jax_cli()
    jax_prog, _ = run_program(tmp_path / "jax", "p", *inputs, cli=j_cli)
    for cli in (j_cli, build_interp_cli()):
        got, _ = run_program(tmp_path / "port", "p", *inputs, cli=cli)
        assert got[0].shape == want.shape
        np.testing.assert_allclose(got[0], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[0], jax_prog[0], rtol=RTOL, atol=ATOL)


def _read_bin(path, name, dtype):
    shape = np.fromfile(path / f"{name}_shape.bin", np.int64)
    return np.fromfile(path / f"{name}.bin", dtype).reshape(shape)


@pytest.mark.parametrize("name,kind", [("DIN", "feat"), ("TwoTower", "dyn_feats"),
                                       ("RNN4Rec", "dyn")])
def test_export_native_programs_writes_jax_files(name, kind, pure_frames,
                                                 feat_frames, tmp_path):
    """The same file set and runtime meta as the JAX package's export; the
    tables equal; the static top-K ids equal but for near-ties; every
    program runs in the port's runner and matches the port model."""
    from librecommender_tpu.serving.native_program import (
        export_native_programs as jax_export,
    )

    jm, tm, info = pair(name, pure_frames, feat_frames)
    j_dir, t_dir = tmp_path / "jax", tmp_path / "port"
    j_meta = jax_export(j_dir, jm, tile_size=32)
    t_meta = tnp.export_native_programs(t_dir, tm, tile_size=32)
    assert t_meta["kind"] == kind
    assert t_meta == j_meta
    assert json.loads((t_dir / "runtime_meta.json").read_text()) == j_meta
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    for f in ("feat_map.json",):
        if (j_dir / f).exists():
            assert json.loads((t_dir / f).read_text()) == json.loads(
                (j_dir / f).read_text())
    for tab, dtype in (("recent_seq", np.int32), ("recent_long", np.int32),
                       ("user_sparse_rows", np.int32),
                       ("user_dense_rows", np.float32)):
        if (j_dir / f"{tab}.bin").exists():
            np.testing.assert_array_equal(_read_bin(t_dir, tab, dtype),
                                          _read_bin(j_dir, tab, dtype))
    uid = np.array([4], np.int32)
    if kind == "feat":
        scores = tm._score_users(np.arange(tm.n_users + 1)).numpy()
        got, want = (_read_bin(d, "static_topk", np.int32) for d in (t_dir, j_dir))
        assert got.shape == want.shape
        for r, j in zip(*np.nonzero(got != want)):
            sa, sb = scores[r, got[r, j]], scores[r, want[r, j]]
            assert abs(sa - sb) <= NEAR_TIE * max(abs(sa), abs(sb)), (r, j)
        extra = [tm.recent_seq_table[4:5].numpy().astype(np.int32),
                 np.asarray(info.user_sparse_unique)[4:5].astype(np.int32),
                 np.asarray(info.user_dense_unique)[4:5].astype(np.float32)]
        assert t_meta["inputs"] == ["users", "seq", "user_sparse_row",
                                    "user_dense_row"]
        runs = {"score_all": ([uid], scores[4:5]),
                "score_dyn": ([uid, *extra], scores[4:5]),
                "score_tile": ([uid, np.arange(32, dtype=np.int32), *extra],
                               scores[4:5, :32])}
    elif kind == "dyn":
        np.testing.assert_allclose(_read_bin(t_dir, "item_repr", np.float32),
                                   _read_bin(j_dir, "item_repr", np.float32),
                                   rtol=1e-6, atol=1e-7)
        users = np.repeat(uid, 8)
        seqs = tm.recent_seq_table[torch.as_tensor(users).long()].numpy()
        want = tm._embed_users(torch.as_tensor(users).long(),
                               torch.as_tensor(seqs).long()).numpy()
        runs = {"user_repr": ([uid, seqs[:1].astype(np.int32)], want[:1]),
                "user_repr_b": ([users, seqs.astype(np.int32)], want)}
    else:
        rows = [np.asarray(info.user_sparse_unique)[4:5].astype(np.int32),
                np.asarray(info.user_dense_unique)[4:5].astype(np.float32)]
        want = tm.user_tower(tm._tree(), torch.as_tensor(uid).long()).detach()
        runs = {"user_repr": ([uid, *rows], want.numpy()),
                "user_repr_b": ([np.repeat(uid, 8),
                                 *(np.repeat(r, 8, 0) for r in rows)],
                                np.repeat(want.numpy(), 8, 0))}
    for prog, (inputs, want) in runs.items():
        got, _ = run_program(t_dir, prog, *inputs)
        np.testing.assert_allclose(got[0], want, rtol=RTOL, atol=ATOL,
                                   err_msg=prog)


# each: (function, inputs); the lowering of the ops it exercises, against
# torch on the same inputs
_X = np.random.default_rng(0).normal(size=(3, 4, 5)).astype(np.float32)
OP_CASES = {
    "index_negative_and_pairs": (
        lambda x, i: x[i, :, i] + x[:, 1:2, 0][i], [_X, np.array([-1, 0, 2],
                                                                 np.int32)]),
    "index_after_a_slice": (lambda x, i: x[:, i, 1:4], [_X, np.array([3, 0],
                                                                      np.int32)]),
    "select_split_repeat_pad": (
        lambda x: torch.nn.functional.pad(
            torch.cat(x.split([2, 3], dim=2)[::-1], dim=2)[1].repeat(2, 1, 1),
            (1, 2, 0, 1), value=0.5), [_X]),
    "softmax_var_any_where": (
        lambda x: torch.where((x > 0).any(dim=1, keepdim=True),
                              torch.softmax(x, dim=-1),
                              x.var(dim=(0, 2), keepdim=True, unbiased=False)),
        [_X]),
    "expand_permute_bmm_clamp": (
        lambda x: torch.clamp((x.permute(0, 2, 1) @ x).expand(2, 3, 5, 5)
                              .sum(0), -1.0, 2.0) - x.mean(), [_X]),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_lowering_rules_op_by_op(case, tmp_path):
    fn, inputs = OP_CASES[case]
    want = fn(*(torch.as_tensor(a).long() if a.dtype.kind == "i"
                else torch.as_tensor(a) for a in inputs)).numpy()
    tnp.save_program(tmp_path, "op", fn, *inputs)
    got, _ = run_program(tmp_path, "op", *inputs)
    assert got[0].shape == want.shape
    np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)


def test_attention_traces_before_any_eager_call(tmp_path):
    """``ops/nn.mha``'s logit scale is a Python float, not a traced tensor,
    also when its cache is cold (the first call is the export's)."""
    from librecommender_tpu_torch.ops import nn as tnn

    gen = torch.Generator().manual_seed(0)
    params = tnn.init_mha(gen, 8, 2)
    tnn._root.cache_clear()
    fn = lambda x: tnn.mha(params, x, x, num_heads=2)  # noqa: E731
    tnp.save_program(tmp_path, "mha", fn, _X[:, :, :4].repeat(2, axis=2))
    x = _X[:, :, :4].repeat(2, axis=2)
    got, _ = run_program(tmp_path, "mha", x)
    np.testing.assert_allclose(got[0], fn(torch.as_tensor(x)).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_an_op_without_a_rule_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="aten.topk"):
        tnp.trace_to_program(lambda x: torch.topk(x, 2, dim=-1).values,
                             _X[0])


def test_one_element_inputs_stay_inputs(monkeypatch, tmp_path):
    """A one-user program reads its input through a chained lookup (a
    feature row's id, then its embedding: torch's tracers take a
    one-element tensor for a constant, and the second index then read an
    uninitialised value); the limit they use is restored after the trace,
    and a torch without it raises instead of tracing."""
    import torch._subclasses.fake_tensor as fake
    import torch.fx.experimental.proxy_tensor as proxy

    limits = (proxy.CONSTANT_NUMEL_LIMIT, fake.CONSTANT_NUMEL_LIMIT)
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    rows = torch.tensor([2, 0, 3, 1])
    fn = lambda u: table[rows[u]] * 2  # noqa: E731
    tnp.save_program(tmp_path, "row", fn, np.array([0], np.int32))
    assert (proxy.CONSTANT_NUMEL_LIMIT, fake.CONSTANT_NUMEL_LIMIT) == limits
    for uid in (1, 3):
        got, _ = run_program(tmp_path, "row", np.array([uid], np.int32))
        np.testing.assert_array_equal(got[0], fn(torch.tensor([uid])).numpy())
    monkeypatch.delattr(proxy, "CONSTANT_NUMEL_LIMIT")
    monkeypatch.delattr(fake, "CONSTANT_NUMEL_LIMIT")
    with pytest.raises(RuntimeError, match="CONSTANT_NUMEL_LIMIT"):
        tnp.trace_to_program(fn, np.array([0], np.int32))


@pytest.mark.cuda
def test_programs_from_card_models_and_the_card_ranking(tmp_path):
    """The programs of a dynamic-embedding model on the card run in the
    port's runner and equal the card model's user vectors; they rank against
    the exported item matrix through one launch of the streaming top-k, as
    the card model's ``recommend_user`` ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from tests.test_torch_export import port_model

    card = port_model("RNN4Rec", device="cuda")
    tnp.export_native_programs(tmp_path, card)
    users = np.arange(8, dtype=np.int32)
    seqs = card.recent_seq_table[torch.as_tensor(users).long().cuda()]
    got, _ = run_program(tmp_path, "user_repr_b", users,
                         seqs.cpu().numpy().astype(np.int32))
    with torch.no_grad():
        want = card._embed_users(torch.as_tensor(users, device="cuda").long(),
                                 seqs)
    np.testing.assert_allclose(got[0], want.cpu().numpy(), rtol=RTOL, atol=ATOL)
    items = torch.as_tensor(_read_bin(tmp_path, "item_repr",
                                      np.float32), device="cuda")
    vecs = torch.cat([torch.as_tensor(got[0], device="cuda"),
                      torch.ones(8, 1, device="cuda")], dim=1)
    st.reset_launches()
    ids, _ = st.streaming_topk(vecs, items, 10)
    torch.cuda.synchronize()
    assert st.launches == 1
    ids = ids.cpu().numpy()
    recs = card.recommend_user(users, 10, inner_id=True, filter_consumed=False)
    exact = (vecs.double() @ items.double().T).cpu().numpy()
    want = np.stack([recs[int(u)] for u in users])
    for r, j in zip(*np.nonzero(ids != want)):
        a, b = exact[r, ids[r, j]], exact[r, want[r, j]]
        assert abs(a - b) <= RTOL * max(abs(a), abs(b)), (r, j)
