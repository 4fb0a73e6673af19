"""The port's gRPC service (``serving/grpc_server.py``) and its proto3 codec
(``serving/recommend_proto.py``) against the JAX package's, on the CPU.

- the codec's bytes equal those of protobuf's message classes generated
  from the JAX package's ``recommend.proto`` (by ``protoc``, into the test's
  own directory), both ways, on the same messages: a negative ``int32``,
  every ``Feature`` case, an empty one, several map entries (protobuf's
  deterministic order), and a ``seq`` written unpacked;
- the port's ``serve`` on a BPR and a DIN loaded from the JAX package's
  saves gives the JAX model's lists to the JAX package's JSON client and to
  a call on the proto method made as the JAX package's proto client makes
  it, and to the port's own clients; the bytes-to-bytes handlers give them
  too;
- with ``grpc`` blocked the port imports, its handlers run and ``serve``
  raises ``ImportError``.
"""
import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from librecommender_tpu_torch import models as tmodels
from librecommender_tpu_torch.serving import grpc_server as tgrpc
from librecommender_tpu_torch.serving.recommend_proto import (
    Feature,
    RecRequest,
    RecResponse,
)

FEAT_COLS = dict(user_col=["sex", "age"], item_col=["genre"],
                 sparse_col=["sex", "genre"], dense_col=["age"])
SMALL = dict(embed_size=8, n_epochs=1, batch_size=256)


@pytest.fixture(scope="module")
def pb2(tmp_path_factory):
    """The JAX package's ``recommend.proto`` compiled by ``protoc`` into a
    directory of this module's own, loaded under a name of its own."""
    import librecommender_tpu.serving as jserving

    protos = Path(jserving.__file__).parent / "protos"
    out = tmp_path_factory.mktemp("pb2")
    subprocess.run(["protoc", f"--python_out={out}", f"-I{protos}",
                    str(protos / "recommend.proto")], check=True)
    spec = importlib.util.spec_from_file_location("port_test_recommend_pb2",
                                                  out / "recommend_pb2.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_proto_is_the_jax_packages():
    import librecommender_tpu.serving as jserving
    import librecommender_tpu_torch.serving as tserving

    name = Path("protos") / "recommend.proto"
    assert ((Path(tserving.__file__).parent / name).read_bytes()
            == (Path(jserving.__file__).parent / name).read_bytes())


# each: (user, n_rec, {name: (case, value)}, seq)
REQUESTS = {
    "empty": ("", 0, {}, []),
    "plain": ("1042", 10, {}, []),
    "negative": ("u-7", -3, {}, [1, -2, 300, 2**31 - 1, -2**31]),
    "every_case": ("7", 5, {"sex": ("string_val", "f"), "age": ("float_val", 0.25),
                            "occupation": ("int_val", -12), "blank": (None, None),
                            "": ("string_val", ""), "zero": ("int_val", 0)}, [4]),
    "many_keys": ("", 1, {k: ("int_val", i) for i, k in enumerate(
        ["B", "aa", "abc", "ab", "a", "ba", "b", "é", "z", ""])}, []),
}


def _pb_request(pb2, user, n_rec, feats, seq):
    req = pb2.RecRequest(user=user, n_rec=n_rec)
    req.seq.extend(seq)
    for name, (case, value) in feats.items():
        if case is None:
            req.user_feats[name].SetInParent()
        else:
            setattr(req.user_feats[name], case, value)
    return req


def _fields(req):
    """A codec ``RecRequest``'s contents as plain values."""
    return (req.user, req.n_rec, {k: (f.kind, f.value) for k, f in req.user_feats.items()},
            list(req.seq))


def _pb_fields(req):
    feats = {}
    for name, feat in req.user_feats.items():
        case = feat.WhichOneof("value")
        feats[name] = (case, getattr(feat, case) if case else None)
    return req.user, req.n_rec, feats, list(req.seq)


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_request_bytes_both_ways(pb2, case):
    user, n_rec, feats, seq = REQUESTS[case]
    ours = RecRequest(user, n_rec, {k: Feature(*v) for k, v in feats.items()}, seq)
    theirs = _pb_request(pb2, user, n_rec, feats, seq)
    data = ours.SerializeToString()
    assert data == theirs.SerializeToString(deterministic=True)
    assert _pb_fields(pb2.RecRequest.FromString(data)) == (user, n_rec, feats, seq)
    # protobuf's own order of map entries (not the deterministic one) reads alike
    assert _fields(RecRequest.FromString(theirs.SerializeToString())) == (
        user, n_rec, feats, seq)


def test_negative_int32_is_ten_bytes(pb2):
    data = RecRequest(n_rec=-1).SerializeToString()
    assert data == b"\x10" + b"\xff" * 9 + b"\x01"
    assert data == pb2.RecRequest(n_rec=-1).SerializeToString()


def test_unpacked_seq_and_repeated_fields_read_alike(pb2):
    """``seq`` written unpacked (one varint field an element, wire type 0) and
    split across a packed and an unpacked run, a user field written twice
    (the last wins) and an unknown field: both readers agree."""
    data = (b"\x0a\x01x" + b"\x20\x05" + b"\x20\xfe\xff\xff\xff\xff\xff\xff\xff\xff\x01"
            + b"\x22\x02\x07\x08" + b"\x0a\x02yz" + b"\x98\x06\x2a"
            + b"\x1a\x08\x0a\x01k\x12\x03\x10\x96\x01")
    ours, theirs = RecRequest.FromString(data), pb2.RecRequest.FromString(data)
    assert _fields(ours) == _pb_fields(theirs) == ("yz", 0, {"k": ("int_val", 150)},
                                                  [5, -2, 7, 8])


@pytest.mark.parametrize("items", [[], ["1", "22", ""], ["é" * 200]])
def test_response_bytes_both_ways(pb2, items):
    data = RecResponse(items).SerializeToString()
    assert data == pb2.RecResponse(items=items).SerializeToString()
    assert RecResponse.FromString(data).items == items
    assert list(pb2.RecResponse.FromString(data).items) == items


@pytest.mark.parametrize("case,value", [("string_val", "abc"), ("int_val", -5),
                                        ("float_val", -1.5e-3), (None, None)])
def test_feature_bytes_both_ways(pb2, case, value):
    theirs = pb2.Feature()
    if case:
        setattr(theirs, case, value)
    data = Feature(case, value).SerializeToString()
    assert data == theirs.SerializeToString()
    back = Feature.FromString(data)
    assert back.kind == case
    if case == "float_val":
        assert back.value == np.float32(value)
    else:
        assert back.value == value


# ---------------------------------------------------------------- the service
@pytest.fixture(scope="module")
def models(pure_frames, feat_frames, tmp_path_factory):
    """name -> (JAX model, the port's model loaded from JAX's save)."""
    from librecommender_tpu import models as jmodels
    from librecommender_tpu.data import DatasetFeat, DatasetPure

    root = tmp_path_factory.mktemp("grpc_models")
    out = {}
    for name, (train, info), kw in (
            ("BPR", DatasetPure.build_trainset(pure_frames[0]), {}),
            ("DIN", DatasetFeat.build_trainset(feat_frames[0], **FEAT_COLS),
             dict(recent_num=5))):
        jm = getattr(jmodels, name)("ranking", info, **SMALL, **kw)
        jm.fit(train, neg_sampling=True, verbose=0)
        jm.save(root / name, name)
        out[name] = (jm, getattr(tmodels, name).load(root / name, name, device="cpu"))
    return out


def _requests(jm, frame):
    """(user, n_rec, seq, user_feats) of three requests."""
    users = [int(u) for u in frame.user.unique()[:3]]
    if "sex" not in frame:
        return [(u, n, None, None) for u, n in zip(users, (5, 10, 3))]
    seq = [int(i) for i in frame.item.iloc[:4]]
    return [(users[0], 5, seq, {"sex": str(frame.sex.iloc[1]), "age": 0.25}),
            (users[1], 7, None, {"sex": str(frame.sex.iloc[2])}),
            (users[2], 4, seq, None)]


def _want(jm, user, n_rec, seq, feats):
    kw = {k: v for k, v in (("seq", seq), ("user_feats", feats)) if v}
    return [int(i) for i in jm.recommend_user(user=user, n_rec=n_rec, **kw)[user]]


@pytest.mark.parametrize("name", ["BPR", "DIN"])
def test_serve_gives_the_jax_lists(models, pb2, pure_frames, feat_frames, name):
    import grpc

    from librecommender_tpu.serving.grpc_server import recommend_client as jax_client

    jm, pm = models[name]
    frame = (pure_frames if name == "BPR" else feat_frames)[0]
    port = _free_port()
    server = tgrpc.serve(pm, port=port)
    try:
        for user, n_rec, seq, feats in _requests(jm, frame):
            want = _want(jm, user, n_rec, seq, feats)
            out = jax_client(port, user, n_rec=n_rec, seq=seq, user_feats=feats)
            assert [int(i) for i in out["rec_list"]] == want
            out = tgrpc.recommend_client(port, user, n_rec=n_rec, seq=seq,
                                         user_feats=feats)
            assert [int(i) for i in out["rec_list"]] == want
            # the proto method, called as the JAX package's proto client calls it
            req = _pb_request(pb2, str(user), n_rec, {
                k: ("string_val" if isinstance(v, str) else "float_val", v)
                for k, v in (feats or {}).items()}, seq or [])
            with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
                call = channel.unary_unary(
                    tgrpc.PROTO_METHOD,
                    request_serializer=pb2.RecRequest.SerializeToString,
                    response_deserializer=pb2.RecResponse.FromString)
                assert [int(i) for i in call(req).items] == want
            out = tgrpc.recommend_client_proto(port, user, n_rec=n_rec, seq=seq,
                                               user_feats=feats)
            assert [int(i) for i in out.items] == want
            # the handlers alone, bytes to bytes
            got = RecResponse.FromString(tgrpc.handle_proto(
                pm, req.SerializeToString())).items
            assert [int(i) for i in got] == want
            body = json.dumps({"user": user, "n_rec": n_rec, "seq": seq,
                               "user_feats": feats}).encode()
            got = json.loads(tgrpc.handle_json(pm, body))["rec_list"]
            assert [int(i) for i in got] == want
    finally:
        server.stop(None)


def _free_port():
    from librecommender_tpu_torch.serving.native_server import free_port

    return free_port()


_BLOCKED = textwrap.dedent(
    """
    import sys
    for blocked in ("grpc", "google.protobuf", "jax"):
        sys.modules[blocked] = None
    from librecommender_tpu_torch.serving import grpc_server as g
    from librecommender_tpu_torch.serving.recommend_proto import RecRequest, RecResponse

    class Model:
        def recommend_user(self, user, n_rec):
            return {user: list(range(100, 100 + n_rec))}

    data = g.handle_proto(Model(), RecRequest("12", 3).SerializeToString())
    assert RecResponse.FromString(data).items == ["100", "101", "102"]
    for call in (lambda: g.serve(Model(), port=1),
                 lambda: g.recommend_client(1, "12"),
                 lambda: g.recommend_client_proto(1, "12")):
        try:
            call()
        except ImportError as err:
            assert "grpc" in str(err), err
        else:
            raise AssertionError("no ImportError without grpc")
    print("ok")
    """
)


def test_without_grpc_the_handlers_run_and_serve_raises():
    out = subprocess.run([sys.executable, "-c", _BLOCKED], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]
