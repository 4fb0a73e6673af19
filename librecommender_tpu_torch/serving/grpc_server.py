"""gRPC online recommendation service.

Counterpart of ``librecommender_tpu/serving/grpc_server.py``, on its wire.
Two methods:

- ``PROTO_METHOD`` (``/recommend.Recommend/GetRecommendation``): binary
  protobuf on the reference's contract (``protos/recommend.proto``: the
  same package, service, rpc and field numbers), read and written by the
  port's own codec (``serving/recommend_proto.py``), so clients generated
  from that proto work unchanged and no ``protoc`` is needed;
- ``METHOD`` (``/librecommender.Recommend/RecommendUser``): JSON payloads
  for stub-free clients,
  ``{"user": ..., "n_rec": 10, "seq": [...], "user_feats": {...}}`` ->
  ``{"rec_list": [...]}``.

The request logic is apart from the transport: ``handle_json`` and
``handle_proto`` take a request's bytes to the response's bytes and call
the model's ``recommend_user`` on its own device, so that they run where
the ``grpc`` package is missing. ``grpc`` is imported only by ``serve`` and
the two clients, which raise ``ImportError`` without it.
"""
import json
from concurrent import futures

from .recommend_proto import Feature, RecRequest, RecResponse

METHOD = "/librecommender.Recommend/RecommendUser"
PROTO_METHOD = "/recommend.Recommend/GetRecommendation"


def _grpc():
    try:
        import grpc
    except ImportError as err:
        raise ImportError(
            "the gRPC transport needs the grpc package (grpcio); without it the "
            "request handlers handle_json and handle_proto still run") from err
    return grpc


def _run(model, user, n_rec, seq, user_feats):
    """The model's list for one request, as raw ids."""
    kwargs = {}
    if seq:
        kwargs["seq"] = seq
    if user_feats:
        kwargs["user_feats"] = user_feats
    try:
        recs = model.recommend_user(user=user, n_rec=n_rec, **kwargs)
    except TypeError:   # a model that takes no request-time seq or features
        recs = model.recommend_user(user=user, n_rec=n_rec)
    key = next(iter(recs))
    return [v.item() if hasattr(v, "item") else v for v in recs[key]]


def handle_json(model, request):
    """``METHOD``'s handler: JSON request bytes -> JSON response bytes."""
    body = json.loads(request.decode())
    items = _run(model, body["user"], int(body.get("n_rec", 10)),
                 body.get("seq"), body.get("user_feats"))
    return json.dumps({"rec_list": items}).encode()


def handle_proto(model, request):
    """``PROTO_METHOD``'s handler: ``RecRequest`` bytes -> ``RecResponse``
    bytes. Raw user ids arrive as strings (the reference's contract); an
    integer-looking one becomes an int, as integer-keyed id maps need."""
    req = RecRequest.FromString(request)
    feats = {name: f.value for name, f in req.user_feats.items()}
    items = _run(model, _coerce_raw_id(req.user), int(req.n_rec or 10),
                 list(req.seq) or None, feats or None)
    return RecResponse([str(i) for i in items]).SerializeToString()


def _coerce_raw_id(value):
    try:
        return int(value)
    except (TypeError, ValueError):
        return value


def serve(model, port=50051, max_workers=8):
    """Start the gRPC server on 127.0.0.1:``port``; returns it (call
    ``.stop(None)`` to shut it down)."""
    grpc = _grpc()

    def method(handle):
        return grpc.unary_unary_rpc_method_handler(
            lambda request, context: handle(model, request))

    handlers = [
        grpc.method_handlers_generic_handler(
            name.rsplit("/", 2)[1], {name.rsplit("/", 1)[1]: method(handle)})
        for name, handle in ((METHOD, handle_json), (PROTO_METHOD, handle_proto))
    ]
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(handlers)
    server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server


def recommend_client(port, user, n_rec=10, seq=None, user_feats=None,
                     host="127.0.0.1"):
    """A JSON client of ``METHOD`` (also its wire's documentation)."""
    grpc = _grpc()
    with grpc.insecure_channel(f"{host}:{port}") as channel:
        call = channel.unary_unary(
            METHOD,
            request_serializer=lambda obj: json.dumps(obj).encode(),
            response_deserializer=lambda data: json.loads(data.decode()),
        )
        return call({"user": user, "n_rec": n_rec, "seq": seq,
                     "user_feats": user_feats})


def recommend_client_proto(port, user, n_rec=10, seq=None, user_feats=None,
                           host="127.0.0.1"):
    """A binary-protobuf client of ``PROTO_METHOD``, sending what a stub
    generated from the reference's proto sends; returns a ``RecResponse``."""
    grpc = _grpc()
    req = RecRequest(user=str(user), n_rec=n_rec,
                     seq=[int(s) for s in seq or ()],
                     user_feats={name: Feature.of(val)
                                 for name, val in (user_feats or {}).items()})
    with grpc.insecure_channel(f"{host}:{port}") as channel:
        call = channel.unary_unary(
            PROTO_METHOD,
            request_serializer=RecRequest.SerializeToString,
            response_deserializer=RecResponse.FromString,
        )
        return call(req)
