"""A hand-written proto3 codec for ``protos/recommend.proto``.

The messages of the online recommendation service (``RecRequest``,
``RecResponse`` and ``Feature``) as plain Python classes, with
``SerializeToString`` and ``FromString`` on protobuf's wire format, so that
the gRPC service speaks the reference's contract without ``protoc`` or
``google.protobuf``. Writing follows protobuf's own: fields in number order,
proto3 defaults left out (but a set oneof case and every map entry's key
and value always written), ``seq`` packed, a negative ``int32`` as a
ten-byte varint, and map entries in the order of protobuf's deterministic
serialization. Reading takes what any proto3 writer sends: fields in any
order, the last of a repeated scalar field or oneof winning, ``seq``
packed or not, unknown fields skipped.
"""
import struct
from dataclasses import dataclass, field

VARINT, I64, LEN, I32 = 0, 1, 2, 5


def _varint(value):
    """``value`` as a base-128 varint; a negative one as its 64-bit two's
    complement, ten bytes."""
    value &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(number, wire):
    return _varint(number << 3 | wire)


def _len_field(number, payload):
    return _key(number, LEN) + _varint(len(payload)) + payload


def _int32(raw):
    """A varint's value as an int32 (protobuf keeps its low 32 bits)."""
    raw &= 0xFFFFFFFF
    return raw - (1 << 32) if raw & 0x80000000 else raw


def _read_varint(data, pos):
    value, shift = 0, 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value & ((1 << 64) - 1), pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than ten bytes")


def _fields(data):
    """Yield (field number, wire type, value) of a message's bytes: an int
    for a varint, bytes for the other wire types."""
    data, pos = memoryview(bytes(data)), 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        number, wire = tag >> 3, tag & 7
        if wire == VARINT:
            value, pos = _read_varint(data, pos)
        elif wire == I64:
            value, pos = bytes(data[pos:pos + 8]), pos + 8
        elif wire == LEN:
            n, pos = _read_varint(data, pos)
            value, pos = bytes(data[pos:pos + n]), pos + n
        elif wire == I32:
            value, pos = bytes(data[pos:pos + 4]), pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if pos > len(data):
            raise ValueError("truncated field")
        yield number, wire, value


@dataclass
class Feature:
    """``Feature``: one of ``string_val``, ``int_val`` (int32) and
    ``float_val`` (float32), named by ``kind``, or none (``kind`` None)."""
    kind: str = None
    value: object = None

    def SerializeToString(self):
        if self.kind == "string_val":
            return _len_field(1, self.value.encode())
        if self.kind == "int_val":
            return _key(2, VARINT) + _varint(int(self.value))
        if self.kind == "float_val":
            return _key(3, I32) + struct.pack("<f", self.value)
        return b""

    @classmethod
    def FromString(cls, data):
        out = cls()
        for number, wire, value in _fields(data):
            if number == 1 and wire == LEN:
                out.kind, out.value = "string_val", value.decode()
            elif number == 2 and wire == VARINT:
                out.kind, out.value = "int_val", _int32(value)
            elif number == 3 and wire == I32:
                out.kind, out.value = "float_val", struct.unpack("<f", value)[0]
        return out

    @classmethod
    def of(cls, value):
        """The case a Python value takes: str, int (bool too) or float."""
        if isinstance(value, str):
            return cls("string_val", value)
        if isinstance(value, int):
            return cls("int_val", int(value))
        return cls("float_val", float(value))


def _map_order(key):
    """protobuf's deterministic order of string map keys: by their UTF-8
    bytes, where one key is a prefix of another the longer first."""
    return [*key.encode(), 256]


@dataclass
class RecRequest:
    """``RecRequest``: ``user`` (string), ``n_rec`` (int32), ``user_feats``
    (string -> Feature) and ``seq`` (repeated int32)."""
    user: str = ""
    n_rec: int = 0
    user_feats: dict = field(default_factory=dict)
    seq: list = field(default_factory=list)

    def SerializeToString(self):
        out = bytearray()
        if self.user:
            out += _len_field(1, self.user.encode())
        if self.n_rec:
            out += _key(2, VARINT) + _varint(int(self.n_rec))
        for name in sorted(self.user_feats, key=_map_order):
            entry = (_len_field(1, name.encode())
                     + _len_field(2, self.user_feats[name].SerializeToString()))
            out += _len_field(3, entry)
        if self.seq:
            out += _len_field(4, b"".join(_varint(int(s)) for s in self.seq))
        return bytes(out)

    @classmethod
    def FromString(cls, data):
        out = cls()
        for number, wire, value in _fields(data):
            if number == 1 and wire == LEN:
                out.user = value.decode()
            elif number == 2 and wire == VARINT:
                out.n_rec = _int32(value)
            elif number == 3 and wire == LEN:
                name, feat = "", Feature()
                for n, w, v in _fields(value):
                    if n == 1 and w == LEN:
                        name = v.decode()
                    elif n == 2 and w == LEN:
                        feat = Feature.FromString(v)
                out.user_feats[name] = feat
            elif number == 4 and wire == VARINT:
                out.seq.append(_int32(value))
            elif number == 4 and wire == LEN:      # packed
                pos = 0
                while pos < len(value):
                    raw, pos = _read_varint(value, pos)
                    out.seq.append(_int32(raw))
        return out


@dataclass
class RecResponse:
    """``RecResponse``: ``items`` (repeated string)."""
    items: list = field(default_factory=list)

    def SerializeToString(self):
        return b"".join(_len_field(1, str(i).encode()) for i in self.items)

    @classmethod
    def FromString(cls, data):
        return cls([v.decode() for n, w, v in _fields(data) if n == 1 and w == LEN])
