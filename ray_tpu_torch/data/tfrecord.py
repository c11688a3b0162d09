"""TFRecord datasource: the TPU ecosystem's native file format.

Capability parity with the reference's TFRecord support (reference:
python/ray/data/datasource/tfrecords_datasource.py — reads tf.train.Example
records into columns; read_api.py read_tfrecords), WITHOUT a tensorflow
dependency: the record framing and the Example protobuf wire format are
decoded directly.

Framing (tensorflow/core/lib/io/record_writer.cc):
    [length: uint64 LE][masked crc32c(length): uint32 LE]
    [data: length bytes][masked crc32c(data): uint32 LE]

Example proto (tensorflow/core/example/example.proto):
    Example{ features: Features{ feature: map<string, Feature> } }
    Feature = oneof { BytesList(1) | FloatList(2) | Int64List(3) }
each list holding repeated values (floats packed, int64 varint packed).

The length CRC is always verified (8 cheap bytes — catches torn/misaligned
files); the data CRC is optional (pure-Python crc32c over megabytes is
slow, and the framing check already rejects corruption that moves record
boundaries).

Port of ray_tpu/data/tfrecord.py.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

import numpy as np

# ---------------------------------------------------------------- crc32c

_CRC32C_POLY = 0x82F63B78
_CRC_TABLE: list[int] = []


def _crc_table() -> list[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- record IO

def read_records(path: str, validate_data_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if masked_crc(header[:8]) != len_crc:
                raise ValueError(f"{path}: corrupt length crc")
            data = f.read(length)
            crc_bytes = f.read(4)
            if len(data) < length or len(crc_bytes) < 4:
                raise ValueError(f"{path}: truncated record body")
            if validate_data_crc:
                (data_crc,) = struct.unpack("<I", crc_bytes)
                if masked_crc(data) != data_crc:
                    raise ValueError(f"{path}: corrupt data crc")
            yield data


def write_records(path: str, records: list[bytes]) -> None:
    """Framing writer (tests/interop: produce files any TF reader accepts)."""
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc(data)))


# ------------------------------------------------- protobuf wire helpers

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_list(buf: bytes, kind: int):
    """BytesList(1) / FloatList(2) / Int64List(3) payloads."""
    out: list[Any] = []
    for field, wt, val in _fields(buf):
        if field != 1:
            continue
        if kind == 1:  # bytes
            out.append(val)
        elif kind == 2:  # float: packed or repeated fixed32
            if wt == 2:
                out.extend(np.frombuffer(val, "<f4").tolist())
            else:
                out.append(struct.unpack("<f", val)[0])
        else:  # int64: packed or repeated varint (two's complement)
            if wt == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    out.append(_to_int64(v))
            else:
                out.append(_to_int64(val))
    return out


def _to_int64(v: int) -> int:
    # proto int64 rides the wire as unsigned; restore the sign.
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_example(data: bytes) -> dict[str, Any]:
    """tf.train.Example bytes -> {feature_name: list of values}."""
    out: dict[str, Any] = {}
    for field, _, features_buf in _fields(data):
        if field != 1:  # Example.features
            continue
        for ffield, _, entry in _fields(features_buf):
            if ffield != 1:  # Features.feature map entry
                continue
            name, value = None, []
            for efield, _, ev in _fields(entry):
                if efield == 1:
                    name = ev.decode("utf-8")
                elif efield == 2:  # Feature
                    for kind, _, lst in _fields(ev):
                        value = _parse_list(lst, kind)
            if name is not None:
                out[name] = value
    return out


def _encode_varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # two's complement: negatives take 10 bytes
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _encode_varint(field << 3 | wt)


def encode_example(features: dict[str, Any]) -> bytes:
    """{name: bytes | list[bytes] | list[float] | list[int]} ->
    tf.train.Example bytes (tests/interop writer)."""
    entries = b""
    for name, vals in features.items():
        if isinstance(vals, (bytes, str, float, int)):
            vals = [vals]
        if all(isinstance(v, (bytes, str)) for v in vals):
            kind = 1
            payload = b"".join(
                _tag(1, 2) + _encode_varint(len(b_)) + b_
                for b_ in ((v.encode() if isinstance(v, str) else v)
                           for v in vals))
        elif all(isinstance(v, int) for v in vals):
            kind = 3
            packed = b"".join(_encode_varint(v) for v in vals)
            payload = _tag(1, 2) + _encode_varint(len(packed)) + packed
        else:
            kind = 2
            packed = struct.pack(f"<{len(vals)}f", *[float(v) for v in vals])
            payload = _tag(1, 2) + _encode_varint(len(packed)) + packed
        feature = _tag(kind, 2) + _encode_varint(len(payload)) + payload
        key = name.encode()
        entry = (_tag(1, 2) + _encode_varint(len(key)) + key
                 + _tag(2, 2) + _encode_varint(len(feature)) + feature)
        entries += _tag(1, 2) + _encode_varint(len(entry)) + entry
    features_msg = entries
    return _tag(1, 2) + _encode_varint(len(features_msg)) + features_msg


def example_rows_to_block(rows: list[dict[str, Any]]) -> dict:
    """Column-dict block from parsed Example rows: scalar lists unwrap,
    uniform numeric columns densify, ragged/bytes stay object arrays."""
    if not rows:
        return {}
    cols: dict[str, Any] = {}
    names: list[str] = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols[k] = []
                names.append(k)
    for r in rows:
        for k in names:
            v = r.get(k, [])
            cols[k].append(v[0] if len(v) == 1 else v)
    out = {}
    for k, vals in cols.items():
        # bytes NEVER densify: numpy 'S' arrays strip trailing NULs, which
        # corrupts binary payloads (serialized tensors routinely end in 0s).
        has_bytes = any(
            isinstance(v, bytes)
            or (isinstance(v, list) and any(isinstance(x, bytes) for x in v))
            for v in vals)
        if not has_bytes:
            try:
                arr = np.asarray(vals)
                if arr.dtype != object and arr.dtype.kind not in "SU":
                    out[k] = arr
                    continue
            except ValueError:
                pass
        arr = np.empty(len(vals), object)
        for i, v in enumerate(vals):
            arr[i] = v
        out[k] = arr
    return out
