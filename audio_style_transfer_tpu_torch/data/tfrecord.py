"""Self-contained TFRecord + tf.train.Example codec (no TensorFlow needed); a
copy of audio_style_transfer_tpu/data/tfrecord.py, which the port does not
import.

The reference ingests the NSynth dataset from TFRecord files through TF1's
C++ reader stack (reference nsynth/reader.py:43-71).  This module
re-provides the wire formats in pure Python/numpy:

* TFRecord framing: ``uint64 length | uint32 masked-crc32c(length) |
  bytes data | uint32 masked-crc32c(data)``;
* a minimal protobuf codec for ``tf.train.Example`` — the only message
  family the pipeline needs (Features -> map<string, Feature>, Feature ->
  one of BytesList / FloatList / Int64List).

CRC32C (Castagnoli) is computed with a numpy table-driven implementation;
verification is optional for speed.  A multithreaded C++ reader with the
same framing lives in the repository's csrc/ (bound by data/native.py).
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------------- #
# CRC32C
# ---------------------------------------------------------------------- #

_CRC_TABLE: list[int] | None = None


def _crc32c_table() -> list[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``, table-driven over Python ints (the JAX package's
    numpy-scalar loop computes the same value, about 17x slower)."""
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------- #
# TFRecord framing
# ---------------------------------------------------------------------- #


def write_tfrecord(path: str, records: list[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != crc:
                    raise IOError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError(f"truncated TFRecord in {path}")
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if masked_crc32c(data) != crc:
                    raise IOError(f"corrupt TFRecord data crc in {path}")
            yield data


# ---------------------------------------------------------------------- #
# Minimal protobuf wire codec
# ---------------------------------------------------------------------- #


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_feature(buf: bytes):
    """Feature = oneof {BytesList=1, FloatList=2, Int64List=3}."""
    for field, _, value in _iter_fields(buf):
        if field == 1:  # BytesList { repeated bytes value = 1; }
            out = []
            for f2, _, v2 in _iter_fields(value):
                if f2 == 1:
                    out.append(v2)
            return out
        if field == 2:  # FloatList { repeated float value = 1 [packed]; }
            floats: list[float] = []
            arr = None
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 1 and w2 == 2:  # packed
                    arr = np.frombuffer(v2, "<f4")
                elif f2 == 1 and w2 == 5:  # unpacked
                    floats.append(struct.unpack("<f", v2)[0])
            if arr is not None:
                return arr
            return np.asarray(floats, np.float32)
        if field == 3:  # Int64List { repeated int64 value = 1 [packed]; }
            ints: list[int] = []
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 1 and w2 == 2:  # packed varints
                    pos = 0
                    while pos < len(v2):
                        val, pos = _read_varint(v2, pos)
                        ints.append(val)
                elif f2 == 1 and w2 == 0:
                    ints.append(v2)
            # Varints are unsigned on the wire; negative int64s arrive as
            # 2^64 + v (see the encoder's & (2**64 - 1)) and must fold
            # back to two's-complement before the int64 cast overflows.
            ints = [v - (1 << 64) if v >= (1 << 63) else v for v in ints]
            return np.asarray(ints, np.int64)
    return []


def parse_example(buf: bytes) -> dict:
    """Decode a serialized tf.train.Example into {name: value}."""
    features: dict = {}
    for field, _, value in _iter_fields(buf):
        if field != 1:  # Example.features
            continue
        for f2, _, v2 in _iter_fields(value):
            if f2 != 1:  # Features.feature (map entry)
                continue
            name = None
            feat = None
            for f3, _, v3 in _iter_fields(v2):
                if f3 == 1:
                    name = v3.decode("utf-8")
                elif f3 == 2:
                    feat = _parse_feature(v3)
            if name is not None:
                features[name] = feat
    return features


def _tag(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _write_varint(len(payload)) + payload


def _encode_feature(value) -> bytes:
    if isinstance(value, (bytes, str)):
        value = [value.encode() if isinstance(value, str) else value]
    if isinstance(value, list) and value and isinstance(value[0], (bytes, str)):
        inner = b"".join(
            _len_delimited(1, v.encode() if isinstance(v, str) else v) for v in value
        )
        return _len_delimited(1, inner)  # BytesList
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        packed = arr.astype("<f4").tobytes()
        inner = _len_delimited(1, packed)
        return _len_delimited(2, inner)  # FloatList (packed)
    if arr.dtype.kind in "iu":
        packed = b"".join(_write_varint(int(v) & (2**64 - 1)) for v in arr.reshape(-1))
        inner = _len_delimited(1, packed)
        return _len_delimited(3, inner)  # Int64List (packed)
    raise TypeError(f"cannot encode feature of dtype {arr.dtype}")


def build_example(features: dict) -> bytes:
    """Encode {name: value} as a serialized tf.train.Example."""
    entries = b""
    for name, value in features.items():
        entry = _len_delimited(1, name.encode("utf-8")) + _len_delimited(
            2, _encode_feature(value)
        )
        entries += _len_delimited(1, entry)
    return _len_delimited(1, entries)
