"""Pure-Python TFRecord IO + minimal tf.train.Example protobuf codec
(counterpart of ``tensorflowasr_tpu/data/tfrecord.py``; the same bytes).

Replaces the reference's TFRecord pipeline (``datasets.py:398-472``) without
a TensorFlow dependency: the TFRecord framing (length + masked crc32c,
payload, payload crc) and the tiny protobuf subset needed for
``Example{features{feature{key: {bytes_list|int64_list|float_list}}}}``
are implemented directly.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, Optional

import numpy as np

# ------------------------------- crc32c (Castagnoli) ------------------------- #

_CRC_TABLE: Optional[np.ndarray] = None


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table[i] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = np.uint32(0xFFFFFFFF)
    arr = np.frombuffer(data, np.uint8)
    crc_int = int(crc)
    t = table
    for b in arr:
        crc_int = int(t[(crc_int ^ int(b)) & 0xFF]) ^ (crc_int >> 8)
    return crc_int ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------- record framing ------------------------------ #


def write_records(path: str, records: Iterator[bytes], compression: Optional[str] = None) -> int:
    """Write records in TFRecord framing. compression: None | "GZIP"."""
    opener = gzip.open if compression == "GZIP" else open
    n = 0
    with opener(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc(rec)))
            n += 1
    return n


def read_records(path: str, compression: Optional[str] = None, verify: bool = False) -> Iterator[bytes]:
    opener = gzip.open if compression == "GZIP" else open
    with opener(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify:
                (crc,) = struct.unpack("<I", header[8:12])
                if masked_crc(header[:8]) != crc:
                    raise ValueError(f"corrupt record header in {path}")
            payload = f.read(length)
            footer = f.read(4)
            if verify:
                (crc,) = struct.unpack("<I", footer)
                if masked_crc(payload) != crc:
                    raise ValueError(f"corrupt record payload in {path}")
            yield payload


# -------------------------- minimal protobuf codec --------------------------- #


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def encode_example(features: dict) -> bytes:
    """{name: bytes | str | list[int] | list[float] | np.ndarray} → Example."""
    feats = bytearray()
    for name, value in features.items():
        if isinstance(value, str):
            value = value.encode("utf-8")
        if isinstance(value, bytes):
            # BytesList: field 1 of Feature
            inner = _len_delim(1, _len_delim(1, value))
        elif isinstance(value, np.ndarray) and np.issubdtype(value.dtype, np.floating) or (
            isinstance(value, (list, tuple)) and value and isinstance(value[0], float)
        ):
            arr = np.asarray(value, "<f4")
            # FloatList (field 2), packed floats (field 1, wire type 2)
            inner = _len_delim(2, _len_delim(1, arr.tobytes()))
        else:
            vals = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in np.asarray(value).reshape(-1))
            # Int64List (field 3), packed varints
            inner = _len_delim(3, _len_delim(1, vals))
        entry = _len_delim(1, name.encode("utf-8")) + _len_delim(2, inner)
        feats += _len_delim(1, entry)  # map entry = Features.feature field 1
    return _len_delim(1, bytes(feats))  # Example.features field 1


def decode_example(data: bytes) -> dict:
    """Example bytes → {name: bytes | np.ndarray(int64|float32)}."""

    def read_fields(buf: bytes):
        pos = 0
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wt = tag >> 3, tag & 7
            if wt == 2:
                ln, pos = _read_varint(buf, pos)
                yield field, buf[pos : pos + ln]
                pos += ln
            elif wt == 0:
                v, pos = _read_varint(buf, pos)
                yield field, v
            elif wt == 5:
                yield field, buf[pos : pos + 4]
                pos += 4
            elif wt == 1:
                yield field, buf[pos : pos + 8]
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wt}")

    out = {}
    for f, features_buf in read_fields(data):
        if f != 1:
            continue
        for f2, entry in read_fields(features_buf):
            if f2 != 1:
                continue
            name = None
            feature = None
            for f3, v in read_fields(entry):
                if f3 == 1:
                    name = v.decode("utf-8")
                elif f3 == 2:
                    feature = v
            if name is None or feature is None:
                continue
            for kind, payload in read_fields(feature):
                if kind == 1:  # BytesList
                    for f4, b in read_fields(payload):
                        if f4 == 1:
                            out[name] = b
                elif kind == 2:  # FloatList
                    floats: list = []
                    for f4, b in read_fields(payload):
                        if f4 == 1:
                            if isinstance(b, bytes):
                                floats.extend(np.frombuffer(b, "<f4").tolist())
                            else:
                                floats.append(b)
                    out[name] = np.asarray(floats, np.float32)
                elif kind == 3:  # Int64List
                    ints: list = []
                    for f4, b in read_fields(payload):
                        if f4 == 1:
                            if isinstance(b, bytes):
                                pos = 0
                                while pos < len(b):
                                    v, pos = _read_varint(b, pos)
                                    if v >= 1 << 63:
                                        v -= 1 << 64
                                    ints.append(v)
                            else:
                                ints.append(b)
                    out[name] = np.asarray(ints, np.int64)
    return out
