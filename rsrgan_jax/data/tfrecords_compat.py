"""Read the reference's TFRecord/SequenceExample datasets without TF.

Migration path for users with corpora already converted by
io_funcs/make_tfrecords.py: parses the TFRecord framing (length-prefixed
records, io_funcs/verify_tfrecords.py:30-51) and the SequenceExample
protobuf wire format (context ``utt_id`` bytes + float FeatureLists
``inputs``[, ``labels``], io_funcs/tfrecords_io.py:12-44) with a minimal
hand-rolled decoder, then repacks into .rtu stores.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from rsrgan_jax.data.store import StoreWriter


def iter_tfrecord_payloads(path: str) -> Iterator[bytes]:
    """Yield raw record payloads (CRCs are skipped, like the reference's
    verifier)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            (length,) = struct.unpack("<Q", head)
            f.read(4)  # masked crc of length
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"{path}: truncated record")
            f.read(4)  # masked crc of payload
            yield payload


# --- minimal protobuf wire decoding ---------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, value_bytes) for LEN fields and
    (field, type, varint-as-bytes) otherwise."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:  # LEN
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:  # VARINT
            v, pos = _read_varint(buf, pos)
            yield field, wire, struct.pack("<Q", v)
        elif wire == 5:  # I32
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:  # I64
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_feature_floats(feature: bytes) -> np.ndarray:
    """Feature{float_list=FloatList{value: repeated float (field 1)}}."""
    for field, _, val in _iter_fields(feature):
        if field == 2:  # float_list
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    return np.frombuffer(v2, dtype="<f4")
    return np.zeros((0,), np.float32)


def _parse_feature_bytes(feature: bytes) -> bytes:
    """Feature{bytes_list=BytesList{value: repeated bytes (field 1)}}."""
    for field, _, val in _iter_fields(feature):
        if field == 1:  # bytes_list
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    return v2
    return b""


def parse_sequence_example(payload: bytes
                           ) -> Tuple[str, np.ndarray,
                                      Optional[np.ndarray]]:
    """SequenceExample -> (utt_id, inputs [T,D], labels [T,D'] or None)."""
    utt_id = ""
    lists = {}
    for field, _, val in _iter_fields(payload):
        if field == 1:  # context: Features{feature: map<string,Feature>}
            for f2, _, entry in _iter_fields(val):
                if f2 != 1:
                    continue
                key, feat = None, None
                for f3, _, v3 in _iter_fields(entry):
                    if f3 == 1:
                        key = v3.decode("utf-8")
                    elif f3 == 2:
                        feat = v3
                if key == "utt_id" and feat is not None:
                    utt_id = _parse_feature_bytes(feat).decode("utf-8")
        elif field == 2:  # feature_lists
            for f2, _, entry in _iter_fields(val):
                if f2 != 1:
                    continue
                key, rows = None, []
                for f3, _, v3 in _iter_fields(entry):
                    if f3 == 1:
                        key = v3.decode("utf-8")
                    elif f3 == 2:  # FeatureList{feature: repeated Feature}
                        for f4, _, v4 in _iter_fields(v3):
                            if f4 == 1:
                                rows.append(_parse_feature_floats(v4))
                if key is not None:
                    lists[key] = rows
    inputs = np.stack(lists["inputs"]) if lists.get("inputs") else None
    labels = np.stack(lists["labels"]) if lists.get("labels") else None
    return utt_id, inputs, labels


def convert_tfrecords_to_store(tfrecords_paths: List[str],
                               output_path: str) -> int:
    """Repack reference TFRecords into one .rtu store shard."""
    count = 0
    with StoreWriter(output_path) as writer:
        for path in tfrecords_paths:
            for payload in iter_tfrecord_payloads(path):
                utt_id, inputs, labels = parse_sequence_example(payload)
                if inputs is None:
                    raise ValueError(f"{path}: record without inputs")
                writer.add(utt_id or f"utt{count:06d}", inputs, labels)
                count += 1
    return count
