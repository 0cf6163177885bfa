"""Sharded utterance store: the replacement for TFRecords.

The reference serializes (inputs[, labels]) per utterance into TFRecord
SequenceExamples (io_funcs/make_tfrecords.py:43-91, tfrecords_io.py:12-44)
and pays a full pipeline scan just to count batches
(scripts/train_gan_rnn_placeholder.py:346-385). This store instead keeps a
flat float32 payload with a JSON index footer so that

* shards are memory-mapped (zero-copy reads, no proto parsing),
* utterance lengths are known up front (batch counts are computed, never
  scanned),
* random access is O(1) for shuffling / bucketing.

File layout (little-endian)::

    b"RTU1" | float32 payload ... | index JSON | uint64 json_len | b"RTU1"
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rsrgan_jax.data.cmvn import Cmvn
from rsrgan_jax.data.kaldi_ark import read_ark_matrix, read_scp

_MAGIC = b"RTU1"


class StoreWriter:
    """Append utterances to a single store shard."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._index: List[dict] = []

    def add(self, utt_id: str, inputs: np.ndarray,
            labels: Optional[np.ndarray] = None) -> None:
        inputs = np.ascontiguousarray(inputs, dtype="<f4")
        entry = {
            "id": utt_id,
            "io": self._f.tell(), "ir": int(inputs.shape[0]),
            "ic": int(inputs.shape[1]),
        }
        self._f.write(inputs.tobytes())
        if labels is not None:
            labels = np.ascontiguousarray(labels, dtype="<f4")
            if labels.shape[0] != inputs.shape[0]:
                # catch it here with the utt named, not as an opaque
                # broadcast error in the batcher's paired row fill
                raise ValueError(
                    f"utt {utt_id}: inputs have {inputs.shape[0]} frames "
                    f"but labels have {labels.shape[0]} — paired "
                    "utterances must be frame-aligned (trim the clean/"
                    "corrupted wavs to equal length before extraction)")
            entry.update({
                "lo": self._f.tell(), "lr": int(labels.shape[0]),
                "lc": int(labels.shape[1]),
            })
            self._f.write(labels.tobytes())
        self._index.append(entry)

    def close(self) -> None:
        blob = json.dumps(self._index).encode("utf-8")
        self._f.write(blob)
        self._f.write(struct.pack("<Q", len(blob)))
        self._f.write(_MAGIC)
        self._f.close()

    def __enter__(self) -> "StoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class UtteranceStore:
    """Memory-mapped random access over one or more store shards."""

    def __init__(self, paths: Sequence[str]):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._mmaps: List[np.memmap] = []
        self._entries: List[Tuple[int, dict]] = []  # (shard, index entry)
        for shard_idx, path in enumerate(paths):
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                head = f.read(4)
                if head != _MAGIC:
                    raise ValueError(f"{path}: not an RTU1 store")
                f.seek(size - 12)
                json_len, tail = struct.unpack("<Q", f.read(8))[0], f.read(4)
                if tail != _MAGIC:
                    raise ValueError(f"{path}: truncated store (bad footer)")
                f.seek(size - 12 - json_len)
                index = json.loads(f.read(json_len).decode("utf-8"))
            self._mmaps.append(np.memmap(path, dtype=np.uint8, mode="r"))
            self._entries.extend((shard_idx, e) for e in index)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def utt_ids(self) -> List[str]:
        return [e["id"] for _, e in self._entries]

    @property
    def lengths(self) -> np.ndarray:
        """Per-utterance frame counts, available without touching payloads."""
        return np.array([e["ir"] for _, e in self._entries], dtype=np.int64)

    @property
    def has_labels(self) -> bool:
        return bool(self._entries) and "lo" in self._entries[0][1]

    @property
    def input_dim(self) -> int:
        return self._entries[0][1]["ic"]

    @property
    def output_dim(self) -> Optional[int]:
        e = self._entries[0][1]
        return e.get("lc")

    def _matrix(self, shard: int, off: int, rows: int, cols: int) -> np.ndarray:
        raw = self._mmaps[shard][off:off + rows * cols * 4]
        return np.frombuffer(raw, dtype="<f4").reshape(rows, cols)

    def inputs(self, i: int) -> np.ndarray:
        shard, e = self._entries[i]
        return self._matrix(shard, e["io"], e["ir"], e["ic"])

    def labels(self, i: int) -> Optional[np.ndarray]:
        shard, e = self._entries[i]
        if "lo" not in e:
            return None
        return self._matrix(shard, e["lo"], e["lr"], e["lc"])

    def __getitem__(self, i: int):
        shard, e = self._entries[i]
        return e["id"], self.inputs(i), self.labels(i)


class StoreView:
    """Subset of an UtteranceStore by utterance index — the store
    interface SequenceBatcher/DeviceFeed need, over ``indices`` of the
    parent. Used by the rotating device feed to batch one resident shard
    at a time (data/device_feed.py RotatingDeviceFeed); views share the
    parent's mmaps, so they cost only the index array."""

    def __init__(self, store, indices):
        self._store = store
        self._ix = np.asarray(indices, dtype=np.int64)
        self._lengths = store.lengths[self._ix]
        ids = store.utt_ids
        self._utt_ids = [ids[i] for i in self._ix]

    def __len__(self) -> int:
        return len(self._ix)

    @property
    def utt_ids(self) -> List[str]:
        return self._utt_ids

    @property
    def lengths(self) -> np.ndarray:
        return self._lengths

    @property
    def has_labels(self) -> bool:
        return self._store.has_labels

    @property
    def input_dim(self) -> int:
        return self._store.input_dim

    @property
    def output_dim(self) -> Optional[int]:
        return self._store.output_dim

    def inputs(self, i: int) -> np.ndarray:
        return self._store.inputs(int(self._ix[i]))

    def labels(self, i: int) -> Optional[np.ndarray]:
        return self._store.labels(int(self._ix[i]))

    def __getitem__(self, i: int):
        return self._store[int(self._ix[i])]


def read_rt60_scp(rt60_scp: str) -> dict:
    """Read an ``utt_id rt60`` scalar table (make_tfrecords_rta.py)."""
    table = {}
    with open(rt60_scp) as f:
        for line in f:
            parts = line.split()
            if parts:
                table[parts[0]] = float(parts[1])
    return table


def build_store_from_scp(inputs_scp: str,
                         output_path: str,
                         labels_scp: Optional[str] = None,
                         inputs_cmvn: Optional[Cmvn] = None,
                         labels_cmvn: Optional[Cmvn] = None,
                         rt60_scp: Optional[str] = None) -> int:
    """Convert paired scp files into one store shard.

    Equivalent of io_funcs/make_tfrecords.py:43-91: asserts utt-id pairing
    between the two scp files and applies global CMVN at write time. With
    ``rt60_scp``, prepends each utterance's reverberation-time scalar as an
    extra leading input column (reverberation-time-aware training,
    io_funcs/make_tfrecords_rta.py:99-103). Returns the number of
    utterances written.
    """
    in_entries = read_scp(inputs_scp)
    lab_entries = read_scp(labels_scp) if labels_scp else None
    if lab_entries is not None and len(in_entries) != len(lab_entries):
        raise ValueError("inputs/labels scp length mismatch")
    rt60 = read_rt60_scp(rt60_scp) if rt60_scp else None

    count = 0
    with StoreWriter(output_path) as writer:
        for i, (utt_id, path, offset) in enumerate(in_entries):
            inputs = np.asarray(read_ark_matrix(path, offset), np.float64)
            if inputs_cmvn is not None:
                inputs = inputs_cmvn.apply(inputs)
            if rt60 is not None:
                col = np.full((inputs.shape[0], 1), rt60[utt_id])
                inputs = np.concatenate([col, inputs], axis=1)
            labels = None
            if lab_entries is not None:
                lab_id, lab_path, lab_off = lab_entries[i]
                assert lab_id == utt_id, (
                    f"utt id mismatch at line {i}: {utt_id} vs {lab_id}")
                labels = np.asarray(read_ark_matrix(lab_path, lab_off),
                                    np.float64)
                if labels_cmvn is not None:
                    labels = labels_cmvn.apply(labels)
            writer.add(utt_id, inputs, labels)
            count += 1
    return count


def verify_store(path: str) -> Tuple[int, int]:
    """Structural validation of a store shard (io_funcs/verify_tfrecords.py
    parity): checks magic/footer, index consistency and that every payload
    slice lies inside the file. Returns (num_utts, num_bad)."""
    store = UtteranceStore([path])  # raises on bad magic/footer
    size = os.path.getsize(path)
    bad = 0
    for shard, e in store._entries:
        end = e["io"] + e["ir"] * e["ic"] * 4
        ok = e["io"] >= 4 and end <= size
        if "lo" in e:
            lend = e["lo"] + e["lr"] * e["lc"] * 4
            ok = ok and lend <= size and e["lr"] == e["ir"]
        if not ok:
            bad += 1
    return len(store), bad


def read_list_file(list_file: str) -> List[str]:
    """Read a newline-separated list of shard paths (utils/misc.py:27-34)."""
    with open(list_file) as f:
        return [line.strip() for line in f if line.strip()]
