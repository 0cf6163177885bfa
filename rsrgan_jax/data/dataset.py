"""Batch iterators: length-bucketed padded sequence batches and shuffled
frame batches.

A static-shape redesign of the reference's two input pipelines
(io_funcs/tfrecords_dataset.py:53-293, tfrecords_io.py:47-255):

* Sequence batches reproduce the bucketing rule of
  tfrecords_dataset.py:157-171 (bucket key = (len-200)//50, grouped into
  windows of batch_size) but pad each batch UP TO THE BUCKET EDGE instead of
  to the batch max, so every bucket maps to one static [B, T_pad, D] shape —
  a small, fixed set of XLA compilations instead of a recompile per batch.
* Frame batches replace the RandomShuffleQueue frame pipeline
  (tfrecords_io.py:206-255): utterances are spliced then frames are drawn
  via a shuffled global index.
* Batch counts are computed from the store index (the reference instead ran
  the whole pipeline to OutOfRange once per config and cached the count,
  scripts/train_gan_rnn_placeholder.py:305-385).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from rsrgan_jax.data.splice import splice_frames_np
from rsrgan_jax.data.store import UtteranceStore

BUCKET_START = 200   # tfrecords_dataset.py:164
BUCKET_WIDTH = 50    # tfrecords_dataset.py:165
NUM_BUCKETS = 20     # tfrecords_dataset.py:55


def bucket_id(length: int, num_buckets: int = NUM_BUCKETS) -> int:
    """Bucket key from tfrecords_dataset.py:158-167 (negatives allowed)."""
    return min(num_buckets, (length - BUCKET_START) // BUCKET_WIDTH)


def padded_length(bucket: int, max_len: int,
                  num_buckets: int = NUM_BUCKETS) -> int:
    """Static padded length for a bucket.

    Regular buckets pad to the bucket's upper edge. The overflow bucket pads
    to max_len rounded up to a 128-frame boundary (rare, bounded recompiles).
    """
    if bucket >= num_buckets:
        return -(-max_len // 128) * 128
    return BUCKET_START + BUCKET_WIDTH * (bucket + 1)


@dataclass
class SequenceBatch:
    utt_ids: List[str]
    inputs: np.ndarray   # [B, T_pad, D * (left+1+right)] float32
    labels: Optional[np.ndarray]  # [B, T_pad, out] float32 or None
    lengths: np.ndarray  # [B] int32 (true lengths before padding)


class SequenceBatcher:
    """Length-bucketed padded utterance batches (get_padded_batch parity).

    One epoch: shuffle utterances, assign to buckets in shuffled order, emit
    a batch whenever a bucket holds ``batch_size`` utterances. Leftover
    partial buckets are dropped when drop_remainder=True, matching the
    training loop's skip of ragged batches
    (scripts/train_gan_rnn_placeholder.py:69-70).
    """

    def __init__(self, store: UtteranceStore, batch_size: int,
                 left_context: int = 0, right_context: int = 0,
                 num_buckets: int = NUM_BUCKETS, shuffle: bool = True,
                 drop_remainder: bool = True, seed: int = 777):
        self.store = store
        self.batch_size = batch_size
        self.left_context = left_context
        self.right_context = right_context
        self.num_buckets = num_buckets
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        self._lengths = store.lengths

    def num_batches(self) -> int:
        """Exact number of full batches per epoch, computed from the index."""
        counts: Dict[int, int] = {}
        for length in self._lengths:
            b = bucket_id(int(length), self.num_buckets)
            counts[b] = counts.get(b, 0) + 1
        if self.drop_remainder:
            return sum(c // self.batch_size for c in counts.values())
        return sum(-(-c // self.batch_size) for c in counts.values())

    def _make_batch(self, indices: List[int],
                    t_pad: Optional[int] = None) -> SequenceBatch:
        lengths = np.array([self._lengths[i] for i in indices], dtype=np.int32)
        if t_pad is None:
            bucket = bucket_id(int(lengths.max()), self.num_buckets)
            t_pad = padded_length(bucket, int(lengths.max()),
                                  self.num_buckets)
        splice = self.left_context + 1 + self.right_context
        in_dim = self.store.input_dim * splice
        # np.empty + per-row tail zeroing: zeroing the whole buffer costs
        # more than the payload writes when lengths sit near the bucket
        # edge (the common case) — the feed host must outrun the chip
        inputs = np.empty((len(indices), t_pad, in_dim), dtype=np.float32)
        out_dim = self.store.output_dim
        labels = (np.empty((len(indices), t_pad, out_dim), dtype=np.float32)
                  if self.store.has_labels else None)
        utt_ids = []
        for row, i in enumerate(indices):
            utt_ids.append(self.store.utt_ids[i])
            feats = self.store.inputs(i)
            t_i = feats.shape[0]
            splice_frames_np(feats, self.left_context,
                             self.right_context, out=inputs[row])
            inputs[row, t_i:] = 0.0
            if labels is not None:
                lab = self.store.labels(i)
                if lab.shape[0] != t_i:
                    # legacy stores written before StoreWriter rejected
                    # frame-misaligned pairs fail legibly, not with a
                    # numpy broadcast error
                    raise ValueError(
                        f"utt {self.store.utt_ids[i]}: inputs have {t_i} "
                        f"frames but labels have {lab.shape[0]}; the store "
                        f"was written from frame-misaligned scp pairs")
                labels[row, :t_i] = lab
                labels[row, t_i:] = 0.0
        return SequenceBatch(utt_ids, inputs, labels, lengths)

    def iter_index_batches(self) -> Iterator[List[int]]:
        """The epoch's batch PLAN (utterance-index lists), separated from
        feature materialization so multi-host runs can share one global
        plan and each host materialize only its rows (see
        HostShardedSequenceBatches)."""
        order = np.arange(len(self.store))
        if self.shuffle:
            self._rng.shuffle(order)
        pending: Dict[int, List[int]] = {}
        for i in order:
            b = bucket_id(int(self._lengths[i]), self.num_buckets)
            pending.setdefault(b, []).append(int(i))
            if len(pending[b]) == self.batch_size:
                yield pending.pop(b)
        if not self.drop_remainder:
            yield from pending.values()

    def __iter__(self) -> Iterator[SequenceBatch]:
        for indices in self.iter_index_batches():
            yield self._make_batch(indices)

    def epochs(self, n: int) -> Iterator[SequenceBatch]:
        for _ in range(n):
            yield from self


class FrameBatcher:
    """Shuffled frame-level batches for the DNN/RCED family.

    Replaces the RandomShuffleQueue pipeline (tfrecords_io.py:206-255): all
    utterances are spliced into a flat frame table once (memory-mapped
    sources, materialized spliced copies), then each epoch draws a fresh
    permutation. drop_remainder mirrors dequeue_many semantics.
    """

    def __init__(self, store: UtteranceStore, batch_size: int,
                 left_context: int = 0, right_context: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True,
                 seed: int = 777):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        ins, labs = [], []
        for i in range(len(store)):
            ins.append(splice_frames_np(np.asarray(store.inputs(i)),
                                        left_context, right_context))
            if store.has_labels:
                labs.append(np.asarray(store.labels(i)))
        self.inputs = np.concatenate(ins, axis=0).astype(np.float32)
        self.labels = (np.concatenate(labs, axis=0).astype(np.float32)
                       if labs else None)

    @property
    def num_frames(self) -> int:
        return self.inputs.shape[0]

    def num_batches(self) -> int:
        if self.drop_remainder:
            return self.num_frames // self.batch_size
        return -(-self.num_frames // self.batch_size)

    def iter_index_batches(self):
        """Epoch batch plan as frame-index arrays (see
        SequenceBatcher.iter_index_batches)."""
        order = np.arange(self.num_frames)
        if self.shuffle:
            self._rng.shuffle(order)
        stop = (self.num_frames - self.num_frames % self.batch_size
                if self.drop_remainder else self.num_frames)
        for start in range(0, stop, self.batch_size):
            yield order[start:start + self.batch_size]

    def _make_batch(self, sel):
        return (self.inputs[sel],
                self.labels[sel] if self.labels is not None else None)

    def __iter__(self):
        for sel in self.iter_index_batches():
            yield self._make_batch(sel)

    def epochs(self, n: int):
        for _ in range(n):
            yield from self


class HostShardedSequenceBatches:
    """Per-host view of a GLOBAL SequenceBatcher plan.

    Every process constructs the same batcher (same store list + seed) and
    wraps it with its (process_index, process_count); each host then
    materializes only its contiguous row block of every global batch, with
    the global batch's padded length. Shapes and batch counts are identical
    across hosts by construction — the property multi-host pjit dispatch
    requires — and the concatenation of all hosts' blocks is exactly the
    single-host global batch (true global shuffling, no per-host data
    silos).
    """

    def __init__(self, batcher: "SequenceBatcher", process_index: int,
                 process_count: int):
        if batcher.batch_size % process_count:
            raise ValueError(
                f"global batch {batcher.batch_size} not divisible by "
                f"{process_count} processes")
        self.batcher = batcher
        self.rows = batcher.batch_size // process_count
        self.process_index = process_index
        if self.num_batches() == 0:
            raise ValueError(
                "multi-host run would yield ZERO full global batches "
                f"(batch {batcher.batch_size} over {process_count} "
                "processes; ragged batches cannot be row-sharded) — "
                "reduce --batch_size or use a larger corpus")

    def num_batches(self) -> int:
        # only FULL global batches are row-shardable; ragged ones are
        # skipped by __iter__, so never count them
        counts: Dict[int, int] = {}
        for length in self.batcher._lengths:
            k = bucket_id(int(length), self.batcher.num_buckets)
            counts[k] = counts.get(k, 0) + 1
        return sum(c // self.batcher.batch_size for c in counts.values())

    def __iter__(self) -> Iterator[SequenceBatch]:
        b = self.batcher
        for indices in b.iter_index_batches():
            if len(indices) != b.batch_size:
                continue  # ragged global batch: every host must skip it
            lens = [int(b._lengths[i]) for i in indices]
            bucket = bucket_id(max(lens), b.num_buckets)
            t_pad = padded_length(bucket, max(lens), b.num_buckets)
            lo = self.process_index * self.rows
            yield b._make_batch(indices[lo:lo + self.rows], t_pad=t_pad)


class HostShardedFrameBatches:
    """Per-host view of a global FrameBatcher plan (frame-level twin of
    HostShardedSequenceBatches)."""

    def __init__(self, batcher: "FrameBatcher", process_index: int,
                 process_count: int):
        if batcher.batch_size % process_count:
            raise ValueError(
                f"global batch {batcher.batch_size} not divisible by "
                f"{process_count} processes")
        self.batcher = batcher
        self.rows = batcher.batch_size // process_count
        self.process_index = process_index
        if self.num_batches() == 0:
            raise ValueError(
                "multi-host run would yield ZERO full global batches — "
                "reduce --batch_size or use a larger corpus")

    def num_batches(self) -> int:
        # full batches only (__iter__ skips the ragged tail)
        return self.batcher.num_frames // self.batcher.batch_size

    def __iter__(self):
        lo = self.process_index * self.rows
        for sel in self.batcher.iter_index_batches():
            if len(sel) != self.batcher.batch_size:
                continue
            yield self.batcher._make_batch(sel[lo:lo + self.rows])


def infer_batches(store: UtteranceStore, left_context: int = 0,
                  right_context: int = 0,
                  pad_to_multiple: int = 128) -> Iterator[SequenceBatch]:
    """Batch-1 inference iterator (decode path, tfrecords_dataset.py:233-293).

    Pads T to a multiple of ``pad_to_multiple`` so decode reuses a small set
    of compiled shapes; true length rides along for unpadding before the
    ark write.
    """
    for i in range(len(store)):
        feats = splice_frames_np(np.asarray(store.inputs(i)),
                                 left_context, right_context)
        t = feats.shape[0]
        t_pad = -(-t // pad_to_multiple) * pad_to_multiple
        padded = np.zeros((1, t_pad, feats.shape[1]), dtype=np.float32)
        padded[0, :t] = feats
        yield SequenceBatch([store.utt_ids[i]], padded, None,
                            np.array([t], dtype=np.int32))


class ThreadedPrefetcher:
    """Producer-thread + bounded queue, the reference's feeder pattern
    (scripts/train_gan_rnn_placeholder.py:30-45,463-478) minus feed_dict."""

    _DONE = object()

    def __init__(self, iterator, capacity: int = 32):
        self._queue: "queue_mod.Queue" = queue_mod.Queue(capacity)
        self._error = None
        self._thread = threading.Thread(
            target=self._run, args=(iterator,), daemon=True)
        self._thread.start()

    def _run(self, iterator):
        try:
            for item in iterator:
                self._queue.put(item)
        except BaseException as e:  # surfaced to the consumer, not dropped
            self._error = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._DONE:
                if self._error is not None:
                    raise RuntimeError(
                        "prefetch producer failed") from self._error
                return
            yield item
