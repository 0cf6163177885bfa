"""Device-resident corpus: upload the store's feature payload to HBM once.

The classic host-fed loop re-ships every batch's features each iteration
(~2.9 GB per pass at reference scale). ``DeviceFeed`` uploads the flat
frame tables ONCE (chunked ``device_put`` + one on-device concat) and
training assembles batches on device from ``[S, B]`` int32 index plans
(rsrgan_jax/ops/gather.py), cutting per-iteration transfer to kilobytes.
What that saves on a GPU host has not been measured (ROADMAP S4).

Replaces the host/device boundary of the reference's feeder-thread +
feed_dict design (scripts/train_gan_rnn_placeholder.py:30-45,463-478)
rather than mirroring it: the device has the memory to hold the working
corpus (reference scale ~100 h of 257-dim LPS ~= 9 GB in bfloat16).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rsrgan_jax.data.store import UtteranceStore

_DEFAULT_CHUNK_BYTES = 1 << 28  # 256 MB: amortizes the per-put fixed cost

_LANE = 128  # minor-dim padding unit of the resident tables


def pad_dim(d: int) -> int:
    """Feature dim rounded up to a multiple of 128.

    A choice from the earlier accelerator, whose compiler stored a table
    with a non-aligned minor dim in another layout and then copied both
    full tables inside the training program. Whether the padding (257 ->
    384 columns, 1.5x memory) helps or costs on a GPU awaits measurement
    (ROADMAP D3)."""
    return -(-d // _LANE) * _LANE


def table_bytes(store: UtteranceStore, itemsize: int = 4) -> int:
    """HBM footprint of a store's resident tables at the given itemsize
    (tile-padded widths — what the device actually allocates)."""
    total = int(store.lengths.sum()) + 1  # +1: the zero pad row
    dims = pad_dim(store.input_dim)
    if store.has_labels:
        dims += pad_dim(store.output_dim)
    return total * dims * itemsize


@partial(jax.jit, donate_argnums=0, static_argnums=3)
def _write_chunk(table: jnp.ndarray, chunk: jnp.ndarray,
                 offset: jnp.ndarray, cast) -> jnp.ndarray:
    """In-place (donated) row-block write — keeps the upload's HBM peak at
    table + one chunk instead of the 2x-table transient a device-side
    concatenate of all chunks would need (at reference scale the f32
    tables alone are ~half of HBM; the concat peak OOMed). ``cast``
    converts a narrower wire dtype to the table dtype on device."""
    if cast:
        chunk = chunk.astype(table.dtype)
    return jax.lax.dynamic_update_slice(table, chunk,
                                        (offset, jnp.int32(0)))


def wire_dtype_for(dtype) -> np.dtype:
    """Dtype feature chunks travel in over the host->device link.

    bfloat16 tables ship as float16: numpy converts f32->f16 natively
    (ml_dtypes bf16 casts are slower), the link moves half the f32
    bytes, and the on-device f16->bf16 cast is free.
    Features are CMVN-normalized z-scores (|x| < ~40), far inside f16
    range, and the f16 mantissa (10 bits) is wider than bf16's (7), so
    f32->f16->bf16 lands within 1 bf16 ulp of the direct f32->bf16
    quantization (exact except double rounding on values within an f16
    half-ulp of a bf16 rounding midpoint — tests/test_device_feed.py
    TestWireDtype pins the bound; the bf16 table is a lossy opt-in
    already, so a terminal-bit difference is inside its contract).
    float32 tables ship as float32 — they are the exactness path.
    Override with RSRGAN_FEED_WIRE_DTYPE={float32,float16,bfloat16}.
    """
    import os
    env = os.environ.get("RSRGAN_FEED_WIRE_DTYPE")
    if env:
        wire = jnp.dtype(env)
        if wire.itemsize < jnp.dtype(dtype).itemsize:
            # e.g. float16 wire under float32 tables: the f32 path is the
            # exactness contract, so a lossy override must be visible
            import sys
            print(f"[device_feed] WARNING: RSRGAN_FEED_WIRE_DTYPE={env} is "
                  f"narrower than the {jnp.dtype(dtype).name} tables — "
                  "host->device transfer is LOSSY", file=sys.stderr)
        return wire
    return np.dtype(np.float16) if jnp.dtype(dtype) == jnp.bfloat16 \
        else jnp.dtype(dtype)


def _replicated(mesh):
    from jax.sharding import NamedSharding, PartitionSpec
    return NamedSharding(mesh, PartitionSpec())


def _make_table(table_rows: int, dim: int, dtype, mesh=None) -> jnp.ndarray:
    """Zeroed ``[table_rows + 1, pad_dim(dim)]`` device table.

    zeros-init covers the pad row (last index) AND the tile-pad columns
    (dim..pad_dim) by construction. Under a mesh the table is REPLICATED
    (every device holds the full corpus slab) so data-parallel replicas
    gather their batch shard locally with no collectives — the per-step
    wire cost stays [S, B] int32 plans either way."""
    if mesh is not None:
        return jnp.zeros((table_rows + 1, pad_dim(dim)), dtype,
                         device=_replicated(mesh))
    return jnp.zeros((table_rows + 1, pad_dim(dim)), dtype)


def _fill_table(table: jnp.ndarray, row_fn, indices, total_rows: int,
                chunk_bytes: int, mesh=None) -> jnp.ndarray:
    """Write ``indices``' utterance rows into (donated) ``table`` rows
    ``[0, total_rows)``, uploaded in large chunks (per-transfer
    overhead makes many small puts slower than few big ones). Rows past ``total_rows`` are left untouched: a shorter shard
    re-using a longer shard's buffer leaves stale rows there, but plans
    only ever index ``[0, total_rows)`` plus the (never-written) zero
    row."""
    dim = int(np.asarray(row_fn(int(indices[0]))).shape[1]) if len(indices) \
        else table.shape[1]
    rows_per_chunk = max(1, chunk_bytes // (dim * 4))
    dtype = table.dtype
    wire = wire_dtype_for(dtype)
    cast = jnp.dtype(wire) != jnp.dtype(dtype)
    sharding = _replicated(mesh) if mesh is not None else None
    written, buf, buf_rows = 0, [], 0

    def put(block: np.ndarray) -> None:
        nonlocal table, written
        host = block.astype(wire, copy=False)
        chunk = (jax.device_put(host, sharding) if sharding is not None
                 else jax.device_put(host))
        table = _write_chunk(table, chunk, jnp.int32(written), cast)
        written += block.shape[0]

    def drain(tail: bool) -> None:
        # Emit blocks of EXACTLY rows_per_chunk (carrying the remainder)
        # so every non-tail _write_chunk shares one compiled shape —
        # utterance boundaries would otherwise make each chunk's row count
        # unique, costing one compile per chunk with no persistent-cache
        # reuse across corpora or rotation cycles.
        nonlocal buf, buf_rows
        pending = np.concatenate(buf) if len(buf) > 1 else buf[0]
        off = 0
        while pending.shape[0] - off >= rows_per_chunk:
            put(pending[off:off + rows_per_chunk])
            off += rows_per_chunk
        if tail and off < pending.shape[0]:
            put(pending[off:])
            off = pending.shape[0]
        buf_rows = pending.shape[0] - off
        buf = [pending[off:]] if buf_rows else []

    for i in indices:
        m = np.asarray(row_fn(int(i)))
        buf.append(m)
        buf_rows += m.shape[0]
        if buf_rows >= rows_per_chunk:
            drain(tail=False)
    if buf:
        drain(tail=True)
    if written != total_rows:
        # dynamic_update_slice CLAMPS out-of-range starts, so a
        # lengths-vs-rows desync would silently corrupt the table (and
        # possibly the all-zero pad row gather_sequences relies on)
        raise ValueError(
            f"store desync: uploaded {written} rows but the store index "
            f"promised {total_rows}")
    return table


def _upload_table(row_fn, n_utts: int, total_rows: int, dim: int, dtype,
                  chunk_bytes: int, mesh=None) -> jnp.ndarray:
    """All utterances' rows + one trailing zero row as a device array."""
    table = _make_table(total_rows, dim, dtype, mesh)
    return _fill_table(table, row_fn, np.arange(n_utts), total_rows,
                       chunk_bytes, mesh)


class DeviceFeed:
    """Resident (inputs, labels) tables + host-side index plans.

    ``inputs_tbl``  [total+1, pad_dim(in_dim)]  (row ``total`` all-zero;
    columns past ``in_dim`` all-zero tile padding — consumers slice with
    the logical ``in_dim``/``out_dim`` attributes)
    ``labels_tbl``  [total+1, pad_dim(out_dim)] or None (test stores)
    ``plan(indices)`` -> (starts [B] int32, lengths [B] int32) numpy arrays
    ready to stack into the ``[S, B]`` plans the gathered train steps take.
    """

    def __init__(self, store: UtteranceStore, dtype=jnp.float32,
                 chunk_bytes: int = _DEFAULT_CHUNK_BYTES, mesh=None):
        lens = store.lengths.astype(np.int64)
        total = int(lens.sum())
        if total + 1 > np.iinfo(np.int32).max:
            raise ValueError(
                f"store has {total} frames — beyond int32 gather indices; "
                "shard the corpus across multiple training runs/hosts")
        starts = np.zeros(len(lens), np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        self.starts = starts.astype(np.int32)
        self.lengths = lens.astype(np.int32)
        self.dtype = dtype
        self.in_dim = int(store.input_dim)
        self.out_dim: Optional[int] = None
        self.inputs_tbl = _upload_table(store.inputs, len(store), total,
                                        store.input_dim, dtype, chunk_bytes,
                                        mesh)
        self.labels_tbl: Optional[jnp.ndarray] = None
        if store.has_labels:
            self.out_dim = int(store.output_dim)
            self.labels_tbl = _upload_table(store.labels, len(store), total,
                                            store.output_dim, dtype,
                                            chunk_bytes, mesh)

    @property
    def num_bytes(self) -> int:
        n = self.inputs_tbl.size * self.inputs_tbl.dtype.itemsize
        if self.labels_tbl is not None:
            n += self.labels_tbl.size * self.labels_tbl.dtype.itemsize
        return int(n)

    def plan(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        ix = np.asarray(indices, np.int64)
        return self.starts[ix], self.lengths[ix]


class RotatingDeviceFeed:
    """Resident-shard rotation for corpora beyond the HBM budget.

    The reference regime trains ~100 h (~36 M frames,
    run_gan_rnn_placeholder.sh:11,163-165) — ~37 GB of tile-padded bf16
    tables against 15.75 GB of HBM. Instead of falling back to the ~30x
    slower host feed, the corpus is partitioned (seeded permutation, so
    shard composition is unbiased) into K utterance shards whose tables
    fit the budget; training visits shards in residencies of one or more
    passes (cli/train.py --feed_rotation_block) and re-fills the SAME
    donated table buffers at each rotation — every shard shares one
    table shape (max shard rows + 1), so all rotations reuse one
    compiled program set and no 2x-table transient exists.

    With ``prefetch=True`` two buffer sets ping-pong: a daemon thread
    uploads the next shard while the chip trains on the current one
    (shards are half-budget so both fit). On links where transfer and
    execution overlap, rotation cost approaches max(upload, compute)
    instead of their sum.

    Block-rotation semantics: within a residency the shard is fully
    shuffled per pass; across the run every shard receives exactly
    ``epochs`` passes. This is block-shuffled SGD — the same trade the
    reference already makes with its capacity-bounded TF queue shuffle
    (tfrecords_io.py shuffle batching), not a new approximation class.
    """

    def __init__(self, store: UtteranceStore, dtype, budget_bytes: int,
                 mesh=None, chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
                 seed: int = 777, prefetch: bool = False):
        if not store.has_labels:
            raise ValueError("RotatingDeviceFeed is a training feed; "
                             "test stores decode via infer_batches")
        self.store = store
        self.dtype = dtype
        self.mesh = mesh
        self.chunk_bytes = chunk_bytes
        self.in_dim = int(store.input_dim)
        self.out_dim = int(store.output_dim)
        lens = store.lengths.astype(np.int64)
        itemsize = jnp.dtype(dtype).itemsize
        bpf = (pad_dim(self.in_dim) + pad_dim(self.out_dim)) * itemsize
        n_buffers = 2 if prefetch else 1
        cap_rows = budget_bytes // (bpf * n_buffers) - 1
        if cap_rows < int(lens.max()):
            raise ValueError(
                f"HBM budget {budget_bytes / 1e9:.1f} GB fits only "
                f"{cap_rows} frames per shard buffer — less than the "
                f"longest utterance ({int(lens.max())})")
        perm = np.random.default_rng(seed).permutation(len(lens))
        shards, cur, cur_rows = [], [], 0
        for i in perm:
            if cur_rows + lens[i] > cap_rows:
                shards.append(np.asarray(cur, np.int64))
                cur, cur_rows = [], 0
            cur.append(int(i))
            cur_rows += int(lens[i])
        if cur:
            shards.append(np.asarray(cur, np.int64))
        self.shards = shards
        self._shard_rows = [int(lens[s].sum()) for s in shards]
        self.max_rows = max(self._shard_rows)
        # local plans per shard, aligned with each shard's utterance order
        self._local = []
        for s in shards:
            sl = lens[s]
            st = np.zeros(len(sl), np.int64)
            np.cumsum(sl[:-1], out=st[1:])
            self._local.append((st.astype(np.int32), sl.astype(np.int32)))
        self._bufs = [self._alloc() for _ in range(n_buffers)]
        self._active_buf = 0
        self._active_shard: Optional[int] = None
        self._thread = None
        self._thread_target: Optional[int] = None
        self.upload_secs = 0.0
        self.uploads = 0
        self.starts: Optional[np.ndarray] = None
        self.lengths: Optional[np.ndarray] = None
        self.inputs_tbl: Optional[jnp.ndarray] = None
        self.labels_tbl: Optional[jnp.ndarray] = None

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def _alloc(self):
        return [_make_table(self.max_rows, self.in_dim, self.dtype,
                            self.mesh),
                _make_table(self.max_rows, self.out_dim, self.dtype,
                            self.mesh)]

    def _fill(self, buf_i: int, k: int) -> None:
        import time
        t0 = time.monotonic()
        rows, ix = self._shard_rows[k], self.shards[k]
        buf = self._bufs[buf_i]
        buf[0] = _fill_table(buf[0], self.store.inputs, ix, rows,
                             self.chunk_bytes, self.mesh)
        buf[1] = _fill_table(buf[1], self.store.labels, ix, rows,
                             self.chunk_bytes, self.mesh)
        # sync so upload_secs measures the transfer, not dispatch
        jax.block_until_ready(buf[1])
        self.upload_secs += time.monotonic() - t0
        self.uploads += 1

    def _activate(self, buf_i: int, k: int) -> None:
        self._active_buf, self._active_shard = buf_i, k
        self.inputs_tbl, self.labels_tbl = self._bufs[buf_i]
        self.starts, self.lengths = self._local[k]

    def ensure_resident(self, k: int) -> None:
        """Make shard ``k`` the active table set (blocking)."""
        if self._active_shard == k:
            return
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._thread_target == k:
                self._activate(1 - self._active_buf, k)
                return
        dst = self._active_buf if len(self._bufs) == 1 \
            else 1 - self._active_buf
        self._fill(dst, k)
        self._activate(dst, k)

    def start_prefetch(self, k: int) -> None:
        """Begin uploading shard ``k`` into the inactive buffer set on a
        daemon thread (no-op without prefetch buffers, when ``k`` is
        already resident, or while a prefetch is in flight)."""
        if (len(self._bufs) == 1 or k == self._active_shard
                or self._thread is not None):
            return
        import threading
        self._thread_target = k
        self._thread = threading.Thread(
            target=self._fill, args=(1 - self._active_buf, k), daemon=True)
        self._thread.start()

    def schedule(self, epochs: int, block: int, seed: int = 0):
        """Residency plan [(shard, passes)]: every shard gets exactly
        ``epochs`` passes, in residencies of up to ``block`` consecutive
        passes, cycling shards in per-cycle shuffled order."""
        rng = np.random.default_rng(seed)
        remaining = np.full(self.num_shards, int(epochs), np.int64)
        visits = []
        while remaining.any():
            for k in rng.permutation(self.num_shards):
                if remaining[k] <= 0:
                    continue
                p = int(min(block, remaining[k]))
                visits.append((int(k), p))
                remaining[k] -= p
        return visits

    @property
    def num_bytes(self) -> int:
        n = 0
        for buf in self._bufs:
            for t in buf:
                n += t.size * t.dtype.itemsize
        return int(n)

    def plan(self, view_indices) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, lengths) local to the ACTIVE shard; ``view_indices``
        are positions within the shard (what a SequenceBatcher over
        ``StoreView(store, feed.shards[k])`` yields)."""
        ix = np.asarray(view_indices, np.int64)
        return self.starts[ix], self.lengths[ix]
