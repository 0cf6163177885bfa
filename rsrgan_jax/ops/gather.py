"""On-device sequence-batch assembly from resident feature tables.

The reference feeds every batch from host memory through ``feed_dict``
(scripts/train_gan_rnn_placeholder.py:66-112), re-shipping the whole
corpus every iteration. This design instead keeps the corpus resident in
device memory as one flat ``[total_frames + 1, D]`` table (last row
all-zero) and assembles each padded batch **on device** with a single
gather per splice offset — the host sends only ``[B]`` int32 index plans.

Semantics are bit-identical to the host batcher
(rsrgan_jax/data/dataset.py SequenceBatcher._make_batch):

* frames past each row's true length come from the zero row (same as the
  batcher's tail zeroing),
* splice context is edge-clamped within the utterance
  (splice_frames_np parity: clip(t+off, 0, len-1)),
* output is float32 regardless of the table dtype (a bfloat16 table is an
  opt-in transfer/HBM compression; values quantize, conventions don't).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp


def gather_sequences(table: jnp.ndarray, starts: jnp.ndarray,
                     lengths: jnp.ndarray, t_pad: int,
                     left: int = 0, right: int = 0,
                     dim: Optional[int] = None) -> jnp.ndarray:
    """``table [N+1, Dp]`` (row N all-zero) -> ``[B, t_pad, D*(left+1+right)]``.

    ``starts``/``lengths`` are ``[B]`` int32: each row b is utterance
    frames ``table[starts[b] : starts[b]+lengths[b]]``, spliced with
    edge-clamped context and zero-padded to ``t_pad``. ``dim`` is the
    logical feature width when the table carries tile-pad columns
    (device_feed.pad_dim — tables are allocated 128-lane aligned so their
    row-major layout is compact and the gather runs in place); the slice
    happens on the small gathered block, never on the table.
    """
    d = table.shape[1] if dim is None else dim
    zero_row = table.shape[0] - 1
    t = jnp.arange(t_pad, dtype=jnp.int32)[None, :]
    len_col = lengths[:, None].astype(jnp.int32)
    start_col = starts[:, None].astype(jnp.int32)
    valid = t < len_col
    cols = []
    for off in range(-left, right + 1):
        src = start_col + jnp.clip(t + off, 0, len_col - 1)
        idx = jnp.where(valid, src, zero_row)
        g = table[idx]
        cols.append(g if d == table.shape[1] else g[..., :d])
    out = cols[0] if len(cols) == 1 else jnp.concatenate(cols, axis=-1)
    return out.astype(jnp.float32)


def assemble_sequence_batch(inputs_tbl: jnp.ndarray,
                            labels_tbl: Optional[jnp.ndarray],
                            starts: jnp.ndarray, lengths: jnp.ndarray,
                            t_pad: int, left: int, right: int,
                            in_dim: Optional[int] = None,
                            out_dim: Optional[int] = None
                            ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """(spliced inputs, labels) for one batch plan; labels never spliced.

    ``in_dim``/``out_dim`` are the logical feature widths of tile-padded
    tables (None = table width, for unpadded tables)."""
    x = gather_sequences(inputs_tbl, starts, lengths, t_pad, left, right,
                         in_dim)
    y = (gather_sequences(labels_tbl, starts, lengths, t_pad, dim=out_dim)
         if labels_tbl is not None else None)
    return x, y
