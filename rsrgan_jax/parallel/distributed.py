"""Multi-host (multi-process) data parallelism over DCN.

The reference is strictly single-process (SURVEY.md section 2.9:
CUDA_VISIBLE_DEVICES tower replication, no collectives). This layer scales
the same data-parallel design across hosts:

* ``jax.distributed.initialize`` connects the processes (gRPC coordination
  service over DCN); after it, ``jax.devices()`` is the GLOBAL device list
  and one ``Mesh`` spans every chip on every host.
* Each host feeds only its own devices' rows of the global batch
  (``jax.make_array_from_process_local_data``); XLA inserts the gradient
  ``psum`` over the host's device links (NVLink) and the network
  across hosts.
* Batch plans are shared, not split: every host builds the same batcher
  (same store list + seed) and materializes its contiguous row block of
  every global batch (data/dataset.py HostSharded*Batches), so program
  shapes and dispatch counts are identical across hosts — the property
  multi-host jit dispatch requires.

Launch (per host)::

    python -m rsrgan_jax.cli.train ... \
        --coordinator_address=host0:8476 \
        --num_processes=4 --process_id=$RANK
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """Connect this process to the training job; no-op without an address.

    Must run before any other JAX device usage. Returns
    (process_index, process_count) — (0, 1) in single-process runs.
    """
    if coordinator_address:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_index(), jax.process_count()


def is_coordinator() -> bool:
    """True on the process that owns checkpoint/metrics writes."""
    return jax.process_index() == 0
