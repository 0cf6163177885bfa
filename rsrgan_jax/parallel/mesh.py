"""Mesh construction and sharding placement helpers."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D ``(data,)`` mesh, or 2-D ``(data, model)`` when model_parallel>1.

    The flagship models are <10M params, so pure DP is the production
    layout; the model axis exists to shard the 760-unit LSTM kernels when
    scaling batch-of-one latency or for the multi-chip dryrun.
    """
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    n = len(devices)
    if model_parallel > 1:
        assert n % model_parallel == 0
        arr = np.asarray(devices).reshape(n // model_parallel,
                                          model_parallel)
        return Mesh(arr, ("data", "model"))
    return Mesh(np.asarray(devices), ("data",))


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> NamedSharding:
    """Batch sharding over the 'data' axis at dimension ``axis``."""
    spec = [None] * ndim
    spec[axis] = "data"
    return NamedSharding(mesh, P(*spec))


def shard_batch(mesh: Mesh, tree: Any, axis: int = 0) -> Any:
    """Place per-host batch arrays as globally data-sharded arrays.

    axis=1 handles stacked multi-step batches [N, B, ...] where N is the
    scan axis and B the data-parallel batch. In multi-process runs each
    host passes only ITS rows (see HostSharded*Batches); the global array
    is assembled from every process's local block.
    """
    multihost = jax.process_count() > 1

    def put(x):
        sharding = data_sharding(mesh, np.ndim(x), axis)
        if multihost:
            return jax.make_array_from_process_local_data(
                sharding, np.asarray(x))
        return jax.device_put(x, sharding)

    return jax.tree.map(put, tree)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Fully replicate a pytree over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def lstm_param_sharding(mesh: Mesh, path_str: str,
                        leaf: Any) -> NamedSharding:
    """Tensor-parallel placement rules for the LSTM stacks.

    The gate dimension (4U) is the natural TP axis: ``kernel [D+P, 4U]``
    and ``bias [4U]`` shard their last axis, the projection ``[U, P]``
    shards its first (contracting) axis so the recurrent matmul chain
    needs a single reduce-scatter/all-gather pair per step.
    Everything else is replicated.
    """
    if "model" not in mesh.axis_names:
        return NamedSharding(mesh, P())
    m = mesh.shape["model"]
    # plain kernel/bias rules apply only inside LSTM cell modules
    # (lstm_cell_N / cell_k / BnLstmCell_N); a Dense kernel whose output
    # dim happens to divide 4*m (e.g. the 40-wide forward_out) must stay
    # replicated — it is not a gate-dim tensor
    in_cell = "cell" in path_str.lower()
    if (leaf.ndim == 2 and in_cell and "kernel" in path_str
            and "proj" not in path_str and leaf.shape[1] % (4 * m) == 0):
        return NamedSharding(mesh, P(None, "model"))
    if (leaf.ndim == 2 and "proj_kernel" in path_str
            and leaf.shape[0] % m == 0):
        return NamedSharding(mesh, P("model", None))
    if (leaf.ndim == 1 and in_cell and "bias" in path_str
            and leaf.shape[0] % (4 * m) == 0):
        return NamedSharding(mesh, P("model"))
    return NamedSharding(mesh, P())


def shard_state(mesh: Mesh, state: Any, tensor_parallel: bool = False
                ) -> Any:
    """Place a train state on the mesh: replicated, or TP-sharded LSTM
    kernels when ``tensor_parallel`` and the mesh has a model axis."""
    if not tensor_parallel or "model" not in mesh.axis_names:
        return replicate(mesh, state)

    flat, treedef = jax.tree_util.tree_flatten_with_path(state)
    out = []
    for path, leaf in flat:
        path_str = "/".join(str(getattr(p, "key", p)) for p in path)
        if hasattr(leaf, "ndim"):
            out.append(jax.device_put(
                leaf, lstm_param_sharding(mesh, path_str, leaf)))
        else:
            out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)
