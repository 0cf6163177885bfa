"""Device-mesh parallelism.

The reference's only distribution strategy is single-process in-graph data
parallelism: per-GPU towers over a sliced super-batch with concat+mean
gradient averaging (utils/ops.py:343-376, models/gan_rnn_placeholder.py:
152-189). The JAX equivalent is declarative: build a
``jax.sharding.Mesh`` over the devices, shard the batch over the ``data`` axis,
replicate (or model-shard) parameters, and let XLA insert the psum for the
gradient reduction inside the already-jitted train step. The LR x num_gpu
rule (scripts/train_gan_rnn_placeholder.py:458-461) maps to
``lr * mesh.shape['data']``.
"""

from rsrgan_jax.parallel.distributed import initialize, is_coordinator
from rsrgan_jax.parallel.mesh import (data_sharding, lstm_param_sharding,
                                      make_mesh, replicate, shard_batch,
                                      shard_state)
