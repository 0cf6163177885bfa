"""Recurrent batch-norm LSTM generator (flax; off the main path).

Re-implementation of /root/reference/models/bnlstm.py. Imported only when
``--g_type bnlstm`` is chosen (rsrgan_jax/models/__init__.py).
"""

from __future__ import annotations

from typing import Any

import flax.linen as nn
import jax.numpy as jnp

from rsrgan_jax.ops.bnlstm import BnLstmCell

_GLOROT = nn.initializers.glorot_uniform()


class BnLstmGenerator(nn.Module):
    """models/bnlstm.py:38-127 — relu FC to 280, 3x recurrent-BN LSTM cells,
    linear out."""

    output_dim: int
    cell_size: int = 760
    num_projection: int = 280
    num_layers: int = 3
    compute_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, inputs, lengths=None, train: bool = False):
        h = nn.relu(nn.Dense(self.num_projection, kernel_init=_GLOROT)(inputs))
        for layer in range(self.num_layers):
            h = BnLstmCell(self.cell_size, self.num_projection,
                           compute_dtype=self.compute_dtype,
                           name=f"cell_{layer}")(h, lengths, train)
        return nn.Dense(self.output_dim, kernel_init=_GLOROT)(h)
