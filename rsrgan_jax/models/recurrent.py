"""Recurrent generators: LSTM and RES_LSTM_{BASE,I,L}.

Re-implementations of the reference generator zoo
(/root/reference/models/lstm.py, res_lstm_base.py, res_lstm_i.py,
res_lstm_l.py) over plain parameter pytrees (rsrgan_jax/ops/lstm.py). All
take batch-major ``[B, T, D]`` features plus true lengths and return
``[B, T, output_dim]``. The recurrent-BN generator lives in
rsrgan_jax/models/bnlstm.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from rsrgan_jax.ops.common import leakyrelu
from rsrgan_jax.ops.lstm import (Model, StackedLstm, dense, dropout,
                                 init_cell, init_dense, lstm_layer)


@dataclasses.dataclass(frozen=True)
class LstmGenerator(Model):
    """models/lstm.py:41-129 — leakyrelu FC to 280, 3x LSTM(760, proj 280),
    linear out. Parameters: Dense_0, StackedLstm_0/cell_k, Dense_1."""

    output_dim: int
    cell_size: int = 760
    num_projection: int = 280
    num_layers: int = 3
    keep_prob: float = 1.0
    compute_dtype: Any = jnp.float32

    def _stack(self) -> StackedLstm:
        return StackedLstm(self.num_layers, self.cell_size,
                           self.num_projection,
                           compute_dtype=self.compute_dtype,
                           dropout_keep_prob=self.keep_prob)

    def init_params(self, key, input_dim: int) -> dict:
        k_in, k_stack, k_out = jax.random.split(key, 3)
        return {"Dense_0": init_dense(k_in, input_dim, self.num_projection),
                "StackedLstm_0": self._stack().init_params(
                    k_stack, self.num_projection),
                "Dense_1": init_dense(k_out, self.num_projection,
                                      self.output_dim)}

    def __call__(self, params, inputs, lengths=None, train: bool = False, *,
                 rngs=None):
        h = leakyrelu(dense(params["Dense_0"], inputs))
        h = self._stack()(params["StackedLstm_0"], h, lengths, train,
                          rngs=rngs)
        return dense(params["Dense_1"], h)


@dataclasses.dataclass(frozen=True)
class ResLstmGenerator(Model):
    """The residual-LSTM family; ``variant`` selects the wiring:

    * "base": 4 stacked LSTM(760, proj=input_dim), no residual, out from
      outputs4 (models/res_lstm_base.py:110-196)
    * "i": 2 layers, input residual — every layer input and the output tap
      add the ORIGINAL inputs (models/res_lstm_i.py:100-192)
    * "l" (flagship): 4 layers, layer residual — inputs_{k+1} = outputs_k +
      inputs_k, out from outputs4 + inputs4 (models/res_lstm_l.py:101-194)

    The projection size equals the input feature dim (257) so residual adds
    type-check, exactly as the reference requires. Parameters:
    lstm_cell_1..lstm_cell_N, forward_out.
    """

    output_dim: int
    variant: str = "l"
    cell_size: int = 760
    keep_prob: float = 1.0
    compute_dtype: Any = jnp.float32

    def __post_init__(self):
        if self.variant not in ("base", "i", "l"):
            raise ValueError(f"unknown res_lstm variant {self.variant}")

    @property
    def num_layers(self) -> int:
        return 2 if self.variant == "i" else 4

    def init_params(self, key, input_dim: int) -> dict:
        keys = jax.random.split(key, self.num_layers + 1)
        params = {f"lstm_cell_{k + 1}": init_cell(keys[k], input_dim,
                                                  self.cell_size, input_dim)
                  for k in range(self.num_layers)}
        params["forward_out"] = init_dense(keys[-1], input_dim,
                                           self.output_dim)
        return params

    def __call__(self, params, inputs, lengths=None, train: bool = False, *,
                 rngs=None):
        def cell(k, h):
            out = lstm_layer(params[f"lstm_cell_{k + 1}"], h, lengths,
                             compute_dtype=self.compute_dtype)[0]
            if train and self.keep_prob < 1.0:
                out = dropout(rngs, k, out, self.keep_prob)
            return out

        layer_in = inputs
        for k in range(self.num_layers):
            out = cell(k, layer_in)
            if self.variant == "l":
                layer_in = out + layer_in  # layer residual
            elif self.variant == "i":
                layer_in = out + inputs  # input residual (original inputs)
            else:
                layer_in = out  # plain stack
        return dense(params["forward_out"], layer_in)
