"""Sequence LSTM discriminator.

Re-implementation of /root/reference/models/discriminator_lstm.py over
plain parameter pytrees. The frame DNN-D lives in
rsrgan_jax/models/feedforward.py and the SEGAN conv discriminator in
rsrgan_jax/models/segan.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from rsrgan_jax.ops.common import gaussian_noise
from rsrgan_jax.ops.lstm import Model, StackedLstm, dense, init_dense


@dataclasses.dataclass(frozen=True)
class LstmDiscriminator(Model):
    """discriminator_lstm.py:24-110 — annealed gaussian input noise, 2x
    LSTM(256, proj 40, peepholes), per-timestep linear 1-unit logit.
    Parameters: StackedLstm_0/cell_k, Dense_0.

    ``noise_std`` may be a traced scalar (the exponentially decayed
    disc_noise_std); noise is applied whenever a 'noise' rng is provided —
    the reference applies it unconditionally, during CV evaluation too
    (discriminator_lstm.py:60). Dropout alone is gated on ``train``.
    """

    cell_size: int = 256
    num_projection: int = 40
    num_layers: int = 2
    keep_prob: float = 1.0
    compute_dtype: Any = jnp.float32

    def _stack(self) -> StackedLstm:
        return StackedLstm(self.num_layers, self.cell_size,
                           self.num_projection,
                           compute_dtype=self.compute_dtype,
                           dropout_keep_prob=self.keep_prob)

    def init_params(self, key, input_dim: int) -> dict:
        k_stack, k_out = jax.random.split(key)
        return {"StackedLstm_0": self._stack().init_params(k_stack,
                                                           input_dim),
                "Dense_0": init_dense(k_out, self.num_projection, 1)}

    def __call__(self, params, inputs, lengths=None, noise_std=0.0,
                 train: bool = False, *, rngs=None):
        h = inputs
        if "noise" in rngs:
            h = gaussian_noise(rngs["noise"], h, noise_std)
        h = self._stack()(params["StackedLstm_0"], h, lengths, train,
                          rngs=rngs)
        return dense(params["Dense_0"], h)  # [B, T, 1]
