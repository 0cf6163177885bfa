"""Frame-level models: DNN, R-CED and CNN generators, the DNN discriminator.

Flax re-implementations of /root/reference/models/dnn.py, rced.py, cnn.py
and discriminator_dnn.py, imported only when a frame trainer is chosen
(rsrgan_jax/models/__init__.py).
Frame models consume spliced frames ``[B, splice*input_dim]`` (a 3-D
``[1, T, D]`` input is squeezed, mirroring dnn.py:38-47).
"""

from __future__ import annotations

from math import sqrt
from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

_GLOROT = nn.initializers.glorot_uniform()


def _as_frames(inputs: jnp.ndarray) -> jnp.ndarray:
    if inputs.ndim == 3:
        assert inputs.shape[0] == 1, "3-D input must be a [1, T, D] utterance"
        return inputs[0]
    return inputs


class DnnGenerator(nn.Module):
    """models/dnn.py:32-121 — 4x1024 ReLU + linear out, optional BN/dropout."""

    output_dim: int
    units: int = 1024
    hidden_layers: int = 3  # plus the first layer = 4 total
    keep_prob: float = 1.0
    batch_norm: bool = False

    @nn.compact
    def __call__(self, inputs, lengths=None, train: bool = False):
        h = _as_frames(inputs)
        for _ in range(1 + self.hidden_layers):
            h = nn.Dense(self.units, kernel_init=_GLOROT)(h)
            if self.batch_norm:
                h = nn.BatchNorm(use_running_average=not train,
                                 momentum=0.99)(h)
            h = nn.relu(h)
            if train and self.keep_prob < 1.0:
                h = nn.Dropout(rate=1.0 - self.keep_prob,
                               deterministic=False)(h)
        y = nn.Dense(self.output_dim, kernel_init=_GLOROT)(h)
        if inputs.ndim == 3:
            y = y[None] if y.ndim == 2 else y
        return y


class RcedGenerator(nn.Module):
    """models/rced.py:34-119 — redundant conv encoder-decoder (9 conv2d
    layers over [splice, input_dim, 1] images) + linear out."""

    output_dim: int
    input_dim: int
    splice: int  # left_context + 1 + right_context
    filters_num: Sequence[int] = (12, 16, 20, 24, 32, 24, 20, 16, 12)
    filters_width: Sequence[int] = (13, 11, 9, 7, 7, 7, 9, 11, 13)
    batch_norm: bool = False

    @nn.compact
    def __call__(self, inputs, lengths=None, train: bool = False):
        frames = _as_frames(inputs)
        B = frames.shape[0]
        h = frames.reshape(B, self.splice, self.input_dim, 1)
        for n, w in zip(self.filters_num, self.filters_width):
            h = nn.Conv(n, kernel_size=(self.splice, w), padding="SAME",
                        kernel_init=_GLOROT)(h)
            if self.batch_norm:
                h = nn.BatchNorm(use_running_average=not train,
                                 momentum=0.99)(h)
            h = nn.relu(h)
        h = h.reshape(B, self.splice * self.input_dim * self.filters_num[-1])
        y = nn.Dense(self.output_dim, kernel_init=_GLOROT,
                     bias_init=nn.initializers.constant(0.1))(h)
        if inputs.ndim == 3:
            y = y[None]
        return y


class CnnGenerator(nn.Module):
    """Working version of models/cnn.py (the reference file is dead code with
    undefined names, cnn.py:89-102): 2 conv layers + FC out."""

    output_dim: int
    input_dim: int
    splice: int
    filters_num: Sequence[int] = (32, 64)
    filters_width: int = 11

    @nn.compact
    def __call__(self, inputs, lengths=None, train: bool = False):
        frames = _as_frames(inputs)
        B = frames.shape[0]
        h = frames.reshape(B, self.splice, self.input_dim, 1)
        for n in self.filters_num:
            h = nn.Conv(n, kernel_size=(self.splice, self.filters_width),
                        padding="SAME", kernel_init=_GLOROT)(h)
            h = nn.relu(h)
        h = h.reshape(B, -1)
        h = nn.relu(nn.Dense(1024, kernel_init=_GLOROT)(h))
        y = nn.Dense(self.output_dim, kernel_init=_GLOROT)(h)
        if inputs.ndim == 3:
            y = y[None]
        return y


class DnnDiscriminator(nn.Module):
    """discriminator_dnn.py:21-98 — 4x1024 ReLU (He-ish truncated-normal
    init), linear 1-unit out clipped to [-0.5, 1.5]."""

    units: int = 1024
    hidden_layers: int = 3
    keep_prob: float = 1.0
    clip_output: bool = True

    @nn.compact
    def __call__(self, inputs, train: bool = False):
        relu_init = nn.initializers.truncated_normal(
            stddev=sqrt(2.0 / self.units))
        h = inputs
        for _ in range(1 + self.hidden_layers):
            h = nn.relu(nn.Dense(self.units, kernel_init=relu_init)(h))
            if train and self.keep_prob < 1.0:
                h = nn.Dropout(rate=1.0 - self.keep_prob,
                               deterministic=False)(h)
        y = nn.Dense(1, kernel_init=_GLOROT)(h)
        if self.clip_output:
            y = jnp.clip(y, -0.5, 1.5)  # discriminator_dnn.py:93
        return y
