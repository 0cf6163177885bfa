"""SEGAN tier: conv auto-encoder generator, WaveNet-style generator, conv
discriminator with virtual batch norm.

Flax re-implementations of /root/reference/models/generator.py,
models/discriminator.py, utils/bnorm.py, as configured by models/segan.py
(g_enc_depths [16..1024], dilated blocks 1..512, D kwidth 31, G kwidth 20).
In this repo SEGAN operates on spliced feature frames [B, W], not raw
audio: D is conditioned on concat(inputs, labels/G) along the feature axis
(segan.py:188-209).
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from rsrgan_jax.ops.common import leakyrelu

_TRUNC02 = nn.initializers.truncated_normal(stddev=0.02)
_GLOROT = nn.initializers.glorot_uniform()

DEFAULT_ENC_DEPTHS = (16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 1024)
DEFAULT_DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class VirtualBatchNorm(nn.Module):
    """utils/bnorm.py:11-69 — stats frozen from the reference (init) batch,
    blended 1/(B+1) with the live batch."""

    epsilon: float = 1e-5

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        assert x.ndim == 3
        ref_mean = self.variable(
            "vbn_stats", "ref_mean",
            lambda: jnp.mean(x, axis=(0, 1), keepdims=True))
        ref_meansq = self.variable(
            "vbn_stats", "ref_meansq",
            lambda: jnp.mean(jnp.square(x), axis=(0, 1), keepdims=True))
        gamma = self.param("gamma",
                           nn.initializers.normal(stddev=0.02), (x.shape[-1],))
        beta = self.param("beta", nn.initializers.zeros, (x.shape[-1],))
        new_coeff = 1.0 / (x.shape[0] + 1.0)
        old_coeff = 1.0 - new_coeff
        mean = (new_coeff * jnp.mean(x, axis=(0, 1), keepdims=True)
                + old_coeff * ref_mean.value)
        mean_sq = (new_coeff * jnp.mean(jnp.square(x), (0, 1), keepdims=True)
                   + old_coeff * ref_meansq.value)
        std = jnp.sqrt(self.epsilon + mean_sq - jnp.square(mean))
        return (x - mean) / std * (1.0 + gamma) + beta


def _downconv(x, features, kwidth, name, use_bias):
    """Strided conv1d (utils/ops.py:78-98), stride 2, SAME padding."""
    return nn.Conv(features, kernel_size=(kwidth,), strides=(2,),
                   padding="SAME", use_bias=use_bias, kernel_init=_TRUNC02,
                   name=name)(x)


class SeganAEGenerator(nn.Module):
    """AEGenerator (generator.py:112-295): 11-layer strided conv encoder,
    latent z concat, mirrored transposed-conv decoder with skip concats,
    leakyrelu (or prelu), final dense to ``units``."""

    units: int
    enc_depths: Sequence[int] = DEFAULT_ENC_DEPTHS
    kwidth: int = 20
    z_on: bool = True
    do_prelu: bool = False
    bias_downconv: bool = False
    bias_deconv: bool = False

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        if x.ndim == 2:
            h = x[:, :, None]
        elif x.ndim == 3:
            h = x
        else:
            raise ValueError("Generator input must be 2-D or 3-D")
        skips = []
        for i, depth in enumerate(self.enc_depths):
            h = _downconv(h, depth, self.kwidth, f"enc_{i}",
                          self.bias_downconv)
            if i < len(self.enc_depths) - 1:
                skips.append(h)
            if self.do_prelu:
                alpha = self.param(f"enc_prelu_{i}", nn.initializers.zeros,
                                   (h.shape[-1],))
                h = nn.relu(h) + alpha * (h - jnp.abs(h)) * 0.5
            else:
                h = leakyrelu(h)

        if self.z_on:
            if self.has_rng("z"):
                z = jax.random.normal(self.make_rng("z"),
                                      (h.shape[0], h.shape[1],
                                       self.enc_depths[-1]))
            else:  # deterministic fallback (infer without z rng)
                z = jnp.zeros((h.shape[0], h.shape[1], self.enc_depths[-1]))
            h = jnp.concatenate([z, h], axis=2)

        dec_depths = tuple(self.enc_depths[:-1][::-1]) + (1,)
        for i, depth in enumerate(dec_depths):
            h = nn.ConvTranspose(depth, kernel_size=(self.kwidth,),
                                 strides=(2,), padding="SAME",
                                 use_bias=self.bias_deconv,
                                 kernel_init=_TRUNC02,
                                 name=f"dec_{i}")(h)
            if i < len(dec_depths) - 1:
                skip = skips[-(i + 1)]
                # crop/pad to the skip length (TF deconv takes output_shape)
                if h.shape[1] > skip.shape[1]:
                    h = h[:, :skip.shape[1]]
                elif h.shape[1] < skip.shape[1]:
                    h = jnp.pad(h, ((0, 0),
                                    (0, skip.shape[1] - h.shape[1]),
                                    (0, 0)))
                if self.do_prelu:
                    alpha = self.param(f"dec_prelu_{i}",
                                       nn.initializers.zeros,
                                       (h.shape[-1],))
                    h = nn.relu(h) + alpha * (h - jnp.abs(h)) * 0.5
                else:
                    h = leakyrelu(h)
                h = jnp.concatenate([h, skip], axis=2)
            else:
                h = h[:, :, 0] if h.shape[-1] == 1 else h.mean(-1)
                h = nn.Dense(self.units, kernel_init=_GLOROT,
                             name="dec_out")(h)
        return h


class SeganWaveGenerator(nn.Module):
    """Generator (generator.py:20-110): stack of gated dilated residual
    blocks (atrous conv1d, tanh x sigmoid gate, 1x1 residual + skip convs),
    skip-sum -> leakyrelu -> conv1x1 -> dense."""

    units: int
    dilations: Sequence[int] = DEFAULT_DILATIONS
    kwidth: int = 3
    num_kernels: int = 32
    z_depth: int = 1024

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        if x.ndim == 2:
            h = x[:, :, None]
        else:
            h = x
        if self.has_rng("z"):
            z = jax.random.normal(self.make_rng("z"),
                                  (h.shape[0], h.shape[1], self.z_depth))
        else:
            z = jnp.zeros((h.shape[0], h.shape[1], self.z_depth))
        h = jnp.concatenate([h, z], axis=2)

        skips = []
        for bi, dilation in enumerate(self.dilations):
            do_skip = bi < len(self.dilations) - 1
            name = f"g_residual_block_{bi}"
            ha = nn.Conv(self.num_kernels, (self.kwidth,),
                         kernel_dilation=(dilation,), padding="SAME",
                         use_bias=False, kernel_init=_TRUNC02,
                         name=f"{name}/conv")(h)
            za = nn.Conv(self.num_kernels, (self.kwidth,),
                         kernel_dilation=(dilation,), padding="SAME",
                         use_bias=False, kernel_init=_TRUNC02,
                         name=f"{name}/conv_gate")(h)
            gated = jnp.tanh(ha) * jax.nn.sigmoid(za)
            res = nn.Conv(1, (1,), padding="SAME", use_bias=False,
                          kernel_init=_TRUNC02,
                          name=f"{name}/residual_conv1")(gated)
            res = res + h[:, :, :1] if h.shape[-1] != 1 else res + h
            if do_skip:
                skips.append(nn.Conv(1, (1,), padding="SAME", use_bias=False,
                                     kernel_init=_TRUNC02,
                                     name=f"{name}/skip_conv1")(gated))
                h = res
            else:
                skips.append(res)
                h = res
        s = leakyrelu(sum(skips))
        s = nn.Conv(1, (1,), padding="SAME", use_bias=False,
                    kernel_init=_TRUNC02, name="wave_conv1")(s)
        return nn.Dense(self.units, kernel_init=_GLOROT,
                        name="wave_out")(s[:, :, 0])


class SeganDiscriminator(nn.Module):
    """discriminator.py:20-95: 11 downconv blocks (kwidth 31, stride 2) with
    VBN + leakyrelu, conv1d(kwidth 31) logits, FC 1. Gaussian input noise is
    applied by the trainer's noise rng."""

    num_fmaps: Sequence[int] = DEFAULT_ENC_DEPTHS
    kwidth: int = 31
    bias_conv: bool = True
    use_vbn: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        h = x[:, :, None] if x.ndim == 2 else x
        for i, fmaps in enumerate(self.num_fmaps):
            h = _downconv(h, fmaps, self.kwidth, f"d_block_{i}",
                          self.bias_conv)
            if self.use_vbn:
                h = VirtualBatchNorm(name=f"d_vbn_{i}")(h)
            h = leakyrelu(h)
        h = nn.Conv(1, (self.kwidth,), padding="SAME", use_bias=False,
                    kernel_init=_TRUNC02, name="logits_conv")(h)
        h = h[:, :, 0]
        return nn.Dense(1, kernel_init=_GLOROT, name="logits_out")(h)
