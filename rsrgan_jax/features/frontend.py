"""Kaldi-parity frame extraction and log-power-spectrum features.

JAX replacement for the external Kaldi ``compute-spectrogram-feats``
binary that produces the reference's 257-dim LPS inputs
(/root/reference/README.md:33-34, SURVEY.md section 2.8). The DSP follows
Kaldi's feat/feature-window.cc + feature-spectrogram.cc semantics:

frame -> [dither] -> remove DC -> (raw log energy) -> preemphasis
      -> window (povey/hamming/...) -> zero-pad to 2^k -> rFFT
      -> power -> floor(eps) -> log ; feature[0] = raw log energy

Everything is expressed as batched array ops ([num_frames, win] tensors) so
one jit compiles the whole front-end into a handful of fused XLA ops plus
one real FFT; no per-frame host loop like Kaldi's C++.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# float32 machine epsilon: Kaldi's power floor (std::numeric_limits<float>::epsilon)
EPS_F32 = float(np.finfo(np.float32).eps)


@dataclass(frozen=True)
class FrameOptions:
    """Kaldi FrameExtractionOptions (defaults for 16 kHz)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        if not self.round_to_power_of_two:
            return self.window_size
        n = 1
        while n < self.window_size:
            n *= 2
        return n


def feature_window(opts: FrameOptions) -> np.ndarray:
    """The analysis window (feature-window.cc FeatureWindowFunction)."""
    N = opts.window_size
    n = np.arange(N, dtype=np.float64)
    a = 2.0 * math.pi / (N - 1)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif opts.window_type == "povey":  # like hanning^0.85, Kaldi default
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(N)
    elif opts.window_type == "blackman":
        coeff = 0.42
        w = (coeff - 0.5 * np.cos(a * n)
             + (0.5 - coeff) * np.cos(2 * a * n))
    else:
        raise ValueError(f"unknown window type {opts.window_type}")
    return w.astype(np.float32)


def num_frames(num_samples: int, opts: FrameOptions) -> int:
    """Frame count under snip_edges semantics (feature-window.cc NumFrames)."""
    if opts.snip_edges:
        if num_samples < opts.window_size:
            return 0
        return 1 + (num_samples - opts.window_size) // opts.window_shift
    return (num_samples + opts.window_shift // 2) // opts.window_shift


def extract_frames(wave: jnp.ndarray, opts: FrameOptions) -> jnp.ndarray:
    """[num_samples] -> [num_frames, window_size] raw sample frames.

    snip_edges=True: frames fully inside the wave. snip_edges=False:
    frames centered at shift*(t+0.5) with Kaldi edge reflection
    (feature-window.cc ExtractWindow: idx<0 -> -idx-1, idx>=n -> 2n-1-idx).
    """
    num_samples = int(wave.shape[0])
    n = num_frames(num_samples, opts)
    if opts.snip_edges:
        starts = np.arange(n) * opts.window_shift
        idx = starts[:, None] + np.arange(opts.window_size)[None, :]
    else:
        mid = (np.arange(n) * opts.window_shift
               + opts.window_shift // 2)
        starts = mid - opts.window_size // 2
        idx = starts[:, None] + np.arange(opts.window_size)[None, :]
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= num_samples, 2 * num_samples - 1 - idx, idx)
    return wave[idx]


def process_frames(frames: jnp.ndarray, opts: FrameOptions,
                   dither_key: Optional[jax.Array] = None,
                   return_log_energy: bool = True):
    """Dither / DC removal / raw energy / preemphasis / windowing.

    Port of feature-window.cc ProcessWindow, batched over frames. Returns
    (windowed [F, win], raw_log_energy [F] or None). Dither is applied only
    when a PRNG key is provided and opts.dither > 0.
    """
    frames = frames.astype(jnp.float32)
    if dither_key is not None and opts.dither != 0.0:
        frames = frames + opts.dither * jax.random.normal(
            dither_key, frames.shape, dtype=jnp.float32)
    if opts.remove_dc_offset:
        frames = frames - jnp.mean(frames, axis=1, keepdims=True)

    log_energy = None
    if return_log_energy:
        energy = jnp.maximum(jnp.sum(frames * frames, axis=1), EPS_F32)
        log_energy = jnp.log(energy)

    if opts.preemph_coeff != 0.0:
        shifted = jnp.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - opts.preemph_coeff * shifted

    window = jnp.asarray(feature_window(opts))
    return frames * window[None, :], log_energy


def power_spectrum(windowed: jnp.ndarray, opts: FrameOptions) -> jnp.ndarray:
    """[F, win] windowed frames -> [F, nfft/2+1] power spectrum."""
    nfft = opts.padded_window_size
    spec = jnp.fft.rfft(windowed, n=nfft, axis=1)
    return (spec.real ** 2 + spec.imag ** 2).astype(jnp.float32)


@dataclass(frozen=True)
class SpectrogramOptions:
    frame_opts: FrameOptions = FrameOptions()
    energy_floor: float = 0.0
    raw_energy: bool = True

    @property
    def dim(self) -> int:
        return self.frame_opts.padded_window_size // 2 + 1


def compute_spectrogram(wave: jnp.ndarray,
                        opts: SpectrogramOptions = SpectrogramOptions(),
                        dither_key: Optional[jax.Array] = None) -> jnp.ndarray:
    """Log-power-spectrum features (compute-spectrogram-feats parity).

    [num_samples] float wave (16-bit PCM scale) -> [num_frames, 257] LPS.
    """
    frames = extract_frames(wave, opts.frame_opts)
    windowed, log_energy = process_frames(
        frames, opts.frame_opts, dither_key,
        return_log_energy=opts.raw_energy)
    power = power_spectrum(windowed, opts.frame_opts)
    feats = jnp.log(jnp.maximum(power, EPS_F32))
    if opts.raw_energy:
        if opts.energy_floor > 0.0:
            log_energy = jnp.maximum(log_energy,
                                     math.log(opts.energy_floor))
        feats = feats.at[:, 0].set(log_energy)
    return feats


def compute_spectrogram_np(wave: np.ndarray,
                           opts: SpectrogramOptions = SpectrogramOptions(),
                           seed: Optional[int] = None) -> np.ndarray:
    """Host convenience wrapper (deterministic unless a seed is given)."""
    key = jax.random.PRNGKey(seed) if seed is not None else None
    return np.asarray(compute_spectrogram(jnp.asarray(wave), opts, key))
