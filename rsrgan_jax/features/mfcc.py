"""Kaldi-parity MFCC (hires, 40-dim) features.

JAX replacement for the external ``compute-mfcc-feats`` +
``mfcc_hires.conf`` stage that produces the reference's 40-dim training
targets (/root/reference/README.md:33-35, SURVEY.md section 2.8). Follows
Kaldi feat/mel-computations.cc + feature-mfcc.cc:

power spectrum -> triangular mel bank (low 20 Hz, high 7600 Hz, 40 bins)
  -> log(floor eps) -> DCT-II (orthogonal, num_ceps rows) -> liftering

``hires`` config: --use-energy=false --num-mel-bins=40 --num-ceps=40
--low-freq=20 --high-freq=-400 (i.e. Nyquist-400). The mel projection and
DCT are dense [bins x ceps] matmuls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rsrgan_jax.features.frontend import (EPS_F32, FrameOptions,
                                          extract_frames, power_spectrum,
                                          process_frames)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel, np.float64) / 1127.0) - 1.0)


@dataclass(frozen=True)
class MelOptions:
    num_bins: int = 40
    low_freq: float = 20.0
    high_freq: float = -400.0  # <=0: offset from Nyquist, Kaldi convention


def mel_banks(opts: MelOptions, frame_opts: FrameOptions) -> np.ndarray:
    """[num_bins, nfft/2+1] triangular filters (mel-computations.cc)."""
    nfft = frame_opts.padded_window_size
    nyquist = 0.5 * frame_opts.samp_freq
    high_freq = (opts.high_freq if opts.high_freq > 0.0
                 else nyquist + opts.high_freq)
    if not (0.0 <= opts.low_freq < high_freq <= nyquist):
        raise ValueError("bad mel frequency range")

    fft_bin_width = frame_opts.samp_freq / nfft
    mel_low = mel_scale(opts.low_freq)
    mel_high = mel_scale(high_freq)
    delta = (mel_high - mel_low) / (opts.num_bins + 1)

    num_fft_bins = nfft // 2 + 1
    freqs = fft_bin_width * np.arange(num_fft_bins)
    mels = mel_scale(freqs)

    banks = np.zeros((opts.num_bins, num_fft_bins), dtype=np.float64)
    for b in range(opts.num_bins):
        left = mel_low + b * delta
        center = mel_low + (b + 1) * delta
        right = mel_low + (b + 2) * delta
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        banks[b] = np.clip(np.minimum(up, down), 0.0, None)
        # Kaldi zeroes weights outside (left, right) exactly:
        banks[b][(mels <= left) | (mels >= right)] = 0.0
    # Kaldi excludes the Nyquist bin from mel integration only implicitly via
    # the frequency range; keep full row (weights there are ~always 0 anyway).
    return banks.astype(np.float32)


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Kaldi ComputeDctMatrix: row0 sqrt(1/N), row k sqrt(2/N)cos(pi k(j+.5)/N)."""
    j = np.arange(num_bins, dtype=np.float64)
    mat = np.zeros((num_ceps, num_bins), dtype=np.float64)
    mat[0] = math.sqrt(1.0 / num_bins)
    for k in range(1, num_ceps):
        mat[k] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi * k * (j + 0.5) / num_bins)
    return mat.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """1 + 0.5*Q*sin(pi*k/Q) (feature-functions.cc ComputeLifterCoeffs)."""
    k = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * k / q)).astype(np.float32)


@dataclass(frozen=True)
class MfccOptions:
    frame_opts: FrameOptions = FrameOptions()
    mel_opts: MelOptions = MelOptions()
    num_ceps: int = 40
    use_energy: bool = False        # hires config
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0

    @property
    def dim(self) -> int:
        return self.num_ceps


def hires_mfcc_options() -> MfccOptions:
    """The mfcc_hires.conf configuration used for the reference's targets."""
    return MfccOptions()


def compute_mfcc(wave: jnp.ndarray,
                 opts: MfccOptions = MfccOptions(),
                 dither_key: Optional[jax.Array] = None) -> jnp.ndarray:
    """[num_samples] wave -> [num_frames, num_ceps] MFCC features."""
    frames = extract_frames(wave, opts.frame_opts)
    windowed, log_energy = process_frames(
        frames, opts.frame_opts, dither_key,
        return_log_energy=opts.use_energy and opts.raw_energy)
    power = power_spectrum(windowed, opts.frame_opts)

    # Feature parity is a float32 contract: force full-precision matmuls
    # (a GPU's default precision for float32 is TF32).
    banks = jnp.asarray(mel_banks(opts.mel_opts, opts.frame_opts))
    mel_energies = jnp.dot(power, banks.T,
                           precision=jax.lax.Precision.HIGHEST)
    log_mel = jnp.log(jnp.maximum(mel_energies, EPS_F32))

    dct = jnp.asarray(dct_matrix(opts.num_ceps, opts.mel_opts.num_bins))
    feats = jnp.dot(log_mel, dct.T, precision=jax.lax.Precision.HIGHEST)

    if opts.cepstral_lifter != 0.0:
        feats = feats * jnp.asarray(
            lifter_coeffs(opts.num_ceps, opts.cepstral_lifter))[None, :]

    if opts.use_energy:
        if not opts.raw_energy:
            energy = jnp.maximum(jnp.sum(windowed ** 2, axis=1), EPS_F32)
            log_energy = jnp.log(energy)
        if opts.energy_floor > 0.0:
            log_energy = jnp.maximum(log_energy,
                                     math.log(opts.energy_floor))
        feats = feats.at[:, 0].set(log_energy)
    return feats


def compute_mfcc_np(wave: np.ndarray, opts: MfccOptions = MfccOptions(),
                    seed: Optional[int] = None) -> np.ndarray:
    key = jax.random.PRNGKey(seed) if seed is not None else None
    return np.asarray(compute_mfcc(jnp.asarray(wave), opts, key))
