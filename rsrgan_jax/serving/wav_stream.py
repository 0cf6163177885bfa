"""Streaming wav -> wav enhancement: samples in, enhanced samples out.

Composes the three exact streaming stages into one bounded-latency
pipeline (the reference has nothing comparable — it enhances offline and
stops at feature arks, scripts/train_gan_rnn_placeholder.py:204-302):

    samples -> streaming framing + LPS      (frame-local: exact)
            -> inputs CMVN -> StreamingEnhancer (carried LSTM state: exact)
            -> labels CMVN^-1 -> magnitude + current-frame noisy phase
            -> irfft -> streaming WOLA overlap-add  (exact)
            -> streaming de-emphasis IIR            (exact)

Every frontend op in the Kaldi analysis chain is frame-local (dither off,
per-frame DC removal / preemphasis / window), so chunked framing equals
offline framing bit-for-bit; the WOLA accumulator finalizes sample n once
the last overlapping frame (floor(n/shift)) has been added, giving an
algorithmic latency of `chunk_frames` frames plus the window-shift
overlap. The full streamed output matches offline
``features.resynth.resynthesize`` of the offline-enhanced features to
float tolerance (tests/test_wav_stream.py).

Compute placement: the LSTM forward runs through the jitted
StreamingEnhancer step (one fixed [1, chunk_frames, D] program); the
FFT/OLA stages are host numpy — a 50x512 rFFT is microseconds, far below
the per-dispatch latency a device round-trip would add.

Internals are split so multiple concurrent streams can share one batched
compiled step (serving/pool.py): ``WavChain`` holds the stream-invariant
DSP (window, CMVN, analysis/synthesis math) and ``WavStreamState`` holds
one stream's mutable state (sample tail, pending frames, WOLA
accumulator, de-emphasis carry).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from rsrgan_jax.data.cmvn import Cmvn
from rsrgan_jax.features.frontend import EPS_F32, FrameOptions, feature_window
from rsrgan_jax.serving.streaming import StreamingEnhancer


class WavChain:
    """Stream-invariant wav<->LPS DSP shared by every stream of a server:
    analysis (framing already done by the caller) and per-frame synthesis.
    Validates that the generator checkpoint is LPS->LPS."""

    def __init__(self, params, inputs_cmvn: Cmvn, labels_cmvn: Cmvn,
                 variant: str = "res_lstm_l",
                 frame_opts: FrameOptions = FrameOptions(dither=0.0),
                 raw_energy: bool = True):
        if frame_opts.dither != 0.0:
            raise ValueError("streaming is deterministic: build the "
                             "FrameOptions with dither=0.0")
        if not frame_opts.snip_edges:
            raise ValueError("streaming framing requires snip_edges=True")
        self.opts = frame_opts
        self.raw_energy = raw_energy
        self.inputs_cmvn = inputs_cmvn
        self.labels_cmvn = labels_cmvn

        self.nfft = frame_opts.padded_window_size
        self.bins = self.nfft // 2 + 1
        out_kernel = (params["Dense_1"]["kernel"] if variant == "lstm"
                      else params["forward_out"]["kernel"])
        if out_kernel.shape[1] != self.bins:
            raise ValueError(
                f"generator output dim {out_kernel.shape[1]} != "
                f"{self.bins} spectrum bins — wav streaming needs an "
                "LPS->LPS checkpoint (train with --output_dim="
                f"{self.bins})")
        if len(inputs_cmvn.mean) != self.bins:
            raise ValueError("inputs CMVN dim != spectrum bins")

        self.window = feature_window(frame_opts).astype(np.float32)
        W, S = frame_opts.window_size, frame_opts.window_shift
        # steady-state peak of the summed squared synthesis window; the
        # 1%-of-peak denominator floor matches offline overlap_add for any
        # signal long enough to reach steady state
        steady = np.zeros(S, np.float64)
        for k in range(0, W, S):
            seg = (self.window[k:k + S].astype(np.float64)) ** 2
            steady[:len(seg)] += seg
        self.den_floor = float(0.01 * steady.max())

    def analyze(self, frames: np.ndarray):
        """[F, W] raw frames -> (normalized LPS [F, bins], complex [F, bins]).

        Numpy mirror of features/frontend.py process_frames."""
        opts = self.opts
        frames = frames.astype(np.float32)
        if opts.remove_dc_offset:
            frames = frames - frames.mean(axis=1, keepdims=True)
        log_energy = None
        if self.raw_energy:
            log_energy = np.log(np.maximum(
                np.sum(frames * frames, axis=1), EPS_F32))
        if opts.preemph_coeff != 0.0:
            shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
            frames = frames - opts.preemph_coeff * shifted
        windowed = frames * self.window[None, :]
        spec = np.fft.rfft(windowed, n=self.nfft, axis=1).astype(np.complex64)
        power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
        lps = np.log(np.maximum(power, EPS_F32))
        if self.raw_energy:
            lps[:, 0] = log_energy
        return self.inputs_cmvn.apply(lps).astype(np.float32), spec

    def synth_frames(self, enhanced_lps: np.ndarray,
                     spec: np.ndarray) -> np.ndarray:
        """Denormalized enhanced LPS + matching noisy spectra ->
        [F, window_size] time-domain frames (pre-OLA)."""
        mag = np.exp(0.5 * enhanced_lps.astype(np.float64))
        noisy_mag = np.abs(spec).astype(np.float64)
        if self.raw_energy:
            mag[:, 0] = noisy_mag[:, 0]
        phase = spec / np.maximum(noisy_mag, np.sqrt(EPS_F32))
        return np.fft.irfft(mag * phase, n=self.nfft,
                            axis=1)[:, :self.opts.window_size]


class WavStreamState:
    """One stream's mutable host state: un-framed sample tail, analyzed
    frames awaiting the model, WOLA accumulator, de-emphasis carry."""

    def __init__(self, chain: WavChain):
        self.chain = chain
        self.reset()

    def reset(self) -> None:
        self._samples = np.zeros((0,), np.float32)  # un-framed input tail
        self._frames_x: list = []      # normalized LPS awaiting a chunk
        self._frames_spec: list = []   # matching complex spectra
        self._acc = np.zeros((0,), np.float64)   # WOLA numerator
        self._den = np.zeros((0,), np.float64)   # WOLA denominator
        self._acc_base = 0   # global sample index of _acc[0]
        self._next_frame = 0  # global index of the next frame to add
        self._deemph_z = np.zeros(1, np.float64)  # lfilter carry

    def push(self, samples: np.ndarray) -> None:
        """Buffer samples; frame + analyze everything frameable."""
        self._samples = np.concatenate(
            [self._samples, np.asarray(samples, np.float32)])
        W = self.chain.opts.window_size
        S = self.chain.opts.window_shift
        n_new = max(0, 1 + (len(self._samples) - W) // S) \
            if len(self._samples) >= W else 0
        if n_new:
            idx = (np.arange(n_new)[:, None] * S + np.arange(W)[None, :])
            lps, spec = self.chain.analyze(self._samples[idx])
            self._frames_x.extend(lps)
            self._frames_spec.extend(spec)
            self._samples = self._samples[n_new * S:]

    def pending(self) -> int:
        return len(self._frames_x)

    def take(self, n: int):
        """Pop the first n pending frames -> (x [n, bins], spec [n, bins])."""
        x = np.stack(self._frames_x[:n])
        spec = np.stack(self._frames_spec[:n])
        del self._frames_x[:n], self._frames_spec[:n]
        return x, spec

    def absorb(self, enhanced_lps: np.ndarray, spec: np.ndarray) -> None:
        """Add F enhanced frames into the WOLA accumulator."""
        frames = self.chain.synth_frames(enhanced_lps, spec)
        F = frames.shape[0]
        W = self.chain.opts.window_size
        S = self.chain.opts.window_shift
        end = (self._next_frame + F - 1) * S + W - self._acc_base
        if end > len(self._acc):
            grow = end - len(self._acc)
            self._acc = np.concatenate([self._acc, np.zeros(grow)])
            self._den = np.concatenate([self._den, np.zeros(grow)])
        w = self.chain.window.astype(np.float64)
        for t in range(F):
            lo = (self._next_frame + t) * S - self._acc_base
            self._acc[lo:lo + W] += w * frames[t]
            self._den[lo:lo + W] += w * w
        self._next_frame += F

    def _emit(self, upto_global: int) -> np.ndarray:
        """Finalize samples [_acc_base, upto_global) through de-emphasis."""
        n = upto_global - self._acc_base
        if n <= 0:
            return np.zeros((0,), np.float32)
        y = self._acc[:n] / np.maximum(self._den[:n], self.chain.den_floor)
        self._acc = self._acc[n:]
        self._den = self._den[n:]
        self._acc_base = upto_global
        if self.chain.opts.preemph_coeff != 0.0:
            from scipy.signal import lfilter

            y, self._deemph_z = lfilter(
                [1.0], [1.0, -self.chain.opts.preemph_coeff], y,
                zi=self._deemph_z)
        return y.astype(np.float32)

    def emit_ready(self) -> np.ndarray:
        """Emit every sample finalized by the frames absorbed so far."""
        return self._emit(self._next_frame * self.chain.opts.window_shift)

    def emit_tail(self) -> np.ndarray:
        """End of stream: emit through the last absorbed frame's end."""
        if self._next_frame == 0:
            return np.zeros((0,), np.float32)
        opts = self.chain.opts
        return self._emit((self._next_frame - 1) * opts.window_shift
                          + opts.window_size)


class StreamingWavEnhancer:
    """Chunked wav->wav enhancement with carried state across ``process``
    calls. Not thread-safe; one instance per stream. For many concurrent
    streams sharing one batched compiled step, use serving.pool.StreamPool."""

    def __init__(self, params, inputs_cmvn: Cmvn, labels_cmvn: Cmvn,
                 variant: str = "res_lstm_l",
                 frame_opts: FrameOptions = FrameOptions(dither=0.0),
                 raw_energy: bool = True, chunk_frames: int = 50):
        self.chain = WavChain(params, inputs_cmvn, labels_cmvn,
                              variant=variant, frame_opts=frame_opts,
                              raw_energy=raw_energy)
        self.opts = self.chain.opts
        self.chunk_frames = int(chunk_frames)
        self.enhancer = StreamingEnhancer(params, variant=variant)
        self.stream = WavStreamState(self.chain)
        self.reset()

    def reset(self) -> None:
        self.stream.reset()
        self._state = self.enhancer.init_state(batch=1)

    def _run_chunk(self, n: Optional[int] = None) -> None:
        """Run the first n buffered frames (default: a full chunk)."""
        n = self.chunk_frames if n is None else n
        x, spec = self.stream.take(n)
        y, self._state = self.enhancer.step(jnp.asarray(x[None]), self._state)
        enhanced = self.chain.labels_cmvn.denormalize(
            np.asarray(y[0], np.float32))
        self.stream.absorb(enhanced, spec)

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Feed samples (16-bit PCM scale float); returns all newly
        finalized enhanced samples (possibly empty)."""
        self.stream.push(samples)
        while self.stream.pending() >= self.chunk_frames:
            self._run_chunk()
        return self.stream.emit_ready()

    def flush(self) -> np.ndarray:
        """End of stream: run the buffered partial chunk (one extra
        compiled shape) and emit everything up to the last frame's end."""
        if self.stream.pending():
            self._run_chunk(self.stream.pending())
        return self.stream.emit_tail()
