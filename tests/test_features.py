"""Feature front-end tests: framing, windows, LPS, mel banks, MFCC."""

import math

import numpy as np
import pytest
import scipy.fftpack

from rsrgan_jax.features import (FrameOptions, MelOptions, MfccOptions,
                                 SpectrogramOptions, compute_mfcc_np,
                                 compute_spectrogram_np, dct_matrix,
                                 feature_window, lifter_coeffs, mel_banks,
                                 num_frames)

NODITHER = FrameOptions(dither=0.0)


class TestFraming:
    def test_num_frames_snip_edges(self):
        opts = FrameOptions()
        assert opts.window_size == 400 and opts.window_shift == 160
        assert opts.padded_window_size == 512
        assert num_frames(400, opts) == 1
        assert num_frames(559, opts) == 1
        assert num_frames(560, opts) == 2
        assert num_frames(16000, opts) == 98
        assert num_frames(399, opts) == 0

    def test_povey_window(self):
        w = feature_window(FrameOptions())
        n = np.arange(400)
        expect = (0.5 - 0.5 * np.cos(2 * math.pi * n / 399)) ** 0.85
        np.testing.assert_allclose(w, expect, rtol=1e-6)

    def test_hamming_window(self):
        w = feature_window(FrameOptions(window_type="hamming"))
        assert abs(w[0] - 0.08) < 1e-6 and abs(w.max() - 1.0) < 1e-3


class TestSpectrogram:
    def test_shape_and_dim(self, rng):
        wave = rng.normal(scale=1000, size=16000).astype(np.float32)
        feats = compute_spectrogram_np(wave, SpectrogramOptions(NODITHER))
        assert feats.shape == (98, 257)

    def test_sine_peak_bin(self):
        """A pure 1 kHz tone peaks at fft bin 32 (1000/16000*512)."""
        t = np.arange(16000) / 16000.0
        wave = (10000 * np.sin(2 * math.pi * 1000 * t)).astype(np.float32)
        feats = compute_spectrogram_np(wave, SpectrogramOptions(NODITHER))
        # skip feature[0] (raw log energy slot)
        peak = feats[:, 1:].argmax(axis=1) + 1
        assert np.all(np.abs(peak - 32) <= 1)

    def test_raw_energy_slot(self, rng):
        """feature[0] is the raw pre-window log energy, not bin-0 power."""
        wave = rng.normal(scale=100, size=4000).astype(np.float32)
        opts = SpectrogramOptions(NODITHER, raw_energy=True)
        feats = compute_spectrogram_np(wave, opts)
        frames_raw = np.stack([wave[i * 160:i * 160 + 400]
                               for i in range(feats.shape[0])])
        frames_raw = frames_raw - frames_raw.mean(axis=1, keepdims=True)
        expect = np.log(np.maximum((frames_raw ** 2).sum(axis=1),
                                   np.finfo(np.float32).eps))
        np.testing.assert_allclose(feats[:, 0], expect, rtol=1e-4)

    def test_dither_changes_output_deterministically(self, rng):
        wave = rng.normal(scale=100, size=4000).astype(np.float32)
        opts = SpectrogramOptions(FrameOptions(dither=1.0))
        a = compute_spectrogram_np(wave, opts, seed=1)
        b = compute_spectrogram_np(wave, opts, seed=1)
        c = compute_spectrogram_np(wave, opts, seed=2)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


class TestMel:
    def test_bank_shapes_and_partition(self):
        banks = mel_banks(MelOptions(), FrameOptions())
        assert banks.shape == (40, 257)
        # triangles overlap to ~1 in the passband interior
        col_sums = banks.sum(axis=0)
        fft_freqs = 16000.0 / 512 * np.arange(257)
        interior = (fft_freqs > 200) & (fft_freqs < 7000)
        assert np.all(col_sums[interior] > 0.6)
        assert np.all(col_sums[interior] <= 1.2)
        # nothing below low_freq or above high_freq
        assert np.all(banks[:, fft_freqs <= 20] == 0)
        assert np.all(banks[:, fft_freqs >= 7600] == 0)

    def test_each_bin_is_triangular(self):
        banks = mel_banks(MelOptions(num_bins=10), FrameOptions())
        for b in banks:
            nz = np.flatnonzero(b)
            assert len(nz) > 0
            peak = b.argmax()
            assert np.all(np.diff(b[nz[0]:peak + 1]) >= -1e-7)
            assert np.all(np.diff(b[peak:nz[-1] + 1]) <= 1e-7)


class TestMfcc:
    def test_dct_matches_scipy_ortho(self):
        mat = dct_matrix(40, 40)
        x = np.random.default_rng(0).normal(size=40)
        expect = scipy.fftpack.dct(x, type=2, norm="ortho")
        np.testing.assert_allclose(mat @ x, expect, rtol=1e-4, atol=1e-5)

    def test_lifter_coeffs(self):
        c = lifter_coeffs(13, 22.0)
        assert c[0] == 1.0
        expect = 1.0 + 0.5 * 22.0 * np.sin(math.pi * np.arange(13) / 22.0)
        np.testing.assert_allclose(c, expect, rtol=1e-6)

    def test_hires_shape(self, rng):
        wave = rng.normal(scale=1000, size=8000).astype(np.float32)
        feats = compute_mfcc_np(wave, MfccOptions(frame_opts=NODITHER))
        assert feats.shape == (48, 40)
        assert np.isfinite(feats).all()

    def test_mfcc_matches_numpy_reference(self, rng):
        """Cross-check the jitted pipeline against a direct float64
        transcription of the Kaldi formulas."""
        wave = rng.normal(scale=2000, size=4000).astype(np.float32)
        opts = MfccOptions(frame_opts=NODITHER)
        got = compute_mfcc_np(wave, opts)

        # independent numpy reference
        F = num_frames(4000, NODITHER)
        frames = np.stack([wave[i * 160:i * 160 + 400] for i in range(F)])
        frames = frames.astype(np.float64)
        frames -= frames.mean(axis=1, keepdims=True)
        pre = frames.copy()
        pre[:, 1:] -= 0.97 * frames[:, :-1]
        pre[:, 0] -= 0.97 * frames[:, 0]
        n = np.arange(400)
        win = (0.5 - 0.5 * np.cos(2 * math.pi * n / 399)) ** 0.85
        spec = np.fft.rfft(pre * win, n=512, axis=1)
        power = np.abs(spec) ** 2
        banks = mel_banks(MelOptions(), NODITHER).astype(np.float64)
        logmel = np.log(np.maximum(power @ banks.T,
                                   np.finfo(np.float32).eps))
        dct = dct_matrix(40, 40).astype(np.float64)
        lift = lifter_coeffs(40, 22.0).astype(np.float64)
        expect = (logmel @ dct.T) * lift
        np.testing.assert_allclose(got, expect, rtol=2e-3, atol=2e-3)


class TestGoldenRegression:
    """Committed golden outputs of the validated front-end — guards the
    float32 feature contract against regressions across rounds."""

    def test_matches_golden_fixture(self):
        import os
        path = os.path.join(os.path.dirname(__file__), "fixtures",
                            "dsp_golden.npz")
        data = np.load(path)
        lps = compute_spectrogram_np(data["wave"],
                                     SpectrogramOptions(NODITHER))
        mfcc = compute_mfcc_np(data["wave"],
                               MfccOptions(frame_opts=NODITHER))
        np.testing.assert_allclose(lps, data["lps"], atol=1e-3)
        np.testing.assert_allclose(mfcc, data["mfcc"], atol=1e-3)


class TestReviewRegressions:
    def test_snip_edges_false_reflection(self):
        """snip_edges=False centers frames and reflects at edges
        (feature-window.cc ExtractWindow semantics)."""
        from rsrgan_jax.features.frontend import extract_frames
        opts = FrameOptions(dither=0.0, snip_edges=False)
        wave = np.arange(1000, dtype=np.float32)
        frames = np.asarray(extract_frames(wave, opts))
        assert frames.shape == (num_frames(1000, opts), 400)
        # first frame: start = 80 - 200 = -120 -> reflected head
        assert frames[0, 0] == wave[119]   # idx -120 -> 119
        assert frames[0, 119] == wave[0]   # idx -1 -> 0
        assert frames[0, 120] == wave[0]   # idx 0
        # tail frame reflects past the end
        last = frames[-1]
        assert np.all(last <= 999)

    def test_energy_floor_applied(self, rng):
        wave = (rng.normal(size=4000) * 0.001).astype(np.float32)  # quiet
        floored = compute_spectrogram_np(
            wave, SpectrogramOptions(NODITHER, energy_floor=1.0))
        unfloored = compute_spectrogram_np(
            wave, SpectrogramOptions(NODITHER, energy_floor=0.0))
        assert floored[:, 0].min() >= 0.0 - 1e-6   # log(1.0) = 0 floor
        assert unfloored[:, 0].min() < 0.0
