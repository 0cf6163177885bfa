"""Simulation subsystem tests: wav IO, convolution vs scipy, SNR mixing,
manifest parsing, corruption + extraction CLIs."""

import os

import numpy as np
import pytest
import scipy.signal

from rsrgan_jax.sim import (SimulationOptions, corrupt_utterance,
                            extend_to_duration, fft_convolve, mix_at_snr,
                            parse_noise_list, parse_rir_list,
                            pick_item_with_probability, read_wav,
                            reverberate, write_wav)


class TestWavIO:
    def test_roundtrip(self, tmp_path, rng):
        samples = (rng.normal(size=8000) * 5000).astype(np.float32)
        path = str(tmp_path / "a.wav")
        write_wav(path, samples, 16000)
        back, rate = read_wav(path)
        assert rate == 16000
        np.testing.assert_allclose(back, np.round(samples).clip(-32768,
                                                                32767),
                                   atol=1.0)


class TestDsp:
    def test_fft_convolve_matches_scipy(self, rng):
        x = rng.normal(size=1000).astype(np.float32)
        h = rng.normal(size=64).astype(np.float32)
        got = fft_convolve(x, h)
        expect = scipy.signal.fftconvolve(x, h)
        np.testing.assert_allclose(got, expect, atol=2e-2)

    def test_reverberate_shift_and_normalize(self, rng):
        x = rng.normal(size=2000).astype(np.float32) * 100
        rir = np.zeros(200, np.float32)
        rir[50] = 1.0  # pure delay of 50 samples
        rir[80] = 0.3
        wet = reverberate(x, rir, shift_output=True, normalize_output=True)
        assert wet.shape == x.shape
        # shift undone: direct path aligns with the dry signal
        corr_aligned = np.corrcoef(wet, x)[0, 1]
        assert corr_aligned > 0.9
        # power normalized
        assert abs(np.sum(wet ** 2) / np.sum(x ** 2) - 1.0) < 1e-3

    def test_mix_at_snr(self, rng):
        speech = rng.normal(size=16000).astype(np.float32) * 1000
        noise = rng.normal(size=16000).astype(np.float32) * 123
        for snr in (0.0, 10.0, 20.0):
            mixed = mix_at_snr(speech, noise, snr)
            added = mixed - speech
            got_snr = 10 * np.log10(np.mean(speech ** 2)
                                    / np.mean(added ** 2))
            assert abs(got_snr - snr) < 0.5

    def test_extend_to_duration(self, rng):
        noise = rng.normal(size=100).astype(np.float32)
        looped = extend_to_duration(noise, 250)
        # loops from the start (wav-reverberate --duration), no random crop
        np.testing.assert_array_equal(looped[:100], noise)
        np.testing.assert_array_equal(looped[100:200], noise)
        np.testing.assert_array_equal(looped[200:], noise[:50])
        np.testing.assert_array_equal(extend_to_duration(noise, 40),
                                      noise[:40])

    def test_mix_foreground_not_extended(self, rng):
        speech = rng.normal(size=1000).astype(np.float32) * 100
        noise = np.ones(100, np.float32)
        mixed = mix_at_snr(speech, noise, 10.0, start_time=300,
                           extend=False)
        added = mixed - speech
        assert np.all(added[:300] == 0)
        assert np.all(added[300:400] != 0)
        assert np.all(added[400:] == 0)  # NOT looped to fill the tail

    def test_mix_past_end_truncates(self, rng):
        speech = rng.normal(size=1000).astype(np.float32) * 100
        noise = np.ones(500, np.float32)
        mixed = mix_at_snr(speech, noise, 10.0, start_time=800,
                           extend=False)
        assert mixed.shape == speech.shape
        assert np.all(mixed[:800] == speech[:800])
        assert np.all(mixed[800:] != speech[800:])


class TestManifests:
    def test_parse_rir_list(self, tmp_path):
        path = tmp_path / "rir_list"
        path.write_text(
            "--rir-id r1 --room-id A /p/r1.wav\n"
            "--rir-id r2 --room-id A /p/r2.wav\n"
            "--rir-id r3 --room-id B /p/r3.wav\n")
        rooms = parse_rir_list(str(path))
        assert {r.room_id for r in rooms} == {"A", "B"}
        total = sum(r.probability for r in rooms)
        assert abs(total - 1.0) < 1e-9
        a = next(r for r in rooms if r.room_id == "A")
        assert len(a.rirs) == 2

    def test_parse_noise_list(self, tmp_path):
        path = tmp_path / "noise_list"
        path.write_text(
            "--noise-id n1 --noise-type point-source "
            "--bg-fg-type foreground /p/n1.wav\n"
            "--noise-id n2 --noise-type isotropic --bg-fg-type background "
            "--room-linkage A /p/n2.wav\n"
            "--noise-id n3 --noise-type isotropic --bg-fg-type background "
            "--room-linkage A /p/n3.wav\n")
        pointsource, iso = parse_noise_list(str(path))
        assert [n.noise_id for n in pointsource] == ["n1"]
        assert pointsource[0].bg_fg_type == "foreground"
        assert abs(sum(n.probability for n in pointsource) - 1.0) < 1e-9
        # isotropic noises are room-keyed, per-room normalized
        assert set(iso) == {"A"}
        assert len(iso["A"]) == 2
        assert abs(sum(n.probability for n in iso["A"]) - 1.0) < 1e-9

    def test_parse_noise_list_iso_requires_room(self, tmp_path):
        path = tmp_path / "noise_list"
        path.write_text("--noise-id n1 --noise-type isotropic /p/n1.wav\n")
        with pytest.raises(ValueError, match="room-linkage"):
            parse_noise_list(str(path))

    def test_pick_with_probability(self, rng, tmp_path):
        path = tmp_path / "rir_list"
        path.write_text("--rir-id r1 --room-id A --probability 0.9 a.wav\n"
                        "--rir-id r2 --room-id B --probability 0.1 b.wav\n")
        rooms = parse_rir_list(str(path))
        counts = {"A": 0, "B": 0}
        for _ in range(300):
            counts[pick_item_with_probability(rng, rooms).room_id] += 1
        assert counts["A"] > counts["B"]


def _delta_rir(pos, length=64):
    rir = np.zeros(length, np.float32)
    rir[pos] = 1.0
    return rir


def _two_room_setup(rng):
    """Two rooms with identity RIRs, one point-source noise, wav dict."""
    from rsrgan_jax.sim import Noise, Rir, Room

    wavs = {
        "A/r1.wav": _delta_rir(0), "A/r2.wav": _delta_rir(0),
        "B/r1.wav": _delta_rir(0),
        "noise.wav": rng.normal(size=400).astype(np.float32),
        "iso_a.wav": rng.normal(size=300).astype(np.float32),
    }
    rooms = [
        Room("A", rirs=[Rir("a1", "A", "A/r1.wav", 0.25),
                        Rir("a2", "A", "A/r2.wav", 0.25)],
             probability=0.5),
        Room("B", rirs=[Rir("b1", "B", "B/r1.wav", 0.5)],
             probability=0.5),
    ]
    noises = [Noise("n0", "noise.wav", "point-source", "foreground",
                    probability=1.0)]
    iso = {"A": [Noise("i0", "iso_a.wav", "isotropic", "background",
                       room_linkage="A", probability=1.0)]}
    return rooms, noises, iso, wavs


class TestSnrEnergyBasis:
    """Kaldi wav-reverberate's SNR semantics when an RIR is supplied:
    noise scaled against the DRY signal's early-reverberation energy, and
    --normalize-output scaling the final mixture to the dry power
    (command semantics built at reverberate_bash.py:219-227,377)."""

    def test_early_reverb_energy_hand_computed(self, rng):
        from rsrgan_jax.sim import early_reverb_energy

        fs = 16000
        speech = rng.normal(size=4000).astype(np.float32) * 100
        rir = np.zeros(2400, np.float32)
        rir[100] = 1.0     # signed peak
        rir[50] = -2.0     # larger |.| but negative: NOT the peak
        rir[300] = 0.5     # inside the early window (peak + 800 samples)
        rir[920] = 0.4     # past peak + 50 ms: excluded
        # window = [peak - 1 ms, peak + 50 ms) = [84, 900)
        early = rir[84:900]
        expected = float(np.mean(
            np.convolve(speech, early)[:len(speech)] ** 2))
        got = early_reverb_energy(speech, rir, fs)
        assert abs(got - expected) / expected < 1e-3

    def test_corruption_matches_hand_computed_kaldi_formula(self, rng):
        """Full corrupt_utterance vs a by-hand wav-reverberate: an RIR
        with a strong LATE tail inflates the wet power; the noise scale
        must come from the dry early energy, and the final mixture must
        be renormalized to the dry power."""
        from rsrgan_jax.sim import Noise, Rir, Room

        fs = 16000
        n = 4000
        speech = rng.normal(size=n).astype(np.float32) * 100
        rir = np.zeros(1200, np.float32)
        rir[0] = 1.0       # direct path (peak, zero delay)
        rir[1000] = 0.9    # late tail, outside the 800-sample early window
        noise = rng.normal(size=1500).astype(np.float32) * 7
        wavs = {"r.wav": rir, "n.wav": noise}
        rooms = [Room("A", rirs=[Rir("a", "A", "r.wav", 1.0)],
                      probability=1.0)]
        noises = [Noise("n", "n.wav", "point-source", "background",
                        probability=1.0)]
        snr = 10.0
        opts = SimulationOptions(background_snr_bounds=(snr, snr),
                                 isotropic_noise_addition_probability=0.0)
        out = corrupt_utterance(speech, rooms, noises, {}, opts,
                                np.random.default_rng(3),
                                lambda p: wavs[p])

        # ---- the same utterance by hand, straight from the Kaldi code ----
        wet = np.convolve(speech, rir)[:n]          # shift = argmax = 0
        early_energy = float(np.mean(
            np.convolve(speech, rir[:800])[:n] ** 2))
        # noise prep: convolved with a room RIR, power-normalized
        n_wet = np.convolve(noise, rir)[:len(noise)]
        n_wet = n_wet * np.sqrt(np.sum(noise ** 2) / np.sum(n_wet ** 2))
        n_ext = np.tile(n_wet, -(-n // len(n_wet)))[:n]
        scale = np.sqrt(early_energy
                        / (np.mean(n_ext ** 2) * 10 ** (snr / 10.0)))
        mix = wet + scale * n_ext
        expected = mix * np.sqrt(np.mean(speech ** 2) / np.mean(mix ** 2))

        np.testing.assert_allclose(out, expected, rtol=2e-3,
                                   atol=2e-3 * np.std(expected))
        # sanity: the legacy basis (wet mixture power, ~1.81x dry here)
        # would scale the noise visibly differently
        wrong_scale = np.sqrt(np.mean(wet ** 2)
                              / (np.mean(n_ext ** 2) * 10 ** (snr / 10.0)))
        assert abs(wrong_scale - scale) / scale > 0.2


class TestPlacementSemantics:
    """reverberate_bash.py:215-227 / :267-281 placement fidelity."""

    def test_foreground_random_start_and_no_tiling(self, rng):
        rooms, noises, iso, wavs = _two_room_setup(rng)
        speech = rng.normal(size=4000).astype(np.float32) * 100
        opts = SimulationOptions(speech_rvb_probability=0.0,
                                 isotropic_noise_addition_probability=0.0)
        starts = []
        for seed in range(30):
            out = corrupt_utterance(speech, rooms, noises, {}, opts,
                                    np.random.default_rng(seed),
                                    lambda p: wavs[p])
            added = np.flatnonzero(out != speech)
            if added.size == 0:  # start landed past the end
                starts.append(len(speech))
                continue
            starts.append(int(added[0]))
            # foreground: support <= noise length, never looped
            assert added[-1] - added[0] < 400
        # random per-utterance start times, many distinct, some nonzero
        assert len(set(starts)) > 10
        assert max(starts) > 0

    def test_noises_mix_without_rooms(self, rng):
        """--noise_list without --rir_list (rooms=[]): the speech stays
        dry but point-source noises must still be mixed in, unconvolved
        (regression: an early-return skipped them silently)."""
        rooms, noises, iso, wavs = _two_room_setup(rng)
        speech = rng.normal(size=4000).astype(np.float32) * 100
        opts = SimulationOptions(isotropic_noise_addition_probability=0.0)
        changed = 0
        for seed in range(10):
            out = corrupt_utterance(speech, [], noises, iso, opts,
                                    np.random.default_rng(seed),
                                    lambda p: wavs[p])
            changed += int(np.any(out != speech))
        assert changed > 0

    def test_noise_rir_from_speech_room(self, rng):
        rooms, noises, iso, wavs = _two_room_setup(rng)
        speech = rng.normal(size=4000).astype(np.float32) * 100
        opts = SimulationOptions(isotropic_noise_addition_probability=0.0)
        for seed in range(20):
            reads = []

            def read(path):
                reads.append(path)
                return wavs[path]

            corrupt_utterance(speech, rooms, noises, {}, opts,
                              np.random.default_rng(seed), read)
            rir_reads = [p for p in reads if "/r" in p]
            speech_room = rir_reads[0].split("/")[0]
            assert all(p.split("/")[0] == speech_room for p in rir_reads), \
                f"noise RIR from a different room than the speech: {reads}"

    def test_background_iso_spans_full_duration(self, rng):
        rooms, noises, iso, wavs = _two_room_setup(rng)
        speech = rng.normal(size=4000).astype(np.float32) * 100
        # identity RIRs: reverb is a no-op, but reading the speech RIR
        # reveals which room was drawn
        opts = SimulationOptions(speech_rvb_probability=1.0,
                                 pointsource_noise_addition_probability=0.0)
        hit_a = False
        for seed in range(20):
            reads = []

            def read(path):
                reads.append(path)
                return wavs[path]

            out = corrupt_utterance(speech, rooms, noises, iso, opts,
                                    np.random.default_rng(seed), read)
            speech_room = reads[0].split("/")[0]
            if speech_room == "A":
                hit_a = True
                added = out - speech
                # iso noise (300 samples) looped over all 4000 samples
                # from t=0: every quarter carries noise energy
                for q in range(4):
                    seg = added[q * 1000:(q + 1) * 1000]
                    assert float(np.sqrt(np.mean(seg ** 2))) > 1.0
            else:
                # room B has no linked isotropic noise -> nothing added
                # (identity-RIR reverb is a numerical no-op)
                np.testing.assert_allclose(out, speech, rtol=1e-4,
                                           atol=1e-3)
        assert hit_a
    def test_corrupt_and_extract(self, tmp_path, rng):
        # build a tiny wav corpus + rir + noise
        wav_dir = tmp_path / "wavs"
        os.makedirs(wav_dir)
        scp = tmp_path / "wav.scp"
        lines = []
        for i in range(3):
            w = (rng.normal(size=16000) * 3000).astype(np.float32)
            p = str(wav_dir / f"u{i}.wav")
            write_wav(p, w)
            lines.append(f"u{i} {p}")
        scp.write_text("\n".join(lines) + "\n")
        rir = np.zeros(100, np.float32)
        rir[10] = 1.0
        rir[40] = 0.4
        write_wav(str(tmp_path / "rir.wav"), rir * 30000)
        noise = (rng.normal(size=32000) * 500).astype(np.float32)
        write_wav(str(tmp_path / "noise.wav"), noise)
        (tmp_path / "rir_list").write_text(
            f"--rir-id r0 --room-id A {tmp_path}/rir.wav\n")
        (tmp_path / "noise_list").write_text(
            f"--noise-id n0 --noise-type isotropic --room-linkage A "
            f"{tmp_path}/noise.wav\n")

        from rsrgan_jax.cli import simulate
        out_dir = str(tmp_path / "rvb")
        rc = simulate.main([f"--wav_scp={scp}",
                            f"--rir_list={tmp_path}/rir_list",
                            f"--noise_list={tmp_path}/noise_list",
                            f"--output_dir={out_dir}"])
        assert rc == 0
        assert os.path.isfile(os.path.join(out_dir, "u1.wav"))

        from rsrgan_jax.cli import extract
        feats_dir = str(tmp_path / "feats")
        rc = extract.main([f"--wav_scp={out_dir}/wav.scp",
                           "--feat_type=spectrogram",
                           f"--output_dir={feats_dir}", "--name=inputs",
                           "--dither=0", "--accumulate_cmvn"])
        assert rc == 0
        rc = extract.main([f"--wav_scp={scp}", "--feat_type=mfcc",
                           f"--output_dir={feats_dir}", "--name=labels",
                           "--dither=0", "--accumulate_cmvn"])
        assert rc == 0
        from rsrgan_jax.data import ScpReader, read_kaldi_cmvn
        lps = ScpReader(os.path.join(feats_dir, "inputs.scp"))
        mfcc = ScpReader(os.path.join(feats_dir, "labels.scp"))
        _, m0 = lps.read_index(0)
        assert m0.shape[1] == 257
        _, c0 = mfcc.read_index(0)
        assert c0.shape[1] == 40
        stats = read_kaldi_cmvn(os.path.join(feats_dir, "inputs.cmvn"))
        assert stats.shape == (2, 258)

    def test_simulate_resumes_existing_outputs(self, tmp_path, rng, capsys):
        """An interrupted corruption run resumes: existing output wavs are
        kept byte-identical (not recomputed), missing ones are produced,
        and the rewritten wav.scp covers the full corpus. --overwrite
        recomputes everything."""
        wav_dir = tmp_path / "wavs"
        os.makedirs(wav_dir)
        scp = tmp_path / "wav.scp"
        lines = []
        for i in range(4):
            w = (rng.normal(size=8000) * 3000).astype(np.float32)
            p = str(wav_dir / f"u{i}.wav")
            write_wav(p, w)
            lines.append(f"u{i} {p}")
        scp.write_text("\n".join(lines) + "\n")
        rir = np.zeros(64, np.float32)
        rir[5] = 1.0
        write_wav(str(tmp_path / "rir.wav"), rir * 30000)
        (tmp_path / "rir_list").write_text(
            f"--rir-id r0 --room-id A {tmp_path}/rir.wav\n")

        from rsrgan_jax.cli import simulate
        out_dir = str(tmp_path / "rvb")
        args = [f"--wav_scp={scp}", f"--rir_list={tmp_path}/rir_list",
                f"--output_dir={out_dir}"]
        assert simulate.main(args) == 0
        assert "Corrupted 4 utterances (0 already present)" in \
            capsys.readouterr().out
        scp_out = os.path.join(out_dir, "wav.scp")
        full = open(scp_out).read()
        kept = open(os.path.join(out_dir, "u1.wav"), "rb").read()
        os.remove(os.path.join(out_dir, "u2.wav"))
        assert simulate.main(args) == 0
        assert "Corrupted 1 utterances (3 already present)" in \
            capsys.readouterr().out
        assert open(scp_out).read() == full
        assert open(os.path.join(out_dir, "u1.wav"), "rb").read() == kept
        assert os.path.getsize(os.path.join(out_dir, "u2.wav")) > 44
        assert simulate.main(args + ["--overwrite"]) == 0
        assert "Corrupted 4 utterances (0 already present)" in \
            capsys.readouterr().out
        # same seed + full recompute -> byte-deterministic corruption
        assert open(os.path.join(out_dir, "u1.wav"), "rb").read() == kept


class TestExtractEdgeCases:
    def test_batched_extractor_matches_single(self, rng):
        """BatchedJitExtractor == JitExtractor per utterance (same dither
        keys, same features) across mixed lengths, partial tail batches,
        and both wire dtypes (int16-exact PCM vs float)."""
        from rsrgan_jax.cli.extract import BatchedJitExtractor, JitExtractor
        from rsrgan_jax.features import FrameOptions
        opts = FrameOptions(dither=1.0)
        waves = []
        for i in range(7):
            n = int(rng.integers(20000, 70000))
            w = np.round(rng.normal(size=n) * 3000).astype(np.float32)
            if i == 3:
                w += 0.25  # non-integral samples -> float32 wire
            waves.append(w)
        for use_dither in (False, True):
            single = JitExtractor("spectrogram", opts, use_dither)
            batched = BatchedJitExtractor("spectrogram", opts, use_dither,
                                          batch=3)
            got = {}
            for i, w in enumerate(waves):
                for t, f in batched.add(i, w, 100 + i):
                    got[t] = f
            for t, f in batched.flush_all():
                got[t] = f
            assert sorted(got) == list(range(7))
            for i, w in enumerate(waves):
                np.testing.assert_allclose(
                    got[i], single(w, 100 + i), rtol=2e-5, atol=2e-4,
                    err_msg=f"utt {i} dither={use_dither}")

    def test_exact_frame_pad_multiple_with_tail(self, tmp_path, rng):
        """Wave whose frame count is an exact FRAME_PAD multiple but with
        trailing samples beyond the last frame (used to crash)."""
        from rsrgan_jax.cli.extract import FRAME_PAD, JitExtractor
        from rsrgan_jax.features import FrameOptions
        opts = FrameOptions(dither=0.0)
        n_samples = opts.window_size + opts.window_shift * (FRAME_PAD - 1) \
            + 100  # 100 extra tail samples -> n_frames == FRAME_PAD
        wave = rng.normal(size=n_samples).astype(np.float32) * 100
        ex = JitExtractor("spectrogram", opts, use_dither=False)
        feats = ex(wave, 0)
        assert feats.shape == (FRAME_PAD, 257)
        assert np.isfinite(feats).all()
