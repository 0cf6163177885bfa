"""Recognition-proxy tests: pseudo-phone synthesis alignments and the
tools/proxy_asr.py classifier/scorer mechanics (the in-image stand-in for
the reference's downstream-WER axis, /root/reference/README.md:45-48)."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsrgan_jax.data.kaldi_ark import ArkWriter
from rsrgan_jax.features.frontend import FrameOptions, num_frames
from rsrgan_jax.sim.synthwav import (NUM_PHONES, PHONE_INVENTORY,
                                     frame_alignment, make_phone_like_wav,
                                     make_sim_assets)


class TestPhoneSynthesis:
    def test_wav_and_units_aligned(self):
        rng = np.random.default_rng(3)
        wav, units = make_phone_like_wav(rng, 1.5)
        assert wav.shape == units.shape
        assert wav.dtype == np.float32
        assert units.min() >= 0 and units.max() < NUM_PHONES
        assert len(np.unique(units)) >= 4  # several units per utterance
        # unit durations within the sampled 60-180 ms range (boundaries may
        # merge repeats is excluded by construction: u != prev)
        bounds = np.flatnonzero(np.diff(units)) + 1
        seglens = np.diff(np.concatenate([[0], bounds, [len(units)]]))
        assert seglens[:-1].min() >= int(0.06 * 16000) - 1

    def test_frame_alignment_matches_kaldi_framing(self):
        rng = np.random.default_rng(4)
        wav, units = make_phone_like_wav(rng, 2.0)
        ali = frame_alignment(units)
        opts = FrameOptions(dither=0.0)
        assert len(ali) == num_frames(len(wav), opts)
        # frame label is the unit at the window center
        assert ali[0] == units[200]
        assert ali[10] == units[10 * 160 + 200]

    def test_make_sim_assets_writes_alignments(self, tmp_path):
        out = str(tmp_path / "sim")
        wav_scp, _, _ = make_sim_assets(out, num_utts=3, min_dur_s=0.5,
                                        max_dur_s=0.8, alignments=True,
                                        seed=1)
        ali_scp = os.path.join(out, "ali.scp")
        assert os.path.isfile(ali_scp)
        with open(ali_scp) as f:
            lines = [line.split() for line in f]
        assert len(lines) == 3
        with open(wav_scp) as f:
            wav_ids = [line.split()[0] for line in f]
        assert [u for u, _ in lines] == wav_ids
        ali = np.load(lines[0][1])
        assert ali.dtype == np.int32 and ali.ndim == 1 and len(ali) > 10

    def test_inventory_is_stable(self):
        # tools/proxy_asr.py's class count and saved alignments depend on
        # the inventory order; growing it is fine, reordering is not
        assert PHONE_INVENTORY[0][0] == "sil"
        assert NUM_PHONES == 16


class TestProxyAsrTool:
    def _write_corpus(self, tmp_path, snr):
        """Synthetic 'features': class-indicative embeddings + noise at
        the given separability; returns (scp_path, ali_scp)."""
        rng = np.random.default_rng(7)
        d = 20
        codes = rng.normal(size=(NUM_PHONES, d)).astype(np.float32)
        ark = str(tmp_path / f"feats_{snr}.ark")
        scp = str(tmp_path / f"feats_{snr}.scp")
        ali_dir = tmp_path / "ali"
        ali_dir.mkdir(exist_ok=True)
        ali_scp = str(tmp_path / "ali.scp")
        w = ArkWriter(scp)
        with open(ali_scp, "w") as af:
            for i in range(40):
                n = int(rng.integers(60, 100))
                labels = rng.integers(0, NUM_PHONES, size=n)
                # unit-ish runs: repeat each label 5x then trim
                labels = np.repeat(labels, 5)[:n].astype(np.int32)
                feats = (codes[labels] * snr
                         + rng.normal(size=(n, d))).astype(np.float32)
                utt = f"u{i}"
                w.write_next_utt(ark, utt, feats)
                path = str(ali_dir / f"{utt}_{snr}.npy")
                np.save(path, labels)
                af.write(f"{utt} {path}\n")
        w.close()
        return scp, ali_scp

    def test_separable_beats_noisy(self, tmp_path, capsys):
        import importlib
        proxy_asr = importlib.import_module("tools.proxy_asr")
        clean_scp, ali_scp = self._write_corpus(tmp_path, snr=4.0)
        noisy_scp, _ = self._write_corpus(tmp_path, snr=0.3)
        out_json = str(tmp_path / "proxy.json")
        rc = proxy_asr.main([
            f"--train_scp={clean_scp}", f"--ali_scp={ali_scp}",
            f"--eval=noisy={noisy_scp}", f"--holdout_scp={clean_scp}",
            "--context=1", "--hidden=32", "--epochs=20", "--batch=128",
            "--lr=3e-3", f"--out={out_json}"])
        assert rc == 0
        with open(out_json) as f:
            result = json.load(f)
        clean = result["systems"]["clean"]
        noisy = result["systems"]["noisy"]
        assert clean["fer"] < 0.25          # separable codes are learnable
        assert noisy["fer"] > clean["fer"] + 0.1  # corruption shows up
        assert 0.0 <= clean["ser"] <= clean["fer"] + 0.35
        assert result["classes"] == NUM_PHONES

    def test_mismatched_alignment_fails_legibly(self, tmp_path):
        import importlib
        proxy_asr = importlib.import_module("tools.proxy_asr")
        scp, ali_scp = self._write_corpus(tmp_path, snr=4.0)
        # corrupt one alignment to a wildly different length
        with open(ali_scp) as f:
            utt, path = f.readline().split()
        np.save(path, np.zeros(5, np.int32))
        with pytest.raises(ValueError, match="alignment frames"):
            proxy_asr.main([f"--train_scp={scp}", f"--ali_scp={ali_scp}",
                            "--context=0", "--epochs=1"])
