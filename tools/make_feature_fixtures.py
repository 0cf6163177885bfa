"""Generate committed feature-parity fixtures from the C++ oracle.

Writes tests/fixtures/oracle_feats.npz: deterministic test waves plus the
LPS/MFCC matrices produced for them by the INDEPENDENT C++ oracle
(rsrgan_jax/native/kaldi_feat_oracle.cc — double precision, its own FFT,
written from the published Kaldi algorithm, sharing no code with the JAX
front-end). tests/test_feature_oracle.py checks the JAX front-end against
both the committed fixture and, when g++ is available, a freshly built
oracle.

Provenance is embedded in the npz (see PROVENANCE below) — this is NOT
output of a stock Kaldi compute-*-feats binary (none exists in this
image); docs/FEATURE_PARITY.md records exactly which knobs that leaves
unverified.

Usage: python tools/make_feature_fixtures.py
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ORACLE = os.path.join(REPO, "rsrgan_jax", "native", "kaldi_feat_oracle")

PROVENANCE = (
    "Generated by tools/make_feature_fixtures.py running "
    "rsrgan_jax/native/kaldi_feat_oracle.cc (independent C++ oracle, "
    "double precision, own radix-2 FFT, implementing Kaldi "
    "feature-window.cc/feature-spectrogram.cc/mel-computations.cc/"
    "feature-mfcc.cc semantics; dither=0, povey window, preemph 0.97, "
    "snip-edges, raw energy; MFCC hires: 40 bins 20..7600 Hz, 40 ceps, "
    "lifter 22, no energy). NOT produced by a stock Kaldi binary — see "
    "docs/FEATURE_PARITY.md for what that leaves unverified.")


def run_oracle(wave: np.ndarray, mode: str) -> np.ndarray:
    wav_path = "/tmp/_fixture_wave.f32le"
    out_path = "/tmp/_fixture_out.mat"
    wave.astype("<f4").tofile(wav_path)
    subprocess.run([ORACLE, mode, wav_path, out_path], check=True)
    with open(out_path, "rb") as f:
        rows, cols = np.frombuffer(f.read(8), "<i4")
        return np.frombuffer(f.read(), "<f4").reshape(rows, cols).copy()


def main() -> None:
    if not os.path.isfile(ORACLE):
        subprocess.run(
            ["bash", os.path.join(REPO, "rsrgan_jax", "native", "build.sh")],
            check=True)

    from rsrgan_jax.sim import make_speech_like_wav

    rng = np.random.default_rng(20260817)
    speech = make_speech_like_wav(rng, 1.0).astype(np.float64)
    # broadband floor keeps every fft/mel bin well above float32 noise so
    # the comparison is meaningful everywhere (real Kaldi, also float32,
    # has the same indeterminacy at spectral nulls)
    speech_floored = (speech + rng.normal(size=speech.shape)
                      * np.std(speech) * 0.01).astype(np.float32)
    noise = (rng.normal(size=16000) * 3000).astype(np.float32)
    tone = (10000 * np.sin(2 * np.pi * 440 / 16000
                           * np.arange(12000))).astype(np.float32)
    tone_floored = (tone + rng.normal(size=tone.shape) * 30).astype(
        np.float32)

    out = {"provenance": np.array(PROVENANCE)}
    for name, wave in (("speech", speech_floored), ("noise", noise),
                       ("tone", tone_floored)):
        out[f"wave_{name}"] = wave
        out[f"lps_{name}"] = run_oracle(wave, "spectrogram")
        out[f"mfcc_{name}"] = run_oracle(wave, "mfcc")
        print(f"{name}: wave {wave.shape} lps {out[f'lps_{name}'].shape} "
              f"mfcc {out[f'mfcc_{name}'].shape}")

    path = os.path.join(REPO, "tests", "fixtures", "oracle_feats.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
