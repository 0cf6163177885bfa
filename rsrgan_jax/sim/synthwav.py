"""Synthetic speech-like audio + room assets for end-to-end simulation.

The reference's pipeline starts from real WSJ speech corrupted with real
openSLR-28 RIRs (reverberate/run.sh, README.md:27-31). This image has no
audio corpora, so integration runs synthesize *speech-like* waveforms —
harmonic glottal source with a drifting F0, slowly-moving formant
resonators, syllabic amplitude modulation and unvoiced (fricative-like)
segments — which give the LPS/MFCC front-end realistically structured
spectra to learn from, unlike white-noise features.

Also builds synthetic rooms: exponentially-decaying RIRs with a direct
path, room-linked isotropic noise, and point-source noises, plus the
option-string manifests (rir_list / noise_list) the simulator parses.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import scipy.signal

from rsrgan_jax.sim.wavio import write_wav


def _resonator(freq: float, bandwidth: float, rate: int):
    """Second-order all-pole resonator (classic formant filter)."""
    r = np.exp(-np.pi * bandwidth / rate)
    theta = 2.0 * np.pi * freq / rate
    a = [1.0, -2.0 * r * np.cos(theta), r * r]
    b = [(1.0 - r) * np.sqrt(1.0 - 2.0 * r * np.cos(2 * theta) + r * r)]
    return b, a


def make_speech_like_wav(rng: np.random.Generator, dur_s: float,
                         rate: int = 16000) -> np.ndarray:
    """One speech-like utterance, int16-scaled float32 samples."""
    n = int(dur_s * rate)
    t = np.arange(n) / rate

    # drifting fundamental (prosody): 90-220 Hz
    f0 = (140.0 + 40.0 * np.sin(2 * np.pi * rng.uniform(0.3, 0.8) * t
                                + rng.uniform(0, 2 * np.pi))
          + 20.0 * np.sin(2 * np.pi * rng.uniform(1.5, 3.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voiced = np.zeros(n, np.float64)
    for k in range(1, 13):  # harmonic-rich glottal source
        voiced += np.sin(k * phase) / k
    # unvoiced source for fricative-like stretches
    unvoiced = rng.normal(size=n)
    b, a = scipy.signal.butter(2, 2500.0 / (rate / 2), "highpass")
    unvoiced = scipy.signal.lfilter(b, a, unvoiced)

    # voiced/unvoiced gating at the ~syllable scale
    seg = int(0.08 * rate)
    gate = np.ones(n)
    for s in range(0, n, seg):
        u = rng.random()
        if u < 0.2:
            gate[s:s + seg] = 0.0  # unvoiced segment
        elif u < 0.3:
            gate[s:s + seg] = -1.0  # silence-ish (low level)
    src = np.where(gate > 0, voiced,
                   np.where(gate == 0, 1.2 * unvoiced, 0.05 * voiced))

    # formant filtering, piecewise-constant targets interpolated per 50 ms
    # block, filter state carried across blocks
    formants = [(rng.uniform(300, 900), 90.0),
                (rng.uniform(1000, 2200), 110.0),
                (rng.uniform(2300, 3200), 170.0)]
    out = np.zeros(n)
    block = int(0.05 * rate)
    for fc, bw in formants:
        zi = None
        comp = np.empty(n)
        freq = fc
        for s in range(0, n, block):
            freq = np.clip(freq + rng.normal(0, 60.0), 250.0, 3800.0)
            b, a = _resonator(float(freq), bw, rate)
            if zi is None:
                zi = scipy.signal.lfilter_zi(b, a) * src[s]
            comp[s:s + block], zi = scipy.signal.lfilter(
                b, a, src[s:s + block], zi=zi)
        out += comp / len(formants)

    # syllabic amplitude modulation + gentle fade at the edges
    env = 0.35 + 0.65 * np.abs(
        np.sin(2 * np.pi * rng.uniform(2.5, 4.5) * t
               + rng.uniform(0, 2 * np.pi))) ** 0.7
    fade = min(int(0.01 * rate), n // 4)
    env[:fade] *= np.linspace(0, 1, fade)
    env[-fade:] *= np.linspace(1, 0, fade)
    out = out * env
    peak = np.max(np.abs(out)) or 1.0
    return (out / peak * 12000.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Pseudo-phone content with ground-truth alignments
#
# The reference's quality claim is downstream ASR WER on enhanced features
# (/root/reference/README.md:45-48) — unmeasurable in this image (no Kaldi
# decoder). But the synthetic corpus's CONTENT is chosen here, so an
# in-image recognition proxy is buildable: utterances composed of units
# from a fixed pseudo-phone inventory, with the frame-level alignment
# recorded at synthesis time. tools/proxy_asr.py trains a frame classifier
# on clean features and scores enhanced features against these
# alignments — the framework's stand-in for the paper's WER axis.
# ---------------------------------------------------------------------------

# (name, kind, params): vowels = Peterson–Barney-style formant triples,
# fricatives = (low, high) noise band in Hz, "sil" = near-silence.
PHONE_INVENTORY = (
    ("sil", "silence", None),
    ("aa", "vowel", (730, 1090, 2440)),
    ("iy", "vowel", (270, 2290, 3010)),
    ("uw", "vowel", (300, 870, 2240)),
    ("eh", "vowel", (530, 1840, 2480)),
    ("ao", "vowel", (570, 840, 2410)),
    ("ae", "vowel", (660, 1720, 2410)),
    ("er", "vowel", (490, 1350, 1690)),
    ("ow", "vowel", (450, 1030, 2380)),
    ("ih", "vowel", (390, 1990, 2550)),
    ("uh", "vowel", (440, 1020, 2240)),
    ("m", "nasal", (280, 900, 2200)),
    ("s", "fric", (4500, 7500)),
    ("sh", "fric", (2000, 5000)),
    ("f", "fric", (1200, 7000)),
    ("v", "vfric", (900, 2500)),
)
NUM_PHONES = len(PHONE_INVENTORY)


def make_phone_like_wav(rng: np.random.Generator, dur_s: float,
                        rate: int = 16000):
    """Speech-like utterance built from PHONE_INVENTORY units.

    Returns ``(wav float32 [n], sample_units int32 [n])`` where
    ``sample_units[i]`` is the inventory index sounding at sample i.
    Units last 60–180 ms; voiced units ride a drifting F0 source like
    make_speech_like_wav, so spectra stay realistically structured.
    """
    n = int(dur_s * rate)
    t = np.arange(n) / rate
    f0 = (140.0 + 40.0 * np.sin(2 * np.pi * rng.uniform(0.3, 0.8) * t
                                + rng.uniform(0, 2 * np.pi))
          + 20.0 * np.sin(2 * np.pi * rng.uniform(1.5, 3.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voiced_src = np.zeros(n, np.float64)
    for k in range(1, 13):
        voiced_src += np.sin(k * phase) / k
    noise_src = rng.normal(size=n)

    out = np.zeros(n)
    units = np.zeros(n, np.int32)
    s = 0
    prev = None
    while s < n:
        seg = int(rng.uniform(0.06, 0.18) * rate)
        e = min(n, s + seg)
        # draw a unit != previous (silence rare-ish)
        while True:
            u = int(rng.integers(0, NUM_PHONES))
            if u != prev and (u != 0 or rng.random() < 0.4):
                break
        prev = u
        name, kind, params = PHONE_INVENTORY[u]
        units[s:e] = u
        if kind == "silence":
            out[s:e] = 0.01 * noise_src[s:e]
        elif kind == "fric":
            lo, hi = params
            b, a = scipy.signal.butter(
                2, [lo / (rate / 2), min(hi / (rate / 2), 0.99)], "bandpass")
            out[s:e] = 0.9 * scipy.signal.lfilter(b, a, noise_src[s:e])
        else:  # vowel / nasal / voiced fricative
            src = voiced_src[s:e].copy()
            if kind == "vfric":
                lo, hi = params
                b, a = scipy.signal.butter(
                    2, [lo / (rate / 2), hi / (rate / 2)], "bandpass")
                src = 0.6 * src + 0.8 * scipy.signal.lfilter(
                    b, a, noise_src[s:e])
                formants = [(lo, 120.0), (hi, 200.0)]
            else:
                jit = rng.normal(0, 30.0, size=3)
                formants = [(float(np.clip(f + j, 150, 3900)), bw)
                            for (f, j), bw in zip(zip(params, jit),
                                                  (90.0, 110.0, 170.0))]
            comp = np.zeros(e - s)
            for fc, bw in formants:
                b, a = _resonator(fc, bw, rate)
                comp += scipy.signal.lfilter(b, a, src) / len(formants)
            if kind == "nasal":
                comp *= 0.6
            out[s:e] = comp
        # 5 ms raised-cosine edges to avoid clicks at unit boundaries
        edge = min(int(0.005 * rate), (e - s) // 2)
        if edge > 0:
            ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, edge))
            out[s:s + edge] *= ramp
            out[e - edge:e] *= ramp[::-1]
        s = e

    # gentle utterance-level fade, prosodic amplitude drift
    env = 0.6 + 0.4 * np.abs(np.sin(
        2 * np.pi * rng.uniform(1.0, 2.0) * t + rng.uniform(0, 2 * np.pi)))
    out *= env
    fade = min(int(0.01 * rate), n // 4)
    env_edge = np.ones(n)
    env_edge[:fade] = np.linspace(0, 1, fade)
    env_edge[-fade:] = np.linspace(1, 0, fade)
    out *= env_edge
    peak = np.max(np.abs(out)) or 1.0
    return (out / peak * 12000.0).astype(np.float32), units


def frame_alignment(sample_units: np.ndarray, rate: int = 16000,
                    frame_length_ms: float = 25.0,
                    frame_shift_ms: float = 10.0) -> np.ndarray:
    """Sample-level units -> per-FRAME labels for Kaldi snip-edges framing
    (features/frontend.py FrameOptions): frame t covers
    [t*shift, t*shift+length); its label is the unit at the window center.
    """
    length = int(rate * 0.001 * frame_length_ms)
    shift = int(rate * 0.001 * frame_shift_ms)
    n = len(sample_units)
    if n < length:
        return np.zeros((0,), np.int32)
    num_frames = 1 + (n - length) // shift
    centers = np.arange(num_frames) * shift + length // 2
    return sample_units[centers].astype(np.int32)


def make_synthetic_rir(rng: np.random.Generator, rt60_s: float,
                       rate: int = 16000,
                       dur_s: float = 0.25) -> np.ndarray:
    """Direct path + exponentially decaying diffuse tail (image-method
    stand-in for the openSLR-28 real RIRs)."""
    n = int(dur_s * rate)
    rir = rng.normal(size=n) * np.exp(
        -6.908 * np.arange(n) / (rt60_s * rate))  # -60 dB at rt60
    delay = int(rng.uniform(0.002, 0.008) * rate)
    rir[:delay] *= 0.01
    rir[delay] = 1.0  # dominant direct path (peak for --shift-output)
    peak = np.max(np.abs(rir))
    return (rir / peak * 28000.0).astype(np.float32)


def make_colored_noise(rng: np.random.Generator, dur_s: float,
                       rate: int = 16000,
                       pole: float = 0.9) -> np.ndarray:
    """Stationary colored noise (single-pole lowpass of white noise)."""
    n = int(dur_s * rate)
    x = scipy.signal.lfilter([1.0], [1.0, -pole], rng.normal(size=n))
    return (x / np.max(np.abs(x)) * 8000.0).astype(np.float32)


def make_sim_assets(out_dir: str, num_utts: int,
                    min_dur_s: float = 1.0, max_dur_s: float = 3.0,
                    num_rooms: int = 2, rirs_per_room: int = 2,
                    rate: int = 16000,
                    seed: int = 0,
                    alignments: bool = False) -> Tuple[str, str, str]:
    """Build a clean corpus + rooms + noises + manifests under out_dir.

    Returns (wav_scp, rir_list, noise_list) paths. Layout:
      clean/<utt>.wav + clean/wav.scp
      rooms/room<k>_rir<j>.wav, rooms/iso_room<k>.wav, rooms/ps_*.wav
      rir_list / noise_list in the reference's option-string format
      (reverberate/data/train/{rir_list,noise_list}).

    ``alignments=True``: utterances are built from the PHONE_INVENTORY
    units (make_phone_like_wav) and a per-frame ground-truth alignment is
    written to ali/<utt>.npy + ali.scp — the labels tools/proxy_asr.py
    scores recognition against.
    """
    rng = np.random.default_rng(seed)
    clean_dir = os.path.join(out_dir, "clean")
    room_dir = os.path.join(out_dir, "rooms")
    os.makedirs(clean_dir, exist_ok=True)
    os.makedirs(room_dir, exist_ok=True)
    ali_dir = os.path.join(out_dir, "ali")
    ali_lines: List[str] = []
    if alignments:
        os.makedirs(ali_dir, exist_ok=True)

    scp_lines: List[str] = []
    for i in range(num_utts):
        dur = float(rng.uniform(min_dur_s, max_dur_s))
        if alignments:
            wav, units = make_phone_like_wav(rng, dur, rate)
            ali_path = os.path.join(ali_dir, f"utt{i:04d}.npy")
            np.save(ali_path, frame_alignment(units, rate))
            ali_lines.append(f"utt{i:04d} {ali_path}")
        else:
            wav = make_speech_like_wav(rng, dur, rate)
        path = os.path.join(clean_dir, f"utt{i:04d}.wav")
        write_wav(path, wav, rate)
        scp_lines.append(f"utt{i:04d} {path}")
    wav_scp = os.path.join(clean_dir, "wav.scp")
    with open(wav_scp, "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    if alignments:
        with open(os.path.join(out_dir, "ali.scp"), "w") as f:
            f.write("\n".join(ali_lines) + "\n")

    rir_lines: List[str] = []
    noise_lines: List[str] = []
    for k in range(num_rooms):
        room_id = f"room{k}"
        for j in range(rirs_per_room):
            rt60 = float(rng.uniform(0.2, 0.7))
            rir = make_synthetic_rir(rng, rt60, rate)
            path = os.path.join(room_dir, f"{room_id}_rir{j}.wav")
            write_wav(path, rir, rate)
            rir_lines.append(f"--rir-id {room_id}_r{j} "
                             f"--room-id {room_id} {path}")
        iso = make_colored_noise(rng, 2.0, rate, pole=0.95)
        iso_path = os.path.join(room_dir, f"iso_{room_id}.wav")
        write_wav(iso_path, iso, rate)
        noise_lines.append(f"--noise-id iso_{room_id} "
                           f"--noise-type isotropic "
                           f"--bg-fg-type background "
                           f"--room-linkage {room_id} {iso_path}")
    bg = make_colored_noise(rng, 1.5, rate, pole=0.85)
    bg_path = os.path.join(room_dir, "ps_bg.wav")
    write_wav(bg_path, bg, rate)
    noise_lines.append(f"--noise-id ps_bg --noise-type point-source "
                       f"--bg-fg-type background {bg_path}")
    fg = make_speech_like_wav(rng, 0.6, rate)  # competing-speaker burst
    fg_path = os.path.join(room_dir, "ps_fg.wav")
    write_wav(fg_path, fg, rate)
    noise_lines.append(f"--noise-id ps_fg --noise-type point-source "
                       f"--bg-fg-type foreground {fg_path}")

    rir_list = os.path.join(out_dir, "rir_list")
    with open(rir_list, "w") as f:
        f.write("\n".join(rir_lines) + "\n")
    noise_list = os.path.join(out_dir, "noise_list")
    with open(noise_list, "w") as f:
        f.write("\n".join(noise_lines) + "\n")
    return wav_scp, rir_list, noise_list
