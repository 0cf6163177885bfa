"""Make the stock-Kaldi golden-fixture loop drop-in (no code changes).

The feature contract is against Kaldi's ``compute-spectrogram-feats`` /
``compute-mfcc-feats`` binaries (/root/reference/README.md:33-35). This
image has no Kaldi, so tests/test_feature_oracle.py validates against an
independent C++ oracle instead (docs/FEATURE_PARITY.md). To close the
last gap with a ONE-TIME offline Kaldi run:

1. On this machine::

       python tools/kaldi_golden.py export --out_dir /tmp/kaldi_golden

   writes the deterministic test waves as 16-bit wavs + ``wav.scp`` +
   ``mfcc_hires.conf`` + a ready-to-run ``run_kaldi.sh``.

2. On any box with a compiled Kaldi, copy that directory and run::

       KALDI_ROOT=/path/to/kaldi bash run_kaldi.sh

   (produces lps.{ark,scp}, lps_hamming.{ark,scp}, mfcc.{ark,scp}).

3. Back here::

       python tools/kaldi_golden.py pack --kaldi_dir /tmp/kaldi_golden \
           --out tests/fixtures/kaldi_golden.npz

   bundles waves + Kaldi outputs + provenance into the fixture.
   tests/test_feature_oracle.py::TestKaldiGolden auto-activates the
   moment the file exists (it is reported as skipped-with-reason until
   then). Commit the npz to make the contract permanent.

Wave set and analysis knobs deliberately match the committed oracle
fixture (tools/make_feature_fixtures.py): dither=0 so runs are
reproducible; LPS with both the Kaldi-default povey window and the
hamming window the reference README documents; MFCC with the WSJ
mfcc_hires.conf (40 bins 20..7600 Hz, 40 ceps, no energy, lifter 22).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WAVE_SEED = 20260817  # same deterministic waves as the oracle fixture

MFCC_HIRES_CONF = """\
# WSJ conf/mfcc_hires.conf as used for the reference's 40-dim targets
# (README.md:33-35), dither pinned to 0 for reproducible goldens.
--use-energy=false
--num-mel-bins=40
--num-ceps=40
--low-freq=20
--high-freq=-400
--dither=0
"""

RUN_KALDI_SH = """\
#!/bin/bash
# Run on a box with a compiled Kaldi. Produces the arks kaldi_golden.py
# pack consumes. KALDI_ROOT must point at the Kaldi checkout.
set -euo pipefail
cd "$(dirname "$0")"
export PATH=$KALDI_ROOT/src/featbin:$PATH
compute-spectrogram-feats --dither=0 scp:wav.scp \\
    ark,scp:lps.ark,lps.scp
compute-spectrogram-feats --dither=0 --window-type=hamming scp:wav.scp \\
    ark,scp:lps_hamming.ark,lps_hamming.scp
compute-mfcc-feats --config=mfcc_hires.conf scp:wav.scp \\
    ark,scp:mfcc.ark,mfcc.scp
(cd $KALDI_ROOT 2>/dev/null && git describe --always --dirty || true) \\
    > kaldi_version.txt
echo OK
"""


def make_waves():
    """The SAME floored waves as the committed oracle fixture
    (tools/make_feature_fixtures.py — identical seed and rng-draw order),
    so a real Kaldi bundle pins the signals both oracles saw. int16
    quantization up front: Kaldi reads 16-bit PCM, so the golden
    comparison must run on exactly the quantized samples."""
    from rsrgan_jax.sim import make_speech_like_wav

    rng = np.random.default_rng(WAVE_SEED)
    speech = make_speech_like_wav(rng, 1.0).astype(np.float64)
    speech = speech + rng.normal(size=speech.shape) * np.std(speech) * 0.01
    noise = rng.normal(size=16000) * 3000.0
    tone = 10000 * np.sin(2 * np.pi * 440 / 16000 * np.arange(12000))
    tone = tone + rng.normal(size=tone.shape) * 30
    return {name: np.asarray(np.clip(np.round(w), -32768, 32767),
                             np.float32)
            for name, w in
            (("speech", speech), ("noise", noise), ("tone", tone))}


def cmd_export(args) -> int:
    from rsrgan_jax.sim.wavio import write_wav

    os.makedirs(args.out_dir, exist_ok=True)
    waves = make_waves()
    scp_lines = []
    for name, wave in waves.items():
        path = os.path.join(args.out_dir, f"{name}.wav")
        write_wav(path, wave, 16000)
        scp_lines.append(f"{name} {os.path.basename(path)}")
    with open(os.path.join(args.out_dir, "wav.scp"), "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    with open(os.path.join(args.out_dir, "mfcc_hires.conf"), "w") as f:
        f.write(MFCC_HIRES_CONF)
    sh = os.path.join(args.out_dir, "run_kaldi.sh")
    with open(sh, "w") as f:
        f.write(RUN_KALDI_SH)
    os.chmod(sh, 0o755)
    print(f"Exported {len(waves)} waves + run_kaldi.sh to {args.out_dir}.\n"
          f"Next: copy to a Kaldi box, `KALDI_ROOT=... bash run_kaldi.sh`, "
          f"copy back, then `python tools/kaldi_golden.py pack "
          f"--kaldi_dir {args.out_dir}`.")
    return 0


def cmd_pack(args) -> int:
    from rsrgan_jax.data.kaldi_ark import ScpReader
    from rsrgan_jax.sim.wavio import read_wav

    d = args.kaldi_dir
    bundle = {}
    names = []
    with open(os.path.join(d, "wav.scp")) as f:
        for line in f:
            name, rel = line.split()
            names.append(name)
            wave, fs = read_wav(os.path.join(d, os.path.basename(rel)))
            assert fs == 16000, (name, fs)
            bundle[f"wave_{name}"] = np.asarray(wave, np.float32)
    for feat, key in (("lps", "lps"), ("lps_hamming", "lps_hamming"),
                      ("mfcc", "mfcc")):
        scp = os.path.join(d, f"{feat}.scp")
        if not os.path.exists(scp):
            print(f"WARNING: {scp} missing; {feat} goldens not packed",
                  file=sys.stderr)
            continue
        reader = ScpReader(scp)
        for name in names:
            bundle[f"{key}_{name}"] = np.asarray(reader.read_utt(name),
                                                 np.float32)
    version = "unknown"
    vfile = os.path.join(d, "kaldi_version.txt")
    if os.path.exists(vfile):
        version = open(vfile).read().strip() or "unknown"
    bundle["provenance"] = np.str_(
        f"Stock Kaldi outputs (version: {version}) produced by "
        f"run_kaldi.sh (compute-spectrogram-feats --dither=0 "
        f"[--window-type=hamming]; compute-mfcc-feats "
        f"--config=mfcc_hires.conf) on the deterministic waves from "
        f"tools/kaldi_golden.py export (seed {WAVE_SEED}).")
    np.savez_compressed(args.out, **bundle)
    print(f"Packed {len(bundle) - 1} arrays -> {args.out}. "
          f"tests/test_feature_oracle.py::TestKaldiGolden now activates.")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/kaldi_golden.py")
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("export")
    e.add_argument("--out_dir", required=True)
    e.set_defaults(func=cmd_export)
    k = sub.add_parser("pack")
    k.add_argument("--kaldi_dir", required=True)
    k.add_argument("--out",
                   default=os.path.join(REPO, "tests", "fixtures",
                                        "kaldi_golden.npz"))
    k.set_defaults(func=cmd_pack)
    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
