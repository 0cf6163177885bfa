"""Corpus corruption CLI — reverberate/run.sh + reverberate_bash.py
equivalent, executing the corruption directly instead of emitting
wav-reverberate shell commands.

    python -m rsrgan_jax.cli.simulate \
        --wav_scp data/train/wav.scp \
        --rir_list reverberate/data/train/rir_list \
        --noise_list reverberate/data/train/noise_list \
        --output_dir out/rvb --num_replications 1

Writes ``<output_dir>/<utt_id>.wav`` plus an output wav.scp, like the
reference's --reverberation-wav-dir mode (reverberate_bash.py:317-383).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rsrgan_jax.sim import (SimulationOptions, corrupt_utterance,
                            parse_noise_list, parse_rir_list, read_wav,
                            write_wav)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsrgan_jax.cli.simulate")
    p.add_argument("--wav_scp", required=True)
    p.add_argument("--rir_list", default=None)
    p.add_argument("--noise_list", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_replications", type=int, default=1)
    p.add_argument("--foreground_snrs", default="5:20",
                   help="lower:upper bounds, sampled uniformly")
    p.add_argument("--background_snrs", default="5:20")
    p.add_argument("--speech_rvb_probability", type=float, default=1.0)
    p.add_argument("--pointsource_noise_addition_probability", type=float,
                   default=1.0)
    p.add_argument("--isotropic_noise_addition_probability", type=float,
                   default=1.0)
    p.add_argument("--max_noises_added", type=int, default=1)
    p.add_argument("--shift_output", default="true")
    p.add_argument("--normalize_output", default="true")
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--overwrite", action="store_true",
                   help="re-corrupt utterances whose output wav already "
                        "exists (default: skip them, so an interrupted "
                        "run resumes; note skipped utterances do not "
                        "consume RNG draws, so a resumed run's remaining "
                        "corruptions differ from a fresh run's)")
    args = p.parse_args(argv)

    def bounds(s):
        lo, hi = s.split(":")
        return (float(lo), float(hi))

    opts = SimulationOptions(
        foreground_snr_bounds=bounds(args.foreground_snrs),
        background_snr_bounds=bounds(args.background_snrs),
        speech_rvb_probability=args.speech_rvb_probability,
        pointsource_noise_addition_probability=(
            args.pointsource_noise_addition_probability),
        isotropic_noise_addition_probability=(
            args.isotropic_noise_addition_probability),
        max_noises_added=args.max_noises_added,
        shift_output=str(args.shift_output).lower() == "true",
        normalize_output=str(args.normalize_output).lower() == "true",
        seed=args.random_seed)

    rooms = parse_rir_list(args.rir_list) if args.rir_list else []
    pointsource, iso_noise_dict = (parse_noise_list(args.noise_list)
                                   if args.noise_list else ([], {}))
    rng = np.random.default_rng(args.random_seed)

    os.makedirs(args.output_dir, exist_ok=True)
    out_scp = os.path.join(args.output_dir, "wav.scp")
    wav_cache = {}

    def cached_read(path):
        if path not in wav_cache:
            wav_cache[path] = read_wav(path)[0]
        return wav_cache[path]

    count = skipped = 0
    with open(out_scp, "w") as scp:
        with open(args.wav_scp) as f:
            entries = [line.strip().split(None, 1) for line in f
                       if line.strip()]
        for rep in range(1, args.num_replications + 1):
            for utt_id, wav_path in entries:
                rvb_id = (f"rvb{rep}_{utt_id}"
                          if args.num_replications > 1 else utt_id)
                out_path = os.path.join(args.output_dir, rvb_id + ".wav")
                if (not args.overwrite and os.path.exists(out_path)
                        and os.path.getsize(out_path) > 44):
                    scp.write(f"{rvb_id} {out_path}\n")
                    skipped += 1
                    continue
                speech, rate = read_wav(wav_path)
                opts.sample_rate = rate
                corrupted = corrupt_utterance(speech, rooms, pointsource,
                                              iso_noise_dict, opts,
                                              rng, cached_read)
                write_wav(out_path, corrupted, rate)
                scp.write(f"{rvb_id} {out_path}\n")
                count += 1
    print(f"Corrupted {count} utterances ({skipped} already present) "
          f"-> {out_scp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
