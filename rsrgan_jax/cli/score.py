"""Objective scoring CLI: enhanced vs clean, per-utterance + summary.

The reference evaluates only via an external Kaldi ASR decode (WER,
/root/reference/README.md:36-48). This scores enhancement directly:

    # waveform metrics (after cli/resynth):
    python -m rsrgan_jax.cli.score --mode wav \
        --est_scp exp/test/wav/wav.scp --ref_scp clean_wav.scp

    # feature-domain metrics on arks (decode output vs clean feats):
    python -m rsrgan_jax.cli.score --mode feats \
        --est_scp exp/test/feats.scp --ref_scp clean_feats.scp

wav mode: SNR, SI-SNR, segmental SNR (dB), STOI, ESTOI (utterances too
short for the 384 ms STOI segments score NaN and are excluded from the
summary means). feats mode: LSD (dB; slot 0 excluded under raw_energy),
feature MSE, and the global-variance ratio (over-smoothing diagnostic;
1.0 = matches the reference spectra's temporal dynamics). Prints one
line per utterance plus a JSON summary of means; optional --per_utt
JSONL dump.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from rsrgan_jax.cli import str2bool
from rsrgan_jax.data.kaldi_ark import ScpReader
from rsrgan_jax.eval import (feature_mse, lsd_from_lps, seg_snr, si_snr,
                             snr, variance_ratio)
from rsrgan_jax.eval.stoi import stoi_both
from rsrgan_jax.sim.wavio import read_wav


def _read_wav_scp(path):
    with open(path) as f:
        return dict(line.strip().split(None, 1) for line in f if line.strip())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsrgan_jax.cli.score")
    p.add_argument("--mode", choices=["wav", "feats"], required=True)
    p.add_argument("--est_scp", required=True)
    p.add_argument("--ref_scp", required=True)
    p.add_argument("--per_utt", default=None,
                   help="optional path for a per-utterance JSONL dump")
    p.add_argument("--intelligibility", type=str2bool,
                   default=True,
                   help="wav mode: compute STOI/ESTOI (host-side "
                        "~O(0.5 s)/utt on this machine; set false to skip "
                        "on large test sets)")
    p.add_argument("--raw_energy", type=str2bool,
                   default=True,
                   help="feats mode: slot 0 is frame energy; excluded "
                        "from LSD (default true, matching extraction)")
    args = p.parse_args(argv)

    rows = []
    if args.mode == "wav":
        est, ref = _read_wav_scp(args.est_scp), _read_wav_scp(args.ref_scp)
        for utt_id in est:
            if utt_id not in ref:
                print(f"WARNING: no reference wav for {utt_id}; skipped",
                      file=sys.stderr)
                continue
            e, fs_e = read_wav(est[utt_id])
            r, fs_r = read_wav(ref[utt_id])
            if fs_e != fs_r:
                print(f"WARNING: sample-rate mismatch for {utt_id} "
                      f"({fs_e} vs {fs_r}); skipped", file=sys.stderr)
                continue
            row = {"utt_id": utt_id, "snr_db": snr(e, r),
                   "si_snr_db": si_snr(e, r),
                   "seg_snr_db": seg_snr(e, r)}
            if args.intelligibility:
                try:
                    row["stoi"], row["estoi"] = stoi_both(e, r, fs=fs_r)
                except ValueError as exc:  # too short / silent for STOI
                    print(f"WARNING: STOI undefined for {utt_id}: {exc}",
                          file=sys.stderr)
                    row["stoi"] = row["estoi"] = float("nan")
            rows.append(row)
    else:
        est, ref = ScpReader(args.est_scp), ScpReader(args.ref_scp)
        ref_ids = set(ref.utt_ids)
        for utt_id, e in est:
            if utt_id not in ref_ids:
                print(f"WARNING: no reference feats for {utt_id}; skipped",
                      file=sys.stderr)
                continue
            r = ref.read_utt(utt_id)
            rows.append({"utt_id": utt_id,
                         "lsd_db": lsd_from_lps(
                             e, r, skip_first_bin=args.raw_energy),
                         "mse": feature_mse(e, r),
                         "gv_ratio": variance_ratio(
                             e, r, skip_first_bin=args.raw_energy)})

    if not rows:
        print("No scored utterances", file=sys.stderr)
        return 1
    for row in rows:
        print(" ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{v}"
                       for k, v in row.items()))
    def _jsonable(v):
        # json.dumps would emit the bare token NaN (invalid JSON);
        # absent values serialize as null instead
        if isinstance(v, float) and not np.isfinite(v):
            return None
        return v

    keys = [k for k in rows[0] if k != "utt_id"]
    vals = {k: [r[k] for r in rows if np.isfinite(r[k])] for k in keys}
    summary = {f"mean_{k}": (round(float(np.mean(v)), 4) if v else None)
               for k, v in vals.items()}
    summary["num_utts"] = len(rows)
    print(json.dumps(summary))
    if args.per_utt:
        with open(args.per_utt, "w") as f:
            for row in rows:
                f.write(json.dumps(
                    {k: _jsonable(v) for k, v in row.items()}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
