#!/bin/bash
# Audible end-to-end enhancement demo: the full wav -> wav loop.
#
# Same chain as recipes/run_e2e_sim.sh but trained feature-to-feature on
# LPS targets (input 257-d LPS of corrupted audio -> clean 257-d LPS), so
# the decode output is invertible back to a waveform:
#
#   synth speech -> cli.simulate (reverb+noise) -> cli.extract (LPS both
#   sides) -> cli.prepare -> cli.train (flagship LSGAN, 257 -> 257)
#   -> decode -> cli.resynth (enhanced LPS + noisy phase -> wav)
#   -> cli.score: LSD(enhanced) must beat LSD(corrupted); waveform
#      SNR/SI-SNR/segSNR of enhanced-vs-clean printed alongside the
#      noisy-vs-clean baseline.
#
# The reference cannot do any of this post-decode: it ends at feature arks
# for an external Kaldi ASR (README.md:36-48). One GPU, ~30-50 min
# cold (training dominates; compiles are cached).
set -euo pipefail
cd "$(dirname "$0")/.."

workdir=${1:-/tmp/rsrgan_enhance_demo}
iters=${2:-20}
num_utts=${3:-96}
val_size=${4:-12}
rm -rf "$workdir" && mkdir -p "$workdir"
train_dir=$workdir/data/train
save_dir=$workdir/exp/gan_lps2lps
mkdir -p "$train_dir"

echo "== stage 0: synthesize clean speech + rooms/noises =="
python - "$workdir" "$num_utts" <<'EOF'
import sys
from rsrgan_jax.sim import make_sim_assets
make_sim_assets(sys.argv[1] + "/sim", num_utts=int(sys.argv[2]),
                min_dur_s=1.2, max_dur_s=3.0, seed=23)
EOF

echo "== stage 1: corrupt (reverb + noise) =="
python -m rsrgan_jax.cli.simulate \
  --wav_scp=$workdir/sim/clean/wav.scp \
  --rir_list=$workdir/sim/rir_list \
  --noise_list=$workdir/sim/noise_list \
  --output_dir=$workdir/sim/rvb \
  --foreground_snrs=5:20 --background_snrs=5:20 \
  --random_seed=1

echo "== stage 2: LPS features on both sides =="
python -m rsrgan_jax.cli.extract \
  --wav_scp=$workdir/sim/rvb/wav.scp --feat_type=spectrogram \
  --output_dir=$train_dir --name=inputs --accumulate_cmvn
python -m rsrgan_jax.cli.extract \
  --wav_scp=$workdir/sim/clean/wav.scp --feat_type=spectrogram \
  --output_dir=$train_dir --name=labels --accumulate_cmvn

echo "== stage 3: cmvn + split + stores =="
python -m rsrgan_jax.cli.prepare cmvn \
  --inputs=$train_dir/inputs.cmvn --labels=$train_dir/labels.cmvn \
  --save_dir=$train_dir
python -m rsrgan_jax.cli.prepare split --val_size=$val_size \
  --data_dir=$train_dir --seed=1
mkdir -p $train_dir/stores
for sub in tr cv; do
  python -m rsrgan_jax.cli.prepare make-store \
    --inputs=$train_dir/$sub/inputs.scp --labels=$train_dir/$sub/labels.scp \
    --cmvn_dir=$train_dir --output_dir=$train_dir/stores --name=$sub
done
echo "$train_dir/stores/tr.rtu" > $train_dir/tr.list
echo "$train_dir/stores/cv.rtu" > $train_dir/cv.list
python -m rsrgan_jax.cli.prepare make-store --test \
  --inputs=$train_dir/cv/inputs.scp --cmvn_dir=$train_dir \
  --output_dir=$train_dir/stores --name=test
echo "$train_dir/stores/test.rtu" > $train_dir/test.list

echo "== stage 4: train flagship GAN (LPS -> LPS) =="
python -m rsrgan_jax.cli.train \
  --trainer=gan_rnn --g_type=res_lstm_l \
  --data_dir=$train_dir \
  --tr_list_file=$train_dir/tr.list --cv_list_file=$train_dir/cv.list \
  --save_dir=$save_dir \
  --batch_size=4 \
  --g_learning_rate=0.0003 --d_learning_rate=0.001 \
  --disc_updates=1 --gen_updates=2 \
  --init_mse_weight=10.0 \
  --input_dim=257 --output_dim=257 \
  --min_epoches=$iters --max_epoches=$iters \
  --init_disc_noise_std=0.05 \
  --l2_scale=0.0

echo "== stage 5: decode (enhance the corrupted cv set) =="
python -m rsrgan_jax.cli.train \
  --decode --trainer=gan_rnn --g_type=res_lstm_l \
  --data_dir=$train_dir --test_list_file=$train_dir/test.list \
  --save_dir=$save_dir \
  --input_dim=257 --output_dim=257 --batch_size=1 \
  --decode_batch_size=4

echo "== stage 6: resynthesize enhanced waveforms =="
# cv-only noisy/clean wav scps for phase + scoring
awk 'NR==FNR {keep[$1]=1; next} ($1 in keep)' \
  $train_dir/cv/inputs.scp $workdir/sim/rvb/wav.scp \
  > $workdir/cv_noisy_wav.scp
awk 'NR==FNR {keep[$1]=1; next} ($1 in keep)' \
  $train_dir/cv/inputs.scp $workdir/sim/clean/wav.scp \
  > $workdir/cv_clean_wav.scp
python -m rsrgan_jax.cli.resynth \
  --enhanced_scp=$save_dir/test/feats.scp \
  --wav_scp=$workdir/cv_noisy_wav.scp \
  --out_dir=$save_dir/test/wav

echo "== stage 7: score (feature LSD + waveform metrics) =="
echo "-- LSD: corrupted LPS vs clean LPS (no-enhancement baseline) --"
python -m rsrgan_jax.cli.score --mode feats \
  --est_scp=$train_dir/cv/inputs.scp --ref_scp=$train_dir/cv/labels.scp \
  --per_utt=$workdir/score_noisy_feats.jsonl
echo "-- LSD: enhanced LPS vs clean LPS --"
python -m rsrgan_jax.cli.score --mode feats \
  --est_scp=$save_dir/test/feats.scp --ref_scp=$train_dir/cv/labels.scp \
  --per_utt=$workdir/score_enh_feats.jsonl
echo "-- waveform: noisy vs clean (baseline) --"
python -m rsrgan_jax.cli.score --mode wav \
  --est_scp=$workdir/cv_noisy_wav.scp --ref_scp=$workdir/cv_clean_wav.scp
echo "-- waveform: enhanced vs clean --"
python -m rsrgan_jax.cli.score --mode wav \
  --est_scp=$save_dir/test/wav/wav.scp --ref_scp=$workdir/cv_clean_wav.scp

python - "$workdir" <<'EOF'
import json, sys
import numpy as np
work = sys.argv[1]
def mean_lsd(path):
    with open(path) as f:
        return float(np.mean([json.loads(l)["lsd_db"] for l in f]))
noisy = mean_lsd(f"{work}/score_noisy_feats.jsonl")
enh = mean_lsd(f"{work}/score_enh_feats.jsonl")
print(f"LSD corrupted : {noisy:.3f} dB")
print(f"LSD enhanced  : {enh:.3f} dB   ratio {enh / noisy:.3f}")
assert enh < noisy, "enhanced LSD did not beat the corrupted baseline"
print("ENHANCE DEMO QUALITY CHECK PASSED")
EOF
