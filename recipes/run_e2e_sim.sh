#!/bin/bash
# Full-chain integration on simulated SPEECH through this framework's own
# DSP — the reference's stage-0..3 pipeline (reverberate/run.sh +
# run_gan_rnn_placeholder.sh) with every external Kaldi binary replaced by
# the rsrgan_jax equivalent:
#
#   synth speech wavs -> cli.simulate (RIR conv + SNR noise)
#                     -> cli.extract  (257-d LPS inputs / 40-d MFCC labels
#                                      + CMVN accumulation)
#                     -> cli.prepare  (cmvn npz, tr/cv split, stores)
#                     -> cli.train    (flagship res_lstm_l LSGAN)
#                     -> cli.train --decode -> Kaldi ark out
#                     -> quality: enhanced-vs-clean MFCC MSE must beat BOTH
#                        the no-enhancement baseline (MFCC of the corrupted
#                        audio) and the predict-the-mean baseline.
#
# One GPU. ~25-45 min cold, mostly train iterations once compiled.
set -euo pipefail
cd "$(dirname "$0")/.."

workdir=${1:-/tmp/rsrgan_e2e_sim}
iters=${2:-20}
num_utts=${3:-96}
val_size=${4:-12}
rm -rf "$workdir" && mkdir -p "$workdir"
train_dir=$workdir/data/train
save_dir=$workdir/exp/gan_res_lstm_l
mkdir -p "$train_dir"

echo "== stage 0: synthesize clean speech + rooms/noises =="
python - "$workdir" "$num_utts" <<'EOF'
import sys
from rsrgan_jax.sim import make_sim_assets
make_sim_assets(sys.argv[1] + "/sim", num_utts=int(sys.argv[2]),
                min_dur_s=1.2, max_dur_s=3.0, seed=11)
EOF

echo "== stage 1: corrupt (reverb + noise) =="
python -m rsrgan_jax.cli.simulate \
  --wav_scp=$workdir/sim/clean/wav.scp \
  --rir_list=$workdir/sim/rir_list \
  --noise_list=$workdir/sim/noise_list \
  --output_dir=$workdir/sim/rvb \
  --foreground_snrs=5:20 --background_snrs=5:20 \
  --random_seed=1

echo "== stage 2: feature extraction (LPS inputs / MFCC labels) =="
python -m rsrgan_jax.cli.extract \
  --wav_scp=$workdir/sim/rvb/wav.scp --feat_type=spectrogram \
  --output_dir=$train_dir --name=inputs --accumulate_cmvn
python -m rsrgan_jax.cli.extract \
  --wav_scp=$workdir/sim/clean/wav.scp --feat_type=mfcc \
  --output_dir=$train_dir --name=labels --accumulate_cmvn
# no-enhancement baseline: MFCC computed directly on the corrupted audio
python -m rsrgan_jax.cli.extract \
  --wav_scp=$workdir/sim/rvb/wav.scp --feat_type=mfcc \
  --output_dir=$workdir/baseline --name=rvb_mfcc

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

echo "== stage 4: train flagship GAN =="
python -m rsrgan_jax.cli.train \
  --trainer=gan_rnn --g_type=res_lstm_l \
  --data_dir=$train_dir \
  --tr_list_file=$train_dir/tr.list --cv_list_file=$train_dir/cv.list \
  --save_dir=$save_dir \
  --batch_size=4 \
  --g_learning_rate=0.0003 --d_learning_rate=0.001 \
  --disc_updates=1 --gen_updates=2 \
  --init_mse_weight=10.0 \
  --input_dim=257 --output_dim=40 \
  --min_epoches=$iters --max_epoches=$iters \
  --init_disc_noise_std=0.05 \
  --l2_scale=0.0

echo "== stage 5: decode (enhance the corrupted cv set) =="
python -m rsrgan_jax.cli.train \
  --decode --trainer=gan_rnn --g_type=res_lstm_l \
  --data_dir=$train_dir --test_list_file=$train_dir/test.list \
  --save_dir=$save_dir \
  --input_dim=257 --output_dim=40 --batch_size=1 \
  --decode_batch_size=4

echo "== stage 6: quality vs baselines =="
python - "$train_dir" "$save_dir" "$workdir/baseline" <<'EOF'
import sys
import numpy as np
from rsrgan_jax.data import ScpReader
train_dir, save_dir, baseline_dir = sys.argv[1:4]
clean = {u: np.asarray(m) for u, m in ScpReader(f"{train_dir}/cv/labels.scp")}
enhanced = {u: np.asarray(m) for u, m in ScpReader(f"{save_dir}/test/feats.scp")}
rvb = {u: np.asarray(m) for u, m in ScpReader(f"{baseline_dir}/rvb_mfcc.scp")}
assert clean.keys() == enhanced.keys()
mse_model, mse_mean, mse_noenh = [], [], []
for u in clean:
    y, g = clean[u], enhanced[u]
    assert y.shape == g.shape, (u, y.shape, g.shape)
    r = rvb[u][:len(y)]
    mse_model.append(np.mean((g - y) ** 2))
    mse_mean.append(np.mean((y.mean(axis=0) - y) ** 2))
    mse_noenh.append(np.mean((r - y[:len(r)]) ** 2))
mse_model = float(np.mean(mse_model))
mse_mean = float(np.mean(mse_mean))
mse_noenh = float(np.mean(mse_noenh))
print(f"enhanced-vs-clean MFCC MSE : {mse_model:.4f}")
print(f"no-enhancement baseline    : {mse_noenh:.4f}  "
      f"(MFCC of corrupted audio)   ratio {mse_model / mse_noenh:.3f}")
print(f"predict-mean baseline      : {mse_mean:.4f}  "
      f"ratio {mse_model / mse_mean:.3f}")
assert mse_model < mse_noenh, "enhancement did not beat corrupted audio"
assert mse_model < 0.8 * mse_mean, "enhancement did not beat mean baseline"
print("E2E SIM QUALITY CHECK PASSED")
EOF
