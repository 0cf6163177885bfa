#!/bin/bash
# The reference training REGIME at reference scale: ~100 h (~36 M train
# frames) on the reference-native task (257-d LPS of reverberant speech
# -> 40-d clean hires MFCC), flagship LSGAN schedule + MSE baseline,
# decoded + scored with feature metrics and the recognition proxy.
# Mirrors run_gan_rnn_placeholder.sh:11,119-168 (train_100h, warm-up
# epoch at d_lr 1e-3 then 18-20 epochs at d_lr 3e-4 / g_lr 8e-5,
# 1 D : 2 G, mse_weight 10, disc noise 0.05, B=8) and run_rnn.sh:125-145
# (MSE, g_lr 3e-4, 20-25 epochs).
#
# The corpus (~37 GB of bf16 feature tables) exceeds the chip's HBM, so
# cli/train rotates resident shards (RotatingDeviceFeed): ROT_BLOCK
# consecutive passes per shard residency, optionally uploading the next
# shard on a background thread (PREFETCH=true) while training.
#
# Disk choreography (the 104k-utt corpus does not fit this host twice):
# wavs are DELETED after feature extraction (MFCC targets are not
# resynthesizable anyway) and the input ark after store building; arks
# are written compressed (Kaldi BCM, same as production Kaldi storage).
#
#   usage: [stage=N stop_stage=M] [NUM_UTTS=104000] [ROT_BLOCK=10]
#          [PREFETCH=true] [SEED=777] run_ref_scale.sh [workdir]
set -euo pipefail
cd "$(dirname "$0")/.."

workdir=${1:-/tmp/rsrgan_ref_scale}
num_utts=${NUM_UTTS:-104000}
val_size=${VAL_SIZE:-300}
gan_epochs=${GAN_EPOCHS:-"18 20"}
mse_epochs=${MSE_EPOCHS:-"20 25"}
rot_block=${ROT_BLOCK:-10}
prefetch=${PREFETCH:-true}
seed=${SEED:-777}
stage=${stage:-0}
stop_stage=${stop_stage:-8}
train_dir=$workdir/data/train
sim_dir=$workdir/sim

gan_dir=$workdir/exp/gan_res_lstm_l
mse_dir=$workdir/exp/mse_res_lstm_l
all_systems() {
  echo "gan gan_rnn $gan_dir"
  echo "mse rnn $mse_dir"
}

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ] && [ ! -f $sim_dir/DONE_synth ]; then
  rm -rf "$workdir" && mkdir -p "$train_dir"
  echo "== stage 0: synthesize ~100h phone-content speech + rooms/noises =="
  python - "$workdir" "$num_utts" <<'EOF'
import sys
from rsrgan_jax.sim import make_sim_assets
make_sim_assets(sys.argv[1] + "/sim", num_utts=int(sys.argv[2]),
                min_dur_s=2.0, max_dur_s=5.0,
                num_rooms=8, rirs_per_room=4, seed=41, alignments=True)
EOF
  touch $sim_dir/DONE_synth
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ] && [ ! -f $sim_dir/DONE_rvb ]; then
  echo "== stage 1: corrupt (reverb + noise) =="
  python -m rsrgan_jax.cli.simulate \
    --wav_scp=$sim_dir/clean/wav.scp \
    --rir_list=$sim_dir/rir_list \
    --noise_list=$sim_dir/noise_list \
    --output_dir=$sim_dir/rvb \
    --foreground_snrs=5:20 --background_snrs=5:20 \
    --random_seed=1
  touch $sim_dir/DONE_rvb
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ] && [ ! -f $train_dir/DONE_feats ]; then
  echo "== stage 2: features (LPS inputs, 40-d MFCC targets + noisy-MFCC baseline) =="
  python -m rsrgan_jax.cli.extract \
    --wav_scp=$sim_dir/rvb/wav.scp --feat_type=spectrogram --compress \
    --output_dir=$train_dir --name=inputs --accumulate_cmvn
  python -m rsrgan_jax.cli.extract \
    --wav_scp=$sim_dir/clean/wav.scp --feat_type=mfcc --compress \
    --output_dir=$train_dir --name=labels --accumulate_cmvn
  python -m rsrgan_jax.cli.extract \
    --wav_scp=$sim_dir/rvb/wav.scp --feat_type=mfcc --compress \
    --output_dir=$train_dir --name=noisy_mfcc
  touch $train_dir/DONE_feats
  echo "-- wavs extracted; deleting waveforms (MFCC task: no resynthesis) --"
  rm -rf $sim_dir/clean $sim_dir/rvb $sim_dir/rooms
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ] && [ ! -f $train_dir/DONE_stores ]; then
  echo "== stage 3: cmvn + split + stores =="
  python -m rsrgan_jax.cli.prepare cmvn \
    --inputs=$train_dir/inputs.cmvn --labels=$train_dir/labels.cmvn \
    --save_dir=$train_dir
  python -m rsrgan_jax.cli.prepare split --val_size=$val_size \
    --data_dir=$train_dir --seed=1
  mkdir -p $train_dir/stores
  for sub in tr cv; do
    python -m rsrgan_jax.cli.prepare make-store \
      --inputs=$train_dir/$sub/inputs.scp \
      --labels=$train_dir/$sub/labels.scp \
      --cmvn_dir=$train_dir --output_dir=$train_dir/stores --name=$sub
  done
  echo "$train_dir/stores/tr.rtu" > $train_dir/tr.list
  echo "$train_dir/stores/cv.rtu" > $train_dir/cv.list
  python -m rsrgan_jax.cli.prepare make-store --test \
    --inputs=$train_dir/cv/inputs.scp --cmvn_dir=$train_dir \
    --output_dir=$train_dir/stores --name=test
  echo "$train_dir/stores/test.rtu" > $train_dir/test.list
  touch $train_dir/DONE_stores
  echo "-- stores built; deleting the input ark (stores carry the payload) --"
  rm -f $train_dir/inputs.ark
fi

common_flags="--g_type=res_lstm_l --data_dir=$train_dir
  --tr_list_file=$train_dir/tr.list --cv_list_file=$train_dir/cv.list
  --input_dim=257 --output_dim=40 --left_context=0 --right_context=0
  --batch_size=8 --batch_norm=False --keep_prob=1.0 --l2_scale=0.0
  --end_improve=0.001
  --feed_rotation_block=$rot_block --feed_prefetch=$prefetch"

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ] && [ ! -f $gan_dir/DONE ]; then
  echo "== stage 4: flagship LSGAN at reference scale (warm-up + main) =="
  set -- $gan_epochs; gmin=$1; gmax=$2
  for cfg in "0.001 1 1" "0.0003 $gmin $gmax"; do
    set -- $cfg
    python -m rsrgan_jax.cli.train \
      --trainer=gan_rnn $common_flags \
      --save_dir=$gan_dir --seed=$seed \
      --g_learning_rate=0.00008 --d_learning_rate=$1 \
      --disc_updates=1 --gen_updates=2 \
      --init_mse_weight=10.0 --init_disc_noise_std=0.05 \
      --min_epoches=$2 --max_epoches=$3
  done
  touch $gan_dir/DONE
fi

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ] && [ ! -f $mse_dir/DONE ]; then
  echo "== stage 5: MSE baseline at reference scale =="
  set -- $mse_epochs
  python -m rsrgan_jax.cli.train \
    --trainer=rnn $common_flags \
    --save_dir=$mse_dir --seed=$seed \
    --g_learning_rate=0.0003 \
    --min_epoches=$1 --max_epoches=$2
  touch $mse_dir/DONE
fi

if [ "$stage" -le 6 ] && [ "$stop_stage" -ge 6 ]; then
  echo "== stage 6: decode the held-out set =="
  all_systems | while read -r name trainer dir; do
    [ -f "$dir/test/feats.scp" ] && continue
    python -m rsrgan_jax.cli.train \
      --decode --trainer=$trainer --g_type=res_lstm_l \
      --data_dir=$train_dir --test_list_file=$train_dir/test.list \
      --save_dir=$dir \
      --input_dim=257 --output_dim=40 --batch_size=1 \
      --decode_batch_size=8
  done
fi

if [ "$stage" -le 7 ] && [ "$stop_stage" -ge 7 ]; then
  echo "== stage 7: feature scores + recognition proxy =="
  awk 'NR==FNR {keep[$1]=1; next} ($1 in keep)' \
    $train_dir/cv/inputs.scp $train_dir/noisy_mfcc.scp \
    > $workdir/cv_noisy_mfcc.scp
  python -m rsrgan_jax.cli.score --mode feats \
    --est_scp=$workdir/cv_noisy_mfcc.scp --ref_scp=$train_dir/cv/labels.scp \
    --per_utt=$workdir/feats_noisy.jsonl > /dev/null
  proxy_evals="--eval noisy=$workdir/cv_noisy_mfcc.scp"
  all_systems | while read -r name trainer dir; do
    python -m rsrgan_jax.cli.score --mode feats \
      --est_scp=$dir/test/feats.scp --ref_scp=$train_dir/cv/labels.scp \
      --per_utt=$workdir/feats_$name.jsonl > /dev/null
  done
  while read -r name trainer dir; do
    proxy_evals="$proxy_evals --eval $name=$dir/test/feats.scp"
  done < <(all_systems)
  python tools/proxy_asr.py \
    --train_scp=$train_dir/tr/labels.scp \
    --ali_scp=$sim_dir/ali.scp \
    --holdout_scp=$train_dir/cv/labels.scp \
    $proxy_evals \
    --batch=16384 --out=$workdir/proxy.json
fi

if [ "$stop_stage" -lt 8 ]; then echo "stopped at stop_stage=$stop_stage"; exit 0; fi
echo "== stage 8: table =="
gate_rc=0
ABLATION_MIN_ESTOI_DELTA=-1 ABLATION_MAX_LSD_RATIO=0.9 \
python tools/ablation_table.py "$workdir" \
  --train_dir="$train_dir" --gan_dir="$gan_dir" --mse_dir="$mse_dir" \
  || gate_rc=$?
# rename BEFORE propagating a gate failure, so the artifacts always land
mv $workdir/ablation.md $workdir/ref_scale.md 2>/dev/null || true
mv $workdir/ablation.json $workdir/ref_scale.json 2>/dev/null || true
exit $gate_rc
