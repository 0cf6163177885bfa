#!/bin/bash
# Reference-native configuration ablation: 257-d LPS -> 40-d MFCC
# (/root/reference/README.md:33-35 — the paper's actual task), scored by
# feature-domain metrics + the recognition proxy (tools/proxy_asr.py).
# MFCC is not invertible to a waveform, so there are no STOI/ESTOI
# columns here; the waveform-domain evidence lives in run_ablation.sh's
# LPS->LPS configuration.
#
# Reuses the corpus (wavs + corrupted-LPS inputs) of a prior
# run_ablation.sh workdir — run that first (at least through stage 3).
#
#   usage: [stage=N stop_stage=M] run_ablation_mfcc.sh \
#            [lps_workdir] [workdir] [val_size] ["gmin gmax"] ["mmin mmax"]
set -euo pipefail
cd "$(dirname "$0")/.."

lps_workdir=${1:-/tmp/rsrgan_ablation}
workdir=${2:-/tmp/rsrgan_ablation_mfcc}
val_size=${3:-200}
gan_epochs=${4:-"18 20"}
mse_epochs=${5:-"20 25"}
stage=${stage:-0}
stop_stage=${stop_stage:-6}
seeds=${SEEDS:-777}
first_seed=$(set -- $seeds; echo "$1")
train_dir=$workdir/data/train

gan_sys() { if [ "$1" = "$first_seed" ]; then echo gan; else echo "gan_s$1"; fi; }
mse_sys() { if [ "$1" = "$first_seed" ]; then echo mse; else echo "mse_s$1"; fi; }
sys_dir() { echo "$workdir/exp/$1_res_lstm_l"; }
gan_dir=$(sys_dir gan)
mse_dir=$(sys_dir mse)
all_systems() {  # "name trainer dir" lines
  for s in $seeds; do echo "$(gan_sys $s) gan_rnn $(sys_dir $(gan_sys $s))"; done
  for s in $seeds; do echo "$(mse_sys $s) rnn $(sys_dir $(mse_sys $s))"; done
}
sim_dir=$lps_workdir/sim
lps_train=$lps_workdir/data/train

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  rm -rf "$workdir" && mkdir -p "$train_dir"
  echo "== stage 0: 40-d hires MFCC targets (clean) + noisy-MFCC baseline =="
  # inputs = the SAME corrupted-LPS features as the LPS run (scp points at
  # the existing arks; no re-extraction)
  cp $lps_train/inputs.scp $lps_train/inputs.cmvn $train_dir/
  python -m rsrgan_jax.cli.extract \
    --wav_scp=$sim_dir/clean/wav.scp --feat_type=mfcc \
    --output_dir=$train_dir --name=labels --accumulate_cmvn
  python -m rsrgan_jax.cli.extract \
    --wav_scp=$sim_dir/rvb/wav.scp --feat_type=mfcc \
    --output_dir=$train_dir --name=noisy_mfcc
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  echo "== stage 1: cmvn + split + stores (LPS inputs, MFCC labels) =="
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
fi

common_flags="--g_type=res_lstm_l --data_dir=$train_dir
  --tr_list_file=$train_dir/tr.list --cv_list_file=$train_dir/cv.list
  --input_dim=257 --output_dim=40 --left_context=0 --right_context=0
  --batch_size=8 --batch_norm=False --keep_prob=1.0 --l2_scale=0.0
  --end_improve=0.001"

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  echo "== stage 2: train flagship LSGAN (LPS->MFCC) per seed =="
  set -- $gan_epochs; gmin=$1; gmax=$2
  for s in $seeds; do
    dir=$(sys_dir $(gan_sys $s))
    [ -f "$dir/DONE" ] && { echo "-- GAN system $(gan_sys $s) already done --"; continue; }
    echo "-- GAN system $(gan_sys $s) (seed=$s) --"
    for cfg in "0.001 1 1" "0.0003 $gmin $gmax"; do
      set -- $cfg
      python -m rsrgan_jax.cli.train \
        --trainer=gan_rnn $common_flags \
        --save_dir=$dir --seed=$s \
        --g_learning_rate=0.00008 --d_learning_rate=$1 \
        --disc_updates=1 --gen_updates=2 \
        --init_mse_weight=10.0 --init_disc_noise_std=0.05 \
        --min_epoches=$2 --max_epoches=$3
    done
    touch "$dir/DONE"
  done
fi

if [ "$stage" -le 3 ] && [ "$stop_stage" -ge 3 ]; then
  echo "== stage 3: train MSE baseline (LPS->MFCC) per seed =="
  set -- $mse_epochs; mmin=$1; mmax=$2
  for s in $seeds; do
    dir=$(sys_dir $(mse_sys $s))
    [ -f "$dir/DONE" ] && { echo "-- MSE system $(mse_sys $s) already done --"; continue; }
    echo "-- MSE system $(mse_sys $s) (seed=$s) --"
    python -m rsrgan_jax.cli.train \
      --trainer=rnn $common_flags \
      --save_dir=$dir --seed=$s \
      --g_learning_rate=0.0003 \
      --min_epoches=$mmin --max_epoches=$mmax
    touch "$dir/DONE"
  done
fi

if [ "$stage" -le 4 ] && [ "$stop_stage" -ge 4 ]; then
  echo "== stage 4: decode the held-out set with every system =="
  all_systems | while read -r name trainer dir; do
    python -m rsrgan_jax.cli.train \
      --decode --trainer=$trainer --g_type=res_lstm_l \
      --data_dir=$train_dir --test_list_file=$train_dir/test.list \
      --save_dir=$dir \
      --input_dim=257 --output_dim=40 --batch_size=1 \
      --decode_batch_size=8
  done
fi

if [ "$stage" -le 5 ] && [ "$stop_stage" -ge 5 ]; then
  echo "== stage 5: feature scores + recognition proxy (MFCC domain) =="
  # noisy baseline = MFCC of the corrupted audio, cv subset
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

if [ "$stop_stage" -lt 6 ]; then echo "stopped at stop_stage=$stop_stage"; exit 0; fi
echo "== stage 6: table (feature-domain + proxy; no wav metrics) =="
# the ESTOI gate cannot apply (MFCC is not resynthesizable); judge on the
# feature-domain LSD ratio only
extra_args=()
for s in $seeds; do
  [ "$(gan_sys $s)" = "gan" ] || extra_args+=("--extra=$(gan_sys $s):LSGAN(seed=$s)")
  [ "$(mse_sys $s)" = "mse" ] || extra_args+=("--extra=$(mse_sys $s):MSE(seed=$s)")
done
nseeds=$(set -- $seeds; echo $#)
if [ "$nseeds" -gt 1 ]; then
  gan_members=$(for s in $seeds; do gan_sys $s; done | paste -sd, -)
  mse_members=$(for s in $seeds; do mse_sys $s; done | paste -sd, -)
  extra_args+=("--aggregate=LSGAN mean±spread ($nseeds seeds):$gan_members")
  extra_args+=("--aggregate=MSE mean±spread ($nseeds seeds):$mse_members")
fi
ABLATION_MIN_ESTOI_DELTA=${ABLATION_MIN_ESTOI_DELTA:--1} \
ABLATION_MAX_LSD_RATIO=${ABLATION_MAX_LSD_RATIO:-0.9} \
python tools/ablation_table.py "$workdir" \
  --train_dir="$train_dir" --gan_dir="$gan_dir" --mse_dir="$mse_dir" \
  ${extra_args[@]+"${extra_args[@]}"}
mv $workdir/ablation.md $workdir/ablation_mfcc.md 2>/dev/null || true
mv $workdir/ablation.json $workdir/ablation_mfcc.json 2>/dev/null || true