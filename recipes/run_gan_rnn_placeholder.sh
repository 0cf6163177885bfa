#!/bin/bash
# Flagship GAN-RNN recipe — mirror of /root/reference/run_gan_rnn_placeholder.sh.
# Stages: 0 data prep, 1 test prep, 2 train (warm-up + main), 3 decode.
set -euo pipefail
cd "$(dirname "$0")/.."

stage=2
nj=8
val_size=3000
train_dir=data/train/train_100h
test_dir=data/test/test001
tr_list=$train_dir/tr.list
cv_list=$train_dir/cv.list
test_list=$test_dir/test.list
save_dir=exp/gan_res_lstm_l

if [ $stage -le 0 ]; then
  echo "Prepare tr and cv data"
  python -m rsrgan_jax.cli.prepare cmvn \
    --inputs=$train_dir/inputs.cmvn --labels=$train_dir/labels.cmvn \
    --save_dir=$train_dir
  python -m rsrgan_jax.cli.prepare split --val_size=$val_size \
    --data_dir=$train_dir
  mkdir -p $train_dir/stores
  python -m rsrgan_jax.cli.prepare make-store \
    --inputs=$train_dir/cv/inputs.scp --labels=$train_dir/cv/labels.scp \
    --cmvn_dir=$train_dir --output_dir=$train_dir/stores --name=cv
  echo "$train_dir/stores/cv.rtu" > $cv_list
  python -m rsrgan_jax.cli.prepare split-scp --nj $nj --data_dir=$train_dir/tr
  : > $tr_list
  for i in $(seq $nj); do
    python -m rsrgan_jax.cli.prepare make-store \
      --inputs=$train_dir/tr/split${nj}/inputs${i}.scp \
      --labels=$train_dir/tr/split${nj}/labels${i}.scp \
      --cmvn_dir=$train_dir --output_dir=$train_dir/stores --name=tr${i}
    echo "$train_dir/stores/tr${i}.rtu" >> $tr_list
  done
  python -m rsrgan_jax.cli.prepare verify-store $train_dir/stores/*.rtu
fi

if [ $stage -le 1 ]; then
  echo "Prepare test data"
  mkdir -p $test_dir/stores
  python -m rsrgan_jax.cli.prepare make-store --test \
    --inputs=$test_dir/test.scp --cmvn_dir=$train_dir \
    --output_dir=$test_dir/stores --name=test
  echo "$test_dir/stores/test.rtu" > $test_list
fi

if [ $stage -le 2 ]; then
  # Warm-up run: higher D LR for 1 epoch, then the main run
  # (run_gan_rnn_placeholder.sh:117-168).
  for cfg in "0.001 1 1" "0.0003 18 20"; do
    set -- $cfg
    python -m rsrgan_jax.cli.train \
      --trainer=gan_rnn \
      --data_dir=$train_dir \
      --tr_list_file=$tr_list \
      --cv_list_file=$cv_list \
      --g_type="res_lstm_l" \
      --save_dir=$save_dir \
      --batch_size=8 \
      --g_learning_rate=0.00008 \
      --d_learning_rate=$1 \
      --disc_updates=1 --gen_updates=2 \
      --batch_norm=False --l2_scale=0.0 \
      --init_mse_weight=10.0 \
      --input_dim=257 --output_dim=40 \
      --left_context=0 --right_context=0 \
      --min_epoches=$2 --max_epoches=$3 \
      --end_improve=0.001 \
      --init_disc_noise_std=0.05 \
      --num_gpu=1
  done
fi

if [ $stage -le 3 ]; then
  python -m rsrgan_jax.cli.train \
    --decode --trainer=gan_rnn \
    --data_dir=$train_dir \
    --test_list_file=$test_list \
    --g_type="res_lstm_l" \
    --save_dir=$save_dir \
    --batch_norm=False \
    --input_dim=257 --output_dim=40 \
    --left_context=0 --right_context=0 \
    --batch_size=1 --keep_prob=1.0 --l2_scale=0.0
fi
