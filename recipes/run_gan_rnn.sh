#!/bin/bash
# GAN-RNN, graph-fed variant — mirror of /root/reference/run_gan_rnn.sh.
# Unlike the placeholder flagship, D and G train on DIFFERENT minibatches
# (--same_batch=false → GanTrainer.d_step/g_step pull fresh batches, as
# models/gan_rnn.py does with its tf.data-fed tensors). Stages: 0 data
# prep, 1 test prep, 2 train, 3 decode.
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
save_dir=exp/gan_rnn_res_lstm_l

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
  # run_gan_rnn.sh:119-144: d_lr 8e-4, l2 1e-7, 25-30 epochs, 4 replicas.
  python -m rsrgan_jax.cli.train \
    --trainer=gan_rnn --same_batch=false \
    --data_dir=$train_dir \
    --tr_list_file=$tr_list \
    --cv_list_file=$cv_list \
    --g_type="res_lstm_l" \
    --save_dir=$save_dir \
    --batch_size=8 \
    --g_learning_rate=0.00008 \
    --d_learning_rate=0.0008 \
    --disc_updates=1 --gen_updates=2 \
    --batch_norm=False --l2_scale=1e-7 \
    --init_mse_weight=10.0 \
    --input_dim=257 --output_dim=40 \
    --left_context=0 --right_context=0 \
    --min_epoches=25 --max_epoches=30 \
    --end_improve=0.001 \
    --init_disc_noise_std=0.05 \
    --num_gpu=4
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
