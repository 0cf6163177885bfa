#!/bin/bash
# Frame DNN MSE recipe — mirror of /root/reference/run_dnn.sh.
set -euo pipefail
cd "$(dirname "$0")/.."

stage=2
train_dir=data/train/train_100h
test_dir=data/test/test001
save_dir=exp/dnn

if [ $stage -le 2 ]; then
  python -m rsrgan_jax.cli.train \
    --trainer=dnn --g_type=dnn \
    --data_dir=$train_dir \
    --tr_list_file=$train_dir/tr.list \
    --cv_list_file=$train_dir/cv.list \
    --save_dir=$save_dir \
    --batch_size=256 \
    --g_learning_rate=0.001 \
    --input_dim=257 --output_dim=40 \
    --left_context=5 --right_context=5 \
    --min_epoches=10 --max_epoches=30 \
    --keep_lr=3 --decay_factor=0.5 \
    --start_decay_impr=0.003 --end_decay_impr=0.0005 \
    --l2_scale=0.00001
fi

if [ $stage -le 3 ]; then
  python -m rsrgan_jax.cli.train \
    --decode --trainer=dnn --g_type=dnn \
    --data_dir=$train_dir \
    --test_list_file=$test_dir/test.list \
    --save_dir=$save_dir \
    --input_dim=257 --output_dim=40 \
    --left_context=5 --right_context=5 \
    --batch_size=1
fi
