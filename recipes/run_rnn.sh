#!/bin/bash
# Sequence MSE recipe (lstm / bnlstm / res_lstm_*) — mirror of run_rnn.sh.
set -euo pipefail
cd "$(dirname "$0")/.."

g_type=${1:-res_lstm_l}
train_dir=data/train/train_100h
save_dir=exp/rnn_$g_type

python -m rsrgan_jax.cli.train \
  --trainer=rnn --g_type=$g_type \
  --data_dir=$train_dir \
  --tr_list_file=$train_dir/tr.list \
  --cv_list_file=$train_dir/cv.list \
  --save_dir=$save_dir \
  --batch_size=16 \
  --g_learning_rate=0.0005 \
  --input_dim=257 --output_dim=40 \
  --left_context=0 --right_context=0 \
  --min_epoches=15 --max_epoches=25 \
  --end_improve=0.001 \
  --l2_scale=0.00001
