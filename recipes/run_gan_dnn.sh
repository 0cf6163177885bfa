#!/bin/bash
# Frame GAN recipe (DNN G + input-conditioned DNN D) — mirror of run_gan_dnn.sh.
set -euo pipefail
cd "$(dirname "$0")/.."

train_dir=data/train/train_100h
save_dir=exp/gan_dnn

python -m rsrgan_jax.cli.train \
  --trainer=gan_dnn --g_type=dnn \
  --data_dir=$train_dir \
  --tr_list_file=$train_dir/tr.list \
  --cv_list_file=$train_dir/cv.list \
  --save_dir=$save_dir \
  --batch_size=256 \
  --g_learning_rate=0.0001 \
  --d_learning_rate=0.0001 \
  --disc_updates=1 --gen_updates=2 \
  --init_mse_weight=10.0 \
  --input_dim=257 --output_dim=40 \
  --left_context=5 --right_context=5 \
  --min_epoches=10 --max_epoches=25 \
  --l2_scale=0.00001
