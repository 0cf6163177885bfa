#!/bin/bash
# SEGAN recipe (conv AE G + conv D with VBN, L1 + LSGAN, RMSProp) — mirror
# of /root/reference/run_segan.sh:92-119. Note the upstream driver was
# broken (imported a nonexistent module); this one runs.
set -euo pipefail
cd "$(dirname "$0")/.."

train_dir=data/train/train_100h
save_dir=exp/segan

python -m rsrgan_jax.cli.train \
  --trainer=segan --g_type=ae \
  --data_dir=$train_dir \
  --tr_list_file=$train_dir/tr.list \
  --cv_list_file=$train_dir/cv.list \
  --save_dir=$save_dir \
  --batch_size=256 \
  --g_learning_rate=0.001 \
  --d_learning_rate=0.001 \
  --disc_updates=1 --gen_updates=1 \
  --bias_deconv=True \
  --init_l1_weight=100.0 \
  --deconv_type="deconv" \
  --input_dim=257 --output_dim=40 \
  --left_context=3 --right_context=3 \
  --min_epoches=10 --max_epoches=25
