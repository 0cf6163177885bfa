#!/bin/bash
# Quality validation on synthetic data: train the flagship GAN, decode the
# held-out set, and check that enhanced features beat the predict-the-mean
# baseline on MSE vs the clean targets. One GPU, ~20-40 min cold
# (seconds per iteration once compiled).
set -euo pipefail
cd "$(dirname "$0")/.."

workdir=${1:-/tmp/rsrgan_quality}
iters=${2:-24}
rm -rf "$workdir" && mkdir -p "$workdir"
train_dir=$workdir/data/train
save_dir=$workdir/exp/gan_res_lstm_l

python - "$train_dir" <<'EOF'
import sys
from rsrgan_jax.data.synthetic import make_synthetic_corpus
make_synthetic_corpus(sys.argv[1], num_utts=64, input_dim=257,
                      output_dim=40, min_len=150, max_len=350, seed=11)
EOF

python -m rsrgan_jax.cli.prepare cmvn \
  --inputs=$train_dir/inputs.cmvn --labels=$train_dir/labels.cmvn \
  --save_dir=$train_dir
python -m rsrgan_jax.cli.prepare split --val_size=8 --data_dir=$train_dir
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

python -m rsrgan_jax.cli.train \
  --decode --trainer=gan_rnn --g_type=res_lstm_l \
  --data_dir=$train_dir --test_list_file=$train_dir/test.list \
  --save_dir=$save_dir \
  --input_dim=257 --output_dim=40 --batch_size=1 \
  --decode_batch_size=4

python - "$train_dir" "$save_dir" <<'EOF'
import sys
import numpy as np
from rsrgan_jax.data import ScpReader
train_dir, save_dir = sys.argv[1], sys.argv[2]
clean = {u: m for u, m in ScpReader(f"{train_dir}/cv/labels.scp")}
enhanced = {u: m for u, m in ScpReader(f"{save_dir}/test/feats.scp")}
assert clean.keys() == enhanced.keys()
mse_model, mse_mean = [], []
for u in clean:
    y, g = np.asarray(clean[u]), np.asarray(enhanced[u])
    assert y.shape == g.shape, (u, y.shape, g.shape)
    mse_model.append(np.mean((g - y) ** 2))
    mse_mean.append(np.mean((y.mean(axis=0) - y) ** 2))
mse_model, mse_mean = np.mean(mse_model), np.mean(mse_mean)
print(f"enhanced-vs-clean MSE: {mse_model:.5f}   "
      f"predict-mean baseline: {mse_mean:.5f}   "
      f"ratio: {mse_model / mse_mean:.3f}")
assert mse_model < 0.5 * mse_mean, "enhancement did not beat the baseline"
print("QUALITY CHECK PASSED")
EOF
