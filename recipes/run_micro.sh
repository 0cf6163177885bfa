#!/bin/bash
# Micro end-to-end run of the flagship GAN-RNN pipeline on synthetic data.
# Mirrors run_gan_rnn_placeholder.sh stages 0-3 at toy scale; finishes in a
# few minutes on one GPU. Used for verification, not benchmarking.

set -euo pipefail
cd "$(dirname "$0")/.."

workdir=${1:-/tmp/rsrgan_micro}
rm -rf "$workdir" && mkdir -p "$workdir"
train_dir=$workdir/data/train
test_dir=$workdir/data/test
save_dir=$workdir/exp/gan_res_lstm_l

echo "=== stage -1: synthesize corpus (stand-in for Kaldi reverb+feats) ==="
python - "$train_dir" <<'EOF'
import sys
from rsrgan_jax.data.synthetic import make_synthetic_corpus
make_synthetic_corpus(sys.argv[1], num_utts=24, input_dim=257, output_dim=40,
                      min_len=120, max_len=260, seed=7)
EOF

echo "=== stage 0: cmvn + split + train/cv stores ==="
python -m rsrgan_jax.cli.prepare cmvn \
  --inputs=$train_dir/inputs.cmvn --labels=$train_dir/labels.cmvn \
  --save_dir=$train_dir
python -m rsrgan_jax.cli.prepare split --val_size=6 --data_dir=$train_dir
mkdir -p $train_dir/stores
for sub in tr cv; do
  python -m rsrgan_jax.cli.prepare make-store \
    --inputs=$train_dir/$sub/inputs.scp --labels=$train_dir/$sub/labels.scp \
    --cmvn_dir=$train_dir --output_dir=$train_dir/stores --name=$sub
done
echo "$train_dir/stores/tr.rtu" > $train_dir/tr.list
echo "$train_dir/stores/cv.rtu" > $train_dir/cv.list

echo "=== stage 1: test store ==="
mkdir -p $test_dir
python -m rsrgan_jax.cli.prepare make-store \
  --inputs=$train_dir/cv/inputs.scp --cmvn_dir=$train_dir \
  --output_dir=$test_dir --name=test --test
echo "$test_dir/test.rtu" > $test_dir/test.list

echo "=== stage 2: train flagship (res_lstm_l G + LSTM D, 2 iterations) ==="
python -m rsrgan_jax.cli.train \
  --trainer=gan_rnn \
  --data_dir=$train_dir \
  --tr_list_file=$train_dir/tr.list \
  --cv_list_file=$train_dir/cv.list \
  --g_type="res_lstm_l" \
  --save_dir=$save_dir \
  --batch_size=2 \
  --g_learning_rate=0.00008 \
  --d_learning_rate=0.001 \
  --disc_updates=1 --gen_updates=2 \
  --batch_norm=False --l2_scale=0.0 \
  --init_mse_weight=10.0 \
  --input_dim=257 --output_dim=40 \
  --left_context=0 --right_context=0 \
  --min_epoches=1 --max_epoches=2 \
  --end_improve=0.001 \
  --init_disc_noise_std=0.05 \
  --num_gpu=1

echo "=== stage 3: decode (enhancement to Kaldi ark) ==="
python -m rsrgan_jax.cli.train \
  --decode --trainer=gan_rnn \
  --data_dir=$train_dir \
  --test_list_file=$test_dir/test.list \
  --g_type="res_lstm_l" \
  --save_dir=$save_dir \
  --batch_norm=False \
  --input_dim=257 --output_dim=40 \
  --left_context=0 --right_context=0 \
  --batch_size=1 --keep_prob=1.0 --l2_scale=0.0

echo "=== verify decode output ==="
python - "$save_dir" <<'EOF'
import sys
from rsrgan_jax.data import ScpReader
import numpy as np
r = ScpReader(sys.argv[1] + "/test/feats.scp")
assert len(r) == 6, len(r)
for utt, mat in r:
    assert mat.shape[1] == 40 and np.isfinite(mat).all()
print(f"OK: {len(r)} enhanced utterances, 40-dim, finite.")
EOF
echo "MICRO RUN PASSED"
