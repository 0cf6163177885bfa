#!/bin/bash
# EMA-decode validation at reference step counts (round-3 VERDICT weak #6 /
# next-round #7): the 0.9999-decay EMA shadow
# (models/gan_rnn_placeholder.py:70,148-150; decode via
# scripts/train_gan_dnn.py:253 load(..., moving_average=True)) needs
# ~10^4+ optimizer steps before the shadow forgets initialization
# (0.9999^10000 = 0.37 of init still present). Every earlier run had
# 2-15k steps, where EMA decode is actively harmful. This recipe trains
# the flagship GAN long enough (default 50 iterations on the 4000-utt
# corpus ~= 47k G-step EMA updates) and decodes the SAME checkpoint with
# raw and EMA ("--moving_average") parameters, scoring both against the
# clean held-out features.
#
# Requires a completed run_ablation.sh workdir (stages 0-3: corpus +
# stores). usage: [iters=50] run_ema_check.sh [lps_workdir] [workdir]
set -euo pipefail
cd "$(dirname "$0")/.."

lps_workdir=${1:-/tmp/rsrgan_ablation}
workdir=${2:-/tmp/rsrgan_ema_check}
iters=${iters:-50}
stage=${stage:-0}
stop_stage=${stop_stage:-3}
train_dir=$lps_workdir/data/train
exp_dir=$workdir/exp/gan_ema

if [ "$stage" -le 0 ] && [ "$stop_stage" -ge 0 ]; then
  rm -rf "$workdir" && mkdir -p "$workdir"
  echo "== stage 0: train flagship LSGAN for $iters iterations =="
  python -m rsrgan_jax.cli.train \
    --trainer=gan_rnn --g_type=res_lstm_l --data_dir=$train_dir \
    --tr_list_file=$train_dir/tr.list --cv_list_file=$train_dir/cv.list \
    --input_dim=257 --output_dim=257 --batch_size=8 \
    --batch_norm=False --keep_prob=1.0 --l2_scale=0.0 \
    --save_dir=$exp_dir \
    --g_learning_rate=0.00008 --d_learning_rate=0.0003 \
    --disc_updates=1 --gen_updates=2 \
    --init_mse_weight=10.0 --init_disc_noise_std=0.05 \
    --min_epoches=$iters --max_epoches=$iters --end_improve=-1 \
   
fi

if [ "$stage" -le 1 ] && [ "$stop_stage" -ge 1 ]; then
  echo "== stage 1: decode held-out set with raw and EMA params =="
  for cfg in "raw false" "ema true"; do
    set -- $cfg
    python -m rsrgan_jax.cli.train \
      --decode --trainer=gan_rnn --g_type=res_lstm_l \
      --data_dir=$train_dir --test_list_file=$train_dir/test.list \
      --save_dir=$exp_dir --moving_average=$2 \
      --input_dim=257 --output_dim=257 --batch_size=1 \
      --decode_batch_size=8
    mv $exp_dir/test $exp_dir/test_$1
    # feats.scp carries absolute ark offsets into the pre-rename dir
    sed -i "s|$exp_dir/test/|$exp_dir/test_$1/|" $exp_dir/test_$1/feats.scp
  done
fi

if [ "$stage" -le 2 ] && [ "$stop_stage" -ge 2 ]; then
  echo "== stage 2: score both decodes =="
  for v in raw ema; do
    python -m rsrgan_jax.cli.score --mode feats \
      --est_scp=$exp_dir/test_$v/feats.scp \
      --ref_scp=$train_dir/cv/labels.scp \
      --per_utt=$workdir/feats_$v.jsonl > $workdir/score_$v.json
  done
fi

echo "== stage 3: EMA-vs-raw verdict =="
python - "$workdir" "$exp_dir" "$iters" <<'EOF'
import json, sys
import numpy as np

workdir, exp_dir, iters = sys.argv[1], sys.argv[2], int(sys.argv[3])
def mean_of(path, key):
    rows = [json.loads(l) for l in open(path)]
    return float(np.mean([r[key] for r in rows if r.get(key) is not None]))

out = {"iterations": iters}
for v in ("raw", "ema"):
    out[v] = {"feature_mse": mean_of(f"{workdir}/feats_{v}.jsonl", "mse"),
              "lsd_db": mean_of(f"{workdir}/feats_{v}.jsonl", "lsd_db")}
# G optimizer steps ~= 2 * batches/iter * iters (2 G updates per batch)
metrics = [json.loads(l) for l in open(f"{exp_dir}/metrics_train.jsonl")]
out["train_iterations_run"] = len(metrics)
out["delta_mse_ema_minus_raw"] = round(
    out["ema"]["feature_mse"] - out["raw"]["feature_mse"], 5)
out["verdict"] = ("EMA_OK" if out["ema"]["feature_mse"]
                  <= out["raw"]["feature_mse"] * 1.02 else "EMA_WORSE")
print(json.dumps(out, indent=1))
with open(f"{workdir}/ema_check.json", "w") as f:
    json.dump(out, f, indent=1)
EOF