#!/bin/bash
# Multi-host data-parallel training demo: two local processes connected
# via jax.distributed (CPU backend, 2 forced devices each = one 4-device
# global mesh), training the frame DNN on a synthetic corpus. On real GPU
# hosts, run the same command once per host with the first host's
# coordinator address and JAX's default (GPU) backend.
#
# The shared-global-plan batching makes the N-process run mathematically
# identical to a single-process run over the same global devices
# (tests/test_multihost.py asserts equality to 1e-4).

set -euo pipefail
cd "$(dirname "$0")/.."

workdir=${1:-/tmp/rsrgan_multihost}
rm -rf "$workdir" && mkdir -p "$workdir"
data_dir=$workdir/data
save_dir=$workdir/exp

python - "$data_dir" <<'EOF'
import sys
from rsrgan_jax.data.synthetic import make_synthetic_corpus
make_synthetic_corpus(sys.argv[1], num_utts=12, input_dim=16, output_dim=6,
                      min_len=30, max_len=60)
EOF
python -m rsrgan_jax.cli.prepare cmvn --inputs=$data_dir/inputs.cmvn \
  --labels=$data_dir/labels.cmvn --save_dir=$data_dir
python -m rsrgan_jax.cli.prepare split --val_size=4 --data_dir=$data_dir \
  --seed=1
for sub in tr cv; do
  python -m rsrgan_jax.cli.prepare make-store \
    --inputs=$data_dir/$sub/inputs.scp --labels=$data_dir/$sub/labels.scp \
    --cmvn_dir=$data_dir --output_dir=$data_dir/stores --name=$sub
  echo "$data_dir/stores/$sub.rtu" > $data_dir/$sub.list
done

port=$(( (RANDOM % 10000) + 20000 ))
common="--trainer=dnn --g_type=dnn
  --tr_list_file=$data_dir/tr.list --cv_list_file=$data_dir/cv.list
  --save_dir=$save_dir --input_dim=16 --output_dim=6 --batch_size=8
  --g_learning_rate=0.001 --keep_lr=1 --bf16=false --l2_scale=0.0
  --min_epoches=1 --max_epoches=2 --seed=7
  --coordinator_address=localhost:$port --num_processes=2"

export JAX_PLATFORM_NAME=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=2"
python -m rsrgan_jax.cli.train $common --process_id=0 &
p0=$!
python -m rsrgan_jax.cli.train $common --process_id=1 &
p1=$!
wait $p0 $p1

test -f $save_dir/checkpoint || { echo "FAIL: no checkpoint"; exit 1; }
echo "MULTIHOST RUN PASSED ($(grep -c . $save_dir/metrics_eval.jsonl) eval records)"
