"""Multi-host (multi-process) data parallelism e2e.

Launches the train CLI in TWO real processes connected via
jax.distributed (CPU backend, 2 forced host devices each = 4 global
devices) and checks the run against a single-process run over the same 4
devices with the same seed: the shared-global-plan batching makes the two
configurations mathematically identical, so losses must match.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(num_local_devices: int):
    env = dict(os.environ)
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{num_local_devices}")
    env["PYTHONPATH"] = REPO
    # isolate from pytest's jax configuration
    env.pop("JAX_PLATFORMS", None)
    return env


def _train_args(data_dir, save_dir, extra):
    return [sys.executable, "-m", "rsrgan_jax.cli.train",
            "--trainer=dnn", "--g_type=dnn",
            f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
            f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
            f"--save_dir={save_dir}",
            "--input_dim=16", "--output_dim=6", "--batch_size=8",
            "--g_learning_rate=0.001", "--keep_lr=1", "--bf16=false",
            "--l2_scale=0.0", "--min_epoches=1", "--max_epoches=1",
            "--seed=7"] + extra


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from rsrgan_jax.cli import prepare as prepare_cli
    from rsrgan_jax.data.synthetic import make_synthetic_corpus
    data_dir = str(tmp_path_factory.mktemp("mh_corpus"))
    make_synthetic_corpus(data_dir, num_utts=12, input_dim=16, output_dim=6,
                          min_len=30, max_len=60)
    assert prepare_cli.main(["cmvn", f"--inputs={data_dir}/inputs.cmvn",
                             f"--labels={data_dir}/labels.cmvn",
                             f"--save_dir={data_dir}"]) == 0
    assert prepare_cli.main(["split", "--val_size=4",
                             f"--data_dir={data_dir}", "--seed=1"]) == 0
    stores = os.path.join(data_dir, "stores")
    for sub in ("tr", "cv"):
        assert prepare_cli.main([
            "make-store", f"--inputs={data_dir}/{sub}/inputs.scp",
            f"--labels={data_dir}/{sub}/labels.scp",
            f"--cmvn_dir={data_dir}", f"--output_dir={stores}",
            f"--name={sub}"]) == 0
        with open(os.path.join(data_dir, f"{sub}.list"), "w") as f:
            f.write(os.path.join(stores, f"{sub}.rtu") + "\n")
    return data_dir


def _last_eval_loss(save_dir: str) -> float:
    with open(os.path.join(save_dir, "metrics_eval.jsonl")) as f:
        return json.loads(f.readlines()[-1])["g_loss"]


def test_two_process_training_matches_single_process(corpus, tmp_path):
    # reference: ONE process, 4 forced devices, data-parallel over all 4
    ref_dir = str(tmp_path / "single")
    r = subprocess.run(
        _train_args(corpus, ref_dir, ["--num_gpu=4"]),
        env=_env(4), capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]

    # same run split over 2 processes x 2 devices
    mh_dir = str(tmp_path / "multi")
    port = _free_port()
    procs = [subprocess.Popen(
        _train_args(corpus, mh_dir, [
            f"--coordinator_address=localhost:{port}",
            "--num_processes=2", f"--process_id={pid}"]),
        env=_env(2), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-3000:] + err[-2000:]

    # only the coordinator writes metrics/checkpoints
    assert os.path.isfile(os.path.join(mh_dir, "checkpoint"))
    ref_loss = _last_eval_loss(ref_dir)
    mh_loss = _last_eval_loss(mh_dir)
    np.testing.assert_allclose(mh_loss, ref_loss, rtol=1e-4)
