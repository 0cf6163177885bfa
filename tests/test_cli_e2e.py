"""End-to-end CLI test: prepare -> train (dnn) -> decode -> verify arks.

Exercises the full reference workflow (run_dnn.sh stages 0-3) on a tiny
synthetic corpus with the frame DNN trainer (small enough for the CPU test
environment). The flagship gan_rnn path is covered at API level in
test_training.py and on the GPU by chip_smoke.py.
"""

import os

import numpy as np
import pytest

from rsrgan_jax.cli import prepare as prepare_cli
from rsrgan_jax.cli import train as train_cli
from rsrgan_jax.data import ScpReader, load_cmvn_npz
from rsrgan_jax.data.synthetic import make_synthetic_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Synthetic corpus with stage-0/1 prep already done (cmvn npz, tr/cv
    stores + list files, inputs-only test store)."""
    data_dir = str(tmp_path_factory.mktemp("corpus"))
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
    assert prepare_cli.main([
        "make-store", f"--inputs={data_dir}/cv/inputs.scp",
        f"--cmvn_dir={data_dir}", f"--output_dir={stores}",
        "--name=test", "--test"]) == 0
    with open(os.path.join(data_dir, "test.list"), "w") as f:
        f.write(os.path.join(stores, "test.rtu") + "\n")
    return data_dir


def test_full_pipeline(corpus, tmp_path):
    data_dir = corpus
    # stage 0: cmvn + split + stores
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
    tr_list = os.path.join(data_dir, "tr.list")
    cv_list = os.path.join(data_dir, "cv.list")
    with open(tr_list, "w") as f:
        f.write(os.path.join(stores, "tr.rtu") + "\n")
    with open(cv_list, "w") as f:
        f.write(os.path.join(stores, "cv.rtu") + "\n")
    # stage 1: test store (inputs only)
    assert prepare_cli.main([
        "make-store", f"--inputs={data_dir}/cv/inputs.scp",
        f"--cmvn_dir={data_dir}", f"--output_dir={stores}",
        "--name=test", "--test"]) == 0
    test_list = os.path.join(data_dir, "test.list")
    with open(test_list, "w") as f:
        f.write(os.path.join(stores, "test.rtu") + "\n")

    # stage 2: train frame DNN for 2 epochs (tiny dims via input flags)
    save_dir = str(tmp_path / "exp")
    rc = train_cli.main([
        "--trainer=dnn", "--g_type=dnn",
        f"--data_dir={data_dir}", f"--tr_list_file={tr_list}",
        f"--cv_list_file={cv_list}", f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--left_context=2",
        "--right_context=2", "--batch_size=64",
        "--g_learning_rate=0.001", "--min_epoches=1", "--max_epoches=2",
        "--keep_lr=1", "--bf16=false", "--l2_scale=0.0"])
    assert rc == 0
    assert os.path.isfile(os.path.join(save_dir, "checkpoint"))
    assert os.path.isfile(os.path.join(save_dir, "metrics_train.jsonl"))

    # stage 3: decode
    rc = train_cli.main([
        "--decode", "--trainer=dnn", "--g_type=dnn",
        f"--data_dir={data_dir}", f"--test_list_file={test_list}",
        f"--save_dir={save_dir}", "--input_dim=16", "--output_dim=6",
        "--left_context=2", "--right_context=2", "--batch_size=1",
        "--bf16=false"])
    assert rc == 0
    feats_scp = os.path.join(save_dir, "test", "feats.scp")
    assert os.path.isfile(feats_scp)
    reader = ScpReader(feats_scp)
    assert len(reader) == 4  # cv utts reused as test set
    # enhanced features are denormalized: roughly label scale, not z-scores
    _, labels_cmvn = load_cmvn_npz(os.path.join(data_dir, "train_cmvn.npz"))
    for utt, mat in zip(reader.utt_ids, (m for _, m in reader)):
        assert mat.shape[1] == 6
        assert np.isfinite(mat).all()

    # decode again with --compress: BCM arks, near-identical contents
    save_dir_c = str(tmp_path / "exp_c")
    import shutil
    shutil.copytree(save_dir, save_dir_c,
                    ignore=shutil.ignore_patterns("test"))
    rc = train_cli.main([
        "--decode", "--trainer=dnn", "--g_type=dnn", "--compress",
        f"--data_dir={data_dir}", f"--test_list_file={test_list}",
        f"--save_dir={save_dir_c}", "--input_dim=16", "--output_dim=6",
        "--left_context=2", "--right_context=2", "--batch_size=1",
        "--bf16=false"])
    assert rc == 0
    c_reader = ScpReader(os.path.join(save_dir_c, "test", "feats.scp"))
    with open(os.path.join(save_dir_c, "test", "feats.ark"), "rb") as f:
        f.seek(c_reader.entries[0][2])
        assert f.read(5) == b"\0BCM "
    for (u1, m1), (u2, m2) in zip(reader, c_reader):
        assert u1 == u2
        span = max(float(m1.max() - m1.min()), 1e-3)
        assert np.abs(m1 - m2).max() <= span / 64.0

    # decode with --text: Kaldi ark,t:-style archive, float32-exact
    save_dir_t = str(tmp_path / "exp_t")
    shutil.copytree(save_dir, save_dir_t,
                    ignore=shutil.ignore_patterns("test"))
    rc = train_cli.main([
        "--decode", "--trainer=dnn", "--g_type=dnn", "--text",
        f"--data_dir={data_dir}", f"--test_list_file={test_list}",
        f"--save_dir={save_dir_t}", "--input_dim=16", "--output_dim=6",
        "--left_context=2", "--right_context=2", "--batch_size=1",
        "--bf16=false"])
    assert rc == 0
    t_ark = os.path.join(save_dir_t, "test", "feats.ark")
    with open(t_ark, "rb") as f:
        assert b"\0B" not in f.read()  # genuinely text
    t_reader = ScpReader(os.path.join(save_dir_t, "test", "feats.scp"))
    for (u1, m1), (u2, m2) in zip(reader, t_reader):
        assert u1 == u2
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))


def test_segan_pipeline(corpus, tmp_path):
    """SEGAN trainer end-to-end at toy depth (run_segan.sh parity)."""
    data_dir = corpus
    stores = os.path.join(data_dir, "stores")
    tr_list = os.path.join(data_dir, "tr.list")
    cv_list = os.path.join(data_dir, "cv.list")
    save_dir = str(tmp_path / "segan_exp")
    rc = train_cli.main([
        "--trainer=segan", "--g_type=ae",
        f"--data_dir={data_dir}", f"--tr_list_file={tr_list}",
        f"--cv_list_file={cv_list}", f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--left_context=1",
        "--right_context=1", "--batch_size=32",
        "--g_learning_rate=0.0005", "--d_learning_rate=0.0005",
        "--g_enc_depths=8,16,32", "--init_l1_weight=100.0",
        "--min_epoches=1", "--max_epoches=1", "--keep_lr=1",
        "--bf16=false"])
    assert rc == 0
    assert os.path.isfile(os.path.join(save_dir, "checkpoint"))

    test_list = os.path.join(data_dir, "test.list")
    rc = train_cli.main([
        "--decode", "--trainer=segan", "--g_type=ae",
        f"--data_dir={data_dir}", f"--test_list_file={test_list}",
        f"--save_dir={save_dir}", "--input_dim=16", "--output_dim=6",
        "--left_context=1", "--right_context=1",
        "--g_enc_depths=8,16,32", "--batch_size=1", "--bf16=false"])
    assert rc == 0
    assert os.path.isfile(os.path.join(save_dir, "test", "feats.scp"))


def test_gan_rnn_fresh_batch_mode(corpus, tmp_path):
    """--same_batch=false exercises the graph-fed d_step/g_step path with a
    tiny lstm generator config (train_gan_rnn.py parity)."""
    data_dir = corpus
    save_dir = str(tmp_path / "ganrnn_exp")
    rc = train_cli.main([
        "--trainer=gan_rnn", "--g_type=res_lstm_i", "--same_batch=false",
        f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--batch_size=2",
        "--g_learning_rate=0.0005", "--d_learning_rate=0.001",
        "--disc_updates=1", "--gen_updates=2",
        "--min_epoches=1", "--max_epoches=1", "--bf16=false",
        "--init_disc_noise_std=0.05", "--l2_scale=0.0"])
    assert rc == 0
    assert os.path.isfile(os.path.join(save_dir, "metrics_train.jsonl"))


def test_gan_rnn_same_batch_multistep(corpus, tmp_path):
    """Default placeholder semantics through the CLI, exercising the
    grouped train_multi_step path (steps_per_call > 1)."""
    data_dir = corpus
    save_dir = str(tmp_path / "ganrnn_same")
    rc = train_cli.main([
        "--trainer=gan_rnn", "--g_type=res_lstm_l",
        f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--batch_size=2",
        "--steps_per_call=2",
        "--g_learning_rate=0.0005", "--d_learning_rate=0.001",
        "--min_epoches=1", "--max_epoches=1", "--bf16=false",
        "--init_disc_noise_std=0.05", "--l2_scale=1e-5"])
    assert rc == 0
    import json
    with open(os.path.join(save_dir, "metrics_train.jsonl")) as f:
        rec = json.loads(f.readline())
    for key in ("d_loss", "g_adv_loss", "g_mse_loss", "g_loss"):
        assert np.isfinite(rec[key])

    # data-parallel GAN decode (g_params branch): batch-1 == DP batched
    decode_common = [
        "--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
        f"--data_dir={data_dir}",
        f"--test_list_file={os.path.join(data_dir, 'test.list')}",
        f"--save_dir={save_dir}", "--input_dim=16", "--output_dim=6",
        "--bf16=false"]
    assert train_cli.main(decode_common) == 0
    single = {u: np.array(m) for u, m in ScpReader(
        os.path.join(save_dir, "test", "feats.scp"))}
    import shutil
    shutil.rmtree(os.path.join(save_dir, "test"))
    assert train_cli.main(decode_common + ["--decode_batch_size=3",
                                           "--num_gpu=2"]) == 0
    dp = {u: m for u, m in ScpReader(
        os.path.join(save_dir, "test", "feats.scp"))}
    assert single.keys() == dp.keys()
    for u in single:
        np.testing.assert_allclose(dp[u], single[u], atol=1e-4)


def test_batched_decode_matches_single(corpus, tmp_path):
    """--decode_batch_size>1 must produce the same arks as batch-1."""
    data_dir = corpus
    save_dir = str(tmp_path / "bd_exp")
    common = [
        "--trainer=rnn", "--g_type=res_lstm_i",
        f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--batch_size=2",
        "--bf16=false", "--l2_scale=0.0"]
    rc = train_cli.main(common + ["--g_learning_rate=0.001",
                                  "--min_epoches=1", "--max_epoches=1"])
    assert rc == 0
    decode_common = [
        "--decode", "--trainer=rnn", "--g_type=res_lstm_i",
        f"--data_dir={data_dir}",
        f"--test_list_file={os.path.join(data_dir, 'test.list')}",
        f"--save_dir={save_dir}", "--input_dim=16", "--output_dim=6",
        "--bf16=false"]
    assert train_cli.main(decode_common) == 0
    single = {u: np.array(m) for u, m in ScpReader(
        os.path.join(save_dir, "test", "feats.scp"))}
    import shutil
    shutil.rmtree(os.path.join(save_dir, "test"))
    assert train_cli.main(decode_common + ["--decode_batch_size=4"]) == 0
    batched = {u: m for u, m in ScpReader(
        os.path.join(save_dir, "test", "feats.scp"))}
    assert single.keys() == batched.keys()
    for u in single:
        np.testing.assert_allclose(batched[u], single[u], atol=1e-4)
    # data-parallel decode (--num_gpu=2): rows sharded over a 2-device
    # mesh, same arks (mse-trainer branch: whole state replicated)
    shutil.rmtree(os.path.join(save_dir, "test"))
    assert train_cli.main(decode_common + ["--decode_batch_size=4",
                                           "--num_gpu=2"]) == 0
    dp = {u: m for u, m in ScpReader(
        os.path.join(save_dir, "test", "feats.scp"))}
    assert single.keys() == dp.keys()
    for u in single:
        np.testing.assert_allclose(dp[u], single[u], atol=1e-4)


def test_gan_rnn_data_parallel_cli(corpus, tmp_path):
    """--num_gpu=2 drives the mesh path through the CLI (replicated state,
    batch sharding incl. stacked multi-step axis-1 sharding)."""
    data_dir = corpus
    save_dir = str(tmp_path / "dp_exp")
    rc = train_cli.main([
        "--trainer=gan_rnn", "--g_type=res_lstm_i",
        f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--batch_size=1",
        "--num_gpu=2", "--steps_per_call=2",
        "--g_learning_rate=0.0005", "--d_learning_rate=0.001",
        "--min_epoches=1", "--max_epoches=1", "--bf16=false",
        "--l2_scale=0.0"])
    assert rc == 0
    assert os.path.isfile(os.path.join(save_dir, "checkpoint"))


def test_training_resumes_from_checkpoint(corpus, tmp_path):
    """Re-invoking the trainer picks up the last accepted checkpoint
    (crash-recovery semantics: the reference reloads via tr_model.load,
    train_gan_rnn_placeholder.py:446-449)."""
    data_dir = corpus
    save_dir = str(tmp_path / "resume_exp")
    common = [
        "--trainer=dnn", "--g_type=dnn",
        f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--batch_size=64",
        "--g_learning_rate=0.001", "--keep_lr=1", "--bf16=false",
        "--l2_scale=0.0"]
    assert train_cli.main(common + ["--min_epoches=1",
                                    "--max_epoches=1"]) == 0
    import json
    with open(os.path.join(save_dir, "metrics_eval.jsonl")) as f:
        first_loss = json.loads(f.readlines()[-1])["g_loss"]
    # second invocation resumes from the saved params: its first CV loss
    # must be at (or below) where the first run ended, not at init scale
    assert train_cli.main(common + ["--min_epoches=1",
                                    "--max_epoches=1"]) == 0
    with open(os.path.join(save_dir, "metrics_eval.jsonl")) as f:
        second_loss = json.loads(f.readlines()[-1])["g_loss"]
    assert second_loss <= first_loss * 1.05


def test_periodic_snapshot_cli(corpus, tmp_path):
    """--checkpoint_every_secs writes a mid-epoch crash-recovery snapshot
    and the next invocation restores from it when it is newest."""
    data_dir = corpus
    save_dir = str(tmp_path / "snap_exp")
    common = [
        "--trainer=dnn", "--g_type=dnn",
        f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--batch_size=8",
        "--g_learning_rate=0.001", "--keep_lr=1", "--bf16=false",
        "--l2_scale=0.0", "--checkpoint_every_secs=0.01"]
    assert train_cli.main(common + ["--min_epoches=1",
                                    "--max_epoches=1"]) == 0
    snap = os.path.join(save_dir, "DNNTrainer.periodic.ckpt")
    assert os.path.isfile(snap)
    # make the snapshot newest; the resume log should say "periodic"
    os.utime(snap)
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert train_cli.main(common + ["--min_epoches=1",
                                        "--max_epoches=1"]) == 0
    assert "Load SUCCESS (periodic)" in buf.getvalue()


def test_reference_flag_aliases():
    """Spellings from the reference's other drivers / run scripts map to
    the canonical flags instead of being silently dropped (upstream,
    run_dnn.sh passes --start_halving_impr to a driver that only knows
    start_decay_impr and parse_known_args ignores it)."""
    args, _ = train_cli.build_parser().parse_known_args(
        ["--min_epochs=7", "--max_epochs=8", "--halving_factor=0.25",
         "--init_noise_std=0.4", "--start_halving_impr=0.01",
         "--end_halving_impr=0.002"])
    train_cli.apply_flag_aliases(args)
    assert args.min_epoches == 7 and args.max_epoches == 8
    assert args.decay_factor == 0.25
    assert args.init_disc_noise_std == 0.4
    assert args.start_decay_impr == 0.01
    assert args.end_decay_impr == 0.002
    # canonical spellings still win when the alias is absent
    args2, _ = train_cli.build_parser().parse_known_args(
        ["--min_epoches=9"])
    train_cli.apply_flag_aliases(args2)
    assert args2.min_epoches == 9


def test_serve_streaming_matches_decode(corpus, tmp_path):
    """cli.serve streams each utterance in chunks with carried state; its
    feats must match the offline batch-1 decode of the same checkpoint."""
    from rsrgan_jax.cli import serve as serve_cli

    data_dir = corpus
    save_dir = str(tmp_path / "serve_exp")
    common = [
        "--trainer=gan_rnn", "--g_type=res_lstm_l",
        f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=16", "--output_dim=6", "--batch_size=2",
        "--bf16=false", "--l2_scale=0.0"]
    rc = train_cli.main(common + ["--g_learning_rate=0.0005",
                                  "--d_learning_rate=0.001",
                                  "--min_epoches=1", "--max_epoches=1"])
    assert rc == 0
    assert train_cli.main([
        "--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
        f"--data_dir={data_dir}",
        f"--test_list_file={os.path.join(data_dir, 'test.list')}",
        f"--save_dir={save_dir}", "--input_dim=16", "--output_dim=6",
        "--bf16=false"]) == 0
    offline = {u: np.array(m) for u, m in ScpReader(
        os.path.join(save_dir, "test", "feats.scp"))}
    assert serve_cli.main([
        f"--save_dir={save_dir}", f"--data_dir={data_dir}",
        f"--test_list_file={os.path.join(data_dir, 'test.list')}",
        "--input_dim=16", "--output_dim=6", "--chunk_frames=13"]) == 0
    streamed = {u: np.array(m) for u, m in ScpReader(
        os.path.join(save_dir, "stream", "feats.scp"))}
    assert offline.keys() == streamed.keys()
    for u in offline:
        np.testing.assert_allclose(streamed[u], offline[u], atol=1e-4)


def test_rt60_aware_pipeline(tmp_path):
    """RT60-aware variant e2e (make_tfrecords_rta.py:99-103): the
    per-utterance reverberation-time scalar prepended as an extra LEADING
    input column must flow through store build, the flagship G AND D
    training step, decode (denormalized via the unaugmented labels cmvn)
    and the checkpoint meta the serve path validates against."""
    import json

    data_dir = str(tmp_path / "data")
    make_synthetic_corpus(data_dir, num_utts=8, input_dim=12, output_dim=5,
                          min_len=30, max_len=60, seed=9)
    assert prepare_cli.main(["cmvn", f"--inputs={data_dir}/inputs.cmvn",
                             f"--labels={data_dir}/labels.cmvn",
                             f"--save_dir={data_dir}"]) == 0
    assert prepare_cli.main(["split", "--val_size=2",
                             f"--data_dir={data_dir}", "--seed=1"]) == 0
    # per-utt RT60 scalars for the whole corpus
    rt60_scp = os.path.join(data_dir, "rt60.scp")
    with open(os.path.join(data_dir, "inputs.scp")) as f:
        ids = [line.split()[0] for line in f]
    with open(rt60_scp, "w") as f:
        for i, utt in enumerate(ids):
            f.write(f"{utt} {0.2 + 0.05 * i:.3f}\n")
    stores = os.path.join(data_dir, "stores")
    for sub in ("tr", "cv"):
        assert prepare_cli.main([
            "make-store", f"--inputs={data_dir}/{sub}/inputs.scp",
            f"--labels={data_dir}/{sub}/labels.scp",
            f"--cmvn_dir={data_dir}", f"--output_dir={stores}",
            f"--name={sub}", f"--rt60_scp={rt60_scp}"]) == 0
        with open(os.path.join(data_dir, f"{sub}.list"), "w") as f:
            f.write(os.path.join(stores, f"{sub}.rtu") + "\n")
    assert prepare_cli.main([
        "make-store", f"--inputs={data_dir}/cv/inputs.scp",
        f"--cmvn_dir={data_dir}", f"--output_dir={stores}",
        "--name=test", "--test", f"--rt60_scp={rt60_scp}"]) == 0
    test_list = os.path.join(data_dir, "test.list")
    with open(test_list, "w") as f:
        f.write(os.path.join(stores, "test.rtu") + "\n")

    # flagship GAN trainer at input_dim = 12 + 1 (the RT60 column)
    save_dir = str(tmp_path / "rt60_exp")
    rc = train_cli.main([
        "--trainer=gan_rnn", "--g_type=res_lstm_l",
        f"--data_dir={data_dir}",
        f"--tr_list_file={os.path.join(data_dir, 'tr.list')}",
        f"--cv_list_file={os.path.join(data_dir, 'cv.list')}",
        f"--save_dir={save_dir}",
        "--input_dim=13", "--output_dim=5", "--batch_size=2",
        "--g_learning_rate=0.0005", "--d_learning_rate=0.001",
        "--min_epoches=1", "--max_epoches=1", "--bf16=false",
        "--init_disc_noise_std=0.05", "--l2_scale=0.0"])
    assert rc == 0
    # the serve-time validation sidecar records the AUGMENTED input dim
    metas = [fn for fn in os.listdir(save_dir) if fn.endswith(".meta.json")]
    assert metas, os.listdir(save_dir)
    with open(os.path.join(save_dir, metas[0])) as f:
        meta = json.load(f)
    assert meta["input_dim"] == 13 and meta["g_type"] == "res_lstm_l"

    # decode: denorm uses the unaugmented 5-dim labels cmvn
    rc = train_cli.main([
        "--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
        f"--data_dir={data_dir}", f"--test_list_file={test_list}",
        f"--save_dir={save_dir}", "--input_dim=13", "--output_dim=5",
        "--bf16=false"])
    assert rc == 0
    reader = ScpReader(os.path.join(save_dir, "test", "feats.scp"))
    assert len(reader) == 2
    for _, mat in reader:
        assert mat.shape[1] == 5
        assert np.isfinite(np.asarray(mat)).all()


def test_plot_cli(tmp_path):
    """cli.plot renders train/cv curves from the metrics JSONL
    (generate_plots.py parity for the structured logs)."""
    import json

    from rsrgan_jax.cli import plot as plot_cli

    save_dir = str(tmp_path / "plot_exp")
    os.makedirs(save_dir)
    for split, base in (("train", 2.0), ("eval", 1.5)):
        with open(os.path.join(save_dir, f"metrics_{split}.jsonl"),
                  "w") as f:
            for i in range(3):
                f.write(json.dumps({"iteration": i + 1,
                                    "g_mse_loss": base / (i + 1),
                                    "g_loss": base * 2 / (i + 1)}) + "\n")
    out = str(tmp_path / "curves.png")
    assert plot_cli.main([f"--save_dir={save_dir}",
                          f"--output={out}"]) == 0
    assert os.path.getsize(out) > 1000
    # missing metrics -> clean error, not a crash
    empty = str(tmp_path / "empty_exp")
    os.makedirs(empty)
    assert plot_cli.main([f"--save_dir={empty}"]) == 1


def test_decode_rejects_mismatched_flags(tmp_path):
    """--decode with a --trainer/--g_type that contradicts the checkpoint's
    .meta.json sidecar exits with a legible message instead of an opaque
    tree-mismatch error (or, for shape-identical res_lstm trees, silent
    garbage)."""
    from rsrgan_jax.training import save_checkpoint

    save_dir = str(tmp_path / "exp")
    save_checkpoint(save_dir, "RNNTrainer", {"p": np.zeros(1)}, 1,
                    meta={"trainer": "rnn", "g_type": "res_lstm_l",
                          "input_dim": 16, "output_dim": 6,
                          "left_context": 0, "right_context": 0})
    common = [f"--data_dir={tmp_path}", f"--test_list_file={tmp_path}/x",
              f"--save_dir={save_dir}", "--input_dim=16", "--output_dim=6",
              "--batch_size=1", "--bf16=false"]
    # wrong --trainer: sidecar filename differs, found via the glob fallback
    with pytest.raises(SystemExit, match="trainer=gan_rnn vs trained"):
        train_cli.main(["--decode", "--trainer=gan_rnn",
                        "--g_type=res_lstm_l"] + common)
    # right trainer, wrong g_type (trees are shape-identical -> only the
    # sidecar can catch this)
    with pytest.raises(SystemExit, match="g_type=res_lstm_base vs trained"):
        train_cli.main(["--decode", "--trainer=rnn",
                        "--g_type=res_lstm_base"] + common)
