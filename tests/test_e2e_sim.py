"""CI-able full-chain integration on simulated speech (CPU-sized).

The same wav -> ark loop as recipes/run_e2e_sim.sh — synth speech ->
cli.simulate -> cli.extract -> cli.prepare -> cli.train -> decode — with a
frame DNN instead of the flagship LSTM GAN so it fits the 1-core CPU test
environment. The heavyweight quality assertion (flagship GAN beats the
no-enhancement baseline) lives in the recipe; here we assert the chain is
lossless end-to-end: consistent utterance pairing, denormalized 40-dim
arks, finite values, and a decreasing training loss on real DSP features.
"""

import json
import os

import numpy as np

from rsrgan_jax.cli import extract as extract_cli
from rsrgan_jax.cli import prepare as prepare_cli
from rsrgan_jax.cli import simulate as simulate_cli
from rsrgan_jax.cli import train as train_cli
from rsrgan_jax.data import ScpReader
from rsrgan_jax.sim import make_sim_assets


def test_wav_to_ark_full_chain(tmp_path):
    work = str(tmp_path)
    wav_scp, rir_list, noise_list = make_sim_assets(
        os.path.join(work, "sim"), num_utts=8, min_dur_s=0.6,
        max_dur_s=1.0, num_rooms=1, rirs_per_room=1, seed=5)

    rvb_dir = os.path.join(work, "sim", "rvb")
    assert simulate_cli.main([f"--wav_scp={wav_scp}",
                              f"--rir_list={rir_list}",
                              f"--noise_list={noise_list}",
                              f"--output_dir={rvb_dir}",
                              "--random_seed=1"]) == 0

    train_dir = os.path.join(work, "data")
    assert extract_cli.main([f"--wav_scp={rvb_dir}/wav.scp",
                             "--feat_type=spectrogram",
                             f"--output_dir={train_dir}", "--name=inputs",
                             "--dither=0", "--accumulate_cmvn"]) == 0
    assert extract_cli.main([f"--wav_scp={wav_scp}", "--feat_type=mfcc",
                             f"--output_dir={train_dir}", "--name=labels",
                             "--dither=0", "--accumulate_cmvn"]) == 0

    # pairing: corrupted inputs and clean labels carry the same utt ids,
    # frame-aligned (same number of frames from the same durations)
    lps = ScpReader(os.path.join(train_dir, "inputs.scp"))
    mfcc = ScpReader(os.path.join(train_dir, "labels.scp"))
    assert lps.utt_ids == mfcc.utt_ids
    for (u1, m1), (u2, m2) in zip(lps, mfcc):
        assert m1.shape == (len(m2), 257) and m2.shape[1] == 40

    assert prepare_cli.main(["cmvn", f"--inputs={train_dir}/inputs.cmvn",
                             f"--labels={train_dir}/labels.cmvn",
                             f"--save_dir={train_dir}"]) == 0
    assert prepare_cli.main(["split", "--val_size=2",
                             f"--data_dir={train_dir}", "--seed=1"]) == 0
    stores = os.path.join(train_dir, "stores")
    for sub in ("tr", "cv"):
        assert prepare_cli.main([
            "make-store", f"--inputs={train_dir}/{sub}/inputs.scp",
            f"--labels={train_dir}/{sub}/labels.scp",
            f"--cmvn_dir={train_dir}", f"--output_dir={stores}",
            f"--name={sub}"]) == 0
        with open(os.path.join(train_dir, f"{sub}.list"), "w") as f:
            f.write(os.path.join(stores, f"{sub}.rtu") + "\n")
    assert prepare_cli.main([
        "make-store", f"--inputs={train_dir}/cv/inputs.scp",
        f"--cmvn_dir={train_dir}", f"--output_dir={stores}",
        "--name=test", "--test"]) == 0
    with open(os.path.join(train_dir, "test.list"), "w") as f:
        f.write(os.path.join(stores, "test.rtu") + "\n")

    save_dir = os.path.join(work, "exp")
    rc = train_cli.main([
        "--trainer=dnn", "--g_type=dnn",
        f"--data_dir={train_dir}",
        f"--tr_list_file={train_dir}/tr.list",
        f"--cv_list_file={train_dir}/cv.list",
        f"--save_dir={save_dir}",
        "--input_dim=257", "--output_dim=40", "--left_context=2",
        "--right_context=2", "--batch_size=128",
        "--g_learning_rate=0.001", "--min_epoches=2", "--max_epoches=2",
        "--keep_lr=2", "--bf16=false", "--l2_scale=0.0"])
    assert rc == 0
    with open(os.path.join(save_dir, "metrics_train.jsonl")) as f:
        losses = [json.loads(line)["g_loss"] for line in f]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses  # learns on real DSP features

    rc = train_cli.main([
        "--decode", "--trainer=dnn", "--g_type=dnn",
        f"--data_dir={train_dir}",
        f"--test_list_file={train_dir}/test.list",
        f"--save_dir={save_dir}",
        "--input_dim=257", "--output_dim=40", "--left_context=2",
        "--right_context=2", "--batch_size=1", "--bf16=false"])
    assert rc == 0

    clean = {u: np.asarray(m)
             for u, m in ScpReader(f"{train_dir}/cv/labels.scp")}
    enhanced = {u: np.asarray(m)
                for u, m in ScpReader(f"{save_dir}/test/feats.scp")}
    assert clean.keys() == enhanced.keys()
    for u, y in clean.items():
        g = enhanced[u]
        assert g.shape == y.shape
        assert np.isfinite(g).all()
        # denormalized outputs live at MFCC scale, not z-score scale:
        # after 2 epochs the prediction should correlate with the target
        # scale (std within 10x), which a raw-z-score bug would break
        assert 0.1 < float(np.std(g)) / float(np.std(y)) < 10.0
