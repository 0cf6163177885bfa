"""Streaming wav->wav enhancement: parity with the offline chain."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsrgan_jax.data.cmvn import Cmvn
from rsrgan_jax.features import FrameOptions, SpectrogramOptions, \
    compute_spectrogram_np
from rsrgan_jax.features.resynth import resynthesize
from rsrgan_jax.models.recurrent import ResLstmGenerator
from rsrgan_jax.serving import StreamingEnhancer
from rsrgan_jax.serving.wav_stream import StreamingWavEnhancer

NODITHER = FrameOptions(dither=0.0)
BINS = 257


def tiny_lps_generator_params(seed=0):
    """A small LPS->LPS res_lstm_l checkpoint tree (257 in, 257 out)."""
    gen = ResLstmGenerator(output_dim=BINS, variant="l", cell_size=32)
    x = jnp.zeros((1, 8, BINS), jnp.float32)
    lens = jnp.full((1,), 8, jnp.int32)
    return gen.init(jax.random.PRNGKey(seed), x, lens)["params"]


def make_cmvns(rng):
    inp = Cmvn(rng.normal(size=BINS) * 0.1,
               1.0 + 0.05 * rng.random(BINS))
    lab = Cmvn(rng.normal(size=BINS) * 0.1,
               1.0 + 0.05 * rng.random(BINS))
    return inp, lab


def noisy_speech(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 2000 * np.sin(2 * np.pi * 250 * t) * (0.5 + 0.5 * np.sin(
        2 * np.pi * 3 * t)) + 300 * rng.standard_normal(n)
    return (x - x.mean()).astype(np.float32)


class TestStreamingWav:
    def test_matches_offline_chain(self):
        """Streamed (irregular sample chunks) == offline extract ->
        whole-utterance enhancer forward -> offline resynthesize."""
        params = tiny_lps_generator_params()
        rng = np.random.default_rng(1)
        inp_cmvn, lab_cmvn = make_cmvns(rng)
        wave = noisy_speech(16000, seed=2)

        # offline reference
        lps = compute_spectrogram_np(
            wave, SpectrogramOptions(NODITHER, raw_energy=True))
        xn = inp_cmvn.apply(lps).astype(np.float32)
        offline_enh = StreamingEnhancer(params, variant="res_lstm_l")
        y, _ = offline_enh.step(jnp.asarray(xn[None]),
                                offline_enh.init_state(1))
        enhanced = lab_cmvn.denormalize(np.asarray(y[0], np.float32))
        offline = resynthesize(enhanced, wave, NODITHER, raw_energy=True)

        # streamed, irregular sample-chunk sizes
        stream = StreamingWavEnhancer(params, inp_cmvn, lab_cmvn,
                                      variant="res_lstm_l",
                                      frame_opts=NODITHER,
                                      chunk_frames=16)
        outs = []
        pos = 0
        for size in (1000, 37, 4000, 2500, 160, 8000, 303):
            outs.append(stream.process(wave[pos:pos + size]))
            pos += size
        outs.append(stream.process(wave[pos:]))
        outs.append(stream.flush())
        streamed = np.concatenate(outs)

        n = min(len(streamed), len(offline))
        assert n > 15000
        err = streamed[:n] - offline[:n]
        snr = 10 * np.log10(np.sum(offline[:n] ** 2)
                            / (np.sum(err ** 2) + 1e-10))
        assert snr > 35.0, snr

    def test_incremental_emission_and_latency(self):
        """Output arrives incrementally and totals the analyzed span."""
        params = tiny_lps_generator_params()
        rng = np.random.default_rng(3)
        inp_cmvn, lab_cmvn = make_cmvns(rng)
        stream = StreamingWavEnhancer(params, inp_cmvn, lab_cmvn,
                                      frame_opts=NODITHER, chunk_frames=8)
        wave = noisy_speech(16000, seed=4)
        got = 0
        emitted_early = False
        for lo in range(0, 16000, 1600):
            out = stream.process(wave[lo:lo + 1600])
            got += len(out)
            if lo < 8000 and len(out):
                emitted_early = True
        got += len(stream.flush())
        assert emitted_early  # bounded latency: output before EOS
        opts = NODITHER
        F = 1 + (16000 - opts.window_size) // opts.window_shift
        assert got == (F - 1) * opts.window_shift + opts.window_size

    def test_reset_reproduces(self):
        params = tiny_lps_generator_params()
        rng = np.random.default_rng(5)
        inp_cmvn, lab_cmvn = make_cmvns(rng)
        stream = StreamingWavEnhancer(params, inp_cmvn, lab_cmvn,
                                      frame_opts=NODITHER, chunk_frames=8)
        wave = noisy_speech(6000, seed=6)
        a = np.concatenate([stream.process(wave), stream.flush()])
        stream.reset()
        b = np.concatenate([stream.process(wave), stream.flush()])
        np.testing.assert_array_equal(a, b)

    def test_rejects_non_lps_checkpoint(self):
        gen = ResLstmGenerator(output_dim=40, variant="l", cell_size=32)
        x = jnp.zeros((1, 8, BINS), jnp.float32)
        params = gen.init(jax.random.PRNGKey(0), x,
                          jnp.full((1,), 8, jnp.int32))["params"]
        rng = np.random.default_rng(7)
        inp_cmvn, lab_cmvn = make_cmvns(rng)
        with pytest.raises(ValueError, match="output dim"):
            StreamingWavEnhancer(params, inp_cmvn, lab_cmvn,
                                 frame_opts=NODITHER)

    def test_rejects_dither(self):
        params = tiny_lps_generator_params()
        rng = np.random.default_rng(8)
        inp_cmvn, lab_cmvn = make_cmvns(rng)
        with pytest.raises(ValueError, match="dither"):
            StreamingWavEnhancer(params, inp_cmvn, lab_cmvn,
                                 frame_opts=FrameOptions(dither=1.0))


def test_serve_cli_wav_mode(tmp_path):
    """cli.serve --wav_scp streams noisy wavs through a (fresh-init)
    LPS->LPS flagship checkpoint and writes enhanced wavs + wav.scp."""
    import os

    from rsrgan_jax.cli import serve as serve_cli
    from rsrgan_jax.models import get_discriminator, get_generator
    from rsrgan_jax.sim.wavio import read_wav, write_wav
    from rsrgan_jax.training import GanTrainer, save_checkpoint

    gen = get_generator("res_lstm_l", input_dim=BINS, output_dim=BINS)
    disc = get_discriminator("lstm")
    trainer = GanTrainer(gen, disc, output_dim=BINS, input_dim=BINS)
    x = jnp.zeros((1, 8, BINS), jnp.float32)
    state = trainer.init_state(jax.random.PRNGKey(0), x,
                               jnp.full((1,), 8, jnp.int32))
    save_dir = str(tmp_path / "exp")
    save_checkpoint(save_dir, "GAN_RNN", state, step=1)

    data_dir = str(tmp_path / "data")
    os.makedirs(data_dir)
    rng = np.random.default_rng(9)
    np.savez(os.path.join(data_dir, "train_cmvn.npz"),
             mean_inputs=rng.normal(size=BINS) * 0.1,
             stddev_inputs=1.0 + 0.05 * rng.random(BINS),
             mean_labels=rng.normal(size=BINS) * 0.1,
             stddev_labels=1.0 + 0.05 * rng.random(BINS))

    wave = noisy_speech(8000, seed=10)
    wav_path = str(tmp_path / "u0.wav")
    write_wav(wav_path, wave)
    wav_scp = str(tmp_path / "noisy.scp")
    with open(wav_scp, "w") as f:
        f.write(f"u0 {wav_path}\n")

    assert serve_cli.main([
        f"--save_dir={save_dir}", f"--data_dir={data_dir}",
        f"--wav_scp={wav_scp}", "--input_dim=257", "--output_dim=257",
        "--chunk_frames=16"]) == 0
    out_dir = os.path.join(save_dir, "stream_wav")
    y, rate = read_wav(os.path.join(out_dir, "u0.wav"))
    assert rate == 16000 and np.isfinite(y).all()
    opts = FrameOptions()
    F = 1 + (len(wave) - opts.window_size) // opts.window_shift
    assert len(y) == (F - 1) * opts.window_shift + opts.window_size
    with open(os.path.join(out_dir, "wav.scp")) as f:
        assert f.read().startswith("u0 ")

    # variant mismatch against the checkpoint's meta sidecar must refuse
    # loudly: res_lstm_l vs res_lstm_base trees are shape-identical, so
    # this is the only guard (training/checkpoints.py meta)
    from rsrgan_jax.training.checkpoints import checkpoint_meta_path
    import json
    with open(checkpoint_meta_path(save_dir, "GAN_RNN"), "w") as f:
        json.dump({"g_type": "res_lstm_base"}, f)
    with pytest.raises(SystemExit, match="res_lstm_base"):
        serve_cli.main([
            f"--save_dir={save_dir}", f"--data_dir={data_dir}",
            f"--wav_scp={wav_scp}", "--input_dim=257", "--output_dim=257",
            "--g_type=res_lstm_l"])
