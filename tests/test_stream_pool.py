"""Batched multi-stream serving: masked-step exactness + pool parity."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rsrgan_jax.data.cmvn import Cmvn
from rsrgan_jax.features import FrameOptions
from rsrgan_jax.models.recurrent import ResLstmGenerator
from rsrgan_jax.serving import StreamingEnhancer, StreamingWavEnhancer, \
    StreamPool

NODITHER = FrameOptions(dither=0.0)
BINS = 257


def tiny_lps_generator_params(seed=0):
    gen = ResLstmGenerator(output_dim=BINS, variant="l", cell_size=32)
    x = jnp.zeros((1, 8, BINS), jnp.float32)
    lens = jnp.full((1,), 8, jnp.int32)
    return gen.init(jax.random.PRNGKey(seed), x, lens)["params"]


def make_cmvns(rng):
    inp = Cmvn(rng.normal(size=BINS) * 0.1, 1.0 + 0.05 * rng.random(BINS))
    lab = Cmvn(rng.normal(size=BINS) * 0.1, 1.0 + 0.05 * rng.random(BINS))
    return inp, lab


def noisy_speech(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 1800 * np.sin(2 * np.pi * 300 * t) * (0.5 + 0.5 * np.sin(
        2 * np.pi * 2.5 * t)) + 250 * rng.standard_normal(n)
    return (x - x.mean()).astype(np.float32)


def state_tree(state):
    return [np.asarray(a) for ch in state for a in ch]


class TestMaskedStep:
    """The lengths-masked StreamingEnhancer.step used by StreamPool."""

    def test_full_lengths_match_unmasked(self):
        params = tiny_lps_generator_params()
        enh = StreamingEnhancer(params, variant="res_lstm_l")
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((3, 12, BINS)), jnp.float32)
        s0 = enh.init_state(3)
        y_u, s_u = enh.step(x, s0)
        y_m, s_m = enh.step(x, s0, lengths=np.full(3, 12, np.int32))
        np.testing.assert_allclose(np.asarray(y_m), np.asarray(y_u),
                                   rtol=0, atol=1e-6)
        for a, b in zip(state_tree(s_m), state_tree(s_u)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)

    def test_partial_lengths_freeze_state(self):
        """A lane with length L ends with the same state as stepping L
        frames alone, and outputs zeros past L."""
        params = tiny_lps_generator_params()
        enh = StreamingEnhancer(params, variant="res_lstm_l")
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal((2, 10, BINS)), jnp.float32)
        lengths = np.array([4, 10], np.int32)
        y, s = enh.step(x, enh.init_state(2), lengths=lengths)
        assert np.all(np.asarray(y)[0, 4:] == 0.0)

        y_ref, s_ref = enh.step(x[:1, :4], enh.init_state(1))
        np.testing.assert_allclose(np.asarray(y)[0, :4],
                                   np.asarray(y_ref)[0], rtol=0, atol=1e-5)
        for (c, h), (c1, h1) in zip(s, s_ref):
            np.testing.assert_allclose(np.asarray(c)[0], np.asarray(c1)[0],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(np.asarray(h)[0], np.asarray(h1)[0],
                                       rtol=0, atol=1e-5)

    def test_zero_length_lane_is_inert(self):
        params = tiny_lps_generator_params()
        enh = StreamingEnhancer(params, variant="res_lstm_l")
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.standard_normal((2, 6, BINS)), jnp.float32)
        s0 = enh.init_state(2)
        y, s = enh.step(x, s0, lengths=np.array([0, 6], np.int32))
        assert np.all(np.asarray(y)[0] == 0.0)
        for (c, h), (c0, h0) in zip(s, s0):
            np.testing.assert_array_equal(np.asarray(c)[0],
                                          np.asarray(c0)[0])
            np.testing.assert_array_equal(np.asarray(h)[0],
                                          np.asarray(h0)[0])


def stream_alone(params, cmvns, wave, chunk_frames=16, block=1600):
    enh = StreamingWavEnhancer(params, cmvns[0], cmvns[1],
                               variant="res_lstm_l", frame_opts=NODITHER,
                               chunk_frames=chunk_frames)
    outs = [enh.process(wave[lo:lo + block])
            for lo in range(0, len(wave), block)]
    outs.append(enh.flush())
    return np.concatenate(outs)


def snr_db(ref, est):
    n = min(len(ref), len(est))
    err = est[:n] - ref[:n]
    return 10 * np.log10(np.sum(ref[:n] ** 2) / (np.sum(err ** 2) + 1e-12))


class TestStreamPool:
    def test_pool_matches_single_streams(self):
        """Three concurrent streams of different lengths, interleaved
        feeds, equal their dedicated single-stream results."""
        params = tiny_lps_generator_params()
        rng = np.random.default_rng(3)
        cmvns = make_cmvns(rng)
        waves = [noisy_speech(9000, 10), noisy_speech(14500, 11),
                 noisy_speech(5200, 12)]
        ref = [stream_alone(params, cmvns, w) for w in waves]

        pool = StreamPool(params, cmvns[0], cmvns[1],
                          variant="res_lstm_l", frame_opts=NODITHER,
                          chunk_frames=16, capacity=4)
        sids = [pool.open() for _ in waves]
        outs = [[] for _ in waves]
        pos = [0] * len(waves)
        blocks = [1600, 900, 2400]  # deliberately uneven rates
        while any(p < len(w) for p, w in zip(pos, waves)):
            for i, sid in enumerate(sids):
                if pos[i] < len(waves[i]):
                    outs[i].append(pool.feed(
                        sid, waves[i][pos[i]:pos[i] + blocks[i]]))
                    pos[i] += blocks[i]
        for i, sid in enumerate(sids):
            outs[i].append(pool.close(sid))
        for i in range(len(waves)):
            got = np.concatenate(outs[i])
            assert len(got) == len(ref[i]), (i, len(got), len(ref[i]))
            assert snr_db(ref[i], got) > 60.0, i

    def test_pool_thread_safe_drivers(self):
        """One driver thread per stream (the production serving shape):
        concurrent open/feed/close serialize on the pool's internal lock
        and every stream still reproduces its dedicated single-stream
        result exactly, whatever the thread interleaving."""
        import threading

        params = tiny_lps_generator_params()
        rng = np.random.default_rng(5)
        cmvns = make_cmvns(rng)
        waves = [noisy_speech(n, 20 + i)
                 for i, n in enumerate((9000, 14500, 5200, 7300))]
        ref = [stream_alone(params, cmvns, w) for w in waves]
        pool = StreamPool(params, cmvns[0], cmvns[1],
                          variant="res_lstm_l", frame_opts=NODITHER,
                          chunk_frames=16, capacity=4)
        results = [None] * len(waves)
        errors = []

        def drive(i):
            try:
                rng_t = np.random.default_rng(100 + i)
                sid = pool.open()
                outs, pos = [], 0
                while pos < len(waves[i]):
                    n = int(rng_t.integers(300, 2500))
                    outs.append(pool.feed(sid, waves[i][pos:pos + n]))
                    pos += n
                outs.append(pool.close(sid))
                results[i] = np.concatenate(outs)
            except Exception as e:  # surfaced by the main thread
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(len(waves))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not errors, errors
        for i in range(len(waves)):
            assert results[i] is not None, f"driver {i} hung"
            assert len(results[i]) == len(ref[i])
            assert snr_db(ref[i], results[i]) > 60.0, i

    def test_lane_reuse_starts_fresh(self):
        """Opening a stream in a previously used lane reproduces a fresh
        stream exactly (recurrent state + DSP state cleared)."""
        params = tiny_lps_generator_params()
        rng = np.random.default_rng(4)
        cmvns = make_cmvns(rng)
        wave = noisy_speech(6000, 13)

        pool = StreamPool(params, cmvns[0], cmvns[1], frame_opts=NODITHER,
                          chunk_frames=8, capacity=1)
        sid = pool.open()
        first = np.concatenate([pool.feed(sid, wave), pool.close(sid)])
        sid2 = pool.open()
        assert sid2 == sid  # same lane
        second = np.concatenate([pool.feed(sid2, wave), pool.close(sid2)])
        np.testing.assert_array_equal(first, second)

    def test_capacity_and_errors(self):
        params = tiny_lps_generator_params()
        rng = np.random.default_rng(5)
        cmvns = make_cmvns(rng)
        pool = StreamPool(params, cmvns[0], cmvns[1], frame_opts=NODITHER,
                          chunk_frames=8, capacity=2)
        a = pool.open()
        b = pool.open()
        with pytest.raises(RuntimeError, match="full"):
            pool.open()
        pool.close(a)
        with pytest.raises(ValueError, match="not open"):
            pool.feed(a, np.zeros(100, np.float32))
        with pytest.raises(ValueError, match="not open"):
            pool.close(a)
        assert pool.active == 1
        pool.close(b)
        assert pool.active == 0

    def test_idle_lanes_dont_dispatch(self):
        """Feeding less than a chunk runs no device step; a full chunk
        runs exactly one."""
        params = tiny_lps_generator_params()
        rng = np.random.default_rng(6)
        cmvns = make_cmvns(rng)
        pool = StreamPool(params, cmvns[0], cmvns[1], frame_opts=NODITHER,
                          chunk_frames=32, capacity=2)
        sid = pool.open()
        opts = NODITHER
        few = opts.window_size + 3 * opts.window_shift  # 4 frames
        out = pool.feed(sid, noisy_speech(few, 14))
        assert pool.steps_run == 0 and len(out) == 0
        pool.feed(sid, noisy_speech(32 * opts.window_shift + 2000, 15))
        assert pool.steps_run >= 1
        pool.close(sid)


def test_serve_cli_pooled_matches_single(tmp_path):
    """cli.serve --num_streams=3 writes the same enhanced wavs as the
    single-stream path."""
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
    rng = np.random.default_rng(7)
    np.savez(os.path.join(data_dir, "train_cmvn.npz"),
             mean_inputs=rng.normal(size=BINS) * 0.1,
             stddev_inputs=1.0 + 0.05 * rng.random(BINS),
             mean_labels=rng.normal(size=BINS) * 0.1,
             stddev_labels=1.0 + 0.05 * rng.random(BINS))

    scp_lines = []
    for i, n in enumerate((7000, 4200, 9800, 6100)):
        wav_path = str(tmp_path / f"u{i}.wav")
        write_wav(wav_path, noisy_speech(n, 20 + i))
        scp_lines.append(f"u{i} {wav_path}\n")
    wav_scp = str(tmp_path / "noisy.scp")
    with open(wav_scp, "w") as f:
        f.writelines(scp_lines)

    common = [f"--save_dir={save_dir}", f"--data_dir={data_dir}",
              f"--wav_scp={wav_scp}", "--input_dim=257",
              "--output_dim=257", "--chunk_frames=16"]
    assert serve_cli.main(
        common + [f"--output_dir={tmp_path}/single"]) == 0
    assert serve_cli.main(
        common + [f"--output_dir={tmp_path}/pooled",
                  "--num_streams=3"]) == 0
    for i in range(4):
        a, _ = read_wav(str(tmp_path / "single" / f"u{i}.wav"))
        b, _ = read_wav(str(tmp_path / "pooled" / f"u{i}.wav"))
        assert len(a) == len(b)
        assert snr_db(a.astype(np.float64), b.astype(np.float64)) > 40.0
