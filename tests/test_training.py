"""Training-layer tests: losses, schedules, optimizer semantics, GAN/MSE
steps, checkpoints."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from rsrgan_jax.models.discriminators import LstmDiscriminator
from rsrgan_jax.models.feedforward import DnnDiscriminator, DnnGenerator
from rsrgan_jax.models.recurrent import ResLstmGenerator
from rsrgan_jax.training import (GanTrainer, ImprovementTracker, MseTrainer,
                                 clip_by_norm_each, ema_update,
                                 exponential_decay, g_mse_loss,
                                 l2_loss_nonbias, load_checkpoint,
                                 lsgan_d_losses, lsgan_g_adv_loss,
                                 save_checkpoint, swap_in_ema)

B, T, D_IN, D_OUT = 2, 10, 8, 4


def tiny_gan_trainer(**kw):
    gen = ResLstmGenerator(output_dim=D_OUT, variant="l", cell_size=12)
    disc = LstmDiscriminator(cell_size=8, num_projection=4)
    defaults = dict(output_dim=D_OUT, input_dim=D_IN, disc_updates=1,
                    gen_updates=2, l2_scale=1e-5)
    defaults.update(kw)
    return GanTrainer(gen, disc, **defaults)


def make_batch(rng):
    x = jnp.asarray(rng.normal(size=(B, T, D_IN)), jnp.float32)
    # learnable target: fixed linear map of inputs
    w = jnp.asarray(rng.normal(size=(D_IN, D_OUT)) * 0.3, jnp.float32)
    y = x @ w
    lengths = jnp.array([T, T - 3], jnp.int32)
    return x, y, lengths


HP = {"g_lr": jnp.float32(1e-3), "d_lr": jnp.float32(1e-3),
      "mse_lambda": jnp.float32(10.0), "disc_noise_std": jnp.float32(0.05),
      "d_real": jnp.float32(1.0), "d_fake": jnp.float32(0.0)}


class TestLosses:
    def test_lsgan_values(self):
        rl = jnp.full((2, 3, 1), 0.8)
        fk = jnp.full((2, 3, 1), 0.3)
        d_rl, d_fk, d = lsgan_d_losses(rl, fk, 1.0, 0.0)
        assert abs(float(d_rl) - 0.04) < 1e-6
        assert abs(float(d_fk) - 0.09) < 1e-6
        assert abs(float(d) - 0.13) < 1e-6
        assert abs(float(lsgan_g_adv_loss(fk, 1.0)) - 0.49) < 1e-6

    def test_g_mse_scale(self, rng):
        g = jnp.asarray(rng.normal(size=(B, T, D_OUT)), jnp.float32)
        y = jnp.zeros_like(g)
        expect = 0.5 * float(jnp.mean(g ** 2)) * D_OUT
        assert abs(float(g_mse_loss(g, y, D_OUT)) - expect) < 1e-5

    def test_l2_skips_bias(self):
        params = {"dense": {"kernel": jnp.ones((2, 2)),
                            "bias": jnp.ones((2,)) * 100}}
        got = float(l2_loss_nonbias(params, 0.1))
        assert abs(got - 0.1 * 0.5 * 4.0) < 1e-6
        assert float(l2_loss_nonbias(params, 0.0)) == 0.0


class TestSchedules:
    def test_exponential_decay_parity(self):
        """Exact values of utils/ops.py:378-391."""
        for it, jobs, iters, lr in [(0, 2, 100, 8e-5), (50, 2, 100, 8e-5),
                                    (99, 1, 100, 1e-3), (120, 3, 100, 1e-3)]:
            final = 1e-4 * lr
            if it + 1 >= iters:
                expect = final
            else:
                expect = lr * math.exp(it * math.log(final / lr) / iters)
            expect_mult = jobs * expect
            assert exponential_decay(it, jobs, iters, lr) == pytest.approx(
                expect_mult)
            assert exponential_decay(it, jobs, iters, lr,
                                     multiply_jobs=False) == pytest.approx(
                expect)

    def test_exponential_decay_zero_init(self):
        """init_value=0 (the CLI's default disc-noise std) stays 0 at every
        iteration instead of raising ZeroDivisionError like the reference's
        unguarded utils/ops.py:385."""
        for it in (0, 1, 50, 99, 120):
            assert exponential_decay(it, 2, 100, 0.0) == 0.0
            assert exponential_decay(it, 2, 100, 0.0,
                                     multiply_jobs=False) == 0.0

    def test_improvement_tracker(self):
        tr = ImprovementTracker(end_improve=0.01)
        tr.add(5.0)
        assert tr.check(0) is True          # improved vs 10000 -> save
        tr.add(6.0)
        assert tr.check(1) is False         # worse -> reject, no rollback
        assert not tr.should_stop(1, min_iters=5)   # below min_iters
        tr.add(4.999)
        tr.check(5)
        assert tr.should_stop(5, min_iters=3) is False or True  # rel>0.01?
        tr.add(4.9989)
        tr.check(6)
        assert tr.should_stop(6, min_iters=3)


class TestOptimizerPieces:
    def test_clip_by_norm_each(self):
        tx = clip_by_norm_each(1.0)
        g = {"a": jnp.array([3.0, 4.0]), "b": jnp.array([0.1, 0.0])}
        clipped, _ = tx.update(g, tx.init(g))
        np.testing.assert_allclose(np.asarray(clipped["a"]), [0.6, 0.8],
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(clipped["b"]), [0.1, 0.0],
                                   rtol=1e-6)  # below norm: untouched

    def test_ema_update(self):
        ema = {"w": jnp.array(1.0)}
        params = {"w": jnp.array(2.0)}
        out = ema_update(ema, params, 0.9)
        assert abs(float(out["w"]) - 1.1) < 1e-6


class TestGanTrainer:
    def test_step_updates_both_nets(self, rng):
        trainer = tiny_gan_trainer()
        x, y, lengths = make_batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        # train_step donates the state buffers; snapshot to host first
        g_before = jax.tree.map(np.asarray, state.g.params)
        d_before = jax.tree.map(np.asarray, state.d.params)
        new_state, metrics = trainer.train_step(state, x, y, lengths, HP,
                                                jax.random.PRNGKey(1))
        for key in ("d_rl_loss", "d_fk_loss", "d_loss", "g_adv_loss",
                    "g_mse_loss", "g_l2_loss", "g_loss"):
            assert np.isfinite(float(metrics[key])), key
        g_diff = jax.tree.map(lambda a, b: float(jnp.abs(a - b).max()),
                              g_before, new_state.g.params)
        d_diff = jax.tree.map(lambda a, b: float(jnp.abs(a - b).max()),
                              d_before, new_state.d.params)
        assert max(jax.tree.leaves(g_diff)) > 0
        assert max(jax.tree.leaves(d_diff)) > 0
        assert int(new_state.step) == 1

    def test_mse_decreases_with_strong_lambda(self, rng):
        trainer = tiny_gan_trainer(gen_updates=2)
        x, y, lengths = make_batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        first = None
        hp = dict(HP)
        hp["g_lr"] = jnp.float32(5e-3)
        for i in range(30):
            state, metrics = trainer.train_step(state, x, y, lengths, hp,
                                                jax.random.PRNGKey(i))
            if first is None:
                first = float(metrics["g_mse_loss"])
        assert float(metrics["g_mse_loss"]) < first * 0.7

    def test_multi_step_matches_sequential(self, rng):
        """train_multi_step over stacked batches == the same train_step
        sequence (same rng splits)."""
        trainer = tiny_gan_trainer()
        x, y, lengths = make_batch(rng)
        N = 3
        base = jax.random.PRNGKey(5)
        rngs = jax.random.split(base, N)

        state_a = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        for i in range(N):
            state_a, m_a = trainer.train_step(state_a, x, y, lengths, HP,
                                              rngs[i])
        a_params = jax.tree.map(np.asarray, state_a.g.params)

        state_b = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        xs = jnp.broadcast_to(x, (N,) + x.shape)
        ys = jnp.broadcast_to(y, (N,) + y.shape)
        ls = jnp.broadcast_to(lengths, (N,) + lengths.shape)
        state_b, m_b = trainer.train_multi_step(state_b, xs, ys, ls, HP,
                                                base)
        b_params = jax.tree.map(np.asarray, state_b.g.params)
        for pa, pb in zip(jax.tree.leaves(a_params),
                          jax.tree.leaves(b_params)):
            np.testing.assert_allclose(pa, pb, atol=1e-5)

    def test_eval_step_does_not_update(self, rng):
        trainer = tiny_gan_trainer()
        x, y, lengths = make_batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        metrics = trainer.eval_step(state, x, y, lengths, HP,
                                    jax.random.PRNGKey(2))
        assert np.isfinite(float(metrics["g_loss"]))

    def test_frame_gan_conditioned(self, rng):
        gen = DnnGenerator(output_dim=D_OUT, units=16)
        disc = DnnDiscriminator(units=16)
        trainer = GanTrainer(gen, disc, output_dim=D_OUT, input_dim=D_IN,
                             left_context=0, d_conditioned=True,
                             frame_mode=True, g_optimizer="adam",
                             d_optimizer="adam", max_grad_norm=None)
        x = jnp.asarray(rng.normal(size=(16, D_IN)), jnp.float32)
        y = jnp.asarray(rng.normal(size=(16, D_OUT)), jnp.float32)
        state = trainer.init_state(jax.random.PRNGKey(0), x)
        state, metrics = trainer.train_step(state, x, y, None, HP,
                                            jax.random.PRNGKey(1))
        assert np.isfinite(float(metrics["g_loss"]))

    def test_sequence_gan_conditioned(self, rng):
        """Sequence-mode conditioned D: the joint discriminator the
        reference sketched but left commented out
        (gan_rnn_placeholder.py:192-213 — d_joint = concat(slice(inputs,
        input_dim*left_context, input_dim), labels/G, axis=-1))."""
        trainer = tiny_gan_trainer(d_conditioned=True)
        x, y, lengths = make_batch(rng)
        # _d_input reproduces the commented-out construction exactly
        joined = trainer._d_input(x, y)
        np.testing.assert_array_equal(np.asarray(joined),
                                      np.concatenate([np.asarray(x),
                                                      np.asarray(y)], -1))
        state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        # D's first-layer combined [x; h] kernel must see
        # (input_dim + output_dim) + num_projection rows vs the
        # unconditioned D's output_dim + num_projection
        def kernel_in_dims(st):
            return {p.shape[0] for p in jax.tree.leaves(st.d.params)
                    if p.ndim == 2}
        proj = 4  # tiny_gan_trainer's LstmDiscriminator num_projection
        assert D_IN + D_OUT + proj in kernel_in_dims(state)
        base = tiny_gan_trainer().init_state(jax.random.PRNGKey(0), x,
                                             lengths)
        assert D_IN + D_OUT + proj not in kernel_in_dims(base)
        assert D_OUT + proj in kernel_in_dims(base)
        state, metrics = trainer.train_step(state, x, y, lengths, HP,
                                            jax.random.PRNGKey(1))
        assert np.isfinite(float(metrics["g_loss"]))

    def test_sequence_gan_conditioned_spliced_center(self, rng):
        """With splice context the conditioned D sees only the CENTER
        frame slice (start = input_dim * left_context)."""
        trainer = tiny_gan_trainer(d_conditioned=True, left_context=1)
        x3 = jnp.asarray(rng.normal(size=(B, T, 3 * D_IN)), jnp.float32)
        y = jnp.asarray(rng.normal(size=(B, T, D_OUT)), jnp.float32)
        joined = trainer._d_input(x3, y)
        np.testing.assert_array_equal(
            np.asarray(joined),
            np.concatenate([np.asarray(x3)[..., D_IN:2 * D_IN],
                            np.asarray(y)], -1))

    def test_cli_plumbs_d_conditioned(self):
        from rsrgan_jax.cli.train import build_parser, build_trainer
        argv = ["--trainer=gan_rnn", "--g_type=res_lstm_l",
                "--tr_list_file=x", "--cv_list_file=x", "--save_dir=x",
                "--input_dim=8", "--output_dim=4"]
        args = build_parser().parse_args(argv + ["--d_conditioned=true"])
        assert build_trainer(args, jnp.float32).d_conditioned is True
        args = build_parser().parse_args(argv)
        assert build_trainer(args, jnp.float32).d_conditioned is False


class TestMseTrainer:
    def test_loss_decreases(self, rng):
        gen = ResLstmGenerator(output_dim=D_OUT, variant="base", cell_size=12)
        trainer = MseTrainer(gen, output_dim=D_OUT, max_grad_norm=15.0)
        x, y, lengths = make_batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        first = None
        for i in range(80):
            state, metrics = trainer.train_step(state, x, y, lengths,
                                                jnp.float32(1e-2),
                                                jax.random.PRNGKey(i))
            if first is None:
                first = float(metrics["g_mse_loss"])
        assert float(metrics["g_mse_loss"]) < first * 0.7
        ev = trainer.eval_step(state, x, y, lengths)
        assert np.isfinite(float(ev["g_loss"]))

    def test_checkpoint_roundtrip_and_ema(self, rng, tmp_path):
        gen = DnnGenerator(output_dim=D_OUT, units=16)
        trainer = MseTrainer(gen, output_dim=D_OUT, sequence_mode=False)
        x = jnp.asarray(rng.normal(size=(8, D_IN)), jnp.float32)
        y = jnp.asarray(rng.normal(size=(8, D_OUT)), jnp.float32)
        state = trainer.init_state(jax.random.PRNGKey(0), x)
        for i in range(3):
            state, _ = trainer.train_step(state, x, y, None,
                                          jnp.float32(1e-2),
                                          jax.random.PRNGKey(i))
        path = save_checkpoint(str(tmp_path), "MSE", state, 3)
        restored = load_checkpoint(str(tmp_path), "MSE", state)
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # EMA swap: params become the shadow
        ema_state = load_checkpoint(str(tmp_path), "MSE", state,
                                    moving_average=True)
        for p, e in zip(jax.tree.leaves(ema_state.net.params),
                        jax.tree.leaves(state.net.ema)):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(e))

    def test_checkpoint_meta_sidecar(self, rng, tmp_path):
        """save_checkpoint(meta=...) writes a readable .meta.json; absent
        meta reads back as None (pre-sidecar checkpoints)."""
        from rsrgan_jax.training import read_checkpoint_meta

        gen = DnnGenerator(output_dim=D_OUT, units=8)
        trainer = MseTrainer(gen, output_dim=D_OUT, sequence_mode=False)
        x = jnp.asarray(rng.normal(size=(4, D_IN)), jnp.float32)
        state = trainer.init_state(jax.random.PRNGKey(0), x)
        assert read_checkpoint_meta(str(tmp_path), "M") is None
        save_checkpoint(str(tmp_path), "M", state, 1,
                        meta={"g_type": "res_lstm_l", "input_dim": 257})
        assert read_checkpoint_meta(str(tmp_path), "M") == {
            "g_type": "res_lstm_l", "input_dim": 257}

    def test_max_to_keep_rotation(self, rng, tmp_path):
        gen = DnnGenerator(output_dim=D_OUT, units=8)
        trainer = MseTrainer(gen, output_dim=D_OUT, sequence_mode=False)
        x = jnp.asarray(rng.normal(size=(4, D_IN)), jnp.float32)
        state = trainer.init_state(jax.random.PRNGKey(0), x)
        for step in range(1, 14):
            save_checkpoint(str(tmp_path), "M", state, step, max_to_keep=10)
        import os
        files = [f for f in os.listdir(tmp_path) if f.endswith(".ckpt")]
        assert len(files) == 10
        assert "M-13.ckpt" in files and "M-3.ckpt" not in files
        restored = load_checkpoint(str(tmp_path), "M", state)
        assert restored is not None

    def test_periodic_snapshot_recovery(self, rng, tmp_path):
        """A newer mid-iteration snapshot wins over the accepted checkpoint;
        an accepted save newer than the snapshot wins back."""
        import os
        import time

        from rsrgan_jax.training import load_newest_state, \
            save_periodic_snapshot

        gen = DnnGenerator(output_dim=D_OUT, units=8)
        trainer = MseTrainer(gen, output_dim=D_OUT, sequence_mode=False)
        x = jnp.asarray(rng.normal(size=(4, D_IN)), jnp.float32)
        y = jnp.asarray(rng.normal(size=(4, D_OUT)), jnp.float32)
        s_dev = trainer.init_state(jax.random.PRNGKey(0), x)
        s0 = jax.device_get(s_dev)  # train_step donates its input buffers
        save_checkpoint(str(tmp_path), "M", s0, 1)
        s1, _ = trainer.train_step(s_dev, x, y, None, jnp.float32(1e-2),
                                   jax.random.PRNGKey(1))
        s1 = jax.device_get(s1)
        time.sleep(0.05)
        save_periodic_snapshot(str(tmp_path), "M", s1)
        got, src = load_newest_state(str(tmp_path), "M", s0)
        assert src == "periodic"
        np.testing.assert_array_equal(
            np.asarray(jax.tree.leaves(got)[0]),
            np.asarray(jax.tree.leaves(s1)[0]))
        # accepted checkpoint newer than the snapshot -> checkpoint wins
        time.sleep(0.05)
        save_checkpoint(str(tmp_path), "M", s0, 2)
        got, src = load_newest_state(str(tmp_path), "M", s0)
        assert src == "checkpoint"
        np.testing.assert_array_equal(
            np.asarray(jax.tree.leaves(got)[0]),
            np.asarray(jax.tree.leaves(s0)[0]))
        # snapshot never enters the accepted rotation / pointer file
        assert "periodic" not in open(
            os.path.join(tmp_path, "checkpoint")).read()


class TestSharedGForward:
    def test_shared_forward_matches_unshared(self, rng):
        """With a deterministic G and disc_noise_std=0, the vjp-shared
        forward must produce bit-equal parameter trajectories."""
        x, y, lengths = make_batch(rng)
        hp = dict(HP)
        hp["disc_noise_std"] = jnp.float32(0.0)
        results = []
        for share in (True, False):
            trainer = tiny_gan_trainer()
            trainer.share_g_forward = share
            state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
            for i in range(3):
                state, m = trainer.train_step(state, x, y, lengths, hp,
                                              jax.random.PRNGKey(i))
            results.append((jax.tree.map(np.asarray, state.g.params),
                            jax.tree.map(np.asarray, state.d.params),
                            {k: float(v) for k, v in m.items()}))
        (g1, d1, m1), (g2, d2, m2) = results
        for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        for a, b in zip(jax.tree.leaves(d1), jax.tree.leaves(d2)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        for k in m1:
            assert abs(m1[k] - m2[k]) < 1e-5 * (1 + abs(m1[k])), k


class TestBnLstmTrainer:
    def test_batch_stats_thread_through_train_step(self, rng):
        """bnlstm's mutable batch_stats must update inside the jitted
        train step and survive multi-step scans."""
        from rsrgan_jax.models.bnlstm import BnLstmGenerator
        gen = BnLstmGenerator(output_dim=D_OUT, cell_size=8,
                              num_projection=5, num_layers=1)
        trainer = MseTrainer(gen, output_dim=D_OUT, max_grad_norm=15.0)
        x, y, lengths = make_batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        assert state.net.extra and "batch_stats" in state.net.extra
        before = jax.tree.map(np.asarray, state.net.extra)
        state, m = trainer.train_step(state, x, y, lengths,
                                      jnp.float32(1e-3),
                                      jax.random.PRNGKey(1))
        after = jax.tree.map(np.asarray, state.net.extra)
        changed = any(not np.allclose(a, b)
                      for a, b in zip(jax.tree.leaves(before),
                                      jax.tree.leaves(after)))
        assert changed
        assert np.isfinite(float(m["g_loss"]))
        # eval must not mutate stats
        st2 = jax.tree.map(np.asarray, state.net.extra)
        trainer.eval_step(state, x, y, lengths)
        for a, b in zip(jax.tree.leaves(st2),
                        jax.tree.leaves(jax.tree.map(np.asarray,
                                                     state.net.extra))):
            np.testing.assert_array_equal(a, b)


class TestDropoutPaths:
    def test_gan_step_with_keep_prob_below_one(self, rng):
        """keep_prob < 1 must run (D dropout rng supplied) — used to crash
        for want of a dropout rng."""
        gen = ResLstmGenerator(output_dim=D_OUT, variant="l", cell_size=12,
                               keep_prob=0.8)
        disc = LstmDiscriminator(cell_size=8, num_projection=4,
                                 keep_prob=0.8)
        trainer = GanTrainer(gen, disc, output_dim=D_OUT, input_dim=D_IN,
                             disc_updates=1, gen_updates=1, l2_scale=0.0)
        x, y, lengths = make_batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
        state, m = trainer.train_step(state, x, y, lengths, HP,
                                      jax.random.PRNGKey(1))
        assert np.isfinite(float(m["g_loss"]))
        ev = trainer.eval_step(state, x, y, lengths, HP,
                               jax.random.PRNGKey(2))
        assert np.isfinite(float(ev["g_loss"]))


class TestTensorboardEvents:
    def test_crc32c_known_vectors(self):
        from rsrgan_jax.training.tensorboard import crc32c
        assert crc32c(b"123456789") == 0xE3069283  # RFC 3720 check value
        assert crc32c(b"") == 0
        assert crc32c(b"\x00" * 32) == 0x8A9136AA

    def test_events_readable_by_tensorflow(self, tmp_path):
        """Our hand-encoded event files must parse with TF's own iterator."""
        from rsrgan_jax.training.tensorboard import EventFileWriter
        with EventFileWriter(str(tmp_path)) as w:
            w.add_scalars(3, {"g_loss": 1.5, "d_loss": -0.25})
            w.add_scalars(4, {"g_loss": 1.25})
            path = w.path

        tf = pytest.importorskip("tensorflow")
        events = list(tf.compat.v1.train.summary_iterator(path))
        assert events[0].file_version == "brain.Event:2"
        scalars = {
            (e.step, v.tag): v.simple_value
            for e in events[1:] for v in e.summary.value
        }
        assert scalars[(3, "g_loss")] == pytest.approx(1.5)
        assert scalars[(3, "d_loss")] == pytest.approx(-0.25)
        assert scalars[(4, "g_loss")] == pytest.approx(1.25)


def test_snapshot_invalidation_on_rollback(tmp_path):
    """A periodic snapshot of a later-REJECTED trajectory must not win
    over the accepted checkpoint after the trainer rolled back."""
    import jax.numpy as jnp2
    from rsrgan_jax.cli.train import PeriodicSnapshotter
    from rsrgan_jax.training import load_newest_state, \
        save_periodic_snapshot

    good = {"w": jnp2.ones((2,))}
    bad = {"w": jnp2.zeros((2,))}
    save_checkpoint(str(tmp_path), "M", good, 1)
    import time
    time.sleep(0.05)
    save_periodic_snapshot(str(tmp_path), "M", bad)
    got, src = load_newest_state(str(tmp_path), "M", good)
    assert src == "periodic"  # pre-rollback: snapshot is newest
    snapper = PeriodicSnapshotter(str(tmp_path), "M", every_secs=1.0)
    snapper.invalidate()      # what the reject branch calls
    got, src = load_newest_state(str(tmp_path), "M", good)
    assert src == "checkpoint"
    np.testing.assert_array_equal(np.asarray(got["w"]), np.ones((2,)))


class TestNpzCheckpoints:
    """Checkpoints are .npz archives keyed by tree path."""

    @pytest.mark.parametrize("kind", ["gan", "mse"])
    def test_roundtrip_with_ema(self, rng, tmp_path, kind):
        x, y, lengths = make_batch(rng)
        if kind == "gan":
            trainer = tiny_gan_trainer()
            state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
            state, _ = trainer.train_step(state, x, y, lengths, HP,
                                          jax.random.PRNGKey(1))
            nets = ("g", "d")
        else:
            gen = ResLstmGenerator(output_dim=D_OUT, variant="i",
                                   cell_size=12)
            trainer = MseTrainer(gen, output_dim=D_OUT, max_grad_norm=15.0)
            state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
            state, _ = trainer.train_step(state, x, y, lengths,
                                          jnp.float32(1e-2),
                                          jax.random.PRNGKey(1))
            nets = ("net",)
        state = jax.device_get(state)
        path = save_checkpoint(str(tmp_path), "M", state, 1)
        with np.load(path) as archive:
            assert f"{nets[0]}/params/lstm_cell_1/kernel" in archive.files
            assert "step" in archive.files
        restored = load_checkpoint(str(tmp_path), "M", state)
        assert type(restored) is type(state)
        assert (jax.tree_util.tree_structure(restored)
                == jax.tree_util.tree_structure(state))
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        ema = load_checkpoint(str(tmp_path), "M", state, moving_average=True)
        for net in nets:
            got, want = getattr(ema, net).params, getattr(state, net).ema
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            # the params really changed: EMA shadow != trained params
            assert any(not np.array_equal(a, b) for a, b in zip(
                jax.tree.leaves(getattr(state, net).params),
                jax.tree.leaves(want)))

    def test_mismatched_tree_names_the_leaf(self, rng, tmp_path):
        x, _, lengths = make_batch(rng)
        state = tiny_gan_trainer().init_state(jax.random.PRNGKey(0), x,
                                              lengths)
        save_checkpoint(str(tmp_path), "M", state, 1)
        wider = tiny_gan_trainer(d_conditioned=True).init_state(
            jax.random.PRNGKey(0), x, lengths)
        with pytest.raises(ValueError, match="d/params/StackedLstm_0/cell_0"
                                             "/kernel has shape"):
            load_checkpoint(str(tmp_path), "M", wider)
        with pytest.raises(ValueError, match="missing"):
            load_checkpoint(str(tmp_path), "M", {"other": np.zeros(1)})
