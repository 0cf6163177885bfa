"""SEGAN tier tests (scaled-down depths for the CPU test env)."""

import jax
import jax.numpy as jnp
import numpy as np

from rsrgan_jax.models.segan import (SeganAEGenerator, SeganDiscriminator,
                                     SeganWaveGenerator, VirtualBatchNorm)
from rsrgan_jax.training.segan import SeganTrainer

B, W_IN, W_OUT = 4, 64, 16
ENC = (8, 16, 32)
HP = {"g_lr": jnp.float32(5e-4), "d_lr": jnp.float32(5e-4),
      "l1_lambda": jnp.float32(100.0), "disc_noise_std": jnp.float32(0.0)}


def test_vbn_reference_stats(rng):
    x = jnp.asarray(rng.normal(loc=3.0, size=(B, 8, 4)), jnp.float32)
    vbn = VirtualBatchNorm()
    variables = vbn.init(jax.random.PRNGKey(0), x)
    assert "vbn_stats" in variables
    ref_mean = np.asarray(variables["vbn_stats"]["ref_mean"])
    np.testing.assert_allclose(ref_mean[0, 0],
                               np.asarray(x).mean((0, 1)), rtol=1e-5)
    # different live batch: stats blended, output finite and roughly normed
    y = jnp.asarray(rng.normal(loc=3.0, size=(B, 8, 4)), jnp.float32)
    out = vbn.apply(variables, y)
    assert np.isfinite(np.asarray(out)).all()
    assert abs(float(jnp.mean(out))) < 1.0


def test_ae_generator_shapes(rng):
    gen = SeganAEGenerator(units=W_OUT, enc_depths=ENC, kwidth=5)
    x = jnp.asarray(rng.normal(size=(B, W_IN)), jnp.float32)
    variables = gen.init({"params": jax.random.PRNGKey(0),
                          "z": jax.random.PRNGKey(1)}, x)
    y = gen.apply(variables, x, rngs={"z": jax.random.PRNGKey(2)})
    assert y.shape == (B, W_OUT)
    # z changes the output; no z rng -> deterministic zeros path
    y2 = gen.apply(variables, x, rngs={"z": jax.random.PRNGKey(3)})
    assert not np.allclose(np.asarray(y), np.asarray(y2))
    d1 = gen.apply(variables, x)
    d2 = gen.apply(variables, x)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_wave_generator_shapes(rng):
    gen = SeganWaveGenerator(units=W_OUT, dilations=(1, 2, 4), z_depth=8)
    x = jnp.asarray(rng.normal(size=(B, W_IN)), jnp.float32)
    variables = gen.init({"params": jax.random.PRNGKey(0),
                          "z": jax.random.PRNGKey(1)}, x)
    y = gen.apply(variables, x, rngs={"z": jax.random.PRNGKey(2)})
    assert y.shape == (B, W_OUT)


def test_discriminator_shapes(rng):
    disc = SeganDiscriminator(num_fmaps=ENC, kwidth=5)
    x = jnp.asarray(rng.normal(size=(B, W_IN + W_OUT)), jnp.float32)
    variables = disc.init(jax.random.PRNGKey(0), x)
    logits = disc.apply(variables, x)
    assert logits.shape == (B, 1)


def test_segan_trainer_l1_decreases(rng):
    gen = SeganAEGenerator(units=W_OUT, enc_depths=ENC, kwidth=5)
    disc = SeganDiscriminator(num_fmaps=ENC, kwidth=5)
    trainer = SeganTrainer(gen, disc)
    x = jnp.asarray(rng.normal(size=(B, W_IN)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(W_IN, W_OUT)) * 0.2, jnp.float32)
    y = x @ w
    state = trainer.init_state(jax.random.PRNGKey(0), x)
    first = None
    for i in range(40):
        state, m = trainer.train_step(state, x, y, HP, jax.random.PRNGKey(i))
        if first is None:
            first = float(m["g_l1_loss"])
    assert float(m["g_l1_loss"]) < first
    ev = trainer.eval_step(state, x, y, HP, jax.random.PRNGKey(99))
    assert np.isfinite(float(ev["g_loss"]))
    out = trainer.infer_step(state.g.params, x)
    assert out.shape == (B, W_OUT)
