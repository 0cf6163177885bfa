"""SEGAN trainer: LSGAN + L1, RMSProp both nets, VBN discriminator.

models/segan.py:118-258 semantics: D conditioned on concat(inputs,
labels/G) along the feature axis, d/g losses vs constants 1/0, G loss =
g_adv + l1_lambda * mean|G - labels|, gaussian input noise on D, EMA
0.9999. The latent z and the D input noise come from per-step PRNG keys.
"""

from __future__ import annotations

import functools


import jax
import jax.numpy as jnp

from rsrgan_jax.ops.common import gaussian_noise
from rsrgan_jax.training.gan import GanState
from rsrgan_jax.training.losses import lsgan_d_losses, lsgan_g_adv_loss
from rsrgan_jax.training.state import NetState, make_optimizer


class SeganTrainer:
    def __init__(self, generator, discriminator, *,
                 disc_updates: int = 1, gen_updates: int = 1,
                 ema_decay: float = 0.9999,
                 optimizer: str = "rmsprop"):
        self.generator = generator
        self.discriminator = discriminator
        self.disc_updates = disc_updates
        self.gen_updates = gen_updates
        self.ema_decay = ema_decay
        self.g_tx = make_optimizer(optimizer, None)
        self.d_tx = make_optimizer(optimizer, None)

    def _g_apply(self, g_params, inputs, z_rng):
        rngs = {"z": z_rng} if z_rng is not None else None
        return self.generator.apply({"params": g_params}, inputs, rngs=rngs)

    def _d_apply(self, d_params, d_extra, inputs, target, noise_std,
                 noise_rng):
        joint = jnp.concatenate([inputs, target], axis=-1)
        if noise_rng is not None:
            joint = gaussian_noise(noise_rng, joint, noise_std)
        return self.discriminator.apply(
            {"params": d_params, **(d_extra or {})}, joint)

    def init_state(self, rng, example_inputs) -> GanState:
        g_rng, d_rng, z_rng = jax.random.split(rng, 3)
        g_vars = self.generator.init({"params": g_rng, "z": z_rng},
                                     example_inputs)
        g_out = self.generator.apply(g_vars, example_inputs)
        joint = jnp.concatenate([example_inputs, g_out], axis=-1)
        d_vars = dict(self.discriminator.init(d_rng, joint))
        d_params = d_vars.pop("params")
        return GanState(
            g=NetState.create(g_vars["params"], self.g_tx),
            d=NetState.create(d_params, self.d_tx, extra=d_vars or None),
            step=jnp.zeros((), jnp.int32))

    def _d_loss(self, d_params, d_extra, g_out, inputs, labels, hp, rngs):
        rl = self._d_apply(d_params, d_extra, inputs, labels,
                           hp["disc_noise_std"], rngs[0])
        fk = self._d_apply(d_params, d_extra, inputs, g_out,
                           hp["disc_noise_std"], rngs[1])
        d_rl, d_fk, d_loss = lsgan_d_losses(rl, fk, 1.0, 0.0)
        return d_loss, {"d_rl_loss": d_rl, "d_fk_loss": d_fk,
                        "d_loss": d_loss}

    def _g_loss(self, g_params, d_params, d_extra, inputs, labels, hp, rngs):
        g_out = self._g_apply(g_params, inputs, rngs[0])
        fk = self._d_apply(d_params, d_extra, inputs, g_out,
                           hp["disc_noise_std"], rngs[1])
        adv = lsgan_g_adv_loss(fk, 1.0)
        l1 = hp["l1_lambda"] * jnp.mean(jnp.abs(g_out - labels))
        loss = adv + l1
        return loss, {"g_adv_loss": adv, "g_l1_loss": l1, "g_loss": loss}

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_step(self, state: GanState, inputs, labels, hp, rng):
        metrics = {}
        rngs = jax.random.split(rng, 3 * (self.disc_updates
                                          + self.gen_updates))
        idx = 0
        for _ in range(self.disc_updates):
            g_out = jax.lax.stop_gradient(
                self._g_apply(state.g.params, inputs, rngs[idx]))
            (_, m), grads = jax.value_and_grad(self._d_loss, has_aux=True)(
                state.d.params, state.d.extra, g_out, inputs, labels, hp,
                (rngs[idx + 1], rngs[idx + 2]))
            idx += 3
            state = state.replace(d=state.d.apply_gradients(
                grads, self.d_tx, hp["d_lr"], self.ema_decay))
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v / self.disc_updates
        for _ in range(self.gen_updates):
            (_, m), grads = jax.value_and_grad(self._g_loss, has_aux=True)(
                state.g.params, state.d.params, state.d.extra, inputs,
                labels, hp, (rngs[idx], rngs[idx + 1]))
            idx += 3
            state = state.replace(g=state.g.apply_gradients(
                grads, self.g_tx, hp["g_lr"], self.ema_decay))
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v / self.gen_updates
        return state.replace(step=state.step + 1), metrics

    @functools.partial(jax.jit, static_argnums=0)
    def eval_step(self, state: GanState, inputs, labels, hp, rng):
        rngs = jax.random.split(rng, 4)
        g_out = self._g_apply(state.g.params, inputs, rngs[0])
        _, d_m = self._d_loss(state.d.params, state.d.extra, g_out, inputs,
                              labels, hp, (rngs[1], rngs[2]))
        fk = self._d_apply(state.d.params, state.d.extra, inputs, g_out,
                           hp["disc_noise_std"], rngs[3])
        adv = lsgan_g_adv_loss(fk, 1.0)
        l1 = hp["l1_lambda"] * jnp.mean(jnp.abs(g_out - labels))
        return {**d_m, "g_adv_loss": adv, "g_l1_loss": l1,
                "g_loss": adv + l1}

    @functools.partial(jax.jit, static_argnums=0)
    def infer_step(self, g_params, inputs):
        return self._g_apply(g_params, inputs, None)
