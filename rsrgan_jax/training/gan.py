"""LSGAN trainers: fused alternating D/G steps under one jit.

Rebuilds the reference's flagship GAN training semantics
(scripts/train_gan_rnn_placeholder.py:48-133 + models/gan_rnn_placeholder.py
:139-298) as pure jitted functions:

* per batch: ``disc_updates`` D steps then ``gen_updates`` G steps, all on
  the SAME minibatch (placeholder-trainer semantics, README.md:39). The
  read-after-write ordering is preserved — every G step sees the D
  parameters produced by the preceding D steps and vice versa — by
  threading the state through a statically unrolled loop inside one jit.
* D optimizer SGD, G optimizer Adam, per-tensor grad clip 15, EMA 0.9999 on
  both var sets (gan_rnn_placeholder.py:144-189).
* losses: LSGAN with assignable soft labels d_real/d_fake, G loss =
  g_adv + mse_lambda * (0.5*MSE*output_dim) + L2(non-bias g vars).
* discriminator input noise std, both learning rates, mse_lambda and the
  soft labels are traced scalars -> schedule updates don't recompile.

The frame-level GAN (models/gan.py) reuses the same step with
``d_conditioned=True`` (D sees concat(center input frame, labels/G)) and
Adam for both nets, no clipping.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from rsrgan_jax.ops.gather import assemble_sequence_batch
from rsrgan_jax.training.losses import (g_mse_loss, l2_loss_nonbias,
                                        lsgan_d_losses, lsgan_g_adv_loss)
from rsrgan_jax.training.state import (NetState, make_optimizer,
                                       pytree_dataclass)


@pytree_dataclass
class GanState:
    g: NetState
    d: NetState
    step: jnp.ndarray


def default_hparams(args=None) -> Dict[str, float]:
    """Assignable scalars (the reference's non-trainable tf.Variables)."""
    return {
        "g_lr": 8e-5, "d_lr": 1e-3, "mse_lambda": 10.0,
        "disc_noise_std": 0.05, "d_real": 1.0, "d_fake": 0.0,
    }


class GanTrainer:
    """Builds init/train/eval functions for a (G, D) pair.

    generator_apply(params, inputs, lengths, train, rngs) -> [B,T,out]
    discriminator_apply(params, x, lengths, noise_std, train, rngs) -> logits
    """

    def __init__(self, generator, discriminator, *, output_dim: int,
                 input_dim: int = 257, left_context: int = 0,
                 disc_updates: int = 1, gen_updates: int = 2,
                 l2_scale: float = 0.0, max_grad_norm: Optional[float] = 15.0,
                 ema_decay: float = 0.9999, g_optimizer: str = "adam",
                 d_optimizer: str = "sgd", d_conditioned: bool = False,
                 frame_mode: bool = False, share_g_forward=None):
        self.generator = generator
        self.discriminator = discriminator
        self.output_dim = output_dim
        self.input_dim = input_dim
        self.left_context = left_context
        self.disc_updates = disc_updates
        self.gen_updates = gen_updates
        self.l2_scale = l2_scale
        self.ema_decay = ema_decay
        self.d_conditioned = d_conditioned
        self.frame_mode = frame_mode
        self.share_g_forward = share_g_forward  # None = auto
        self.g_tx = make_optimizer(g_optimizer, max_grad_norm)
        self.d_tx = make_optimizer(d_optimizer, max_grad_norm)

    # -- model application helpers -----------------------------------------

    def _g_apply(self, g_params, inputs, lengths, train, dropout_rng):
        rngs = {"dropout": dropout_rng} if dropout_rng is not None else None
        if self.frame_mode:
            return self.generator.apply({"params": g_params}, inputs,
                                        train=train, rngs=rngs)
        return self.generator.apply({"params": g_params}, inputs, lengths,
                                    train, rngs=rngs)

    def _d_input(self, inputs, target):
        """What D sees for a given target (labels or G output)."""
        if not self.d_conditioned:
            return target  # flagship: D on labels vs G output only
        # frame GAN: concat center input frame with the target (gan.py:159-174)
        start = self.input_dim * self.left_context
        center = jax.lax.slice_in_dim(inputs, start, start + self.input_dim,
                                      axis=-1)
        return jnp.concatenate([center, target], axis=-1)

    def _d_apply(self, d_params, inputs, target, lengths, noise_std, train,
                 noise_rng):
        x = self._d_input(inputs, target)
        rngs = {}
        if noise_rng is not None:
            rngs["noise"] = noise_rng
            if train:  # D dropout (keep_prob < 1) draws from its own stream
                rngs["dropout"] = jax.random.fold_in(noise_rng, 1)
        rngs = rngs or None
        if self.frame_mode:
            return self.discriminator.apply({"params": d_params}, x,
                                            train=train, rngs=rngs)
        return self.discriminator.apply({"params": d_params}, x, lengths,
                                        noise_std, train, rngs=rngs)

    # -- state construction -------------------------------------------------

    def init_state(self, rng, example_inputs, example_lengths=None
                   ) -> GanState:
        g_rng, d_rng = jax.random.split(rng)
        if self.frame_mode:
            g_vars = self.generator.init(g_rng, example_inputs)
            g_out = self.generator.apply(g_vars, example_inputs)
            d_vars = self.discriminator.init(
                d_rng, self._d_input(example_inputs, g_out))
        else:
            g_vars = self.generator.init(g_rng, example_inputs,
                                         example_lengths)
            g_out = self.generator.apply(g_vars, example_inputs,
                                         example_lengths)
            d_vars = self.discriminator.init(
                d_rng, self._d_input(example_inputs, g_out),
                example_lengths)
        return GanState(
            g=NetState.create(g_vars["params"], self.g_tx),
            d=NetState.create(d_vars["params"], self.d_tx),
            step=jnp.zeros((), jnp.int32))

    # -- losses --------------------------------------------------------------

    def _d_loss_fn(self, d_params, g_out, inputs, labels, lengths, hp,
                   rngs, train=True):
        # D(real) and D(fake) share weights and have no cross-sample
        # coupling (no batch norm in either GanTrainer discriminator), so
        # they run as ONE forward on the batch-stacked input: the LSTM
        # recurrence is latency-bound, so 2B rows cost the same wall-clock
        # as B. Per-half loss means are computed after splitting, so the
        # math matches the two-forward formulation exactly (up to the
        # gaussian-noise stream, which is iid either way).
        rl_rng, _ = rngs
        b = labels.shape[0]
        both = jnp.concatenate([labels, g_out], axis=0)
        inputs2 = (jnp.concatenate([inputs, inputs], axis=0)
                   if self.d_conditioned else inputs)
        lengths2 = (jnp.concatenate([lengths, lengths], axis=0)
                    if lengths is not None else None)
        d_both = self._d_apply(d_params, inputs2, both, lengths2,
                               hp["disc_noise_std"], train, rl_rng)
        d_rl, d_fk = d_both[:b], d_both[b:]
        d_rl_loss, d_fk_loss, d_loss = lsgan_d_losses(
            d_rl, d_fk, hp["d_real"], hp["d_fake"])
        metrics = {"d_rl_loss": d_rl_loss, "d_fk_loss": d_fk_loss,
                   "d_loss": d_loss}
        return d_loss, (metrics, d_fk)

    def _g_loss_fn(self, g_params, d_params, inputs, labels, lengths, hp,
                   rngs):
        dropout_rng, fk_rng = rngs
        g_out = self._g_apply(g_params, inputs, lengths, True, dropout_rng)
        d_fk = self._d_apply(d_params, inputs, g_out, lengths,
                             hp["disc_noise_std"], True, fk_rng)
        adv = lsgan_g_adv_loss(d_fk, hp["d_real"])
        mse = g_mse_loss(g_out, labels, self.output_dim)
        l2 = l2_loss_nonbias(g_params, self.l2_scale)
        g_loss = adv + hp["mse_lambda"] * mse + l2
        return g_loss, {"g_adv_loss": adv, "g_mse_loss": mse,
                        "g_l2_loss": l2, "g_loss": g_loss}

    # -- steps ----------------------------------------------------------------

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_step(self, state: GanState, inputs, labels, lengths, hp, rng):
        """disc_updates D steps + gen_updates G steps on one batch."""
        return self._train_step_impl(state, inputs, labels, lengths, hp,
                                     rng)

    def _train_step_impl(self, state: GanState, inputs, labels, lengths,
                         hp, rng):
        metrics = {}
        rngs = jax.random.split(rng, 3 * self.disc_updates
                                + 3 * self.gen_updates)
        r = iter(range(len(rngs)))

        # When G is deterministic given its params (no dropout — the
        # flagship config), every D step's fake input and the FIRST G
        # step's forward are the same computation on the same G params.
        # Compute it once with jax.vjp: the D steps reuse the primal, the
        # first G step pulls its parameter gradient back through the saved
        # linearization instead of re-running forward+backward from x.
        share = self._share_g_forward()

        if share:
            dropout_rng = rngs[next(r)]
            g_out, g_vjp = jax.vjp(
                lambda p: self._g_apply(p, inputs, lengths, True,
                                        dropout_rng),
                state.g.params)
            g_out_const = jax.lax.stop_gradient(g_out)

        for _ in range(self.disc_updates):
            if share:
                fake = g_out_const
            else:
                dropout_rng = rngs[next(r)]
                fake = jax.lax.stop_gradient(self._g_apply(
                    state.g.params, inputs, lengths, True, dropout_rng))
            (_, (m, _)), grads = jax.value_and_grad(
                self._d_loss_fn, has_aux=True)(
                    state.d.params, fake, inputs, labels, lengths, hp,
                    (rngs[next(r)], rngs[next(r)]))
            state = state.replace(d=state.d.apply_gradients(
                grads, self.d_tx, hp["d_lr"], self.ema_decay))
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v / self.disc_updates

        for g_iter in range(self.gen_updates):
            if share and g_iter == 0:
                d_params = state.d.params
                fk_rng = rngs[next(r)]
                _ = next(r)

                def head(g_out):
                    d_fk = self._d_apply(d_params, inputs, g_out, lengths,
                                         hp["disc_noise_std"], True, fk_rng)
                    adv = lsgan_g_adv_loss(d_fk, hp["d_real"])
                    mse = g_mse_loss(g_out, labels, self.output_dim)
                    return adv + hp["mse_lambda"] * mse, (adv, mse)

                (_, (adv, mse)), dgout = jax.value_and_grad(
                    head, has_aux=True)(g_out)
                (grads,) = g_vjp(dgout)
                l2 = l2_loss_nonbias(state.g.params, self.l2_scale)
                if self.l2_scale > 0.0:
                    l2_grads = jax.grad(l2_loss_nonbias)(state.g.params,
                                                         self.l2_scale)
                    grads = jax.tree.map(jnp.add, grads, l2_grads)
                m = {"g_adv_loss": adv, "g_mse_loss": mse,
                     "g_l2_loss": l2,
                     "g_loss": adv + hp["mse_lambda"] * mse + l2}
            else:
                (_, m), grads = jax.value_and_grad(
                    self._g_loss_fn, has_aux=True)(
                        state.g.params, state.d.params, inputs, labels,
                        lengths, hp, (rngs[next(r)], rngs[next(r)]))
                _ = next(r)
            state = state.replace(g=state.g.apply_gradients(
                grads, self.g_tx, hp["g_lr"], self.ema_decay))
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v / self.gen_updates

        state = state.replace(step=state.step + 1)
        return state, metrics

    def _share_g_forward(self) -> bool:
        """Safe iff G has no sample-dependent stochastic layers (dropout).
        Matches the reference exactly in that case: its D-step and G-step
        sess.runs recompute identical G forwards (same variables, same
        feed_dict, keep_prob 1.0)."""
        if self.share_g_forward is not None:
            return bool(self.share_g_forward)
        if self.disc_updates < 1 or self.gen_updates < 1:
            return False
        keep_prob = getattr(self.generator, "keep_prob", 1.0)
        return float(keep_prob) >= 1.0

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def d_step(self, state: GanState, inputs, labels, lengths, hp, rng):
        """One discriminator update alone (graph-fed trainer semantics:
        models/gan_rnn.py feeds D and G from DIFFERENT minibatches)."""
        rngs = jax.random.split(rng, 3)
        g_out = jax.lax.stop_gradient(
            self._g_apply(state.g.params, inputs, lengths, True, rngs[0]))
        (_, (m, _)), grads = jax.value_and_grad(
            self._d_loss_fn, has_aux=True)(
            state.d.params, g_out, inputs, labels, lengths, hp,
            (rngs[1], rngs[2]))
        state = state.replace(d=state.d.apply_gradients(
            grads, self.d_tx, hp["d_lr"], self.ema_decay))
        return state, m

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def g_step(self, state: GanState, inputs, labels, lengths, hp, rng):
        """One generator update alone (graph-fed trainer semantics)."""
        rngs = jax.random.split(rng, 2)
        (_, m), grads = jax.value_and_grad(self._g_loss_fn, has_aux=True)(
            state.g.params, state.d.params, inputs, labels, lengths, hp,
            (rngs[0], rngs[1]))
        state = state.replace(
            g=state.g.apply_gradients(grads, self.g_tx, hp["g_lr"],
                                      self.ema_decay),
            step=state.step + 1)
        return state, m

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_multi_step(self, state: GanState, inputs, labels, lengths,
                         hp, rng):
        """N train steps under one jit: scan over stacked same-bucket
        batches (inputs [N,B,T,D], labels [N,B,T,out], lengths [N,B]).

        Amortizes per-call host->device dispatch; semantically identical
        to N train_step calls in sequence. Same-bucket grouping matches
        the reference's group_by_window batching, so optimization order
        stays equivalent.
        """
        n = inputs.shape[0]
        rngs = jax.random.split(rng, n)

        def body(state, scan_in):
            xi, yi, li, ri = scan_in
            state, metrics = self._train_step_impl(state, xi, yi, li, hp,
                                                   ri)
            return state, metrics

        state, metrics = jax.lax.scan(body, state,
                                      (inputs, labels, lengths, rngs))
        return state, jax.tree.map(jnp.mean, metrics)

    @functools.partial(jax.jit, static_argnums=(0, 8, 9, 10, 11, 12),
                       donate_argnums=1)
    def train_multi_step_gathered(self, state: GanState, inputs_tbl,
                                  labels_tbl, starts, lengths, hp, rng,
                                  t_pad: int, left: int, right: int,
                                  in_dim: int = None, out_dim: int = None):
        """N train steps with ON-DEVICE batch assembly from resident
        tables (rsrgan_jax/data/device_feed.py): ``starts``/``lengths`` are
        [S, B] int32 plans; each scan step gathers its [B, t_pad, D] batch
        from HBM instead of receiving it from the host. Semantically
        identical to N ``train_step`` calls on host-materialized batches
        (tests/test_device_feed.py proves bit-equality)."""
        n = starts.shape[0]
        rngs = jax.random.split(rng, n)

        def body(state, scan_in):
            st, le, ri = scan_in
            x, y = assemble_sequence_batch(inputs_tbl, labels_tbl, st, le,
                                           t_pad, left, right,
                                           in_dim, out_dim)
            return self._train_step_impl(state, x, y, le, hp, ri)

        state, metrics = jax.lax.scan(body, state, (starts, lengths, rngs))
        return state, jax.tree.map(jnp.mean, metrics)

    @functools.partial(jax.jit, static_argnums=(0, 8, 9, 10, 11, 12))
    def eval_multi_step_gathered(self, state: GanState, inputs_tbl,
                                 labels_tbl, starts, lengths, hp, rng,
                                 t_pad: int, left: int, right: int,
                                 in_dim: int = None, out_dim: int = None):
        """N eval steps with on-device batch assembly; returns the metric
        means over the S plans (equal batch sizes -> equal weights)."""
        n = starts.shape[0]
        rngs = jax.random.split(rng, n)

        def body(carry, scan_in):
            st, le, ri = scan_in
            x, y = assemble_sequence_batch(inputs_tbl, labels_tbl, st, le,
                                           t_pad, left, right,
                                           in_dim, out_dim)
            return carry, self._eval_step_impl(state, x, y, le, hp, ri)

        _, metrics = jax.lax.scan(body, 0, (starts, lengths, rngs))
        return jax.tree.map(jnp.mean, metrics)

    @functools.partial(jax.jit, static_argnums=0)
    def eval_step(self, state: GanState, inputs, labels, lengths, hp, rng):
        return self._eval_step_impl(state, inputs, labels, lengths, hp, rng)

    def _eval_step_impl(self, state: GanState, inputs, labels, lengths, hp,
                        rng):
        """All losses, no updates (eval_one_iteration parity: noise active,
        dropout off)."""
        rngs = jax.random.split(rng, 3)
        g_out = self._g_apply(state.g.params, inputs, lengths, False, None)
        _, (d_m, d_fk) = self._d_loss_fn(state.d.params, g_out, inputs,
                                         labels, lengths, hp,
                                         (rngs[0], rngs[1]), train=False)
        adv = lsgan_g_adv_loss(d_fk, hp["d_real"])
        mse = g_mse_loss(g_out, labels, self.output_dim)
        g_loss = adv + hp["mse_lambda"] * mse
        return {**d_m, "g_adv_loss": adv, "g_mse_loss": mse,
                "g_l2_loss": jnp.zeros(()), "g_loss": g_loss}

    @functools.partial(jax.jit, static_argnums=0)
    def infer_step(self, g_params, inputs, lengths):
        """Generator forward only (decode path, infer=True parity)."""
        return self._g_apply(g_params, inputs, lengths, False, None)
