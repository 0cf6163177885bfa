"""MSE-only trainers (DNNTrainer / RNNTrainer equivalents).

models/dnn_trainer.py:107-190 and models/rnn_trainer.py:114-201 as one
jitted step: Adam, loss = 0.5*MSE*output_dim + L2(non-bias), EMA 0.9999;
the RNN variant adds per-tensor grad clip 15.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from rsrgan_jax.ops.gather import assemble_sequence_batch
from rsrgan_jax.training.losses import g_mse_loss, l2_loss_nonbias
from rsrgan_jax.training.state import (NetState, make_optimizer,
                                       pytree_dataclass)


@pytree_dataclass
class MseState:
    net: NetState
    step: jnp.ndarray


class MseTrainer:
    """Supervised trainer for any generator in the zoo.

    ``sequence_mode``: model takes (inputs, lengths); otherwise frames.
    ``batch_stats`` mutable collection (bnlstm) is threaded through
    ``NetState.extra``.
    """

    def __init__(self, generator, *, output_dim: int,
                 l2_scale: float = 0.0,
                 max_grad_norm: Optional[float] = None,
                 ema_decay: float = 0.9999,
                 optimizer: str = "adam",
                 sequence_mode: bool = True):
        self.generator = generator
        self.output_dim = output_dim
        self.l2_scale = l2_scale
        self.ema_decay = ema_decay
        self.sequence_mode = sequence_mode
        self.tx = make_optimizer(optimizer, max_grad_norm)

    def init_state(self, rng, example_inputs, example_lengths=None
                   ) -> MseState:
        if self.sequence_mode:
            variables = self.generator.init(rng, example_inputs,
                                            example_lengths)
        else:
            variables = self.generator.init(rng, example_inputs)
        variables = dict(variables)
        params = variables.pop("params")
        extra = variables or None
        return MseState(net=NetState.create(params, self.tx, extra=extra),
                        step=jnp.zeros((), jnp.int32))

    def _apply(self, params, extra, inputs, lengths, train, dropout_rng):
        variables = {"params": params, **(extra or {})}
        rngs = {"dropout": dropout_rng} if dropout_rng is not None else None
        mutable = [k for k in (extra or {})] if train else False
        kwargs = dict(rngs=rngs, mutable=mutable) if mutable else \
            dict(rngs=rngs)
        if self.sequence_mode:
            out = self.generator.apply(variables, inputs, lengths, train,
                                       **kwargs)
        else:
            out = self.generator.apply(variables, inputs, train=train,
                                       **kwargs)
        if mutable:
            return out  # (y, new_extra)
        return out, extra

    def _loss_fn(self, params, extra, inputs, labels, lengths, dropout_rng):
        g_out, new_extra = self._apply(params, extra, inputs, lengths, True,
                                       dropout_rng)
        mse = g_mse_loss(g_out, labels, self.output_dim)
        l2 = l2_loss_nonbias(params, self.l2_scale)
        return mse + l2, ({"g_mse_loss": mse, "g_l2_loss": l2,
                           "g_loss": mse + l2}, new_extra)

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_step(self, state: MseState, inputs, labels, lengths, lr, rng):
        return self._train_step_impl(state, inputs, labels, lengths, lr,
                                     rng)

    def _train_step_impl(self, state, inputs, labels, lengths, lr, rng):
        (_, (metrics, new_extra)), grads = jax.value_and_grad(
            self._loss_fn, has_aux=True)(
                state.net.params, state.net.extra, inputs, labels, lengths,
                rng)
        net = state.net.apply_gradients(grads, self.tx, lr, self.ema_decay)
        net = net.replace(extra=new_extra)
        return state.replace(net=net, step=state.step + 1), metrics

    @functools.partial(jax.jit, static_argnums=0, donate_argnums=1)
    def train_multi_step(self, state: MseState, inputs, labels, lengths,
                         lr, rng):
        """N chained steps per jit over stacked same-shape batches
        (see GanTrainer.train_multi_step)."""
        n = inputs.shape[0]
        rngs = jax.random.split(rng, n)

        def body(state, scan_in):
            xi, yi, li, ri = scan_in
            return self._train_step_impl(state, xi, yi, li, lr, ri)

        state, metrics = jax.lax.scan(
            body, state,
            (inputs, labels,
             lengths if lengths is not None else jnp.zeros((n, 1)), rngs))
        return state, jax.tree.map(jnp.mean, metrics)

    @functools.partial(jax.jit, static_argnums=(0, 8, 9, 10, 11, 12),
                       donate_argnums=1)
    def train_multi_step_gathered(self, state: MseState, inputs_tbl,
                                  labels_tbl, starts, lengths, lr, rng,
                                  t_pad: int, left: int, right: int,
                                  in_dim: int = None, out_dim: int = None):
        """N train steps with on-device batch assembly from resident
        tables ([S, B] int32 plans; see GanTrainer.train_multi_step_gathered
        and rsrgan_jax/data/device_feed.py)."""
        n = starts.shape[0]
        rngs = jax.random.split(rng, n)

        def body(state, scan_in):
            st, le, ri = scan_in
            x, y = assemble_sequence_batch(inputs_tbl, labels_tbl, st, le,
                                           t_pad, left, right,
                                           in_dim, out_dim)
            return self._train_step_impl(state, x, y, le, lr, ri)

        state, metrics = jax.lax.scan(body, state, (starts, lengths, rngs))
        return state, jax.tree.map(jnp.mean, metrics)

    @functools.partial(jax.jit, static_argnums=(0, 6, 7, 8, 9, 10))
    def eval_multi_step_gathered(self, state: MseState, inputs_tbl,
                                 labels_tbl, starts, lengths,
                                 t_pad: int, left: int, right: int,
                                 in_dim: int = None, out_dim: int = None):
        """N eval steps with on-device batch assembly (metric means)."""

        def body(carry, scan_in):
            st, le = scan_in
            x, y = assemble_sequence_batch(inputs_tbl, labels_tbl, st, le,
                                           t_pad, left, right,
                                           in_dim, out_dim)
            return carry, self._eval_step_impl(state, x, y, le)

        _, metrics = jax.lax.scan(body, 0, (starts, lengths))
        return jax.tree.map(jnp.mean, metrics)

    @functools.partial(jax.jit, static_argnums=0)
    def eval_step(self, state: MseState, inputs, labels, lengths):
        return self._eval_step_impl(state, inputs, labels, lengths)

    def _eval_step_impl(self, state: MseState, inputs, labels, lengths):
        g_out, _ = self._apply(state.net.params, state.net.extra, inputs,
                               lengths, False, None)
        mse = g_mse_loss(g_out, labels, self.output_dim)
        return {"g_mse_loss": mse, "g_l2_loss": jnp.zeros(()),
                "g_loss": mse}

    @functools.partial(jax.jit, static_argnums=0)
    def infer_step(self, state: MseState, inputs, lengths=None):
        g_out, _ = self._apply(state.net.params, state.net.extra, inputs,
                               lengths, False, None)
        return g_out

    def infer_with_params(self, params, extra, inputs, lengths=None):
        g_out, _ = self._apply(params, extra, inputs, lengths, False, None)
        return g_out
