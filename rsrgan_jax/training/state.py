"""Train-state containers, optimizers and EMA.

Optimizer conventions copied from the reference:

* gradients are averaged over the global batch (== tower averaging,
  utils/ops.py:343-376), then each tensor is clipped to norm
  ``max_grad_norm`` (tf.clip_by_norm semantics, per-tensor, models/
  gan_rnn_placeholder.py:176-182) BEFORE the optimizer transform;
* Adam uses TF defaults (b1 0.9, b2 0.999, eps 1e-8) with bias correction;
* an EMA shadow (decay 0.9999, models/gan_rnn_placeholder.py:70,148-150)
  tracks every trainable and can be swapped in for evaluation/decode
  (``load(..., moving_average=True)`` parity).

Learning rates are traced scalars passed into each step (the reference's
assignable LR variables), so schedule changes never trigger recompilation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax


def clip_by_norm_each(max_norm: Optional[float]):
    """Per-tensor norm clip, tf.clip_by_norm parity: t * c / max(c, ||t||)."""

    def init_fn(params):
        del params
        return optax.EmptyState()

    def update_fn(updates, state, params=None):
        del params
        if max_norm is None:
            return updates, state

        def clip(t):
            norm = jnp.sqrt(jnp.sum(jnp.square(t)))
            return t * (max_norm / jnp.maximum(norm, max_norm))

        return jax.tree.map(clip, updates), state

    return optax.GradientTransformation(init_fn, update_fn)


def make_optimizer(name: str, max_grad_norm: Optional[float] = None
                   ) -> optax.GradientTransformation:
    """Scale-free transform; the step multiplies by -lr afterwards."""
    if name == "adam":
        core = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    elif name == "sgd":
        core = optax.identity()
    elif name == "rmsprop":
        core = optax.scale_by_rms(decay=0.9, eps=1e-10)  # TF RMSProp defaults
    else:
        raise ValueError(f"unknown optimizer {name}")
    return optax.chain(clip_by_norm_each(max_grad_norm), core)


def apply_updates_with_lr(params, updates, lr):
    """params - lr * updates (updates already optimizer-transformed)."""
    return jax.tree.map(lambda p, u: p - lr * u, params, updates)


def ema_update(ema, params, decay: float):
    """shadow -= (1-decay) * (shadow - param), TF ExponentialMovingAverage."""
    return jax.tree.map(lambda e, p: e - (1.0 - decay) * (e - p), ema, params)


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree (every field is a child),
    with ``replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self,
                                                              **changes)
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class NetState:
    """One network's trainable state: params + optimizer state + EMA shadow."""

    params: Any
    opt_state: Any
    ema: Any
    extra: Any = None  # mutable collections (e.g. bnlstm batch_stats)

    @classmethod
    def create(cls, params, tx: optax.GradientTransformation, extra=None):
        return cls(params=params, opt_state=tx.init(params),
                   ema=jax.tree.map(jnp.array, params), extra=extra)

    def apply_gradients(self, grads, tx, lr, ema_decay: float):
        updates, new_opt = tx.update(grads, self.opt_state, self.params)
        new_params = apply_updates_with_lr(self.params, updates, lr)
        new_ema = ema_update(self.ema, new_params, ema_decay)
        return self.replace(params=new_params, opt_state=new_opt,
                            ema=new_ema)
