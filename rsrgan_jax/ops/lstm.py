"""Peephole + projection LSTM over plain parameter pytrees.

Functional equivalent of ``tf.contrib.rnn.LSTMCell(num_units,
use_peepholes=True, num_proj=..., forget_bias=1.0, activation=tanh)`` driven
by ``tf.nn.dynamic_rnn(sequence_length=...)`` — the recurrent workhorse of
the reference's generators and discriminators
(/root/reference/models/res_lstm_l.py:86-93,104-108,
/root/reference/models/discriminator_lstm.py:70-91).

* The input projection ``x @ W_x`` for ALL timesteps is hoisted out of the
  recurrence into one [T*B, D] x [D, 4U] matmul, so the ``lax.scan`` body
  only holds the [B, P] x [P, 4U] recurrent matmul, the [B, U] x [U, P]
  projection and the gate math.
* Sequence-major ``[T, B, ...]`` layout inside the scan, batch-major at the
  boundary to match the reference's ``[B, T, D]`` API.
* Length masking reproduces dynamic_rnn semantics exactly: past a
  sequence's end the carried state freezes and emitted outputs are zero.
* Gate order matches TF's (i, j, f, o) and the combined [D+P, 4U] kernel is
  glorot-initialized as one matrix, like TF's single ``kernel`` variable, so
  initialization statistics line up.

``lstm_layer`` is the one definition of the cell: training, decode and the
streaming server (serving/streaming.py) all run it.

The module classes keep the calling convention the trainers use:
``init(key, inputs, ...) -> {"params": tree}`` and
``apply({"params": tree}, inputs, ..., rngs={...})``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

GLOROT = jax.nn.initializers.glorot_uniform()
_ZEROS = jax.nn.initializers.zeros


class Model:
    """Flax-style entry points over a subclass's ``init_params(key,
    input_dim)`` and ``__call__(params, inputs, ..., rngs=...)``."""

    def init(self, key, inputs, *unused_args, **unused_kwargs):
        """Parameters for ``inputs``' feature width (its last axis)."""
        return {"params": self.init_params(key, inputs.shape[-1])}

    def apply(self, variables, *args, rngs=None, **kwargs):
        return self(variables["params"], *args, rngs=rngs or {}, **kwargs)


def init_dense(key, in_dim: int, out_dim: int, kernel_init=GLOROT) -> dict:
    return {"kernel": kernel_init(key, (in_dim, out_dim), jnp.float32),
            "bias": _ZEROS(key, (out_dim,), jnp.float32)}


def dense(params, x):
    return x @ params["kernel"] + params["bias"]


def dropout(rngs, site: int, x, keep_prob: float):
    """Inverted dropout keeping ``keep_prob``; ``site`` separates the
    streams of the call sites that share one 'dropout' key."""
    if "dropout" not in rngs:
        raise ValueError("dropout in train mode needs rngs={'dropout': key}")
    keep = jax.random.bernoulli(jax.random.fold_in(rngs["dropout"], site),
                                keep_prob, x.shape)
    return jnp.where(keep, x / keep_prob, 0.0)


def init_cell(key, input_dim: int, num_units: int, num_proj: int) -> dict:
    """LSTMCell variables: combined [D+P, 4U] kernel, bias, [U, P]
    projection and the three peephole diagonals."""
    k_kernel, k_proj, k_i, k_f, k_o = jax.random.split(key, 5)
    U, P = num_units, num_proj
    return {
        "kernel": GLOROT(k_kernel, (input_dim + P, 4 * U), jnp.float32),
        "bias": _ZEROS(key, (4 * U,), jnp.float32),
        "proj_kernel": GLOROT(k_proj, (U, P), jnp.float32),
        "w_i_diag": GLOROT(k_i, (1, U), jnp.float32),
        "w_f_diag": GLOROT(k_f, (1, U), jnp.float32),
        "w_o_diag": GLOROT(k_o, (1, U), jnp.float32),
    }


def lstm_layer(params, inputs: jnp.ndarray,
               lengths: Optional[jnp.ndarray] = None, *,
               state: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
               compute_dtype: Any = jnp.float32,
               forget_bias: float = 1.0):
    """One LSTM layer scanned over time.

    (inputs [B, T, D], lengths [B] or None, state (c [B, U], h [B, P]) or
    zeros) -> (outputs [B, T, P], final state). Matmuls run in
    ``compute_dtype``; state and gate math stay float32.
    """
    B, T, D = inputs.shape
    U, P = params["proj_kernel"].shape
    cdt = compute_dtype
    w_x, w_h = params["kernel"][:D], params["kernel"][D:]
    bias = params["bias"]
    w_i = params["w_i_diag"][0]
    w_f = params["w_f_diag"][0]
    w_o = params["w_o_diag"][0]

    xw = jnp.einsum("btd,du->tbu", inputs.astype(cdt), w_x.astype(cdt)
                    ).astype(jnp.float32)  # [T, B, 4U]
    if lengths is not None:
        step_mask = (jnp.arange(T)[:, None]
                     < lengths[None, :].astype(jnp.int32))  # [T, B]
    else:
        step_mask = jnp.ones((T, B), dtype=bool)
    w_h_c = w_h.astype(cdt)
    proj_c = params["proj_kernel"].astype(cdt)

    def step(carry, scan_in):
        c_prev, h_prev = carry  # [B, U] f32, [B, P] f32
        xw_t, mask_t = scan_in  # [B, 4U], [B]
        gates = xw_t + (h_prev.astype(cdt) @ w_h_c).astype(jnp.float32)
        i, j, f, o = jnp.split(gates + bias, 4, axis=1)
        c = (jax.nn.sigmoid(f + forget_bias + w_f * c_prev) * c_prev
             + jax.nn.sigmoid(i + w_i * c_prev) * jnp.tanh(j))
        m = jax.nn.sigmoid(o + w_o * c) * jnp.tanh(c)
        h = (m.astype(cdt) @ proj_c).astype(jnp.float32)

        keep = mask_t[:, None]
        c = jnp.where(keep, c, c_prev)
        h_state = jnp.where(keep, h, h_prev)
        return (c, h_state), jnp.where(keep, h, 0.0)

    if state is None:
        state = (jnp.zeros((B, U), jnp.float32),
                 jnp.zeros((B, P), jnp.float32))
    # the scope names the recurrence's ops in profiles (tools/profile_step.py)
    with jax.named_scope("lstm_recurrence"):
        state, outputs = jax.lax.scan(step, state, (xw, step_mask))
    return jnp.swapaxes(outputs, 0, 1), state  # [B, T, P]


@dataclasses.dataclass(frozen=True)
class LstmCellP(Model):
    """One LSTM layer with peepholes + projection, scanned over time.

    Call: (params, inputs [B, T, D], lengths [B] or None) -> [B, T, P].
    """

    num_units: int
    num_proj: int
    forget_bias: float = 1.0
    compute_dtype: Any = jnp.float32

    def init_params(self, key, input_dim: int) -> dict:
        return init_cell(key, input_dim, self.num_units, self.num_proj)

    def __call__(self, params, inputs, lengths=None, *, rngs=None):
        return lstm_layer(params, inputs, lengths,
                          compute_dtype=self.compute_dtype,
                          forget_bias=self.forget_bias)[0]


@dataclasses.dataclass(frozen=True)
class StackedLstm(Model):
    """MultiRNNCell equivalent: N stacked cells ``cell_0..cell_{N-1}``,
    with dropout after each layer in training when keep_prob < 1."""

    num_layers: int
    num_units: int
    num_proj: int
    compute_dtype: Any = jnp.float32
    dropout_keep_prob: float = 1.0

    def init_params(self, key, input_dim: int) -> dict:
        keys = jax.random.split(key, self.num_layers)
        return {f"cell_{k}": init_cell(keys[k],
                                       input_dim if k == 0 else self.num_proj,
                                       self.num_units, self.num_proj)
                for k in range(self.num_layers)}

    def __call__(self, params, inputs, lengths=None, train: bool = False, *,
                 rngs=None):
        h = inputs
        for k in range(self.num_layers):
            h = lstm_layer(params[f"cell_{k}"], h, lengths,
                           compute_dtype=self.compute_dtype)[0]
            if train and self.dropout_keep_prob < 1.0:
                h = dropout(rngs, k, h, self.dropout_keep_prob)
        return h
