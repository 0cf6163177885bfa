"""Streaming (chunked) enhancement for the causal generator zoo.

The reference enhances whole utterances offline (batch-1 decode,
scripts/train_gan_rnn_placeholder.py:279-291). For online serving a
dereverberation front-end must process audio in small chunks with bounded
latency. Every LSTM generator is causal (unidirectional LSTMs + per-frame
dense), so chunked processing with carried recurrent state is EXACT: this
module recomputes the generator forward from the trained parameter tree
with explicit (c, h) state threading and a jitted per-chunk step, through
the same LSTM layer the training path runs (rsrgan_jax/ops/lstm.py).

Supported wirings. The constructor validates the checkpoint's parameter
tree against the variant's expected shape (cell count, dense heads,
peephole/projection params), so structurally mismatched checkpoints
raise. Caveat: ``res_lstm_l`` and ``res_lstm_base`` have IDENTICAL tree
shapes (they differ only in residual wiring), which no tree check can
distinguish — `cli/serve.py` closes that hole by validating ``--g_type``
against the checkpoint's ``.meta.json`` sidecar
(training/checkpoints.py).

* ``res_lstm_l``  — 4 layers, layer residual (models/res_lstm_l.py)
* ``res_lstm_base`` — 4 stacked layers, no residual (res_lstm_base.py)
* ``res_lstm_i``  — 2 layers, input residual (res_lstm_i.py)
* ``lstm``        — leakyrelu input projection + 3 stacked cells
  (models/lstm.py)

``bnlstm`` is rejected: its recurrent batch-norm cell depends on per-step
moving statistics that the plain LSTM recurrence cannot reproduce.

Usage::

    enhancer = StreamingEnhancer(params, variant="res_lstm_l")
    state = enhancer.init_state(batch=1)
    for chunk in chunks:                         # [B, T_chunk, 257]
        out, state = enhancer.step(chunk, state) # [B, T_chunk, 40]
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp

from rsrgan_jax.ops.common import leakyrelu
from rsrgan_jax.ops.lstm import dense, lstm_layer

_RES_VARIANTS = ("res_lstm_l", "res_lstm_base", "res_lstm_i")
SUPPORTED_VARIANTS = _RES_VARIANTS + ("lstm",)


@functools.partial(jax.jit,
                   static_argnames=("variant", "num_layers", "forget_bias"))
def _stream_step(params, state, chunk, variant, num_layers, forget_bias,
                 lengths=None):
    new_state = []

    def run_cell(cell_params, k, seq):
        out, carry = lstm_layer(cell_params, seq, lengths, state=state[k],
                                forget_bias=forget_bias)
        new_state.append(carry)
        return out

    x = chunk
    if variant == "lstm":
        h = leakyrelu(dense(params["Dense_0"], x))
        cells = params["StackedLstm_0"]
        for k in range(num_layers):
            h = run_cell(cells[f"cell_{k}"], k, h)
        y = dense(params["Dense_1"], h)
    else:
        layer_in = x
        for k in range(num_layers):
            out = run_cell(params[f"lstm_cell_{k + 1}"], k, layer_in)
            if variant == "res_lstm_l":
                layer_in = out + layer_in  # layer residual
            elif variant == "res_lstm_i":
                layer_in = out + x  # input residual (original inputs)
            else:  # res_lstm_base: plain stack
                layer_in = out
        y = dense(params["forward_out"], layer_in)
    if lengths is not None:
        # residual wiring and biases leak input past the mask; zero it so
        # masked lanes visibly produce no output
        valid = jnp.arange(x.shape[1])[None, :] < lengths[:, None]
        y = jnp.where(valid[:, :, None], y, 0.0)
    return y, new_state


class StreamingEnhancer:
    """Chunked generator forward with carried state, variant-aware."""

    def __init__(self, params, variant: str = "res_lstm_l",
                 forget_bias: float = 1.0):
        """``params``: the generator's param dict, e.g.
        ``state.g.params`` from a checkpoint. Params stay TRACED arguments
        of the jitted step (hot-swappable; no giant baked-in constants).

        Raises ``ValueError`` when ``variant`` is unsupported or the
        parameter tree does not match the variant's expected wiring.
        """
        if variant not in SUPPORTED_VARIANTS:
            raise ValueError(
                f"StreamingEnhancer does not support variant {variant!r} "
                f"(supported: {SUPPORTED_VARIANTS}); bnlstm's recurrent "
                "batch-norm cannot be streamed exactly")
        self.params = params
        self.variant = variant
        self.forget_bias = float(forget_bias)

        if variant == "lstm":
            stack = params.get("StackedLstm_0")
            if (stack is None or "Dense_0" not in params
                    or "Dense_1" not in params):
                raise ValueError(
                    "parameter tree does not look like models/lstm.py "
                    "(expected Dense_0 + StackedLstm_0 + Dense_1; got "
                    f"{sorted(params)})")
            self._cells = [stack[f"cell_{k}"]
                           for k in range(len(
                               [k for k in stack if k.startswith("cell_")]))]
        else:
            names = sorted(k for k in params if k.startswith("lstm_cell_"))
            expected = 2 if variant == "res_lstm_i" else 4
            if len(names) != expected or "forward_out" not in params:
                raise ValueError(
                    f"parameter tree does not match {variant} (expected "
                    f"{expected} lstm_cell_* + forward_out; got "
                    f"{sorted(params)})")
            self._cells = [params[n] for n in names]
        for cell in self._cells:
            missing = {"kernel", "bias", "proj_kernel", "w_i_diag",
                       "w_f_diag", "w_o_diag"} - set(cell)
            if missing:
                raise ValueError(
                    f"LSTM cell params missing {sorted(missing)} — not a "
                    "peephole-projection cell checkpoint")
        self.num_layers = len(self._cells)
        self.num_units = self._cells[0]["proj_kernel"].shape[0]
        self.num_proj = self._cells[0]["proj_kernel"].shape[1]

    def init_state(self, batch: int) -> List[Tuple[jnp.ndarray, jnp.ndarray]]:
        return [(jnp.zeros((batch, c["proj_kernel"].shape[0]), jnp.float32),
                 jnp.zeros((batch, c["proj_kernel"].shape[1]), jnp.float32))
                for c in self._cells]

    def step(self, chunk: jnp.ndarray, state, lengths=None):
        """[B, T_chunk, P] -> ([B, T_chunk, out], new state).

        Exact continuation: feeding chunks back-to-back reproduces the
        whole-utterance forward bit-for-bit (see tests).

        ``lengths`` ([B] int, optional) marks per-lane valid frame counts:
        a lane's recurrent state freezes after its length, and its outputs
        beyond it are zeros to be discarded. This lets independent streams
        of uneven progress share one batched compiled step (StreamPool).
        With ``lengths=None`` (or all-full lengths) the step is the
        unmasked program — results are identical, proven in tests.
        """
        if lengths is not None:
            lengths = jnp.asarray(lengths, jnp.int32)
        return _stream_step(self.params, state, chunk, self.variant,
                            self.num_layers, self.forget_bias,
                            lengths=lengths)
