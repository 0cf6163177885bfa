"""Model zoo + registry.

``get_generator(g_type, ...)`` mirrors the reference's string dispatch
(models/gan_rnn_placeholder.py:125-132, rnn_trainer.py:97-108,
dnn_trainer.py:94-101). Sequence generators take (inputs [B,T,D], lengths,
train); frame generators take spliced frames.

The LSTM models (lstm, res_lstm_*, the LSTM discriminator) are plain JAX.
The others (bnlstm, dnn/rced/cnn, the DNN discriminator) are written with
flax and imported only when chosen.
"""

from __future__ import annotations

import importlib
from typing import Any

import jax.numpy as jnp

from rsrgan_jax.models.discriminators import LstmDiscriminator
from rsrgan_jax.models.recurrent import LstmGenerator, ResLstmGenerator

SEQUENCE_G_TYPES = ("lstm", "bnlstm", "res_lstm_base", "res_lstm_i",
                    "res_lstm_l")
FRAME_G_TYPES = ("dnn", "rced", "cnn")


def _flax_model(module: str, name: str):
    """``rsrgan_jax.models.<module>.<name>``, a flax model: fail with the
    package's name when flax is not installed."""
    try:
        import flax.linen  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{name} is written with flax; install the 'flax' "
                          "package to use it") from e
    return getattr(importlib.import_module(f"rsrgan_jax.models.{module}"),
                   name)


def get_generator(g_type: str, *, input_dim: int, output_dim: int,
                  left_context: int = 0, right_context: int = 0,
                  keep_prob: float = 1.0, batch_norm: bool = False,
                  compute_dtype: Any = jnp.float32):
    splice = left_context + 1 + right_context
    if g_type == "lstm":
        return LstmGenerator(output_dim=output_dim, keep_prob=keep_prob,
                             compute_dtype=compute_dtype)
    if g_type in ("res_lstm_base", "res_lstm_i", "res_lstm_l"):
        return ResLstmGenerator(output_dim=output_dim,
                                variant=g_type.rsplit("_", 1)[-1],
                                keep_prob=keep_prob,
                                compute_dtype=compute_dtype)
    if g_type == "bnlstm":
        return _flax_model("bnlstm", "BnLstmGenerator")(
            output_dim=output_dim, compute_dtype=compute_dtype)
    if g_type == "dnn":
        return _flax_model("feedforward", "DnnGenerator")(
            output_dim=output_dim, keep_prob=keep_prob,
            batch_norm=batch_norm)
    if g_type == "rced":
        return _flax_model("feedforward", "RcedGenerator")(
            output_dim=output_dim, input_dim=input_dim, splice=splice,
            batch_norm=batch_norm)
    if g_type == "cnn":
        return _flax_model("feedforward", "CnnGenerator")(
            output_dim=output_dim, input_dim=input_dim, splice=splice)
    raise ValueError(f"Unrecognized G type {g_type}")


def get_discriminator(d_type: str, *, keep_prob: float = 1.0,
                      compute_dtype: Any = jnp.float32):
    if d_type == "lstm":
        return LstmDiscriminator(keep_prob=keep_prob,
                                 compute_dtype=compute_dtype)
    if d_type == "dnn":
        return _flax_model("feedforward", "DnnDiscriminator")(
            keep_prob=keep_prob)
    raise ValueError(f"Unrecognized D type {d_type}")
