"""Streaming enhancer: chunked forward == whole-utterance forward, for
every supported generator wiring; mismatched checkpoints are rejected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsrgan_jax.models.recurrent import LstmGenerator, ResLstmGenerator
from rsrgan_jax.serving import StreamingEnhancer

B, T, P, OUT = 2, 24, 7, 3

CHUNKS = ((0, 5), (5, 11), (16, 8))  # uneven chunk sizes


def _make(variant, rng):
    if variant == "lstm":
        gen = LstmGenerator(output_dim=OUT, cell_size=11, num_projection=5)
    else:
        gen = ResLstmGenerator(output_dim=OUT, variant=variant[9:] or "l",
                               cell_size=11)
    x = jnp.asarray(rng.normal(size=(B, T, P)), jnp.float32)
    lens = jnp.full((B,), T, jnp.int32)
    variables = gen.init(jax.random.PRNGKey(0), x, lens)
    full = np.asarray(gen.apply(variables, x, lens))
    return variables["params"], x, full


@pytest.mark.parametrize("variant", ["res_lstm_l", "res_lstm_base",
                                     "res_lstm_i", "lstm"])
def test_chunked_matches_full(variant, rng):
    params, x, full = _make(variant, rng)
    enhancer = StreamingEnhancer(params, variant=variant)
    state = enhancer.init_state(B)
    outs = []
    for start, size in CHUNKS:
        out, state = enhancer.step(x[:, start:start + size], state)
        outs.append(np.asarray(out))
    chunked = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(chunked, full, atol=1e-5)


def test_state_isolation(rng):
    """Independent streams don't leak state across init_state calls."""
    params, x, _ = _make("res_lstm_l", rng)
    enh = StreamingEnhancer(params)
    out1, _ = enh.step(x, enh.init_state(B))
    _, carried = enh.step(x, enh.init_state(B))
    out2, _ = enh.step(x, enh.init_state(B))
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
    out3, _ = enh.step(x, carried)  # warm state -> different output
    assert not np.allclose(np.asarray(out1), np.asarray(out3))


def test_rejects_wrong_variant_tree(rng):
    """A res_lstm_l checkpoint fed as res_lstm_i (and vice versa) raises
    instead of silently producing wrong output (round-1 weakness)."""
    params_l, _, _ = _make("res_lstm_l", rng)
    with pytest.raises(ValueError, match="does not match res_lstm_i"):
        StreamingEnhancer(params_l, variant="res_lstm_i")
    params_i, _, _ = _make("res_lstm_i", rng)
    with pytest.raises(ValueError, match="does not match res_lstm_l"):
        StreamingEnhancer(params_i, variant="res_lstm_l")
    with pytest.raises(ValueError, match="lstm.py"):
        StreamingEnhancer(params_l, variant="lstm")


def test_rejects_bnlstm(rng):
    from rsrgan_jax.models.bnlstm import BnLstmGenerator

    gen = BnLstmGenerator(output_dim=OUT, cell_size=8, num_projection=5,
                          num_layers=2)
    x = jnp.asarray(rng.normal(size=(B, T, P)), jnp.float32)
    variables = gen.init(jax.random.PRNGKey(0), x,
                         jnp.full((B,), T, jnp.int32))
    with pytest.raises(ValueError, match="bnlstm"):
        StreamingEnhancer(variables["params"], variant="bnlstm")
