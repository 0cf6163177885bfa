"""Model-zoo tests: LSTM cell math/masking parity, generator shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsrgan_jax.models import (FRAME_G_TYPES, SEQUENCE_G_TYPES,
                               get_discriminator, get_generator)
from rsrgan_jax.ops.lstm import LstmCellP

B, T, D_IN, D_OUT = 2, 12, 9, 4


def _np_lstm_reference(params, x, lengths, num_units, num_proj):
    """Direct float64 transcription of tf.contrib.rnn.LSTMCell with
    peepholes + projection (gate order i, j, f, o, forget_bias 1.0)."""
    kernel = np.asarray(params["kernel"], np.float64)
    bias = np.asarray(params["bias"], np.float64)
    proj = np.asarray(params["proj_kernel"], np.float64)
    w_i = np.asarray(params["w_i_diag"], np.float64)[0]
    w_f = np.asarray(params["w_f_diag"], np.float64)[0]
    w_o = np.asarray(params["w_o_diag"], np.float64)[0]

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    Bn, Tn, Dn = x.shape
    c = np.zeros((Bn, num_units))
    h = np.zeros((Bn, num_proj))
    out = np.zeros((Bn, Tn, num_proj))
    for t in range(Tn):
        concat = np.concatenate([x[:, t], h], axis=1)
        gates = concat @ kernel + bias
        i, j, f, o = np.split(gates, 4, axis=1)
        c_new = (sigmoid(f + 1.0 + w_f * c) * c
                 + sigmoid(i + w_i * c) * np.tanh(j))
        m = sigmoid(o + w_o * c_new) * np.tanh(c_new)
        h_new = m @ proj
        for b in range(Bn):
            if t < lengths[b]:
                c[b] = c_new[b]
                h[b] = h_new[b]
                out[b, t] = h_new[b]
    return out


class TestLstmCell:
    def test_matches_tf_cell_equations(self, rng):
        cell = LstmCellP(num_units=6, num_proj=5)
        x = rng.normal(size=(B, T, D_IN)).astype(np.float32)
        lengths = np.array([T, T - 4], dtype=np.int32)
        params = cell.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(lengths))["params"]
        got = np.asarray(cell.apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(lengths)))
        expect = _np_lstm_reference(params, x.astype(np.float64), lengths,
                                    6, 5)
        np.testing.assert_allclose(got, expect, atol=2e-5)

    def test_masking_semantics(self, rng):
        """dynamic_rnn parity: zero outputs after length, and changing the
        padded tail must not change valid outputs."""
        cell = LstmCellP(num_units=4, num_proj=3)
        x = rng.normal(size=(1, T, D_IN)).astype(np.float32)
        lengths = jnp.array([5], dtype=jnp.int32)
        params = cell.init(jax.random.PRNGKey(1), jnp.asarray(x), lengths)
        out1 = cell.apply(params, jnp.asarray(x), lengths)
        assert np.all(np.asarray(out1)[0, 5:] == 0)
        x2 = x.copy()
        x2[0, 5:] = 123.0  # garbage in padding
        out2 = cell.apply(params, jnp.asarray(x2), lengths)
        np.testing.assert_allclose(np.asarray(out1)[0, :5],
                                   np.asarray(out2)[0, :5], atol=1e-6)

    def test_no_lengths_means_full(self, rng):
        cell = LstmCellP(num_units=4, num_proj=3)
        x = jnp.asarray(rng.normal(size=(B, T, D_IN)), jnp.float32)
        params = cell.init(jax.random.PRNGKey(2), x, None)
        full = cell.apply(params, x, jnp.full((B,), T, jnp.int32))
        nolen = cell.apply(params, x, None)
        np.testing.assert_allclose(np.asarray(full), np.asarray(nolen),
                                   atol=1e-6)


class TestGeneratorZoo:
    @pytest.mark.parametrize("g_type", SEQUENCE_G_TYPES)
    def test_sequence_generators(self, rng, g_type):
        gen = get_generator(g_type, input_dim=D_IN, output_dim=D_OUT)
        x = jnp.asarray(rng.normal(size=(B, T, D_IN)), jnp.float32)
        lengths = jnp.array([T, T - 3], dtype=jnp.int32)
        variables = gen.init(jax.random.PRNGKey(0), x, lengths)
        y = gen.apply(variables, x, lengths)
        assert y.shape == (B, T, D_OUT)
        assert np.isfinite(np.asarray(y)).all()

    def test_bnlstm_updates_batch_stats_in_train(self, rng):
        gen = get_generator("bnlstm", input_dim=D_IN, output_dim=D_OUT)
        x = jnp.asarray(rng.normal(size=(B, T, D_IN)), jnp.float32)
        lengths = jnp.array([T, T], dtype=jnp.int32)
        variables = gen.init(jax.random.PRNGKey(0), x, lengths)
        assert "batch_stats" in variables
        y, mutated = gen.apply(variables, x, lengths, True,
                               mutable=["batch_stats"])
        before = jax.tree_util.tree_leaves(variables["batch_stats"])
        after = jax.tree_util.tree_leaves(mutated["batch_stats"])
        assert any(not np.allclose(a, b) for a, b in zip(before, after))

    @pytest.mark.parametrize("g_type", FRAME_G_TYPES)
    def test_frame_generators(self, rng, g_type):
        splice = 3
        gen = get_generator(g_type, input_dim=D_IN, output_dim=D_OUT,
                            left_context=1, right_context=1)
        x = jnp.asarray(rng.normal(size=(B * 4, splice * D_IN)), jnp.float32)
        variables = gen.init(jax.random.PRNGKey(0), x)
        y = gen.apply(variables, x)
        assert y.shape == (B * 4, D_OUT)

    def test_frame_generator_utterance_mode(self, rng):
        gen = get_generator("dnn", input_dim=D_IN, output_dim=D_OUT)
        x = jnp.asarray(rng.normal(size=(1, T, D_IN)), jnp.float32)
        variables = gen.init(jax.random.PRNGKey(0), x)
        y = gen.apply(variables, x)
        assert y.shape == (1, T, D_OUT)


class TestDiscriminators:
    def test_lstm_discriminator(self, rng):
        disc = get_discriminator("lstm")
        y = jnp.asarray(rng.normal(size=(B, T, D_OUT)), jnp.float32)
        lengths = jnp.array([T, T - 2], dtype=jnp.int32)
        variables = disc.init(jax.random.PRNGKey(0), y, lengths)
        logits = disc.apply(variables, y, lengths)
        assert logits.shape == (B, T, 1)
        # noise path: train + noise rng changes the logits
        noisy = disc.apply(variables, y, lengths, 0.5, True,
                           rngs={"noise": jax.random.PRNGKey(7)})
        assert not np.allclose(np.asarray(logits), np.asarray(noisy))

    def test_dnn_discriminator_clip(self, rng):
        disc = get_discriminator("dnn")
        x = jnp.asarray(rng.normal(size=(8, 2 * D_OUT)) * 100, jnp.float32)
        variables = disc.init(jax.random.PRNGKey(0), x)
        logits = np.asarray(disc.apply(variables, x))
        assert logits.shape == (8, 1)
        assert logits.min() >= -0.5 and logits.max() <= 1.5


class TestParamTree:
    """Every main-path model's parameter paths and shapes equal those of
    the flax modules they replace (captured in
    tests/fixtures/flax_param_tree.json), so checkpoints, the tensor-
    parallel rules and serving's tree check keep their keys. At full width
    the initial values also keep flax's distribution (std and max)."""

    import json as _json
    import os as _os

    FIXTURE = _json.load(open(_os.path.join(
        _os.path.dirname(__file__), "fixtures", "flax_param_tree.json")))

    @staticmethod
    def _build(key):
        width, kind, name = (key.split("/") + [None])[:3]
        din, dout, B_, T_ = (9, 4, 2, 6) if width == "small" else \
            (257, 40, 1, 4)
        if kind == "cell":
            return LstmCellP(num_units=6, num_proj=5), (2, 3, 9)
        if kind == "G":
            return (get_generator(name, input_dim=din, output_dim=dout),
                    (B_, T_, din))
        width_in = dout + (din if name == "lstm_cond" else 0)
        return get_discriminator("lstm"), (B_, T_, width_in)

    @staticmethod
    def _flat(params):
        return {"/".join(str(k.key) for k in path): leaf
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(params)[0]}

    @pytest.mark.parametrize("key", sorted(FIXTURE))
    def test_paths_shapes_and_init(self, key):
        model, shape = self._build(key)
        x = jnp.zeros(shape, jnp.float32)
        params = self._flat(model.init(jax.random.PRNGKey(0), x)["params"])
        want = self.FIXTURE[key]
        assert sorted(params) == sorted(want)
        for path, leaf in params.items():
            assert list(leaf.shape) == want[path]["shape"], path
            if "std" not in want[path]:
                continue
            a = np.asarray(leaf)
            # sample std of a uniform draw has relative sd sqrt(0.2/n)
            # per draw; two independent draws, 6 sigma
            tol = 6 * np.sqrt(0.4 / a.size) * want[path]["std"]
            assert abs(a.std() - want[path]["std"]) <= tol, path
            assert abs(np.abs(a).max() - want[path]["absmax"]) <= \
                0.02 * want[path]["absmax"] + 1e-12, path
