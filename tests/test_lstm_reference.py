"""The scan LSTM models against an independent per-timestep numpy
reference: forward, gradients, masked-tail invariance, bf16 vs f32.

The reference is a direct transcription of tf.contrib.rnn.LSTMCell with
peepholes + projection (gate order i, j, f, o, forget_bias 1.0) and of the
reference repo's layer wirings, one timestep at a time. Gradients are
checked as directional derivatives against central finite differences of
the float64 reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsrgan_jax.models import LstmDiscriminator, ResLstmGenerator
from rsrgan_jax.ops.lstm import LstmCellP

B, T = 3, 7


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def np_cell(p, x, lengths):
    """[B, T, D] -> [B, T, P]: the cell, frozen state and zero outputs past
    each length (dynamic_rnn)."""
    dt = x.dtype
    kernel, bias, proj = (p[k].astype(dt)
                          for k in ("kernel", "bias", "proj_kernel"))
    w_i, w_f, w_o = (p[k].astype(dt)[0]
                     for k in ("w_i_diag", "w_f_diag", "w_o_diag"))
    U, P = proj.shape
    c = np.zeros((x.shape[0], U), dt)
    h = np.zeros((x.shape[0], P), dt)
    out = np.zeros((x.shape[0], x.shape[1], P), dt)
    for t in range(x.shape[1]):
        gates = np.concatenate([x[:, t], h], axis=1) @ kernel + bias
        i, j, f, o = np.split(gates, 4, axis=1)
        c_new = _sigmoid(f + 1.0 + w_f * c) * c + _sigmoid(i + w_i * c) * \
            np.tanh(j)
        h_new = (_sigmoid(o + w_o * c_new) * np.tanh(c_new)) @ proj
        live = (t < lengths)[:, None]
        c = np.where(live, c_new, c)
        h = np.where(live, h_new, h)
        out[:, t] = np.where(live, h_new, 0.0)
    return out


def np_dense(p, x):
    return x @ p["kernel"].astype(x.dtype) + p["bias"].astype(x.dtype)


def np_res_lstm(params, x, lengths, variant):
    layers = 2 if variant == "i" else 4
    layer_in = x
    for k in range(layers):
        out = np_cell(params[f"lstm_cell_{k + 1}"], layer_in, lengths)
        layer_in = {"l": out + layer_in, "i": out + x, "base": out}[variant]
    return np_dense(params["forward_out"], layer_in)


def np_lstm_d(params, x, lengths):
    stack = params["StackedLstm_0"]
    h = x
    for k in range(len(stack)):
        h = np_cell(stack[f"cell_{k}"], h, lengths)
    return np_dense(params["Dense_0"], h)


# name -> (model, input width, numpy reference)
CASES = {
    "cell": (LstmCellP(num_units=6, num_proj=5), 9, np_cell),
    "res_lstm_base": (ResLstmGenerator(output_dim=4, variant="base",
                                       cell_size=6), 5,
                      lambda p, x, l: np_res_lstm(p, x, l, "base")),
    "res_lstm_i": (ResLstmGenerator(output_dim=4, variant="i", cell_size=6),
                   5, lambda p, x, l: np_res_lstm(p, x, l, "i")),
    "res_lstm_l": (ResLstmGenerator(output_dim=4, variant="l", cell_size=6),
                   5, lambda p, x, l: np_res_lstm(p, x, l, "l")),
    "d_plain": (LstmDiscriminator(cell_size=6, num_projection=4), 4,
                np_lstm_d),
    "d_odd_layers": (LstmDiscriminator(cell_size=6, num_projection=4,
                                       num_layers=3), 7, np_lstm_d),
}


def _setup(name, seed=0):
    model, width, ref = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, width)).astype(np.float32)
    lengths = np.array([T, T - 3, 2], np.int32)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    return model, ref, params, x, lengths


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_numpy(name):
    model, ref, params, x, lengths = _setup(name)
    got = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(lengths)))
    want = ref(params, x, lengths)
    assert want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_finite_differences(name):
    """grad . v == d/de loss(params + e v), the right side by central
    differences of the float64 reference."""
    model, ref, params, x, lengths = _setup(name, seed=1)
    rng = np.random.default_rng(2)
    w = rng.normal(size=ref(params, x, lengths).shape)
    v = jax.tree.map(lambda a: rng.normal(size=a.shape), params)

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(x),
                          jnp.asarray(lengths))
        return jnp.sum(out * w.astype(np.float32))

    grads = jax.grad(loss)(params)
    got = sum(float(np.sum(np.asarray(g, np.float64) * d))
              for g, d in zip(jax.tree.leaves(grads), jax.tree.leaves(v)))

    def np_loss(p):
        p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
        return float(np.sum(ref(p64, x.astype(np.float64), lengths) * w))

    eps = 1e-5
    plus = jax.tree.map(lambda a, d: a + eps * d, params, v)
    minus = jax.tree.map(lambda a, d: a - eps * d, params, v)
    want = (np_loss(plus) - np_loss(minus)) / (2 * eps)
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_masked_tail_invariance(name):
    """Garbage past a sequence's length changes neither its valid outputs
    nor the gradient of a loss over valid frames."""
    model, _, params, x, lengths = _setup(name, seed=3)
    x2 = x.copy()
    for b, n in enumerate(lengths):
        x2[b, n:] = 1e3
    valid = (np.arange(T)[None, :] < lengths[:, None])[..., None]

    def run(inputs):
        def loss(p):
            out = model.apply({"params": p}, jnp.asarray(inputs),
                              jnp.asarray(lengths))
            return jnp.sum(jnp.where(valid, out, 0.0)), out
        (_, out), g = jax.value_and_grad(loss, has_aux=True)(params)
        return np.asarray(out), g

    out1, g1 = run(x)
    out2, g2 = run(x2)
    np.testing.assert_allclose(np.where(valid, out1, 0),
                               np.where(valid, out2, 0), atol=1e-6)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_bf16_gradients_track_f32():
    """bfloat16 matmul operands (8 significant bits, ~4e-3 relative
    rounding each) with float32 state: the flagship wiring's gradient stays
    within 5e-2 relative L2 of the float32 one."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(B, 12, 8)), jnp.float32)
    lengths = jnp.array([12, 9, 5], jnp.int32)
    w = jnp.asarray(rng.normal(size=(B, 12, 4)), jnp.float32)
    grads = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        gen = ResLstmGenerator(output_dim=4, variant="l", cell_size=16,
                               compute_dtype=dtype)
        params = gen.init(jax.random.PRNGKey(0), x)["params"]
        grads[dtype] = jax.grad(lambda p: jnp.sum(
            gen.apply({"params": p}, x, lengths) * w))(params)
    flat = {k: np.concatenate([np.ravel(a) for a in jax.tree.leaves(g)])
            for k, g in grads.items()}
    ref = flat[jnp.float32]
    err = np.linalg.norm(flat[jnp.bfloat16] - ref) / np.linalg.norm(ref)
    assert 0 < err < 5e-2, err
