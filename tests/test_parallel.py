"""Data-parallel equivalence on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from rsrgan_jax.models.discriminators import LstmDiscriminator
from rsrgan_jax.models.recurrent import ResLstmGenerator
from rsrgan_jax.parallel import make_mesh, replicate, shard_batch, shard_state
from rsrgan_jax.training import GanTrainer

D_IN, D_OUT, T = 8, 4, 10


def tiny_trainer():
    gen = ResLstmGenerator(output_dim=D_OUT, variant="l", cell_size=8)
    disc = LstmDiscriminator(cell_size=8, num_projection=4)
    return GanTrainer(gen, disc, output_dim=D_OUT, input_dim=D_IN)


HP = {"g_lr": jnp.float32(1e-3), "d_lr": jnp.float32(1e-3),
      "mse_lambda": jnp.float32(10.0), "disc_noise_std": jnp.float32(0.0),
      "d_real": jnp.float32(1.0), "d_fake": jnp.float32(0.0)}


def test_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.shape == {"data": 8}
    mesh2 = make_mesh(8, model_parallel=2)
    assert mesh2.shape == {"data": 4, "model": 2}


def test_dp_step_matches_single_device(rng):
    """One DP step over 8 devices == one step on the full batch on one
    device (grad averaging == tower averaging)."""
    assert len(jax.devices()) == 8
    trainer = tiny_trainer()
    B = 16
    x = jnp.asarray(rng.normal(size=(B, T, D_IN)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(B, T, D_OUT)), jnp.float32)
    lengths = jnp.full((B,), T, jnp.int32)

    state0 = trainer.init_state(jax.random.PRNGKey(0), x[:2], lengths[:2])
    snap = jax.tree.map(np.asarray, state0)

    # single-device step
    s1, m1 = trainer.train_step(state0, x, y, lengths, HP,
                                jax.random.PRNGKey(1))
    m1 = {k: float(v) for k, v in m1.items()}
    s1_params = jax.tree.map(np.asarray, s1.g.params)

    # DP step: shard batch over mesh, replicate state
    mesh = make_mesh(8)
    state0b = jax.tree.map(jnp.asarray, snap)
    state_dp = replicate(mesh, state0b)
    xb, yb, lb = shard_batch(mesh, (x, y, lengths))
    s2, m2 = trainer.train_step(state_dp, xb, yb, lb, HP,
                                jax.random.PRNGKey(1))
    m2 = {k: float(v) for k, v in m2.items()}
    s2_params = jax.tree.map(np.asarray, s2.g.params)

    for k in m1:
        assert abs(m1[k] - m2[k]) < 1e-4 * (1 + abs(m1[k])), (k, m1[k], m2[k])
    for a, b in zip(jax.tree.leaves(s1_params), jax.tree.leaves(s2_params)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_tp_shards_production_flagship_tree(rng):
    """The ACTUAL flagship tree — res_lstm_l G (4x LSTM-760/proj-257) and
    LSTM D (2x 256/proj-40) — sharded on the (data, model) mesh: every
    LSTM cell kernel/bias/proj_kernel leaf must receive a non-replicated
    spec (catching name-matching rot in parallel/mesh.py's placement
    rules), and a TP+DP train step must match the single-device step.
    Tiny B/T keeps CPU time sane; the dims are production."""
    gen = ResLstmGenerator(output_dim=40, variant="l", cell_size=760)
    disc = LstmDiscriminator(cell_size=256, num_projection=40)
    trainer = GanTrainer(gen, disc, output_dim=40, input_dim=257)
    B, T_ = 4, 12
    x = jnp.asarray(rng.normal(size=(B, T_, 257)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(B, T_, 40)), jnp.float32)
    lengths = jnp.full((B,), T_, jnp.int32)
    state = trainer.init_state(jax.random.PRNGKey(0), x[:2], lengths[:2])
    snap = jax.tree.map(np.asarray, state)

    mesh = make_mesh(8, model_parallel=2)
    state_tp = shard_state(mesh, state, tensor_parallel=True)

    # --- placement audit: every cell leaf sharded exactly as intended ---
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"g": state_tp.g.params, "d": state_tp.d.params})
    sharded = {"kernel": [], "bias": [], "proj_kernel": []}
    for path, leaf in flat:
        path_str = "/".join(str(getattr(p, "key", p)) for p in path)
        spec = tuple(leaf.sharding.spec)
        tail = path_str.rsplit("/", 1)[-1]
        in_cell = "cell" in path_str.lower()
        if in_cell and tail == "proj_kernel":
            assert spec[:1] == ("model",), (path_str, spec)
            sharded[tail].append(path_str)
        elif in_cell and tail == "kernel":
            assert spec and spec[-1] == "model", (path_str, spec)
            sharded[tail].append(path_str)
        elif in_cell and tail == "bias":
            assert spec == ("model",), (path_str, spec)
            sharded[tail].append(path_str)
        else:
            # everything outside the cells (Dense kernels/biases,
            # peepholes) must stay replicated — even when its width
            # happens to divide the gate shard (the 40-wide forward_out
            # Dense was once incidentally sharded by name-matching rot)
            assert all(s is None for s in spec), (path_str, spec)
    # 4 G cells + 2 D cells = 6 of each leaf kind, all non-replicated
    for kind, paths in sharded.items():
        assert len(paths) == 6, (kind, paths)

    # --- TP+DP step equality vs single device at production dims ---
    state_ref = jax.tree.map(jnp.asarray, snap)
    s1, m1 = trainer.train_step(state_ref, x, y, lengths, HP,
                                jax.random.PRNGKey(5))
    xb, yb, lb = shard_batch(mesh, (x, y, lengths))
    s2, m2 = trainer.train_step(state_tp, xb, yb, lb, HP,
                                jax.random.PRNGKey(5))
    for k in m1:
        a, b = float(m1[k]), float(m2[k])
        assert abs(a - b) < 1e-3 * (1 + abs(a)), (k, a, b)
    for (p1, a), (p2, b) in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, s1.g.params))[0],
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, s2.g.params))[0]):
        np.testing.assert_allclose(a, b, atol=5e-4, err_msg=str(p1))


def test_tp_sharded_state_runs(rng):
    """2-D (data, model) mesh with TP-sharded LSTM kernels compiles and
    executes; outputs match the replicated run."""
    trainer = tiny_trainer()
    B = 8
    x = jnp.asarray(rng.normal(size=(B, T, D_IN)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(B, T, D_OUT)), jnp.float32)
    lengths = jnp.full((B,), T, jnp.int32)
    state = trainer.init_state(jax.random.PRNGKey(0), x[:2], lengths[:2])
    ref_out = np.asarray(trainer.infer_step(state.g.params, x, lengths))

    mesh = make_mesh(8, model_parallel=2)
    state_tp = shard_state(mesh, state, tensor_parallel=True)
    xb = shard_batch(mesh, x)
    lb = shard_batch(mesh, lengths)
    out = np.asarray(trainer.infer_step(state_tp.g.params, xb, lb))
    np.testing.assert_allclose(out, ref_out, atol=1e-5)

    # and a full train step under TP matches the single-device step
    # (train_step donates the state arg and device_put may alias leaves
    # into state_tp -> run the single-device step on a fresh copy)
    yb = shard_batch(mesh, y)
    state_copy = jax.tree.map(
        jnp.asarray, jax.tree.map(np.asarray, state))
    s1, m1 = trainer.train_step(state_copy, x, y, lengths, HP,
                                jax.random.PRNGKey(3))
    s2, m2 = trainer.train_step(state_tp, xb, yb, lb, HP,
                                jax.random.PRNGKey(3))
    for k in m1:
        a, b = float(m1[k]), float(m2[k])
        assert abs(a - b) < 1e-4 * (1 + abs(a)), (k, a, b)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, s1.g.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, s2.g.params))):
        np.testing.assert_allclose(a, b, atol=1e-4)
