"""Multi-chip benchmark: flagship GAN training over a data-parallel mesh.

The same fused train_multi_step as bench.py, batch sharded over a 1-D
``data`` mesh, replicated state, psum-reduced grads via the sharded-step
machinery proven DP-equal in tests/test_parallel.py.

    python bench_multichip.py [n_devices]     # GPUs of this host
    python bench_multichip.py 8 --cpu-validate  # hermetic 8-CPU check

--cpu-validate re-execs with a forced n-device host mesh (no accelerator
touched, same mechanism as __graft_entry__.dryrun_multichip) and runs the
full sharded bench loop at tiny shapes. Without it the run needs GPUs.

Prints the device on an earlier line and ONE JSON line last:
{"metric", "value", "unit", "per_chip", "devices", "device"}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

STEPS = 15


def _reexec_cpu_validate(n_devices: int) -> int:
    env = dict(os.environ)
    env["_RSRGAN_MCBENCH_CHILD"] = "1"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(n_devices),
         "--cpu-validate"],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__))).returncode


def main() -> int:
    args = [a for a in sys.argv[1:]]
    validate = "--cpu-validate" in args
    args = [a for a in args if not a.startswith("--")]
    n_devices = int(args[0]) if args else 0

    if validate and os.environ.get("_RSRGAN_MCBENCH_CHILD") != "1":
        return _reexec_cpu_validate(n_devices or 8)

    import jax

    if validate:
        jax.config.update("jax_platform_name", "cpu")
    import jax.numpy as jnp

    from rsrgan_jax.cli import enable_compile_cache, require_gpu
    from rsrgan_jax.models import get_discriminator, get_generator
    from rsrgan_jax.parallel import make_mesh, shard_batch, shard_state
    from rsrgan_jax.training import GanTrainer

    devices = (jax.devices("cpu") if validate
               else require_gpu("bench_multichip.py")[0])
    enable_compile_cache()
    if n_devices:
        assert len(devices) >= n_devices, (
            f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    n = len(devices)
    mesh = make_mesh(devices=devices)

    if validate:
        from rsrgan_jax.models.discriminators import LstmDiscriminator
        from rsrgan_jax.models.recurrent import ResLstmGenerator

        B_per, T = 2, 32
        gen = ResLstmGenerator(output_dim=40, variant="l", cell_size=16)
        disc = LstmDiscriminator(cell_size=8, num_projection=8)
    else:
        B_per, T = 16, 500
        gen = get_generator("res_lstm_l", input_dim=257, output_dim=40,
                            compute_dtype=jnp.bfloat16)
        disc = get_discriminator("lstm", compute_dtype=jnp.bfloat16)
    B = B_per * n
    trainer = GanTrainer(gen, disc, output_dim=40, input_dim=257,
                         disc_updates=1, gen_updates=2, l2_scale=0.0,
                         max_grad_norm=15.0)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(B, T, 257)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(B, T, 40)), jnp.float32)
    lengths = jnp.asarray(rng.integers(int(0.8 * T), T + 1, (B,)),
                          jnp.int32)
    hp = {"g_lr": jnp.float32(8e-5 * n), "d_lr": jnp.float32(1e-3 * n),
          "mse_lambda": jnp.float32(10.0),
          "disc_noise_std": jnp.float32(0.05),
          "d_real": jnp.float32(1.0), "d_fake": jnp.float32(0.0)}

    state = trainer.init_state(jax.random.PRNGKey(0), x[:2], lengths[:2])
    state = shard_state(mesh, state)

    steps = 2 if validate else STEPS
    xs = jnp.broadcast_to(x, (steps,) + x.shape)
    ys = jnp.broadcast_to(y, (steps,) + y.shape)
    ls = jnp.broadcast_to(lengths, (steps,) + lengths.shape)
    # stacked batches shard on axis 1 (the per-step batch axis)
    xs, ys, ls = shard_batch(mesh, (xs, ys, ls), axis=1)
    key = jax.random.PRNGKey(1)

    with mesh:
        state, metrics = trainer.train_multi_step(state, xs, ys, ls, hp,
                                                  key)
        g0 = float(metrics["g_loss"])
        assert np.isfinite(g0), metrics
        reps = []
        for _ in range(2 if validate else 4):
            key, sub = jax.random.split(key)
            t0 = time.perf_counter()
            state, metrics = trainer.train_multi_step(state, xs, ys, ls,
                                                      hp, sub)
            jax.block_until_ready((state, metrics))
            reps.append((time.perf_counter() - t0) / steps)
    dt = min(reps)

    true_frames = float(np.sum(np.asarray(lengths)))
    print(json.dumps({
        "metric": ("gan_train_frames_per_sec_multichip_VALIDATE"
                   if validate else "gan_train_frames_per_sec_multichip"),
        "value": round(true_frames / dt, 1),
        "unit": f"true frames/s over {n} devices "
                f"(1 D + 2 G steps, B={B_per}/device, T={T})",
        "per_chip": round(true_frames / dt / n, 1),
        "devices": n,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": n},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
