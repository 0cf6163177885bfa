"""Device-time breakdown of the flagship GAN training step from a profile.

Times the flagship 1 D + 2 G step (res_lstm_l G + LSTM D, bf16 matmuls)
with the profiler off, then traces a few steps and reduces the device
trace: the LSTM recurrence's share of kernel time (the ops under the
``lstm_recurrence`` scope, rsrgan_jax/ops/lstm.py), forward and backward
apart, and the device's idle share of the traced window.

    python tools/profile_step.py [--batch 16] [--time 500] [--out DIR]
    python tools/profile_step.py --xplane PATH --hlo HLO_TEXT [--steps N]
        (reduce a saved trace; no device run)

Prints one JSON line. Needs a GPU for the device run.
"""

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCOPE = "lstm_recurrence"


def _norm(name: str) -> str:
    """Kernel and HLO names differ in separators (fusion.3 / fusion_3)."""
    return re.sub(r"[._\-]", "_", name)


def op_names_from_hlo(hlo_text: str) -> dict:
    """Normalized HLO instruction name -> its metadata op_name (the JAX
    scope path)."""
    names = {}
    for m in re.finditer(r"^\s*(?:ROOT )?%?([\w.\-]+) = .*?"
                         r'metadata=\{[^}]*op_name="([^"]*)"', hlo_text,
                         re.M):
        names[_norm(m.group(1))] = m.group(2)
    return names


def classify(op_name: str) -> str:
    if SCOPE in op_name:
        return ("recurrence bwd" if "transpose(" in op_name
                else "recurrence fwd")
    return "other"


def _op_name(event, stats: dict, op_names: dict):
    """The event's JAX scope path, or None when it cannot be found."""
    for key in ("tf_op", "long_name"):
        if SCOPE in str(stats.get(key, "")):
            return str(stats[key])
    for name in (stats.get("hlo_op"), event.name):
        if name:
            found = op_names.get(_norm(str(name).lstrip("%").split(" ")[0]))
            if found is not None:
                return found
    return None


def reduce_trace(xplane_path: str, hlo_text: str, steps: int) -> dict:
    """Per-step device ms by class, from the kernels on the device's
    stream lines (XLA may run them inside CUDA graphs)."""
    import jax

    op_names = op_names_from_hlo(hlo_text)
    data = jax.profiler.ProfileData.from_file(xplane_path)
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit(f"no GPU device plane in {xplane_path}: "
                         f"{[p.name for p in data.planes]}")
    plane = planes[0]
    lines = [line for line in plane.lines if line.name.startswith("Stream")]
    if not lines:
        raise SystemExit(f"no stream line on {plane.name}: "
                         f"{[line.name for line in plane.lines]}")
    per_class = collections.Counter()
    intervals = []
    unmatched = collections.Counter()
    stat_keys = set()
    for line in lines:
        for ev in line.events:
            stats = dict(ev.stats)
            stat_keys.update(stats)
            op_name = _op_name(ev, stats, op_names)
            if op_name is None:
                unmatched[ev.name[:80]] += ev.duration_ns
                op_name = ""
            per_class[classify(op_name)] += ev.duration_ns
            intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end = 0, None
    for s, e in intervals:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = intervals[-1][1] - intervals[0][0] if intervals else 0
    total = sum(per_class.values())
    out = {"device_plane": plane.name, "stream_lines": len(lines),
           "events": len(intervals), "steps_traced": steps,
           "kernel_ms_per_step": round(total / 1e6 / steps, 3),
           "window_ms_per_step": round(window / 1e6 / steps, 3),
           "idle_share": round(1.0 - busy / window, 4) if window else None}
    for cls in ("recurrence fwd", "recurrence bwd", "other"):
        key = cls.replace(" ", "_")
        out[f"{key}_ms_per_step"] = round(per_class[cls] / 1e6 / steps, 3)
        out[f"{key}_share"] = (round(per_class[cls] / total, 4) if total
                               else None)
    out["unmatched_ms_per_step"] = round(
        sum(unmatched.values()) / 1e6 / steps, 3)
    out["unmatched_top"] = [name for name, _ in unmatched.most_common(5)]
    out["stat_keys"] = sorted(stat_keys)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--time", type=int, default=500)
    p.add_argument("--steps", type=int, default=3,
                   help="steps traced (the timed window is 10 steps)")
    p.add_argument("--out", default=None,
                   help="directory for the trace and HLO (default: a "
                        "temporary directory)")
    p.add_argument("--xplane", default=None)
    p.add_argument("--hlo", default=None)
    args = p.parse_args()
    if args.xplane:
        with open(args.hlo) as f:
            print(json.dumps(reduce_trace(args.xplane, f.read(),
                                          args.steps)))
        return

    import jax
    import jax.numpy as jnp

    from rsrgan_jax.cli import enable_compile_cache, require_gpu
    from rsrgan_jax.models import get_discriminator, get_generator
    from rsrgan_jax.training import GanTrainer

    devices, card = require_gpu("tools/profile_step.py")
    enable_compile_cache()
    B, T = args.batch, args.time
    gen = get_generator("res_lstm_l", input_dim=257, output_dim=40,
                        compute_dtype=jnp.bfloat16)
    disc = get_discriminator("lstm", compute_dtype=jnp.bfloat16)
    trainer = GanTrainer(gen, disc, output_dim=40, input_dim=257,
                         disc_updates=1, gen_updates=2, l2_scale=0.0,
                         max_grad_norm=15.0)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(B, T, 257)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(B, T, 40)), jnp.float32)
    lengths = jnp.asarray(rng.integers(int(0.9 * T), T + 1, (B,)),
                          jnp.int32)
    hp = {"g_lr": jnp.float32(8e-5), "d_lr": jnp.float32(1e-3),
          "mse_lambda": jnp.float32(10.0),
          "disc_noise_std": jnp.float32(0.05),
          "d_real": jnp.float32(1.0), "d_fake": jnp.float32(0.0)}
    state = trainer.init_state(jax.random.PRNGKey(0), x, lengths)
    key = jax.random.PRNGKey(1)
    hlo = (type(trainer).train_step.lower(trainer, state, x, y, lengths, hp,
                                          key).compile().as_text())

    for _ in range(2):  # compile + warm
        state, m = trainer.train_step(state, x, y, lengths, hp, key)
    jax.block_until_ready((state, m))
    t0 = time.perf_counter()
    for _ in range(10):
        state, m = trainer.train_step(state, x, y, lengths, hp, key)
    jax.block_until_ready((state, m))
    step_ms = (time.perf_counter() - t0) * 1e3 / 10

    out_dir = args.out or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "rsrgan_profile")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"train_step_B{B}.hlo.txt"), "w") as f:
        f.write(hlo)
    trace_dir = os.path.join(out_dir, f"trace_B{B}")
    jax.profiler.start_trace(trace_dir)
    for _ in range(args.steps):
        state, m = trainer.train_step(state, x, y, lengths, hp, key)
    jax.block_until_ready((state, m))
    jax.profiler.stop_trace()
    paths = sorted(glob.glob(trace_dir + "/**/*.xplane.pb", recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise SystemExit(f"no xplane.pb under {trace_dir}")

    reduced = reduce_trace(paths[-1], hlo, args.steps)
    d = devices[0]
    print(json.dumps({
        "platform": d.platform, "device_kind": d.device_kind,
        "device_count": len(devices), "card": card,
        "batch": B, "time": T, "true_frames": int(np.sum(lengths)),
        "step_ms": round(step_ms, 3),
        "true_frames_per_sec": round(float(np.sum(lengths)) / step_ms * 1e3,
                                     1),
        "xplane": paths[-1],
        **reduced,
        # one stream runs the kernels one at a time, so the untraced step
        # less their time is the device's idle time (tracing slows the
        # host, which inflates the traced window's idle share)
        "idle_share_untraced": round(
            1.0 - reduced["kernel_ms_per_step"] / step_ms, 4)}))


if __name__ == "__main__":
    main()
