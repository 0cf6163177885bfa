"""Unified train/decode driver.

Covers the reference's eight ``scripts/train_*.py`` drivers with one CLI
(flag names preserved from scripts/train_gan_rnn_placeholder.py:589-752 and
scripts/train_dnn.py):

* ``--trainer gan_rnn`` — flagship sequence LSGAN, placeholder-trainer
  semantics (D and G updated on the same minibatch, README.md:39)
* ``--trainer gan_dnn`` — frame-level LSGAN with input-conditioned DNN-D
* ``--trainer rnn``     — MSE sequence trainer (lstm/bnlstm/res_lstm_*)
* ``--trainer dnn``     — MSE frame trainer (dnn/rced/cnn) with staged LR
  decay and reject-with-rollback checkpointing
* ``--decode``          — enhancement: G forward, CMVN denormalize, write
  Kaldi feats.ark/feats.scp (train_gan_rnn_placeholder.py:204-302)

One jitted step per bucket shape, batches sharded over a 1-D data mesh
(LR x replicas rule applied like the reference's LR x num_gpu), bf16
matmuls inside the models, float32 state.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rsrgan_jax.cli import enable_compile_cache, str2bool
from rsrgan_jax.data import (ArkWriter, FrameBatcher,
                             HostShardedFrameBatches,
                             HostShardedSequenceBatches, SequenceBatcher,
                             ThreadedPrefetcher, UtteranceStore,
                             infer_batches, load_cmvn_npz, read_list_file)
from rsrgan_jax.models import get_discriminator, get_generator
from rsrgan_jax.parallel import (initialize as init_distributed,
                                 is_coordinator, make_mesh, replicate,
                                 shard_batch)
from rsrgan_jax.training import (GanTrainer, ImprovementTracker, MseTrainer,
                                 exponential_decay, load_checkpoint,
                                 load_newest_state, read_checkpoint_meta,
                                 save_checkpoint, save_periodic_snapshot,
                                 staged_decay)

GAN_METRICS = ("d_rl_loss", "d_fk_loss", "d_loss", "g_adv_loss",
               "g_mse_loss", "g_l2_loss", "g_loss")
MSE_METRICS = ("g_mse_loss", "g_l2_loss", "g_loss")
SEGAN_METRICS = ("d_rl_loss", "d_fk_loss", "d_loss", "g_adv_loss",
                 "g_l1_loss", "g_loss")


def log(msg: str) -> None:
    print(msg)
    sys.stdout.flush()


class MetricsWriter:
    """Structured metrics sink: grep-able JSONL plus (optionally) real
    TensorBoard event files, mirroring the reference's per-split FileWriters
    into save_dir/train and save_dir/eval
    (models/gan_rnn_placeholder.py:81-86)."""

    def __init__(self, save_dir: str, split: str, tensorboard: bool = False,
                 enabled: bool = True):
        self.enabled = enabled  # False on non-coordinator processes
        self.path = os.path.join(save_dir, f"metrics_{split}.jsonl")
        self._tb = None
        if not enabled:
            return
        os.makedirs(save_dir, exist_ok=True)
        if tensorboard:
            from rsrgan_jax.training.tensorboard import EventFileWriter
            self._tb = EventFileWriter(os.path.join(save_dir, split))

    def write(self, iteration: int, metrics: dict) -> None:
        if not self.enabled:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps({"iteration": iteration, **scalars}) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(iteration, scalars)


class PeriodicSnapshotter:
    """Time-based mid-iteration crash-recovery snapshots
    (--checkpoint_every_secs; the reference only saves at iteration ends,
    scripts/train_gan_rnn_placeholder.py:535-554)."""

    def __init__(self, save_dir: str, name: str, every_secs: float):
        self.save_dir, self.name, self.every = save_dir, name, every_secs
        self._last = time.monotonic()

    def maybe(self, state) -> None:
        if self.every <= 0 or time.monotonic() - self._last < self.every:
            return
        save_periodic_snapshot(self.save_dir, self.name,
                               jax.device_get(state))
        self._last = time.monotonic()
        log(f"Periodic snapshot saved ({self.name}.periodic.ckpt)")

    def invalidate(self) -> None:
        """Drop the snapshot when the live state is rolled back — a
        snapshot of the rejected trajectory must not win on resume."""
        from rsrgan_jax.training.checkpoints import periodic_snapshot_path
        path = periodic_snapshot_path(self.save_dir, self.name)
        if os.path.isfile(path):
            os.remove(path)


def restore_state(args, name: str, state):
    """Latest accepted checkpoint; with periodic snapshots enabled, a newer
    mid-iteration snapshot wins (crash recovery)."""
    if args.checkpoint_every_secs > 0:
        return load_newest_state(args.save_dir, name, state)
    return load_checkpoint(args.save_dir, name, state), "checkpoint"


def build_trainer(args, compute_dtype):
    if args.trainer == "segan":
        from rsrgan_jax.models.segan import (SeganAEGenerator,
                                             SeganDiscriminator,
                                             SeganWaveGenerator)
        from rsrgan_jax.training.segan import SeganTrainer
        depths = tuple(int(d) for d in args.g_enc_depths.split(","))
        if args.g_type in ("ae", "dnn", "lstm"):  # run_segan.sh: g_type=ae
            gen = SeganAEGenerator(units=args.output_dim,
                                   enc_depths=depths,
                                   do_prelu=args.g_nl == "prelu",
                                   bias_deconv=args.bias_deconv,
                                   bias_downconv=args.bias_downconv)
        else:
            gen = SeganWaveGenerator(units=args.output_dim)
        disc = SeganDiscriminator(num_fmaps=depths,
                                  bias_conv=args.bias_d_conv)
        return SeganTrainer(gen, disc, disc_updates=args.disc_updates,
                            gen_updates=args.gen_updates)
    gen = get_generator(args.g_type, input_dim=args.input_dim,
                        output_dim=args.output_dim,
                        left_context=args.left_context,
                        right_context=args.right_context,
                        keep_prob=args.keep_prob,
                        batch_norm=args.batch_norm,
                        compute_dtype=compute_dtype)
    if args.trainer == "gan_rnn":
        disc = get_discriminator("lstm", keep_prob=args.keep_prob,
                                 compute_dtype=compute_dtype)
        return GanTrainer(gen, disc, output_dim=args.output_dim,
                          input_dim=args.input_dim,
                          left_context=args.left_context,
                          disc_updates=args.disc_updates,
                          gen_updates=args.gen_updates,
                          l2_scale=args.l2_scale, max_grad_norm=15.0,
                          g_optimizer="adam", d_optimizer="sgd",
                          d_conditioned=args.d_conditioned)
    if args.trainer == "gan_dnn":
        disc = get_discriminator("dnn", keep_prob=args.keep_prob)
        return GanTrainer(gen, disc, output_dim=args.output_dim,
                          input_dim=args.input_dim,
                          left_context=args.left_context,
                          disc_updates=args.disc_updates,
                          gen_updates=args.gen_updates,
                          l2_scale=args.l2_scale, max_grad_norm=None,
                          g_optimizer="adam", d_optimizer="adam",
                          d_conditioned=True, frame_mode=True)
    if args.trainer == "rnn":
        return MseTrainer(gen, output_dim=args.output_dim,
                          l2_scale=args.l2_scale, max_grad_norm=15.0)
    if args.trainer == "dnn":
        return MseTrainer(gen, output_dim=args.output_dim,
                          l2_scale=args.l2_scale, max_grad_norm=None,
                          sequence_mode=False)
    raise ValueError(f"unknown trainer {args.trainer}")


def setup_devices(args):
    """(mesh, num_devices, process_index, process_count).

    Single process: the reference's --num_gpu tower count maps to the
    first N local devices. Multi-process (--coordinator_address): one mesh
    over ALL global devices; grads psum within a host and over the
    network across hosts.
    """
    pid, pcount = jax.process_index(), jax.process_count()
    if pcount > 1:
        num_devices = jax.device_count()
        if args.num_gpu not in (1, num_devices):
            log(f"NOTE: --num_gpu={args.num_gpu} ignored in multi-process "
                f"mode; using all {num_devices} global devices")
        return make_mesh(None), num_devices, pid, pcount
    mesh = make_mesh(args.num_gpu) if args.num_gpu > 1 else None
    return mesh, args.num_gpu, pid, pcount


def model_name(args) -> str:
    return {"gan_rnn": "GAN_RNN", "gan_dnn": "GAN", "rnn": "RNNTrainer",
            "dnn": "DNNTrainer", "segan": "SEGAN"}[args.trainer]


def ckpt_meta(args) -> dict:
    """Model-config sidecar saved next to checkpoints; loaders use it to
    validate wiring the param tree can't encode (res_lstm_l vs
    res_lstm_base trees are shape-identical)."""
    return {"trainer": args.trainer, "g_type": args.g_type,
            "input_dim": args.input_dim, "output_dim": args.output_dim,
            "left_context": args.left_context,
            "right_context": args.right_context,
            # effective D conditioning (gan_dnn is always conditioned,
            # gan.py:159-182); decode never builds D, but a resume with
            # the wrong D input width should be explicable from the sidecar
            "d_conditioned": args.trainer == "gan_dnn"
            or bool(getattr(args, "d_conditioned", False))}


def make_hparams(args, num_devices: int):
    return {"g_lr": jnp.float32(args.g_learning_rate * num_devices),
            "d_lr": jnp.float32(args.d_learning_rate * num_devices),
            "mse_lambda": jnp.float32(args.init_mse_weight),
            "l1_lambda": jnp.float32(args.init_l1_weight),
            "disc_noise_std": jnp.float32(args.init_disc_noise_std),
            "d_real": jnp.float32(1.0), "d_fake": jnp.float32(0.0)}


def _fmt(metrics: dict, keys) -> str:
    return ", ".join(f"{k} = {float(metrics[k]):.5f}" for k in keys)


def _avg(accum: list) -> dict:
    keys = accum[0].keys()
    return {k: float(np.mean([float(m[k]) for m in accum])) for k in keys}


def _avg_weighted(accum: list) -> dict:
    """Weighted mean of (metrics_dict, batch_count) pairs with ONE packed
    device readback instead of a host sync per scalar per batch."""
    keys = list(accum[0][0].keys())
    mat = jnp.stack([jnp.stack([jnp.asarray(m[k], jnp.float32)
                                for k in keys]) for m, _ in accum])
    vals = np.asarray(jax.device_get(mat))
    weights = np.array([n for _, n in accum], np.float64)
    return {k: float(np.average(vals[:, i], weights=weights))
            for i, k in enumerate(keys)}


class FeedPlan(NamedTuple):
    """Resolved device-feed configuration (decide_device_feed)."""
    dtype: Any
    rotate: bool
    budget: int


# Share of the device's memory kept for params, optimizer state and the
# step's working set when the corpus tables are sized. Not yet measured
# on the card (ROADMAP S4).
FEED_WORKING_SET_SHARE = 0.25


def feed_memory_budget(device) -> float:
    """Bytes the resident corpus tables may take on ``device``:
    $RSRGAN_FEED_HBM_BUDGET when set, else the device's ``bytes_limit``
    less FEED_WORKING_SET_SHARE of it. A device that reports no memory
    statistics is an error."""
    if "RSRGAN_FEED_HBM_BUDGET" in os.environ:
        return float(os.environ["RSRGAN_FEED_HBM_BUDGET"])
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise SystemExit(
            f"device feed: {device} reports no memory statistics to size "
            "the resident tables; set RSRGAN_FEED_HBM_BUDGET (bytes) or "
            "--device_feed=off")
    return stats["bytes_limit"] * (1.0 - FEED_WORKING_SET_SHARE)


def decide_device_feed(args, tr_store, cv_store, mesh, pcount):
    """Resolve --device_feed/--device_feed_dtype to a FeedPlan or None.

    The gathered path covers the single-process sequence trainers —
    single-device AND mesh runs (tables replicate over the mesh, batch
    plans shard over the data axis); multi-host and the graph-fed GAN
    variant keep the host feed. Corpora whose tables exceed the HBM
    budget rotate resident shards (RotatingDeviceFeed) instead of
    falling back to the host feed.
    """
    from rsrgan_jax.data.device_feed import table_bytes
    if args.device_feed == "off":
        return None
    eligible = (args.trainer in ("gan_rnn", "rnn") and pcount == 1
                and (args.trainer != "gan_rnn" or args.same_batch))
    if not eligible:
        if args.device_feed == "on":
            log("NOTE: --device_feed=on ignored (multi-host/graph-fed "
                "runs use the host feed)")
        return None
    if args.device_feed == "auto" and jax.default_backend() != "gpu":
        return None
    # Under a mesh the tables are replicated, so the budget is per device.
    budget = feed_memory_budget(jax.local_devices()[0])
    f32_bytes = table_bytes(tr_store, 4) + table_bytes(cv_store, 4)
    if args.device_feed_dtype == "float32":
        dtype = jnp.float32
    elif args.device_feed_dtype == "bfloat16":
        dtype = jnp.bfloat16
    elif f32_bytes <= budget:
        dtype = jnp.float32
    else:
        log(f"[*] device feed: f32 tables ({f32_bytes / 1e9:.1f} GB) exceed "
            f"the HBM budget ({budget / 1e9:.1f} GB); using bfloat16 tables")
        dtype = jnp.bfloat16
    itemsize = jnp.dtype(dtype).itemsize
    need = table_bytes(tr_store, itemsize) + table_bytes(cv_store, itemsize)
    rotate = need > budget
    if rotate:
        log(f"[*] device feed: {jnp.dtype(dtype).name} tables "
            f"({need / 1e9:.1f} GB) exceed the HBM budget "
            f"({budget / 1e9:.1f} GB); rotating resident shards")
    return FeedPlan(dtype, rotate, int(budget))


def show_all_variables(state) -> None:
    """Parameter-count summary (utils/misc.py:37-40 parity)."""
    def count(tree):
        return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(tree))

    if hasattr(state, "g"):
        log(f"G variables: {count(state.g.params) / 1e6:.2f}M params; "
            f"D variables: {count(state.d.params) / 1e6:.2f}M params")
    else:
        log(f"G variables: {count(state.net.params) / 1e6:.2f}M params")


class Profiler:
    """Optional XLA trace capture around the first training iteration
    (--profile_dir); view with TensorBoard or xprof."""

    def __init__(self, profile_dir):
        self.dir = profile_dir
        self.active = False

    def start(self):
        if self.dir and not self.active:
            jax.profiler.start_trace(self.dir)
            self.active = True

    def stop(self):
        if self.active:
            jax.profiler.stop_trace()
            self.active = False
            log(f"Wrote profiler trace to {self.dir}")


# ---------------------------------------------------------------------------
# sequence trainers (gan_rnn / rnn)
# ---------------------------------------------------------------------------

def run_sequence_training(args) -> int:
    compute_dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    trainer = build_trainer(args, compute_dtype)
    is_gan = args.trainer == "gan_rnn"
    name = model_name(args)

    tr_store = UtteranceStore(read_list_file(args.tr_list_file))
    cv_store = UtteranceStore(read_list_file(args.cv_list_file))

    mesh, num_devices, pid, pcount = setup_devices(args)
    global_batch = args.batch_size * num_devices

    def make_batcher(store, shuffle):
        b = SequenceBatcher(store, global_batch, args.left_context,
                            args.right_context, shuffle=shuffle,
                            seed=args.seed)
        if b.num_batches() == 0:
            # small sets: every bucket is a partial window — keep ragged
            # batches rather than dropping the whole stream (the reference's
            # group_by_window also emits final partial windows)
            b = SequenceBatcher(store, global_batch, args.left_context,
                                args.right_context, shuffle=shuffle,
                                drop_remainder=False, seed=args.seed)
        return b

    tr_batches = make_batcher(tr_store, True)
    cv_batches = make_batcher(cv_store, False)
    if pcount > 1:
        # shared global plan; this host materializes only its rows
        tr_batches = HostShardedSequenceBatches(tr_batches, pid, pcount)
        cv_batches = HostShardedSequenceBatches(cv_batches, pid, pcount)
    tr_num_batch = tr_batches.num_batches()
    cv_num_batch = cv_batches.num_batches()
    min_iters, max_iters = args.min_epoches, args.max_epoches
    log(f"LOG: #train_batch = {tr_num_batch}, #valid_batch = {cv_num_batch}\n"
        f"LOG: #min_iters = {min_iters}, #max_iters = {max_iters}")

    # init from one example batch (drop_remainder=False: must also work
    # for corpora smaller than a full bucket window)
    example = next(iter(SequenceBatcher(tr_store, global_batch,
                                        args.left_context,
                                        args.right_context,
                                        drop_remainder=False, seed=0)))
    rng = jax.random.PRNGKey(args.seed)
    state = trainer.init_state(rng, jnp.asarray(example.inputs),
                               jnp.asarray(example.lengths))
    restored, restore_src = restore_state(args, name, state)
    if restored is not None:
        state = restored
        log(f"[*] Load SUCCESS ({restore_src})")
    else:
        log("[!] Begin a new model.")
    if mesh is not None:
        state = replicate(mesh, state)

    snapper = PeriodicSnapshotter(
        args.save_dir, name,
        args.checkpoint_every_secs if is_coordinator() else 0.0)
    show_all_variables(state)
    hp = make_hparams(args, num_devices)
    tracker = ImprovementTracker(args.end_improve)
    profiler = Profiler(args.profile_dir)
    tr_writer = MetricsWriter(args.save_dir, "train", args.tensorboard,
                              enabled=is_coordinator())
    cv_writer = MetricsWriter(args.save_dir, "eval", args.tensorboard,
                              enabled=is_coordinator())
    step_rng = jax.random.PRNGKey(args.seed + 1)
    metric_keys = GAN_METRICS if is_gan else MSE_METRICS

    steps_per_call = max(1, args.steps_per_call)

    feed_plan = decide_device_feed(args, tr_store, cv_store, mesh, pcount)
    feed_tr = feed_cv = None
    rotating = False
    shard_batchers = visits = None
    if feed_plan is not None:
        from rsrgan_jax.data.device_feed import (DeviceFeed,
                                                 RotatingDeviceFeed,
                                                 table_bytes)
        t0 = time.monotonic()
        feed_cv = DeviceFeed(cv_store, dtype=feed_plan.dtype, mesh=mesh)
        if feed_plan.rotate:
            from rsrgan_jax.data.store import StoreView
            itemsize = jnp.dtype(feed_plan.dtype).itemsize
            tr_budget = feed_plan.budget - table_bytes(cv_store, itemsize)
            feed_tr = RotatingDeviceFeed(
                tr_store, feed_plan.dtype, tr_budget, mesh=mesh,
                seed=args.seed, prefetch=args.feed_prefetch)
            rotating = True
            shard_batchers = [make_batcher(StoreView(tr_store, s), True)
                              for s in feed_tr.shards]
            visits = feed_tr.schedule(max_iters, args.feed_rotation_block,
                                      seed=args.seed)
            tr_num_batch = sum(b.num_batches() for b in shard_batchers)
            log(f"[*] device feed: rotating {feed_tr.num_shards} shards "
                f"(<= {feed_tr.max_rows} frames each, "
                f"{feed_tr.num_bytes / 1e9:.2f} GB of "
                f"{jnp.dtype(feed_plan.dtype).name} buffers), "
                f"{len(visits)} residencies x "
                f"<= {args.feed_rotation_block} passes"
                f"{', async prefetch' if args.feed_prefetch else ''}")
        else:
            feed_tr = DeviceFeed(tr_store, dtype=feed_plan.dtype, mesh=mesh)
            log(f"[*] device feed: "
                f"{(feed_tr.num_bytes + feed_cv.num_bytes) / 1e9:.2f} GB "
                f"resident ({jnp.dtype(feed_plan.dtype).name} tables) "
                f"uploaded in {time.monotonic() - t0:.1f} s")

    # Rotation redefines one loop iteration as a shard RESIDENCY (block
    # passes over one shard); schedules and stop conditions then advance
    # by effective epochs = completed passes / num_shards, so lr decay and
    # min/max-epoch semantics stay in corpus-epoch units.
    n_iterations = len(visits) if rotating else max_iters
    min_stop_iters = min_iters
    if rotating:
        cum = 0
        min_stop_iters = n_iterations
        for i, (_, p) in enumerate(visits):
            cum += p
            if cum >= min_iters * feed_tr.num_shards:
                min_stop_iters = i + 1
                break
    eff_epoch = 0.0

    for iteration in range(n_iterations):
        if iteration == 1:
            profiler.start()   # capture the steady-state second iteration
        start = datetime.datetime.now()
        tr_accum, cv_accum = [], []  # (metrics dict, batch count) pairs
        true_frames = 0

        # Group same-bucket batches and run them as one jitted multi-step
        # scan — amortizes per-dispatch host latency.
        pending = {}

        def place(arrays, axis=0):
            """Host batch -> device: sharded over the mesh, or plain
            device arrays single-device (no jnp->np round trip)."""
            if mesh is not None:
                return shard_batch(mesh, arrays, axis)
            return tuple(jnp.asarray(a) for a in arrays)

        def run_group(batches):
            nonlocal state, step_rng
            if len(batches) < steps_per_call:
                # partial group: run single steps — stacking would compile a
                # fresh program for every distinct group size
                for b in batches:
                    step_rng, sub = jax.random.split(step_rng)
                    arrays = place((b.inputs, b.labels, b.lengths))
                    if is_gan:
                        state, m = trainer.train_step(state, *arrays, hp,
                                                      sub)
                    else:
                        state, m = trainer.train_step(state, *arrays,
                                                      hp["g_lr"], sub)
                    tr_accum.append((m, 1))
                    snapper.maybe(state)
                return
            step_rng, sub = jax.random.split(step_rng)
            stacked = (np.stack([b.inputs for b in batches]),
                       np.stack([b.labels for b in batches]),
                       np.stack([b.lengths for b in batches]))
            arrays = place(stacked, axis=1)
            if is_gan:
                state, m = trainer.train_multi_step(state, *arrays, hp, sub)
            else:
                state, m = trainer.train_multi_step(state, *arrays,
                                                    hp["g_lr"], sub)
            tr_accum.append((m, len(batches)))
            snapper.maybe(state)

        def place_plans(starts, lens):
            """[S, B] int32 plans -> device: batch axis (1) sharded over
            the data mesh (each DP replica gathers its rows from its
            replicated table copy), plain arrays single-device."""
            if mesh is not None:
                return shard_batch(mesh, (jnp.asarray(starts),
                                          jnp.asarray(lens)), axis=1)
            return jnp.asarray(starts), jnp.asarray(lens)

        def run_gathered(t_pad, plans):
            """Dispatch a group of same-shape batch PLANS; features are
            assembled on device from the resident tables."""
            nonlocal state, step_rng
            step_rng, sub = jax.random.split(step_rng)
            starts, lens = place_plans(np.stack([p[0] for p in plans]),
                                       np.stack([p[1] for p in plans]))
            lr_or_hp = hp if is_gan else hp["g_lr"]
            state, m = trainer.train_multi_step_gathered(
                state, feed_tr.inputs_tbl, feed_tr.labels_tbl, starts,
                lens, lr_or_hp, sub, t_pad, args.left_context,
                args.right_context, feed_tr.in_dim, feed_tr.out_dim)
            tr_accum.append((m, len(plans)))
            snapper.maybe(state)

        def plan_shape(batcher, lengths):
            from rsrgan_jax.data.dataset import bucket_id, padded_length
            mx = int(lengths.max())
            b = bucket_id(mx, batcher.num_buckets)
            return padded_length(b, mx, batcher.num_buckets)

        if feed_tr is not None:
            pending = {}
            if rotating:
                shard_k, n_passes = visits[iteration]
                feed_tr.ensure_resident(shard_k)
                if args.feed_prefetch and iteration + 1 < len(visits):
                    feed_tr.start_prefetch(visits[iteration + 1][0])
                streams = [shard_batchers[shard_k]] * n_passes
                eff_epoch += n_passes / feed_tr.num_shards
            else:
                streams = [tr_batches]
                eff_epoch += 1.0
            for stream in streams:
                for indices in stream.iter_index_batches():
                    st, le = feed_tr.plan(indices)
                    true_frames += int(le.sum())
                    t_pad = plan_shape(stream, le)
                    key = (t_pad, len(indices))
                    pending.setdefault(key, []).append((st, le))
                    if len(pending[key]) == steps_per_call:
                        run_gathered(t_pad, pending.pop(key))
            for (t_pad, _), plans in pending.items():
                for p in plans:  # leftovers: S=1 calls, no per-size compiles
                    run_gathered(t_pad, [p])
        elif is_gan and not args.same_batch:
            # graph-fed variant: D and G consume different minibatches
            # (models/gan_rnn.py:66-95, scripts/train_gan_rnn.py:21-80)
            d_accum, g_accum = [], []
            stream = iter(ThreadedPrefetcher(iter(tr_batches), 32))

            def next_arrays():
                nonlocal true_frames
                b = next(stream)
                true_frames += int(b.lengths.sum())
                return place((b.inputs, b.labels, b.lengths))

            try:
                while True:
                    for _ in range(args.disc_updates):
                        step_rng, sub = jax.random.split(step_rng)
                        state, m = trainer.d_step(state, *next_arrays(),
                                                  hp, sub)
                        d_accum.append(m)
                    for _ in range(args.gen_updates):
                        step_rng, sub = jax.random.split(step_rng)
                        state, m = trainer.g_step(state, *next_arrays(),
                                                  hp, sub)
                        g_accum.append(m)
                    snapper.maybe(state)
            except StopIteration:
                pass
            if d_accum and g_accum:
                tr_accum.append(({**_avg(d_accum), **_avg(g_accum)}, 1))
        else:
            for batch in ThreadedPrefetcher(iter(tr_batches), 32):
                true_frames += int(batch.lengths.sum())
                key = batch.inputs.shape
                pending.setdefault(key, []).append(batch)
                if len(pending[key]) == steps_per_call:
                    run_group(pending.pop(key))
            for group in pending.values():
                run_group(group)
        if not tr_accum:
            log("ERROR: empty train batch stream")
            return 1
        # _avg_weighted syncs on the packed metrics, so train_secs measures
        # the completed train section (dispatches are async until here)
        tr_m = _avg_weighted(tr_accum)
        train_secs = (datetime.datetime.now() - start).total_seconds()

        if feed_cv is not None:
            pending = {}

            def run_eval(t_pad, plans):
                nonlocal step_rng
                starts, lens = place_plans(np.stack([p[0] for p in plans]),
                                           np.stack([p[1] for p in plans]))
                if is_gan:
                    step_rng, sub = jax.random.split(step_rng)
                    m = trainer.eval_multi_step_gathered(
                        state, feed_cv.inputs_tbl, feed_cv.labels_tbl,
                        starts, lens, hp, sub, t_pad, args.left_context,
                        args.right_context, feed_cv.in_dim, feed_cv.out_dim)
                else:
                    m = trainer.eval_multi_step_gathered(
                        state, feed_cv.inputs_tbl, feed_cv.labels_tbl,
                        starts, lens, t_pad, args.left_context,
                        args.right_context, feed_cv.in_dim, feed_cv.out_dim)
                cv_accum.append((m, len(plans)))

            for indices in cv_batches.iter_index_batches():
                st, le = feed_cv.plan(indices)
                t_pad = plan_shape(cv_batches, le)
                key = (t_pad, len(indices))
                pending.setdefault(key, []).append((st, le))
                if len(pending[key]) == steps_per_call:
                    run_eval(t_pad, pending.pop(key))
            for (t_pad, _), plans in pending.items():
                for p in plans:
                    run_eval(t_pad, [p])
        else:
            for batch in ThreadedPrefetcher(iter(cv_batches), 32):
                arrays = place((batch.inputs, batch.labels, batch.lengths))
                step_rng, sub = jax.random.split(step_rng)
                if is_gan:
                    metrics = trainer.eval_step(state, *arrays, hp, sub)
                else:
                    metrics = trainer.eval_step(state, *arrays)
                cv_accum.append((metrics, 1))
        if not cv_accum:
            log("ERROR: empty cv batch stream")
            return 1
        cv_m = _avg_weighted(cv_accum)
        if not all(np.isfinite(v) for v in tr_m.values()):
            log(f"FATAL: non-finite training loss at iteration "
                f"{iteration + 1}: {tr_m} — stopping (last accepted "
                f"checkpoint is preserved).")
            return 2
        took = (datetime.datetime.now() - start).total_seconds()
        fps = true_frames / max(train_secs, 1e-9)
        rot_note = ""
        if rotating:
            rot_note = (f" [shard {visits[iteration][0]} x "
                        f"{visits[iteration][1]} passes, epoch "
                        f"{eff_epoch:.2f}, uploads {feed_tr.uploads} "
                        f"({feed_tr.upload_secs:.0f} s total)]")
        log(f"{iteration + 1}/{n_iterations} (INFO): d_learning_rate = "
            f"{float(hp['d_lr']):.5e}, g_learning_rate = "
            f"{float(hp['g_lr']):.5e}, time = {took / 3600.0:.3f} h\n"
            f"{iteration + 1}/{n_iterations} (SPEED): train_frames_per_sec "
            f"= {fps:.0f} (true frames through the cli/train loop, "
            f"{train_secs:.1f} s train section){rot_note}\n"
            f"{iteration + 1}/{n_iterations} (TRAIN AVG.LOSS): "
            f"{_fmt(tr_m, metric_keys)}\n"
            f"{iteration + 1}/{n_iterations} (CROSS AVG.LOSS): "
            f"{_fmt(cv_m, metric_keys)}")
        tr_row = {**tr_m, "train_frames_per_sec": fps,
                  "g_lr": float(hp["g_lr"]), "d_lr": float(hp["d_lr"])}
        if rotating:
            tr_row["eff_epoch"] = eff_epoch
        tr_writer.write(iteration + 1, tr_row)
        cv_writer.write(iteration + 1, cv_m)
        profiler.stop()

        # schedules (train_gan_rnn_placeholder.py:524-533). The reference
        # staircase: epoch 1 runs at the init values (assigned before the
        # loop, :458-461) and epoch k >= 2 at decay(k-1) on COMPLETED
        # epochs. Under rotation a residency boundary can fall mid-epoch,
        # so advance by whole effective corpus epochs (floor) and keep
        # the init values until the first full epoch completes —
        # feeding a fractional epoch into decay() would trip its
        # `iteration + 1 >= num_iters` clause and snap a 1-epoch warm-up
        # to the final value after the first residency.
        sched_t = int(eff_epoch) if rotating else iteration + 1
        if sched_t >= 1:
            hp["g_lr"] = jnp.float32(exponential_decay(
                sched_t, num_devices, min_iters, args.g_learning_rate))
            hp["d_lr"] = jnp.float32(exponential_decay(
                sched_t, num_devices, min_iters, args.d_learning_rate))
            hp["disc_noise_std"] = jnp.float32(exponential_decay(
                sched_t, num_devices, min_iters,
                args.init_disc_noise_std, multiply_jobs=False))

        tracker.add(cv_m["g_loss"])
        if tracker.check(iteration):
            if is_coordinator():
                save_checkpoint(args.save_dir, name, jax.device_get(state),
                                iteration + 1, meta=ckpt_meta(args))
            log(f"Iteration {iteration + 1}: Nnet Accepted. "
                f"Save model SUCCESS.")
        else:
            log(f"Iteration {iteration + 1}: Nnet Rejected.")
        if tracker.should_stop(iteration, min_stop_iters):
            log(f"Iteration {iteration + 1}: Finished, too small relative "
                f"G improvement {tracker.rel_impr:g}")
            break
    log("Training Done.")
    return 0


# ---------------------------------------------------------------------------
# frame trainers (gan_dnn / dnn)
# ---------------------------------------------------------------------------

def run_frame_training(args) -> int:
    trainer = build_trainer(args, jnp.float32)
    is_gan = args.trainer == "gan_dnn"
    is_segan = args.trainer == "segan"
    name = model_name(args)

    tr_store = UtteranceStore(read_list_file(args.tr_list_file))
    cv_store = UtteranceStore(read_list_file(args.cv_list_file))
    mesh, num_devices, pid, pcount = setup_devices(args)
    global_batch = args.batch_size * num_devices

    tr_batches = FrameBatcher(tr_store, global_batch, args.left_context,
                              args.right_context, seed=args.seed)
    cv_batches = FrameBatcher(cv_store, global_batch, args.left_context,
                              args.right_context, shuffle=False,
                              seed=args.seed)
    if pcount > 1:
        tr_batches = HostShardedFrameBatches(tr_batches, pid, pcount)
        cv_batches = HostShardedFrameBatches(cv_batches, pid, pcount)
    log(f"LOG: #train_batch = {tr_batches.num_batches()}, "
        f"#valid_batch = {cv_batches.num_batches()}")

    x0, y0 = next(iter(tr_batches))
    rng = jax.random.PRNGKey(args.seed)
    state = trainer.init_state(rng, jnp.asarray(x0))
    restored, restore_src = restore_state(args, name, state)
    if restored is not None:
        state = restored
        log(f"[*] Load SUCCESS ({restore_src})")
    else:
        log("[!] Begin a new model.")
    if mesh is not None:
        state = replicate(mesh, state)

    snapper = PeriodicSnapshotter(
        args.save_dir, name,
        args.checkpoint_every_secs if is_coordinator() else 0.0)
    show_all_variables(state)
    hp = make_hparams(args, num_devices)
    profiler = Profiler(args.profile_dir)
    g_lr = float(hp["g_lr"])
    tr_writer = MetricsWriter(args.save_dir, "train", args.tensorboard,
                              enabled=is_coordinator())
    cv_writer = MetricsWriter(args.save_dir, "eval", args.tensorboard,
                              enabled=is_coordinator())
    step_rng = jax.random.PRNGKey(args.seed + 1)
    metric_keys = (SEGAN_METRICS if is_segan
                   else GAN_METRICS if is_gan else MSE_METRICS)

    def place(arrays):
        if mesh is not None:
            return shard_batch(mesh, arrays)
        return tuple(jnp.asarray(a) for a in arrays)

    def eval_epoch(state):
        accum = []
        for x, y in cv_batches:
            arrays = place((x, y))
            if is_segan:
                accum.append(trainer.eval_step(state, *arrays, hp,
                                               jax.random.PRNGKey(0)))
            elif is_gan:
                k = jax.random.PRNGKey(0)
                accum.append(trainer.eval_step(state, *arrays, None, hp, k))
            else:
                accum.append(trainer.eval_step(state, *arrays, None))
        return _avg(accum)

    cv_m = eval_epoch(state)
    log(f"CROSSVAL.LOSS PRERUN: {_fmt(cv_m, metric_keys)}")
    g_loss_prev = cv_m["g_loss"]
    decay_steps = 1

    for epoch in range(args.max_epoches):
        if epoch == 1:
            profiler.start()
        start = datetime.datetime.now()
        tr_accum = []
        for x, y in ThreadedPrefetcher(iter(tr_batches), 32):
            arrays = place((x, y))
            step_rng, sub = jax.random.split(step_rng)
            if is_segan:
                state, m = trainer.train_step(state, *arrays, hp, sub)
            elif is_gan:
                state, m = trainer.train_step(state, *arrays, None, hp, sub)
            else:
                state, m = trainer.train_step(state, *arrays, None,
                                              jnp.float32(g_lr), sub)
            tr_accum.append(m)
            snapper.maybe(state)
        tr_m = _avg(tr_accum)
        cv_m = eval_epoch(state)
        took = (datetime.datetime.now() - start).total_seconds()
        log(f"Epoch {epoch + 1} (TRAIN AVG.LOSS): {_fmt(tr_m, metric_keys)},"
            f" learning_rate= {g_lr:.3e}\n"
            f"Epoch {epoch + 1} (CROSS AVG.LOSS): {_fmt(cv_m, metric_keys)},"
            f" TIME USED {took / 3600.0:.2f} h")
        tr_writer.write(epoch + 1, tr_m)
        cv_writer.write(epoch + 1, cv_m)
        profiler.stop()

        g_loss_new = cv_m["g_loss"]
        if g_loss_new < g_loss_prev:
            if is_coordinator():
                save_checkpoint(args.save_dir, name, jax.device_get(state),
                                epoch + 1, meta=ckpt_meta(args))
            log(f"Epoch {epoch + 1}: Nnet Accepted. Save model SUCCESS.")
            g_rel_impr = (g_loss_prev - g_loss_new) / g_loss_prev
            g_loss_prev = g_loss_new
        else:
            # reject + ROLLBACK to previous checkpoint (train_dnn.py:393-414)
            log(f"Epoch {epoch + 1}: Nnet Rejected.")
            rolled = load_checkpoint(args.save_dir, name,
                                     jax.device_get(state))
            if rolled is None:
                log("[!] Load failed. No checkpoint to restore. Exit now.")
                return 1
            state = replicate(mesh, rolled) if mesh is not None else rolled
            snapper.invalidate()
            log("[*] Load previous model SUCCESS.")
            g_rel_impr = (g_loss_prev - g_loss_new) / g_loss_prev

        if g_rel_impr < args.start_decay_impr and \
                epoch + 1 >= args.keep_lr:
            g_lr = staged_decay(args.g_learning_rate * num_devices,
                                args.decay_factor, decay_steps)
            decay_steps += 1
        if g_rel_impr < args.end_decay_impr:
            if epoch < args.min_epoches:
                log(f"Epoch {epoch + 1}: We were supposed to finish, but we "
                    f"continue as min_epoches {args.min_epoches}")
                continue
            log(f"Epoch {epoch + 1}: Finished, too small relative G "
                f"improvement {g_rel_impr:g}")
            break
    log("Training Done.")
    return 0


# ---------------------------------------------------------------------------
# decode (enhancement)
# ---------------------------------------------------------------------------

def validate_checkpoint_compat(args, name: str) -> None:
    """Fail legibly when the decode flags contradict the checkpoint's
    .meta.json sidecar. A wrong --trainer otherwise dies inside flax
    deserialization with an opaque "Missing field ... in state dict", and a
    wrong --g_type (res_lstm_l vs res_lstm_base trees are shape-identical)
    silently decodes garbage."""
    meta = read_checkpoint_meta(args.save_dir, name)
    if meta is None:
        # a wrong --trainer looks for the wrong sidecar filename; fall back
        # to whatever trainer's sidecar IS in the directory
        import glob as _glob
        others = sorted(_glob.glob(os.path.join(args.save_dir,
                                                "*.meta.json")))
        if not others:
            return  # pre-sidecar checkpoint: nothing to validate against
        with open(others[0]) as f:
            meta = json.load(f)
    mismatches = []
    for key, got in [("trainer", args.trainer), ("g_type", args.g_type),
                     ("input_dim", args.input_dim),
                     ("output_dim", args.output_dim),
                     ("left_context", args.left_context),
                     ("right_context", args.right_context)]:
        want = meta.get(key)
        if want is not None and want != got:
            mismatches.append(f"--{key}={got} vs trained {key}={want}")
    if mismatches:
        raise SystemExit(
            f"checkpoint config mismatch in {args.save_dir}: "
            + "; ".join(mismatches)
            + " (from the checkpoint's .meta.json sidecar)")


def run_decode(args) -> int:
    compute_dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    trainer = build_trainer(args, compute_dtype)
    name = model_name(args)
    validate_checkpoint_compat(args, name)
    sequence = args.trainer in ("gan_rnn", "rnn")

    test_store = UtteranceStore(read_list_file(args.test_list_file))
    num_batch = len(test_store)

    example = next(iter(infer_batches(test_store, args.left_context,
                                      args.right_context)))
    rng = jax.random.PRNGKey(0)
    if sequence:
        state = trainer.init_state(rng, jnp.asarray(example.inputs),
                                   jnp.asarray(example.lengths))
    else:
        state = trainer.init_state(rng, jnp.asarray(example.inputs[0]))
    state = load_checkpoint(args.save_dir, name, state,
                            moving_average=args.moving_average)
    if state is None:
        log("[!] Load failed. Checkpoint not found. Exit now.")
        return 1
    log("[*] Load SUCCESS")

    cmvn_filename = os.path.join(args.data_dir, "train_cmvn.npz")
    if not os.path.isfile(cmvn_filename):
        log(f"{cmvn_filename} not exist, exit now.")
        return 1
    _, labels_cmvn = load_cmvn_npz(cmvn_filename)

    out_dir = os.path.join(args.save_dir, "test")
    os.makedirs(out_dir, exist_ok=True)
    writer = ArkWriter(os.path.join(out_dir, "feats.scp"),
                       compress=args.compress, text=args.text)
    ark_path = os.path.join(out_dir, "feats.ark")

    # Data-parallel decode: with --num_gpu>1 the batched enhancement path
    # shards each batch's rows over a 1-D data mesh (replicated G params,
    # XLA SPMD — the serving analogue of training's tower parity). The
    # reference decode is strictly batch-1 single-GPU
    # (train_gan_rnn_placeholder.py:204-302); this is a scale-out extension.
    mesh = None
    if sequence and args.decode_batch_size > 1 and args.num_gpu > 1:
        mesh = make_mesh(args.num_gpu)
        log(f"[*] Decoding over a {dict(mesh.shape)} device mesh")

    if hasattr(state, "g") and args.trainer == "segan":
        g_params = state.g.params

        def infer(inputs, lengths):
            return trainer.infer_step(g_params, inputs)
    elif hasattr(state, "g"):
        g_params = state.g.params
        if mesh is not None:
            g_params = replicate(mesh, g_params)

        def infer(inputs, lengths):
            if mesh is not None:
                inputs, lengths = shard_batch(mesh, (inputs, lengths))
            return trainer.infer_step(g_params, inputs, lengths)
    else:
        if mesh is not None:
            state = replicate(mesh, state)

        def infer(inputs, lengths):
            if mesh is not None and sequence:
                inputs, lengths = shard_batch(mesh, (inputs, lengths))
            return trainer.infer_step(state, inputs,
                                      lengths if sequence else None)

    start = datetime.datetime.now()
    if sequence and args.decode_batch_size > 1:
        _decode_batched(args, test_store, infer, labels_cmvn, writer,
                        ark_path, row_quant=args.num_gpu if mesh else 1)
    else:
        it = ThreadedPrefetcher(
            infer_batches(test_store, args.left_context,
                          args.right_context), 16)
        for i, batch in enumerate(it):
            if sequence:
                act = infer(jnp.asarray(batch.inputs),
                            jnp.asarray(batch.lengths))
                act = np.asarray(act)[0, :int(batch.lengths[0])]
            else:
                act = infer(jnp.asarray(batch.inputs[0]), None)
                act = np.asarray(act)[:int(batch.lengths[0])]
            result = labels_cmvn.denormalize(act)
            writer.write_next_utt(ark_path, batch.utt_ids[0],
                                  np.vstack(result))
            log(f"[{i + 1}/{num_batch}] Write inferred {batch.utt_ids[0]} "
                f"to {ark_path}")
    writer.close()
    took = (datetime.datetime.now() - start).total_seconds()
    log(f"Decoding time is {took}s")
    return 0


def _decode_batched(args, test_store, infer, labels_cmvn, writer,
                    ark_path, row_quant: int = 1) -> None:
    """Batched enhancement: group utterances by padded length (128-frame
    quantization), run B-at-a-time, write results back in scp order.
    A serving-throughput extension over the reference's batch-1 decode.

    ``row_quant``: round each batch's row count up to this multiple with
    zero rows (discarded on write) so the rows divide evenly over a data
    mesh when decoding with --num_gpu>1.
    """
    from rsrgan_jax.data.splice import splice_frames_np

    B = args.decode_batch_size
    lengths = test_store.lengths
    pad = [int(-(-l // 128) * 128) for l in lengths]
    order = sorted(range(len(test_store)), key=lambda i: (pad[i], i))
    results = {}
    idx = 0
    while idx < len(order):
        t_pad = pad[order[idx]]
        group = []
        while (idx < len(order) and len(group) < B
               and pad[order[idx]] == t_pad):
            group.append(order[idx])
            idx += 1
        splice = args.left_context + 1 + args.right_context
        rows = -(-len(group) // row_quant) * row_quant
        x = np.zeros((rows, t_pad, test_store.input_dim * splice),
                     np.float32)
        # dummy pad rows keep full length: zero inputs, outputs discarded
        lens = np.full((rows,), t_pad, np.int32)
        for row, i in enumerate(group):
            feats = splice_frames_np(np.asarray(test_store.inputs(i)),
                                     args.left_context, args.right_context)
            x[row, :feats.shape[0]] = feats
            lens[row] = feats.shape[0]
        act = np.asarray(infer(jnp.asarray(x), jnp.asarray(lens)))
        for row, i in enumerate(group):
            results[i] = labels_cmvn.denormalize(act[row, :lens[row]])
    for i in range(len(test_store)):
        writer.write_next_utt(ark_path, test_store.utt_ids[i],
                              np.vstack(results[i]))
    log(f"Wrote {len(results)} utterances (batched decode, B={B})")


# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rsrgan_jax.cli.train")
    p.add_argument("--trainer", default="gan_rnn",
                   choices=["gan_rnn", "gan_dnn", "rnn", "dnn", "segan"])
    p.add_argument("--decode", action="store_true", default=False)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--tr_list_file", type=str, default=None)
    p.add_argument("--cv_list_file", type=str, default=None)
    p.add_argument("--test_list_file", type=str, default=None)
    p.add_argument("--input_dim", type=int, default=257)
    p.add_argument("--output_dim", type=int, default=40)
    p.add_argument("--left_context", type=int, default=0)
    p.add_argument("--right_context", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--g_learning_rate", type=float, default=0.0003)
    p.add_argument("--d_learning_rate", type=float, default=0.001)
    p.add_argument("--min_epoches", type=int, default=25)
    p.add_argument("--max_epoches", type=int, default=30)
    p.add_argument("--end_improve", type=float, default=0.001)
    p.add_argument("--num_threads", type=int, default=8)
    p.add_argument("--save_dir", type=str, default="exp/gan_rnn")
    p.add_argument("--init_mse_weight", type=float, default=1.0)
    p.add_argument("--init_l1_weight", type=float, default=100.0)
    p.add_argument("--g_nl", default="leaky", choices=["leaky", "prelu"])
    p.add_argument("--bias_deconv", type=str2bool, nargs="?", const=True, default=True)
    p.add_argument("--bias_downconv", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--deconv_type", default="deconv",
                   choices=["deconv", "nn_deconv"])
    p.add_argument("--g_enc_depths",
                   default="16,32,32,64,64,128,128,256,256,512,1024",
                   help="comma list of SEGAN encoder/D depths")
    p.add_argument("--g_type", type=str, default="lstm")
    p.add_argument("--disc_updates", type=int, default=1)
    p.add_argument("--gen_updates", type=int, default=2)
    p.add_argument("--batch_norm", type=str2bool, nargs="?", const=True, default=False)
    p.add_argument("--keep_prob", type=float, default=1.0)
    p.add_argument("--init_disc_noise_std", type=float, default=0.0)
    p.add_argument("--l2_scale", type=float, default=0.00001)
    p.add_argument("--num_gpu", type=int, default=1,
                   help="number of devices (data-parallel replicas); with "
                        "--decode --decode_batch_size>1 it also shards "
                        "decode batches over the mesh")
    # frame-trainer schedule flags (train_dnn.py)
    p.add_argument("--start_decay_impr", type=float, default=0.003)
    p.add_argument("--end_decay_impr", type=float, default=0.0005)
    p.add_argument("--keep_lr", type=int, default=3)
    p.add_argument("--decay_factor", type=float, default=0.5)
    # beyond the reference
    p.add_argument("--compress", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="write decoded feats.ark as Kaldi CompressedMatrix "
                        "(copy-feats --compress=true equivalent)")
    p.add_argument("--text", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="write decoded feats.ark as a Kaldi TEXT archive "
                        "(copy-feats ark,t: equivalent)")
    p.add_argument("--coordinator_address", type=str, default="",
                   help="host:port of process 0; enables multi-host data "
                        "parallelism over DCN (jax.distributed)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--checkpoint_every_secs", type=float, default=0.0,
                   help="also snapshot the live state every N seconds "
                        "mid-iteration (crash recovery; 0 = off)")
    p.add_argument("--tensorboard", type=str2bool, nargs="?", const=True, default=True,
                   help="also write TensorBoard event files under "
                        "save_dir/{train,eval} (reference FileWriter parity)")
    p.add_argument("--bf16", type=str2bool, nargs="?", const=True, default=True,
                   help="bfloat16 matmuls in models (float32 state)")
    p.add_argument("--steps_per_call", type=int, default=8,
                   help="same-bucket train steps fused under one jit")
    p.add_argument("--device_feed", default="auto",
                   choices=["auto", "on", "off"],
                   help="keep the corpus resident in device memory and "
                        "assemble batches on device (sequence trainers, "
                        "single-process; tables replicate over a "
                        "--num_gpu mesh). auto = on when the backend is "
                        "a GPU; corpora past the memory budget (device "
                        "bytes_limit less a working-set reserve, or "
                        "$RSRGAN_FEED_HBM_BUDGET) rotate resident shards")
    p.add_argument("--device_feed_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="resident table dtype; bfloat16 halves HBM + "
                        "upload time (features quantize, training "
                        "conventions unchanged)")
    p.add_argument("--feed_rotation_block", type=int, default=1,
                   help="consecutive passes per shard residency when the "
                        "device feed rotates (1 = every epoch visits "
                        "every shard — reference-faithful; larger blocks "
                        "amortize shard uploads into block-shuffled SGD)")
    p.add_argument("--feed_prefetch", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="upload the next shard on a background thread "
                        "while training on the current one (rotation "
                        "only; doubles shard buffers, halves shard size)")
    p.add_argument("--d_conditioned", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="sequence GAN (gan_rnn): condition D on "
                        "concat(center input frame, labels/G output) — "
                        "the joint discriminator the reference sketched "
                        "but left commented out "
                        "(gan_rnn_placeholder.py:192-213); default False "
                        "matches its active unconditioned D. The frame "
                        "GAN (gan_dnn) is always conditioned, as "
                        "upstream (gan.py:159-182)")
    p.add_argument("--same_batch", type=str2bool, nargs="?", const=True, default=True,
                   help="True: placeholder-trainer semantics (D and G on "
                        "the same minibatch); False: graph-fed semantics "
                        "(each update pulls a fresh batch)")
    p.add_argument("--moving_average", type=str2bool, nargs="?", const=True,
                   default=False, help="decode with EMA shadow params")
    p.add_argument("--decode_batch_size", type=int, default=1,
                   help=">1: batched enhancement grouped by padded length")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="capture an XLA profiler trace of iteration 2")
    p.add_argument("--bias_d_conv", type=str2bool, nargs="?", const=True,
                   default=True,
                   help="bias the SEGAN discriminator convs "
                        "(train_segan.py --bias_D_conv)")
    # Accepted spellings from the reference's other drivers / run scripts.
    # Upstream these drift (min_epochs vs min_epoches,
    # --start_halving_impr passed by run_dnn.sh to a driver that only
    # knows start_decay_impr) and get SILENTLY dropped by
    # parse_known_args; here they alias the canonical flag.
    p.add_argument("--min_epochs", type=int, default=None,
                   help="alias of --min_epoches (train_rnn.py spelling)")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="alias of --max_epoches (train_rnn.py spelling)")
    p.add_argument("--init_noise_std", type=float, default=None,
                   help="alias of --init_disc_noise_std (train_segan.py)")
    p.add_argument("--start_halving_impr", type=float, default=None,
                   help="alias of --start_decay_impr (run_dnn.sh spelling)")
    p.add_argument("--end_halving_impr", type=float, default=None,
                   help="alias of --end_decay_impr (run_dnn.sh spelling)")
    p.add_argument("--halving_factor", type=float, default=None,
                   help="alias of --decay_factor (run_dnn.sh spelling)")
    return p


_FLAG_ALIASES = (
    ("min_epochs", "min_epoches"),
    ("max_epochs", "max_epoches"),
    ("init_noise_std", "init_disc_noise_std"),
    ("start_halving_impr", "start_decay_impr"),
    ("end_halving_impr", "end_decay_impr"),
    ("halving_factor", "decay_factor"),
)


def apply_flag_aliases(args) -> None:
    for alias, canonical in _FLAG_ALIASES:
        value = getattr(args, alias)
        if value is not None:
            setattr(args, canonical, value)


def main(argv=None) -> int:
    args, unparsed = build_parser().parse_known_args(argv)
    apply_flag_aliases(args)
    if args.coordinator_address:
        pid, pcount = init_distributed(args.coordinator_address,
                                       args.num_processes, args.process_id)
        log(f"LOG: distributed process {pid}/{pcount}, "
            f"{jax.device_count()} global devices")
    enable_compile_cache()
    log("*** Parsed arguments ***")
    log(json.dumps(vars(args), indent=1, default=str))
    if unparsed:
        log(f"WARNING: ignoring unknown flags {unparsed}")
    if args.decode:
        return run_decode(args)
    if args.trainer in ("gan_rnn", "rnn"):
        return run_sequence_training(args)
    return run_frame_training(args)  # dnn / gan_dnn / segan


if __name__ == "__main__":
    sys.exit(main())
