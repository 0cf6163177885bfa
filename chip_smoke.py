"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py               # every phase below, on one card
    python chip_smoke.py --devices 4   # only the data-parallel phase

Everything runs in this one process (a JAX process holds most of a card's
memory). Phases, at the flagship's full width (res_lstm_l G: 257 in,
4x LSTM-760 with projection 257, 40 out; LSTM D: 2x LSTM-256 with
projection 40), with random weights made from a seed:

  (a) device check: the default backend must be a GPU; prints the device,
      the JAX version, XLA_FLAGS and the card's name and power limit;
  (b) parity: forward and gradients of G+D at B=4, T=200 with masked
      lengths, on the card against the same function on the CPU;
  (c) training: cli/train on a seeded synthetic store (lengths 455-500),
      gan_rnn with the device feed on, with it off, and the rnn trainer;
  (d) decode: cli/train --decode --decode_batch_size 8, against the
      trainer's infer_step;
  (e) serve: cli/serve on the same checkpoint, against (d);
  (f) features: cli/extract LPS and MFCC against the same extraction on
      the CPU;
  (g) the path above never imported flax.

With ``--devices 4`` it runs only flagship gan_rnn training over a 4-card
``data`` mesh at global B=64 for 2 steps, against the same 2 steps on one
card. No phase catches its own failure: any failure exits nonzero. The
last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np

IN_DIM, OUT_DIM = 257, 40
# Bounds on the relative L2 error ||got - ref|| / ||ref|| of each tensor.
# float32 at "highest" precision differs from the CPU only by summation
# order; TF32 and bfloat16 keep 10 and 7 mantissa bits in the matmul
# inputs (float32 accumulation), ~1e-3 and ~4e-3 per rounding.
TOL_F32 = 1e-4
TOL_REDUCED = 2e-2
TOL_FEATURES = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                  1e-30))


def tree_rel_err(got, ref) -> float:
    """Worst leaf's relative L2 error."""
    import jax

    return max(rel_err(g, r) for g, r in zip(jax.tree.leaves(got),
                                              jax.tree.leaves(ref)))


def check(label: str, err: float, bound: float) -> None:
    log(f"  {label}: rel err {err:.3e} (bound {bound:.0e})")
    if not err <= bound:
        raise AssertionError(f"{label}: rel err {err:.3e} > {bound:.0e}")


def flagship(compute_dtype, in_dim=IN_DIM, out_dim=OUT_DIM, cell=760,
             d_cell=256):
    from rsrgan_jax.models import LstmDiscriminator, ResLstmGenerator

    return (ResLstmGenerator(output_dim=out_dim, variant="l", cell_size=cell,
                             compute_dtype=compute_dtype),
            LstmDiscriminator(cell_size=d_cell, num_projection=out_dim,
                              compute_dtype=compute_dtype))


def phase_parity(gpu, cpu, B=4, T=200, in_dim=IN_DIM, out_dim=OUT_DIM,
                 cell=760, d_cell=256) -> None:
    """(b) G+D forward and gradients on the card vs the CPU."""
    import jax
    import jax.numpy as jnp

    log(f"(b) parity: G+D forward and gradients, B={B} T={T}")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, in_dim)).astype(np.float32)
    y = rng.normal(size=(B, T, out_dim)).astype(np.float32)
    lengths = rng.integers(T // 2, T + 1, size=(B,)).astype(np.int32)
    lengths[0] = T

    def make_fn(compute_dtype):
        gen, disc = flagship(compute_dtype, in_dim, out_dim, cell, d_cell)

        def loss_fn(g_params, d_params, x, y, lengths):
            out = gen.apply({"params": g_params}, x, lengths)
            logits = disc.apply({"params": d_params}, out, lengths)
            mask = (jnp.arange(T)[None, :] < lengths[:, None])[..., None]
            loss = (jnp.sum(jnp.where(mask, (logits - 1.0) ** 2, 0.0))
                    + jnp.sum(jnp.where(mask, (out - y) ** 2, 0.0))
                    ) / jnp.sum(lengths)
            return loss, (out, logits)

        return gen, disc, jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))

    gen, disc, _ = make_fn(jnp.float32)
    with jax.default_device(cpu):
        g_params = gen.init(jax.random.PRNGKey(1), x)["params"]
        d_params = disc.init(jax.random.PRNGKey(2), y)["params"]

    def run(device, compute_dtype, precision):
        fn = make_fn(compute_dtype)[2]
        args = jax.device_put((g_params, d_params, x, y, lengths), device)
        with jax.default_matmul_precision(precision):
            (_, (out, logits)), grads = fn(*args)
        return jax.tree.map(np.asarray, (out, logits, grads))

    ref = run(cpu, jnp.float32, "highest")
    for name, dtype, precision, bound in (
            ("float32, precision highest", jnp.float32, "highest", TOL_F32),
            ("float32, default precision (TF32)", jnp.float32, "default",
             TOL_REDUCED),
            ("bfloat16 compute", jnp.bfloat16, "default", TOL_REDUCED)):
        out, logits, (g_grads, d_grads) = run(gpu, dtype, precision)
        log(f" {name}:")
        check("G output", rel_err(out, ref[0]), bound)
        check("D logits", rel_err(logits, ref[1]), bound)
        check("G grads (worst leaf)", tree_rel_err(g_grads, ref[2][0]),
              bound)
        check("D grads (worst leaf)", tree_rel_err(d_grads, ref[2][1]),
              bound)


def write_corpus(root: str, in_dim: int, out_dim: int, lengths=(455, 500),
                 sizes=(("tr", 64), ("cv", 16), ("test", 12))) -> dict:
    """Seeded stores (labels a fixed linear map of the inputs plus noise)
    and a train_cmvn.npz; returns {split: list file}."""
    from rsrgan_jax.data import StoreWriter

    rng = np.random.default_rng(11)
    w = rng.normal(size=(in_dim, out_dim)).astype(np.float32) * 0.05
    lists = {}
    for name, n in sizes:
        path = os.path.join(root, f"{name}.rtu")
        with StoreWriter(path) as writer:
            for i in range(n):
                t = int(rng.integers(*lengths))
                x = rng.normal(size=(t, in_dim)).astype(np.float32)
                y = x @ w + 0.1 * rng.normal(size=(t, out_dim)).astype(
                    np.float32)
                writer.add(f"{name}{i:04d}", x, y)
        lists[name] = os.path.join(root, f"{name}.list")
        with open(lists[name], "w") as f:
            f.write(path + "\n")
    np.savez(os.path.join(root, "train_cmvn.npz"),
             mean_inputs=np.zeros(in_dim, np.float32),
             stddev_inputs=np.ones(in_dim, np.float32),
             mean_labels=np.full(out_dim, 1.5, np.float32),
             stddev_labels=np.full(out_dim, 2.0, np.float32))
    return lists


def run_cli(main, argv, log_path: str) -> str:
    """Run a CLI ``main`` with its output in ``log_path``; returns the log.
    A nonzero exit raises with the log's tail."""
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        rc = main(argv)
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        raise RuntimeError(f"{main.__module__} {argv} exited {rc}:\n"
                           + text[-3000:])
    return text


def read_scp(path: str) -> dict:
    from rsrgan_jax.data import ScpReader

    return {utt: np.asarray(mat) for utt, mat in ScpReader(path)}


def phase_training(root: str, lists: dict, in_dim: int, out_dim: int
                   ) -> str:
    """(c) three cli/train runs; returns the gan_rnn save_dir."""
    from rsrgan_jax.cli import train as train_cli

    common = [f"--tr_list_file={lists['tr']}",
              f"--cv_list_file={lists['cv']}", f"--data_dir={root}",
              f"--input_dim={in_dim}", f"--output_dim={out_dim}",
              "--batch_size=16", "--min_epoches=1", "--max_epoches=1",
              "--tensorboard=false"]
    gan = ["--trainer=gan_rnn", "--g_type=res_lstm_l",
           "--g_learning_rate=8e-5", "--d_learning_rate=1e-3",
           "--disc_updates=1", "--gen_updates=2", "--init_mse_weight=10.0",
           "--init_disc_noise_std=0.05"]
    # (label, save_dir name, flags, device feed expected on)
    runs = (("gan_rnn, device feed on", "gan_feed", gan
             + ["--device_feed=on"], True),
            ("gan_rnn, device feed off", "gan_host", gan
             + ["--device_feed=off"], False),
            ("rnn, device feed auto", "rnn", [
                "--trainer=rnn", "--g_type=res_lstm_l",
                "--g_learning_rate=3e-4"], True))
    log("(c) training: one iteration of cli/train each")
    for label, sub, argv, feed_on in runs:
        save_dir = os.path.join(root, sub)
        text = run_cli(train_cli.main, common + argv
                       + [f"--save_dir={save_dir}"],
                       os.path.join(root, f"{sub}.log"))
        if ("device feed:" in text) != feed_on:
            raise AssertionError(f"{label}: device feed is not "
                                 f"{'on' if feed_on else 'off'}")
        with open(os.path.join(save_dir, "metrics_train.jsonl")) as f:
            row = json.loads(f.readlines()[-1])
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"{label}: non-finite metrics {row}")
        if not os.path.isfile(os.path.join(save_dir, "checkpoint")):
            raise AssertionError(f"{label}: no checkpoint written")
        log(f"  {label}: g_loss {row['g_loss']:.5f}, "
            f"{row['train_frames_per_sec']:.0f} true frames/s "
            "(first iteration, compiles included), checkpoint written")
    return os.path.join(root, "gan_feed")


def phase_decode(root: str, lists: dict, save_dir: str, in_dim: int,
                 out_dim: int) -> dict:
    """(d) batched decode vs the trainer's infer_step; returns its output."""
    import jax
    import jax.numpy as jnp

    from rsrgan_jax.cli import train as train_cli
    from rsrgan_jax.data import UtteranceStore, load_cmvn_npz, \
        read_list_file
    from rsrgan_jax.training import load_checkpoint

    log("(d) decode: --decode --decode_batch_size 8 vs infer_step")
    argv = ["--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
            f"--data_dir={root}", f"--test_list_file={lists['test']}",
            f"--save_dir={save_dir}", f"--input_dim={in_dim}",
            f"--output_dim={out_dim}", "--decode_batch_size=8"]
    run_cli(train_cli.main, argv, os.path.join(root, "decode.log"))
    decoded = read_scp(os.path.join(save_dir, "test", "feats.scp"))

    args = train_cli.build_parser().parse_args(argv)
    trainer = train_cli.build_trainer(args, jnp.bfloat16)
    store = UtteranceStore(read_list_file(lists["test"]))
    t_pad = int(-(-store.lengths.max() // 128) * 128)
    x = np.zeros((1, t_pad, in_dim), np.float32)
    state = trainer.init_state(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.full((1,), t_pad, jnp.int32))
    state = load_checkpoint(save_dir, "GAN_RNN", state)
    _, labels_cmvn = load_cmvn_npz(os.path.join(root, "train_cmvn.npz"))
    if sorted(decoded) != sorted(store.utt_ids):
        raise AssertionError("decode wrote other utterances than the store")
    worst = 0.0
    for i, utt in enumerate(store.utt_ids):
        n = int(store.lengths[i])
        x[:] = 0.0
        x[0, :n] = store.inputs(i)
        ref = trainer.infer_step(state.g.params, jnp.asarray(x),
                                 jnp.full((1,), n, jnp.int32))
        ref = labels_cmvn.denormalize(np.asarray(ref)[0, :n])
        got = decoded[utt]
        if got.shape != (n, out_dim) or not np.isfinite(got).all():
            raise AssertionError(f"{utt}: decoded {got.shape}, finite "
                                 f"{np.isfinite(got).all()}")
        worst = max(worst, rel_err(got, ref))
    check(f"{len(decoded)} utterances, {out_dim}-dim, finite; decode vs "
          "infer_step (bfloat16, B=8 vs B=1)", worst, TOL_REDUCED)
    return decoded


def phase_serve(root: str, lists: dict, save_dir: str, decoded: dict,
                in_dim: int, out_dim: int) -> None:
    """(e) cli/serve on the same checkpoint vs (d)."""
    from rsrgan_jax.cli import serve as serve_cli

    log("(e) serve: cli/serve, 50-frame chunks, vs decode")
    run_cli(serve_cli.main, [
        f"--save_dir={save_dir}", f"--data_dir={root}",
        f"--test_list_file={lists['test']}", "--chunk_frames=50",
        "--trainer=gan_rnn", "--g_type=res_lstm_l",
        f"--input_dim={in_dim}", f"--output_dim={out_dim}"],
        os.path.join(root, "serve.log"))
    served = read_scp(os.path.join(save_dir, "stream", "feats.scp"))
    if sorted(served) != sorted(decoded):
        raise AssertionError("serve wrote other utterances than decode")
    worst = max(rel_err(served[u], decoded[u]) for u in decoded)
    check("serve (float32) vs decode (bfloat16)", worst, TOL_REDUCED)


def phase_features(root: str, cpu, n_waves: int = 4) -> None:
    """(f) cli/extract LPS + MFCC on the card vs the CPU."""
    import jax
    import jax.numpy as jnp

    from rsrgan_jax.cli import extract as extract_cli
    from rsrgan_jax.features import (FrameOptions, MfccOptions,
                                     SpectrogramOptions, compute_mfcc,
                                     compute_spectrogram)
    from rsrgan_jax.sim.wavio import read_wav, write_wav

    log(f"(f) features: cli/extract LPS and MFCC on {n_waves} waves vs CPU")
    rng = np.random.default_rng(5)
    scp = os.path.join(root, "wav.scp")
    with open(scp, "w") as f:
        for i in range(n_waves):
            n = int(rng.integers(16000, 48000))
            t = np.arange(n) / 16000.0
            wave = (3000.0 * np.sin(2 * np.pi * (200 + 150 * i) * t)
                    + 500.0 * rng.normal(size=n))
            path = os.path.join(root, f"w{i}.wav")
            write_wav(path, wave)
            f.write(f"w{i} {path}\n")
    frame_opts = FrameOptions(dither=0.0)
    for feat_type, name, compute, opts in (
            ("spectrogram", "lps", compute_spectrogram,
             SpectrogramOptions(frame_opts)),
            ("mfcc", "mfcc", compute_mfcc,
             MfccOptions(frame_opts=frame_opts))):
        out_dir = os.path.join(root, "feats")
        run_cli(extract_cli.main, [
            f"--wav_scp={scp}", f"--feat_type={feat_type}",
            f"--output_dir={out_dir}", f"--name={name}", "--dither=0"],
            os.path.join(root, f"extract_{name}.log"))
        got = read_scp(os.path.join(out_dir, f"{name}.scp"))
        worst = 0.0
        for i in range(n_waves):
            wave, _ = read_wav(os.path.join(root, f"w{i}.wav"))
            with jax.default_device(cpu):
                ref = np.asarray(compute(jnp.asarray(wave, jnp.float32),
                                         opts))
            if got[f"w{i}"].shape != ref.shape:
                raise AssertionError(f"{name} w{i}: {got[f'w{i}'].shape} vs "
                                     f"{ref.shape}")
            worst = max(worst, rel_err(got[f"w{i}"], ref))
        check(f"{name} {ref.shape[1]}-dim, card vs CPU", worst, TOL_FEATURES)


def phase_data_parallel(devices, B=64, T=500, steps=2, in_dim=IN_DIM,
                        out_dim=OUT_DIM, cell=760, d_cell=256) -> None:
    """Flagship gan_rnn steps over a data mesh of ``devices`` vs the same
    steps on one device.

    Tolerance: the two runs reduce gradients in different orders, so they
    differ in the last bits. G's Adam scales every update to about the
    learning rate, so a gradient entry near zero whose sign differs moves
    that weight by up to 2 x g_lr per G update: 2 steps x 2 G updates x
    2 x 1e-4 = 8e-4. Parameters must agree to 1e-3 absolute, and the
    losses to TOL_REDUCED relative.
    """
    import jax
    import jax.numpy as jnp

    from rsrgan_jax.parallel import make_mesh, replicate, shard_batch
    from rsrgan_jax.training import GanTrainer

    n = len(devices)
    log(f"data parallel: flagship gan_rnn, global B={B} T={T}, {steps} "
        f"steps over a {n}-device data mesh vs one device")
    gen, disc = flagship(jnp.bfloat16, in_dim, out_dim, cell, d_cell)
    trainer = GanTrainer(gen, disc, output_dim=out_dim, input_dim=in_dim,
                         disc_updates=1, gen_updates=2, l2_scale=0.0,
                         max_grad_norm=15.0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, in_dim)).astype(np.float32)
    y = rng.normal(size=(B, T, out_dim)).astype(np.float32)
    lengths = rng.integers(int(0.9 * T), T + 1, size=(B,)).astype(np.int32)
    hp = {"g_lr": np.float32(1e-4), "d_lr": np.float32(1e-3),
          "mse_lambda": np.float32(10.0), "disc_noise_std": np.float32(0.05),
          "d_real": np.float32(1.0), "d_fake": np.float32(0.0)}
    with jax.default_device(devices[0]):
        state0 = jax.tree.map(np.asarray, trainer.init_state(
            jax.random.PRNGKey(0), jnp.asarray(x[:2]),
            jnp.asarray(lengths[:2])))

    def train(state, batch):
        metrics = None
        for k in range(steps):
            state, metrics = trainer.train_step(
                state, *batch, hp, jax.random.PRNGKey(10 + k))
        return jax.tree.map(np.asarray, (state, metrics))

    single = train(jax.device_put(state0, devices[0]),
                   jax.device_put((x, y, lengths), devices[0]))
    mesh = make_mesh(devices=devices)
    dp = train(replicate(mesh, state0), shard_batch(mesh, (x, y, lengths)))
    for net in ("g", "d"):
        a = getattr(single[0], net).params
        b = getattr(dp[0], net).params
        diff = max(float(np.max(np.abs(u - v)))
                   for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
        moved = max(float(np.max(np.abs(u - v))) for u, v in zip(
            jax.tree.leaves(a), jax.tree.leaves(getattr(state0, net).params)))
        log(f"  {net.upper()} params: max |dp - single| {diff:.3e} (bound "
            f"1e-03); max move from init {moved:.3e}")
        if not diff <= 1e-3:
            raise AssertionError(f"{net} params differ by {diff:.3e}")
    for k, v in single[1].items():
        check(f"{k} ({float(v):.5f})", rel_err(dp[1][k], v), TOL_REDUCED)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=1, choices=[1, 4],
                   help="4: run only data-parallel training over 4 cards")
    args = p.parse_args(argv)

    from rsrgan_jax.cli import enable_compile_cache, require_gpu

    devices, _ = require_gpu("chip_smoke.py")  # (a)
    if len(devices) < args.devices:
        raise SystemExit(f"chip_smoke.py --devices {args.devices} found "
                         f"{len(devices)} GPUs")
    devices = devices[:args.devices]
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_compile_cache()}")
    import jax

    if args.devices > 1:
        phase_data_parallel(devices)
    else:
        cpu = jax.devices("cpu")[0]
        phase_parity(devices[0], cpu)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            lists = write_corpus(root, IN_DIM, OUT_DIM)
            save_dir = phase_training(root, lists, IN_DIM, OUT_DIM)
            decoded = phase_decode(root, lists, save_dir, IN_DIM, OUT_DIM)
            phase_serve(root, lists, save_dir, decoded, IN_DIM, OUT_DIM)
            phase_features(root, cpu)
        if "flax" in sys.modules:
            raise AssertionError("the main path imported flax")
        log("(g) flax was not imported")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
