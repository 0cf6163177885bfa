"""Streaming enhancement CLI: bounded-latency serving over Kaldi I/O.

Beyond the reference (which only enhances offline, batch-1, whole
utterances — scripts/train_gan_rnn_placeholder.py:204-302): this driver
runs the flagship generator through serving.StreamingEnhancer, processing
each utterance in fixed-size chunks with carried recurrent state — the
processing mode an online dereverberation front-end needs. The chunked
forward is EXACT (res_lstm_l is causal; tests/test_streaming.py proves
bit-equality with the whole-utterance forward), so the emitted
feats.ark/feats.scp match an offline decode up to kernel dtype.

Usage::

    python -m rsrgan_jax.cli.serve \
        --save_dir exp/gan_res_lstm_l --data_dir data/train/train_100h \
        --test_list_file data/test/test001/test.list \
        --chunk_frames 50

    # wav -> wav streaming (LPS->LPS checkpoints, --output_dim 257):
    python -m rsrgan_jax.cli.serve \
        --save_dir exp/gan_lps2lps --data_dir data/train \
        --wav_scp noisy_wav.scp --output_dim 257 --chunk_frames 50

The wav mode runs the whole pipeline online — streaming LPS analysis,
carried-state generator forward, WOLA resynthesis with the current
chunk's noisy phase (serving/wav_stream.py) — and writes enhanced wavs
plus a wav.scp.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from rsrgan_jax.cli import enable_compile_cache, str2bool
from rsrgan_jax.data import (ArkWriter, UtteranceStore, infer_batches,
                             load_cmvn_npz, read_list_file)
from rsrgan_jax.serving import StreamingEnhancer


def log(msg: str) -> None:
    print(msg)
    sys.stdout.flush()


def apply_checkpoint_meta(args, meta) -> None:
    """Fill the trainer settings serve has no flag for from the
    checkpoint's .meta.json sidecar: ``d_conditioned`` changes D's input
    width, which is part of the tree the checkpoint restores into."""
    args.d_conditioned = bool((meta or {}).get("d_conditioned", False))


def load_generator_params(args):
    """The generator's param tree from a training checkpoint."""
    from rsrgan_jax.cli.train import build_trainer, model_name
    from rsrgan_jax.serving.streaming import SUPPORTED_VARIANTS
    from rsrgan_jax.training import load_checkpoint, read_checkpoint_meta

    if args.g_type not in SUPPORTED_VARIANTS:
        raise SystemExit(f"serve supports --g_type in {SUPPORTED_VARIANTS} "
                         f"(got {args.g_type})")
    meta = read_checkpoint_meta(args.save_dir, model_name(args))
    apply_checkpoint_meta(args, meta)
    if meta is not None and meta.get("g_type") not in (None, args.g_type):
        # the param trees of res_lstm_l / res_lstm_base are shape-identical,
        # so only this sidecar can catch serving with the wrong wiring
        raise SystemExit(
            f"checkpoint in {args.save_dir} was trained with "
            f"--g_type={meta['g_type']} but serve got "
            f"--g_type={args.g_type}; serving with the wrong wiring would "
            "silently produce garbage")
    trainer = build_trainer(args, jnp.float32)
    rng = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 8, args.input_dim), jnp.float32)
    lens = jnp.full((1,), 8, jnp.int32)
    state = trainer.init_state(rng, x, lens)
    state = load_checkpoint(args.save_dir, model_name(args), state,
                            moving_average=args.moving_average)
    if state is None:
        return None
    return state.g.params if hasattr(state, "g") else state.params


def _stream_single(args, params, inputs_cmvn, labels_cmvn, opts, entries,
                   out_dir, scp):
    """One stream at a time through StreamingWavEnhancer."""
    from rsrgan_jax.serving.wav_stream import StreamingWavEnhancer
    from rsrgan_jax.sim.wavio import read_wav, write_wav

    enhancer = StreamingWavEnhancer(
        params, inputs_cmvn, labels_cmvn, variant=args.g_type,
        frame_opts=opts, chunk_frames=args.chunk_frames)
    # feed in chunk-sized sample blocks (frames * shift per step)
    block = args.chunk_frames * opts.window_shift
    total = 0
    for i, (utt_id, wav_path) in enumerate(entries):
        wave, rate = read_wav(wav_path)
        if rate != opts.samp_freq:
            log(f"WARNING: {utt_id} rate {rate} != {opts.samp_freq:g}")
        enhancer.reset()
        outs = [enhancer.process(wave[lo:lo + block])
                for lo in range(0, len(wave), block)]
        outs.append(enhancer.flush())
        y = np.concatenate(outs)
        out_path = os.path.join(out_dir, f"{utt_id}.wav")
        write_wav(out_path, y, rate=int(rate))
        scp.write(f"{utt_id} {out_path}\n")
        total += len(wave)
        log(f"[{i + 1}/{len(entries)}] Streamed {utt_id} "
            f"({len(wave)} samples, blocks of {block})")
    return total


def _stream_pooled(args, params, inputs_cmvn, labels_cmvn, opts, entries,
                   out_dir, scp):
    """All wavs interleaved through one batched StreamPool: every device
    dispatch carries up to --num_streams lanes, so throughput scales with
    concurrency instead of paying batch-1 latency per chunk."""
    from rsrgan_jax.serving.pool import StreamPool
    from rsrgan_jax.sim.wavio import read_wav, write_wav

    pool = StreamPool(params, inputs_cmvn, labels_cmvn,
                      variant=args.g_type, frame_opts=opts,
                      chunk_frames=args.chunk_frames,
                      capacity=args.num_streams)
    block = args.chunk_frames * opts.window_shift
    todo = list(entries)
    active = {}  # sid -> [utt_id, wave, pos, outs]
    done = total = 0
    while todo or active:
        while todo and pool.active < pool.capacity:
            utt_id, wav_path = todo.pop(0)
            wave, rate = read_wav(wav_path)
            if rate != opts.samp_freq:
                log(f"WARNING: {utt_id} rate {rate} != {opts.samp_freq:g}")
            active[pool.open()] = [utt_id, wave, 0, [], int(rate)]
        for sid in list(active):
            utt_id, wave, pos, outs, rate = active[sid]
            if pos < len(wave):
                outs.append(pool.feed(sid, wave[pos:pos + block]))
                active[sid][2] = pos + block
            else:
                outs.append(pool.close(sid))
                y = np.concatenate(outs)
                out_path = os.path.join(out_dir, f"{utt_id}.wav")
                write_wav(out_path, y, rate=rate)
                scp.write(f"{utt_id} {out_path}\n")
                total += len(wave)
                done += 1
                log(f"[{done}/{len(entries)}] Streamed {utt_id} "
                    f"({len(wave)} samples, {pool.active} peers)")
                del active[sid]
    log(f"Pool: {pool.steps_run} batched dispatches, "
        f"{pool.frames_run} frames "
        f"({pool.frames_run / max(pool.steps_run, 1):.1f} per dispatch, "
        f"capacity {pool.capacity * args.chunk_frames})")
    return total


def serve_wavs(args, params, inputs_cmvn, labels_cmvn) -> int:
    """wav->wav streaming over an scp of noisy wavs."""
    from rsrgan_jax.features.frontend import FrameOptions

    opts = FrameOptions(dither=0.0)
    out_dir = args.output_dir or os.path.join(args.save_dir, "stream_wav")
    os.makedirs(out_dir, exist_ok=True)
    with open(args.wav_scp) as f:
        entries = [line.strip().split(None, 1) for line in f if line.strip()]

    runner = _stream_pooled if args.num_streams > 1 else _stream_single
    start = datetime.datetime.now()
    with open(os.path.join(out_dir, "wav.scp"), "w") as scp:
        total = runner(args, params, inputs_cmvn, labels_cmvn, opts,
                       entries, out_dir, scp)
    took = (datetime.datetime.now() - start).total_seconds()
    mode = (f"{args.num_streams} pooled streams"
            if args.num_streams > 1 else "single stream")
    log(f"Streaming done: {total} samples in {took:.2f}s "
        f"({total / max(took, 1e-9) / opts.samp_freq:.2f}x realtime "
        f"host-synced, {mode})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--data_dir", required=True,
                   help="directory holding train_cmvn.npz")
    p.add_argument("--test_list_file", default=None,
                   help="feature-store mode input (required unless "
                        "--wav_scp is given)")
    p.add_argument("--wav_scp", default=None,
                   help="wav->wav streaming mode: scp of noisy wavs "
                        "(needs an LPS->LPS checkpoint, --output_dim 257)")
    p.add_argument("--output_dir", default=None,
                   help="default: <save_dir>/stream")
    p.add_argument("--num_streams", type=int, default=1,
                   help="wav mode: >1 batches this many concurrent "
                        "streams into one compiled step (StreamPool)")
    p.add_argument("--chunk_frames", type=int, default=50,
                   help="frames per streamed chunk (latency bound)")
    p.add_argument("--g_type", default="res_lstm_l")
    p.add_argument("--trainer", default="gan_rnn")
    p.add_argument("--input_dim", type=int, default=257)
    p.add_argument("--output_dim", type=int, default=40)
    p.add_argument("--left_context", type=int, default=0)
    p.add_argument("--right_context", type=int, default=0)
    p.add_argument("--keep_prob", type=float, default=1.0)
    p.add_argument("--batch_norm", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--l2_scale", type=float, default=0.0)
    p.add_argument("--disc_updates", type=int, default=1)
    p.add_argument("--gen_updates", type=int, default=2)
    p.add_argument("--bf16", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--moving_average", action="store_true")
    p.add_argument("--compress", action="store_true",
                   help="write a Kaldi CompressedMatrix ark")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args, unknown = p.parse_known_args(argv)
    if unknown:
        log(f"WARNING: ignoring unknown flags {unknown}")
    if (args.test_list_file is None) == (args.wav_scp is None):
        p.error("exactly one of --test_list_file / --wav_scp is required")

    enable_compile_cache()

    params = load_generator_params(args)
    if params is None:
        log("[!] Load failed. Checkpoint not found. Exit now.")
        return 1
    log("[*] Load SUCCESS")

    cmvn_path = os.path.join(args.data_dir, "train_cmvn.npz")
    inputs_cmvn, labels_cmvn = load_cmvn_npz(cmvn_path)

    if args.wav_scp:
        return serve_wavs(args, params, inputs_cmvn, labels_cmvn)

    store = UtteranceStore(read_list_file(args.test_list_file))
    enhancer = StreamingEnhancer(params, variant=args.g_type)

    out_dir = args.output_dir or os.path.join(args.save_dir, "stream")
    os.makedirs(out_dir, exist_ok=True)
    writer = ArkWriter(os.path.join(out_dir, "feats.scp"),
                       compress=args.compress)
    ark_path = os.path.join(out_dir, "feats.ark")

    start = datetime.datetime.now()
    total_frames = 0
    n = len(store)
    C = args.chunk_frames
    for i, batch in enumerate(infer_batches(store, args.left_context,
                                            args.right_context)):
        (utt_id,) = batch.utt_ids
        T = int(batch.lengths[0])
        x = np.asarray(batch.inputs[:1, :T])  # [1, T, 257] (unpadded)
        state = enhancer.init_state(batch=1)
        outs = []
        for lo in range(0, T, C):
            take = min(C, T - lo)
            chunk = np.zeros((1, C, x.shape[-1]), np.float32)
            chunk[:, :take] = x[:, lo:lo + take]
            # fixed [1, C, D] chunk shape -> ONE compiled program; the
            # final chunk's pad rows pollute only the discarded state
            y, state = enhancer.step(jnp.asarray(chunk), state)
            outs.append(np.asarray(y[0, :take]))
        enhanced = labels_cmvn.denormalize(np.concatenate(outs, axis=0))
        writer.write_next_utt(ark_path, utt_id,
                              enhanced.astype(np.float32))
        total_frames += T
        log(f"[{i + 1}/{n}] Streamed {utt_id} "
            f"({T} frames, chunks of {C})")
    writer.close()
    took = (datetime.datetime.now() - start).total_seconds()
    log(f"Streaming done: {total_frames} frames in {took:.2f}s "
        f"({total_frames / max(took, 1e-9):,.0f} frames/s host-synced)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
