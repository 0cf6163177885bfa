"""Feature extraction CLI — replaces the external Kaldi feature stage.

Equivalent of ``compute-spectrogram-feats`` (257-dim LPS),
``compute-mfcc-feats --config=mfcc_hires.conf`` (40-dim MFCC) and
``compute-cmvn-stats`` (/root/reference/README.md:33-35, SURVEY.md 2.8):

    python -m rsrgan_jax.cli.extract --wav_scp wav.scp \
        --feat_type spectrogram --output_dir feats --name inputs \
        [--accumulate_cmvn]

Writes ``<name>.ark`` / ``<name>.scp`` and optionally ``<name>.cmvn``
(Kaldi binary stats), all consumable by the prepare/train CLIs or by Kaldi
itself.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

from rsrgan_jax.data.cmvn import CmvnAccumulator, write_kaldi_cmvn
from rsrgan_jax.data.kaldi_ark import ArkWriter
from rsrgan_jax.features import (FrameOptions, MfccOptions,
                                 SpectrogramOptions, compute_mfcc,
                                 compute_spectrogram, num_frames)
from rsrgan_jax.sim.wavio import read_wav

FRAME_PAD = 200  # jit shapes quantized to 2-second frame blocks


class JitExtractor:
    """Compiled feature extraction over a small set of padded lengths.

    Waves are zero-padded so the frame count is a FRAME_PAD multiple; one
    jitted program per padded length serves the whole corpus (with the
    persistent compile cache, across runs too).
    """

    def __init__(self, feat_type: str, frame_opts: FrameOptions,
                 use_dither: bool):
        import jax

        self.jax = jax
        self.feat_type = feat_type
        self.frame_opts = frame_opts
        self.use_dither = use_dither

    @functools.lru_cache(maxsize=None)
    def _fn(self, padded_samples: int):
        jax = self.jax
        if self.feat_type == "spectrogram":
            opts = SpectrogramOptions(self.frame_opts)
            compute = compute_spectrogram
        else:
            opts = MfccOptions(frame_opts=self.frame_opts)
            compute = compute_mfcc
        if self.use_dither:
            return jax.jit(lambda w, key: compute(w, opts, key))
        return jax.jit(lambda w: compute(w, opts))

    def __call__(self, wave: np.ndarray, seed: int) -> np.ndarray:
        opts = self.frame_opts
        n_frames = num_frames(len(wave), opts)
        if n_frames == 0:
            return np.zeros((0, 257 if self.feat_type == "spectrogram"
                             else 40), np.float32)
        pad_frames = -(-n_frames // FRAME_PAD) * FRAME_PAD
        padded_samples = opts.window_size + opts.window_shift * (
            pad_frames - 1)
        padded = np.zeros(padded_samples, np.float32)
        # the wave may extend past the last kept frame's span (frames are
        # snipped); samples beyond padded_samples contribute to no frame
        n_copy = min(len(wave), padded_samples)
        padded[:n_copy] = wave[:n_copy]
        if self.use_dither:
            feats = self._fn(padded_samples)(
                padded, self.jax.random.PRNGKey(seed))
        else:
            feats = self._fn(padded_samples)(padded)
        return np.asarray(feats)[:n_frames]


class BatchedJitExtractor:
    """Batches same-padded-length waves into fixed [B, T] stacks so ONE
    device dispatch serves B utterances.

    Per-call dispatch latency dominates single-utterance extraction of
    short waves. Stacking amortizes it B-fold while keeping the
    compile-shape budget identical: partial batches are zero-padded to the
    same [B, T] stack, so each (dtype, length) bucket still compiles
    exactly one program. Waves whose samples are exact
    int16 values (all PCM wavs) ride the wire as int16 and are cast to
    float32 on device, halving upload bytes losslessly.

    Results are handed back as (ticket, feats) pairs as their batch
    completes; the caller reorders. Per-utterance dither keys match the
    unbatched path (PRNGKey(seed) per row), and tests pin batched ==
    unbatched features.
    """

    def __init__(self, feat_type: str, frame_opts: FrameOptions,
                 use_dither: bool, batch: int):
        import jax

        self.jax = jax
        self.feat_type = feat_type
        self.frame_opts = frame_opts
        self.use_dither = use_dither
        self.batch = batch
        self.dim = 257 if feat_type == "spectrogram" else 40
        self._bufs = {}  # (padded_samples, wire_dtype) -> [(ticket, wave, n_frames, seed)]

    @functools.lru_cache(maxsize=None)
    def _fn(self, padded_samples: int, wire_dtype: str):
        jax = self.jax
        if self.feat_type == "spectrogram":
            opts = SpectrogramOptions(self.frame_opts)
            compute = compute_spectrogram
        else:
            opts = MfccOptions(frame_opts=self.frame_opts)
            compute = compute_mfcc

        def one(w, seed):
            w = w.astype("float32")
            if self.use_dither:
                return compute(w, opts, jax.random.PRNGKey(seed))
            return compute(w, opts)

        return jax.jit(jax.vmap(one))

    def add(self, ticket: int, wave: np.ndarray, seed: int):
        """Queue one wave; returns [(ticket, feats)] completed by this add."""
        opts = self.frame_opts
        n_frames = num_frames(len(wave), opts)
        if n_frames == 0:
            return [(ticket, np.zeros((0, self.dim), np.float32))]
        pad_frames = -(-n_frames // FRAME_PAD) * FRAME_PAD
        padded_samples = opts.window_size + opts.window_shift * (
            pad_frames - 1)
        n_copy = min(len(wave), padded_samples)
        wire = "float32"
        w = wave[:n_copy]
        if (np.all(np.abs(w) <= 32767.0)
                and np.array_equal(w, np.trunc(w))):
            wire = "int16"
        padded = np.zeros(padded_samples, wire)
        padded[:n_copy] = w
        key = (padded_samples, wire)
        buf = self._bufs.setdefault(key, [])
        buf.append((ticket, padded, n_frames, seed))
        if len(buf) == self.batch:
            return self._flush(key)
        return []

    def _flush(self, key):
        entries = self._bufs.pop(key, [])
        if not entries:
            return []
        padded_samples, wire = key
        stack = np.zeros((self.batch, padded_samples), wire)
        seeds = np.zeros((self.batch,), np.int32)
        for i, (_, padded, _, seed) in enumerate(entries):
            stack[i] = padded
            seeds[i] = seed
        out = np.asarray(self._fn(padded_samples, wire)(stack, seeds))
        return [(t, out[i, :nf].copy())
                for i, (t, _, nf, _) in enumerate(entries)]

    def flush_all(self):
        done = []
        for key in sorted(self._bufs):
            done.extend(self._flush(key))
        return done

    def pending_count(self) -> int:
        return sum(len(b) for b in self._bufs.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsrgan_jax.cli.extract")
    p.add_argument("--wav_scp", required=True)
    p.add_argument("--feat_type", choices=["spectrogram", "mfcc"],
                   required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--name", required=True)
    p.add_argument("--dither", type=float, default=1.0)
    p.add_argument("--dither_seed", type=int, default=0,
                   help="deterministic dither stream")
    p.add_argument("--accumulate_cmvn", action="store_true")
    p.add_argument("--compress", action="store_true",
                   help="write Kaldi CompressedMatrix arks "
                        "(copy-feats --compress=true equivalent)")
    p.add_argument("--text", action="store_true",
                   help="write a Kaldi TEXT archive (ark,t: equivalent)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="utterances per device dispatch (1 = legacy "
                        "single-utterance path)")
    args = p.parse_args(argv)

    from rsrgan_jax.cli import enable_compile_cache
    enable_compile_cache()

    frame_opts = FrameOptions(dither=args.dither)
    os.makedirs(args.output_dir, exist_ok=True)
    scp_path = os.path.join(args.output_dir, args.name + ".scp")
    ark_path = os.path.join(args.output_dir, args.name + ".ark")
    writer = ArkWriter(scp_path, compress=args.compress, text=args.text)
    acc = None

    with open(args.wav_scp) as f:
        entries = [line.strip().split(None, 1) for line in f if line.strip()]

    # Batches complete out of order (one bucket per padded length); the
    # ark/scp/CMVN must land in corpus order so the three extraction
    # passes' scp files stay line-aligned for `prepare split`'s zip.
    pending = {}
    next_write = 0

    def drain():
        nonlocal next_write, acc
        while next_write in pending:
            feats = pending.pop(next_write)
            if acc is None and args.accumulate_cmvn:
                acc = CmvnAccumulator(feats.shape[1])
            if acc is not None:
                acc.accumulate(feats)
            writer.write_next_utt(ark_path, entries[next_write][0], feats)
            next_write += 1

    if args.batch_size > 1:
        extractor = BatchedJitExtractor(args.feat_type, frame_opts,
                                        args.dither > 0, args.batch_size)
        for idx, (utt_id, wav_path) in enumerate(entries):
            wave, rate = read_wav(wav_path)
            if rate != frame_opts.samp_freq:
                print(f"WARNING: {utt_id} rate {rate} != "
                      f"{frame_opts.samp_freq:g}", file=sys.stderr)
            for t, feats in extractor.add(idx, wave, args.dither_seed + idx):
                pending[t] = feats
            # a rare-length bucket can stall the in-order writer while
            # completed batches pile up; bound the buffer
            if len(pending) + extractor.pending_count() > 512:
                for t, feats in extractor.flush_all():
                    pending[t] = feats
            drain()
        for t, feats in extractor.flush_all():
            pending[t] = feats
        drain()
        assert next_write == len(entries), \
            f"wrote {next_write} of {len(entries)} utterances"
    else:
        extractor = JitExtractor(args.feat_type, frame_opts, args.dither > 0)
        for idx, (utt_id, wav_path) in enumerate(entries):
            wave, rate = read_wav(wav_path)
            if rate != frame_opts.samp_freq:
                print(f"WARNING: {utt_id} rate {rate} != "
                      f"{frame_opts.samp_freq:g}", file=sys.stderr)
            pending[idx] = extractor(wave, args.dither_seed + idx)
            drain()
    writer.close()
    if acc is not None:
        cmvn_path = os.path.join(args.output_dir, args.name + ".cmvn")
        write_kaldi_cmvn(cmvn_path, acc.stats_matrix())
        print(f"CMVN stats -> {cmvn_path}")
    print(f"Wrote {len(entries)} x {args.feat_type} -> {ark_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
