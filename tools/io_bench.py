"""Data-pipeline throughput bench (host side, no accelerator).

The reference's only perf harnesses were the I/O smoke tests that timed a
pipeline scan (io_funcs/tfrecords_io_test.py:95-97, SURVEY.md section 4).
This is the equivalent with real numbers for every stage of OUR pipeline,
answering "can one host core feed N chips at M frames/s?":

  ark-plain    sequential float-ark decode (ScpReader)
  ark-bcm      compressed-ark decode, numpy vs native C++ path
  store-build  scp -> .rtu store conversion (CMVN applied)
  store-scan   raw utterance reads from the mmap store
  batcher      SequenceBatcher epoch (bucketed, padded, spliced)
  prefetch     ThreadedPrefetcher-wrapped batcher (overlap check)

Usage: python tools/io_bench.py [num_utts] [frames_per_utt]
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rsrgan_jax.data import (ArkWriter, ScpReader, SequenceBatcher,
                             ThreadedPrefetcher, UtteranceStore,
                             build_store_from_scp)


def main() -> None:
    num_utts = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 400
    in_dim, out_dim = 257, 40
    rng = np.random.default_rng(0)
    results = {}

    def report(name, total_frames, dt, extra=""):
        rate = total_frames / dt
        results[name] = round(rate, 1)
        print(f"{name:12s} {dt:7.3f} s  {rate:12,.0f} frames/s  {extra}",
              flush=True)

    with tempfile.TemporaryDirectory() as d:
        lengths = rng.integers(int(0.6 * frames), frames + 1, num_utts)
        total = int(lengths.sum())
        mats_in = [rng.normal(size=(l, in_dim)).astype(np.float32) * 3
                   for l in lengths]
        mats_out = [rng.normal(size=(l, out_dim)).astype(np.float32)
                    for l in lengths]

        for name, mats, compress in (("in", mats_in, False),
                                     ("in_bcm", mats_in, True),
                                     ("out", mats_out, False)):
            with ArkWriter(os.path.join(d, f"{name}.scp"),
                           compress=compress) as w:
                for i, m in enumerate(mats):
                    w.write_next_utt(os.path.join(d, f"{name}.ark"),
                                     f"utt{i:05d}", m)

        t0 = time.perf_counter()
        for _, m in ScpReader(os.path.join(d, "in.scp")):
            pass
        report("ark-plain", total, time.perf_counter() - t0)

        import rsrgan_jax.data.kaldi_ark as ka

        saved = ka._native
        try:
            ka._native = None
            t0 = time.perf_counter()
            for _, m in ScpReader(os.path.join(d, "in_bcm.scp")):
                pass
            report("ark-bcm-np", total, time.perf_counter() - t0)
        finally:
            ka._native = saved
        if ka._native is not None:
            t0 = time.perf_counter()
            for _, m in ScpReader(os.path.join(d, "in_bcm.scp")):
                pass
            report("ark-bcm-c++", total, time.perf_counter() - t0)

        store_path = os.path.join(d, "bench.rtu")
        t0 = time.perf_counter()
        build_store_from_scp(os.path.join(d, "in.scp"), store_path,
                             labels_scp=os.path.join(d, "out.scp"))
        report("store-build", total, time.perf_counter() - t0)

        store = UtteranceStore([store_path])
        t0 = time.perf_counter()
        for i in range(len(store)):
            store.inputs(i)
            store.labels(i)
        report("store-scan", total, time.perf_counter() - t0)

        flagship = SequenceBatcher(store, batch_size=16)
        t0 = time.perf_counter()
        got = sum(int(b.lengths.sum()) for b in flagship)
        report("batcher-0ctx", got, time.perf_counter() - t0,
               "(flagship: no splice)")

        batcher = SequenceBatcher(store, batch_size=16, left_context=2,
                                  right_context=2)
        t0 = time.perf_counter()
        got = sum(int(b.lengths.sum()) for b in batcher)
        report("batcher", got, time.perf_counter() - t0,
               "(spliced x5, bucketed+padded)")

        t0 = time.perf_counter()
        got = sum(int(b.lengths.sum())
                  for b in ThreadedPrefetcher(iter(batcher), capacity=8))
        report("prefetch", got, time.perf_counter() - t0)

    print(json.dumps({"metric": "io_bench_frames_per_sec", **results}))


if __name__ == "__main__":
    main()
