"""Streaming-serving latency benchmark: per-chunk step latency percentiles.

An online dereverberation front-end has a LATENCY budget: each chunk of C
frames covers C*10 ms of audio, so the p99 step latency must stay under
that to hold realtime. This tool times `serving.StreamingEnhancer.step`
(the same jitted program `cli/serve.py` and the StreamPool dispatch) over
many chunks on a GPU and prints the device, then one JSON line per
(chunk_frames, lanes) config:

    python tools/serve_bench.py [num_chunks]

Each step is timed to ``jax.block_until_ready``; the pipelined aggregate
dispatches every chunk and waits once at the end.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rsrgan_jax.cli import enable_compile_cache, require_gpu  # noqa: E402
from rsrgan_jax.models import get_generator  # noqa: E402
from rsrgan_jax.serving import StreamingEnhancer  # noqa: E402

IN_DIM, OUT_DIM = 257, 40
FRAME_MS = 10.0


def bench(enhancer, lanes: int, chunk_frames: int, num_chunks: int):
    rng = np.random.default_rng(0)
    chunk = jnp.asarray(
        rng.normal(size=(lanes, chunk_frames, IN_DIM)), jnp.float32)
    state = enhancer.init_state(batch=lanes)
    # warm-up: compile + first dispatch
    y, state = jax.block_until_ready(enhancer.step(chunk, state))

    lat_ms = []
    for _ in range(num_chunks):
        t0 = time.perf_counter()
        y, state = jax.block_until_ready(enhancer.step(chunk, state))
        lat_ms.append((time.perf_counter() - t0) * 1e3)

    # pipelined aggregate: dispatch all chunks, sync once at the end —
    # what a serving loop that overlaps host/device work achieves
    t0 = time.perf_counter()
    for _ in range(num_chunks):
        y, state = enhancer.step(chunk, state)
    jax.block_until_ready((y, state))
    pipelined_ms = (time.perf_counter() - t0) * 1e3 / num_chunks

    lat = np.asarray(lat_ms)
    budget_ms = chunk_frames * FRAME_MS
    return {
        "metric": "stream_step_latency_ms",
        "lanes": lanes,
        "chunk_frames": chunk_frames,
        "chunk_audio_ms": budget_ms,
        "p50": round(float(np.percentile(lat, 50)), 3),
        "p95": round(float(np.percentile(lat, 95)), 3),
        "p99": round(float(np.percentile(lat, 99)), 3),
        "pipelined_mean": round(pipelined_ms, 3),
        "realtime_p99": bool(np.percentile(lat, 99) < budget_ms),
        "frames_per_sec_synced": round(
            lanes * chunk_frames / (lat.mean() * 1e-3)),
    }


def main() -> int:
    num_chunks = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    require_gpu("tools/serve_bench.py")
    enable_compile_cache()
    gen = get_generator("res_lstm_l", input_dim=IN_DIM, output_dim=OUT_DIM,
                        compute_dtype=jnp.bfloat16)
    x = jnp.zeros((1, 8, IN_DIM), jnp.float32)
    params = gen.init(jax.random.PRNGKey(0), x,
                      jnp.full((1,), 8, jnp.int32))["params"]
    enhancer = StreamingEnhancer(params, variant="res_lstm_l")
    for lanes in (1, 8, 32, 64):
        for chunk_frames in (10, 50):
            print(json.dumps(bench(enhancer, lanes, chunk_frames,
                                   num_chunks)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
