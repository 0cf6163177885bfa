"""Command-line entry points (train/decode, prepare, simulate, extract,
plot, serve, resynth, score) mirroring the reference's scripts/ +
run_*.sh layers plus the beyond-reference serving/evaluation surface."""

import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def str2bool(v) -> bool:
    """Boolean flag parser (utils/misc.py:43-49 semantics): only
    yes/true/t/1 (case-insensitive) are truthy; everything else is False.
    Shared by every CLI so falsy spellings behave consistently."""
    return str(v).lower() in ("yes", "true", "t", "1")


def require_gpu(tool: str):
    """The local GPUs, after printing them and the cards' name and power
    limit as nvidia-smi gives them. Any other JAX backend is an error: a
    measurement on the GPU never falls back to the CPU."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"{tool} needs a GPU; JAX's default backend is "
                         f"{jax.default_backend()!r}")
    devices = jax.devices()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    print(f"device: platform={devices[0].platform} "
          f"kind={devices[0].device_kind} count={len(devices)} "
          f"jax={jax.__version__}")
    print("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(card)
    sys.stdout.flush()
    return devices, card


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache sits at ``<checkout>/.jax_cache``:
    a fixed path, so runs from one checkout find each other's programs.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    cache_dir = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
