"""Native ark codec parity tests (builds the codec on demand)."""

import os
import subprocess

import numpy as np
import pytest

from rsrgan_jax.data.kaldi_ark import _decode_compressed

try:
    from rsrgan_jax.native import ark_native
except Exception:
    ark_native = None

if ark_native is None:  # build it (seconds) instead of skipping
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "rsrgan_jax", "native", "build.sh")
    try:
        subprocess.run(["bash", build], check=True, capture_output=True,
                       timeout=120)
        import rsrgan_jax.native as _nat
        ark_native = _nat.reload_native()
    except Exception:
        ark_native = None

pytestmark = pytest.mark.skipif(
    ark_native is None,
    reason="libark_codec.so build failed (bash rsrgan_jax/native/build.sh)")


def test_decode_compressed_matches_numpy(rng):
    rows, cols = 57, 13
    headers = np.sort(rng.integers(0, 65536, (cols, 4)), axis=1
                      ).astype("<u2")
    data = rng.integers(0, 256, (cols, rows)).astype(np.uint8)
    payload = headers.tobytes() + data.tobytes()
    a = ark_native.decode_compressed(payload, -4.0, 8.0, rows, cols)
    b = _decode_compressed(payload, -4.0, 8.0, rows, cols)
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_apply_cmvn_matches_numpy(rng):
    feats = rng.normal(size=(40, 7)).astype(np.float32)
    mean = feats.mean(0)
    std = feats.std(0)
    got = ark_native.apply_cmvn(feats, mean, std)
    np.testing.assert_allclose(got, (feats - mean) / std, rtol=2e-4,
                               atol=1e-4)


def test_encode_compressed_matches_numpy(rng):
    """Native encoder must be BIT-identical to the numpy encoder."""
    import rsrgan_jax.data.kaldi_ark as ka

    mats = [
        rng.normal(scale=3.0, size=(120, 13)).astype(np.float32),
        rng.normal(size=(1, 4)).astype(np.float32),
        np.full((9, 5), 2.5, np.float32),
        np.concatenate([rng.normal(size=(200, 6)),
                        rng.normal(scale=50.0, size=(3, 6))]
                       ).astype(np.float32),
    ]
    saved = ka._native
    try:
        for m in mats:
            ka._native = ark_native
            native_bytes = ka._encode_compressed(m)
            ka._native = None
            numpy_bytes = ka._encode_compressed(m)
            assert native_bytes == numpy_bytes
    finally:
        ka._native = saved
