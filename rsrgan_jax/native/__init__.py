"""ctypes bindings for the native ark codec (libark_codec.so).

Falls back silently when the library hasn't been built — pure-numpy paths
in rsrgan_jax.data.kaldi_ark remain fully functional. Build with
``bash rsrgan_jax/native/build.sh``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libark_codec.so")


class _ArkNative:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.decode_compressed_ark.argtypes = [
            ctypes.c_char_p, ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.decode_compressed_ark.restype = None
        lib.encode_compressed_ark.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.encode_compressed_ark.restype = None
        lib.apply_cmvn.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.apply_cmvn.restype = None

    def decode_compressed(self, payload: bytes, min_value: float,
                          value_range: float, rows: int,
                          cols: int) -> np.ndarray:
        out = np.empty((rows, cols), dtype=np.float32)
        self._lib.decode_compressed_ark(payload, min_value, value_range,
                                        rows, cols, out)
        return out

    def encode_compressed(self, mat: np.ndarray, min_value: float,
                          value_range: float) -> bytes:
        """Headers + column-major uint8 payload (everything after the
        16-byte GlobalHeader)."""
        mat = np.ascontiguousarray(mat, np.float32)
        rows, cols = mat.shape
        out = np.empty(cols * 8 + rows * cols, dtype=np.uint8)
        scratch = np.empty(rows * (cols + 1), dtype=np.float32)
        self._lib.encode_compressed_ark(mat, min_value, value_range,
                                        rows, cols, out, scratch)
        return out.tobytes()

    def apply_cmvn(self, feats: np.ndarray, mean: np.ndarray,
                   stddev: np.ndarray) -> np.ndarray:
        feats = np.ascontiguousarray(feats, np.float32)
        mean = np.ascontiguousarray(mean, np.float32)
        istd = np.ascontiguousarray(1.0 / stddev, np.float32)
        out = np.empty_like(feats)
        self._lib.apply_cmvn(feats, mean, istd, feats.shape[0],
                             feats.shape[1], out)
        return out


def reload_native():
    """(Re-)load libark_codec.so after an on-demand build; updates this
    module's ``ark_native`` and the codec's cached handle. Returns the
    binding or None."""
    global ark_native
    if os.path.isfile(_LIB_PATH):
        try:
            ark_native = _ArkNative(ctypes.CDLL(_LIB_PATH))
        except OSError:  # pragma: no cover
            ark_native = None
    import rsrgan_jax.data.kaldi_ark as _ka
    _ka._native = ark_native
    return ark_native


ark_native = None
if os.path.isfile(_LIB_PATH):
    try:
        ark_native = _ArkNative(ctypes.CDLL(_LIB_PATH))
    except OSError:  # pragma: no cover
        ark_native = None
