"""Kaldi binary ark/scp codec.

Re-implements (vectorized, Python 3) the reader/writer the reference carries
at io_funcs/kaldi_io.py:24-283:

* float / double binary matrices  ("\0BFM "/"\0BDM ")
* compressed matrices, format 1   ("\0BCM " -- GlobalHeader + per-column
  percentile headers + uint8 payload, column-major), cf. kaldi_io.py:121-161.
  The reference dequantizes with a per-element Python loop (its known
  data-prep bottleneck, SURVEY.md section 2.8); here the whole payload is
  decoded with numpy piecewise arithmetic. An optional C++ fast path lives in
  rsrgan_jax/native (used automatically when built).
* compressed matrices, formats 2/3 ("\0BCM2 "/"\0BCM3 " -- GlobalHeader +
  row-major uint16/uint8 payload, value = min + range*code/(65535|255)).
  Stock Kaldi writes format 2 for matrices with <= 8 rows, which the
  reference REJECTS (kaldi_io.py:104-107 "Unsupport format"); supporting it
  closes that interchange gap with real Kaldi archives.
* TEXT archives ("utt  [\\n row...\\n row ]") as produced/consumed by
  ``copy-feats ark,t:`` -- read and write (the reference has no text-mode
  support at all).

Writer emits standard Kaldi binary float matrices. NOTE: the reference
writer (kaldi_io.py:260-278) omits the space between the utterance id and
the "\0B" binary marker, which makes its arks readable only through .scp
offsets. We write the space like real Kaldi does, so output arks are
readable both sequentially and via scp; the scp offset (pointing at "\0B")
and everything after it are byte-identical to the reference's layout.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

try:  # optional native fast path (rsrgan_jax/native/ark_codec.cc)
    from rsrgan_jax.native import ark_native as _native
except Exception:  # pragma: no cover - native lib absent
    _native = None


class ArkFormatError(ValueError):
    """Raised when an ark payload does not match the expected binary format."""


# ---------------------------------------------------------------------------
# scp handling
# ---------------------------------------------------------------------------

def parse_scp_line(line: str) -> Tuple[str, str, int]:
    """Parse one scp line ``utt path:offset`` -> (utt_id, path, offset)."""
    utt_id, path_pos = line.strip().split(None, 1)
    if ":" in path_pos:
        path, pos = path_pos.rsplit(":", 1)
        return utt_id, path, int(pos)
    return utt_id, path_pos, 0


def read_scp(scp_path: str) -> List[Tuple[str, str, int]]:
    """Read a .scp file into a list of (utt_id, ark_path, offset)."""
    entries = []
    with open(scp_path, "r") as fin:
        for line in fin:
            line = line.strip()
            if line:
                entries.append(parse_scp_line(line))
    return entries


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

_GLOBAL_HEADER = struct.Struct("<ffii")  # min_value, range, num_rows, num_cols


def _decode_compressed(payload: bytes, min_value: float, value_range: float,
                       num_rows: int, num_cols: int) -> np.ndarray:
    """Vectorized decode of Kaldi CompressedMatrix format 1 ("BCM ").

    Layout (kaldi_io.py:138-161): ``num_cols`` per-column headers of four
    uint16 percentiles, then the uint8 payload stored column-major.
    """
    head_bytes = num_cols * 8
    headers = np.frombuffer(payload, dtype="<u2", count=num_cols * 4)
    headers = headers.reshape(num_cols, 4).astype(np.float64)
    # uint16 -> float: min + range * v / 65535        (kaldi_io.py:121-126)
    perc = min_value + value_range * (1.0 / 65535.0) * headers
    p0, p25, p75, p100 = perc[:, 0], perc[:, 1], perc[:, 2], perc[:, 3]

    data = np.frombuffer(payload, dtype=np.uint8, offset=head_bytes,
                         count=num_rows * num_cols)
    v = data.reshape(num_cols, num_rows).astype(np.float64)

    # char -> float, piecewise linear over [0,64], (64,192], (192,255]
    # (kaldi_io.py:128-136)
    lo = p0[:, None] + (p25 - p0)[:, None] * v * (1.0 / 64.0)
    mid = p25[:, None] + (p75 - p25)[:, None] * (v - 64.0) * (1.0 / 128.0)
    hi = p75[:, None] + (p100 - p75)[:, None] * (v - 192.0) * (1.0 / 63.0)
    out = np.where(v < 64, lo, np.where(v <= 192, mid, hi))
    # column-major payload -> [rows, cols]; float32 like every other read
    # path (and like the native codec, so both backends agree in dtype)
    return np.ascontiguousarray(out.T, dtype=np.float32)


def _read_text_matrix(buf, first: bytes) -> np.ndarray:
    """Parse a Kaldi TEXT matrix ("[\\n r0c0 r0c1\\n r1c0 r1c1 ]") from a
    file object; ``first`` holds bytes already consumed by the caller."""
    chunks = [first]
    while b"]" not in chunks[-1]:
        chunk = buf.read(4096)
        if not chunk:
            raise ArkFormatError("unterminated text matrix (no ']')")
        chunks.append(chunk)
    blob = b"".join(chunks)
    end = blob.index(b"]")
    # leave anything after ']' (plus one newline) unconsumed for iter_ark
    tail = blob[end + 1:]
    if tail.startswith(b"\n"):
        tail = tail[1:]
    buf.seek(-len(tail), os.SEEK_CUR)
    body = blob[:end].lstrip()
    if not body.startswith(b"["):
        raise ArkFormatError("text matrix must start with '['")
    rows = [r for r in body[1:].decode("utf-8").strip().splitlines()
            if r.strip()]
    if not rows:
        return np.zeros((0, 0), np.float32)
    mat = [np.array(r.split(), dtype=np.float32) for r in rows]
    cols = len(mat[0])
    if any(len(r) != cols for r in mat):
        raise ArkFormatError("ragged text matrix")
    return np.stack(mat)


def read_matrix(buf, dtype_hint: Optional[str] = None) -> np.ndarray:
    """Read one Kaldi matrix (binary at "\0B", else text) from a file
    object positioned at its first byte."""
    header = buf.read(5)
    if len(header) < 5 or header[1:2] != b"B":
        if header.lstrip()[:1] == b"[":
            return _read_text_matrix(buf, header)
        raise ArkFormatError("not a Kaldi matrix (no \\0B header or '[')")
    kind = header[2:5]
    if kind[:1] == b"C":
        if kind in (b"CM2", b"CM3"):
            # Kaldi token "CM2 "/"CM3 " is 4 bytes; consume its space.
            buf.read(1)
            min_value, value_range, rows, cols = _GLOBAL_HEADER.unpack(
                buf.read(_GLOBAL_HEADER.size))
            if kind == b"CM2":  # two bytes per element, row-major
                data = np.frombuffer(buf.read(rows * cols * 2), dtype="<u2")
                mat = min_value + value_range * (1.0 / 65535.0) * (
                    data.astype(np.float64))
            else:  # one byte per element, row-major
                data = np.frombuffer(buf.read(rows * cols), dtype=np.uint8)
                mat = min_value + value_range * (1.0 / 255.0) * (
                    data.astype(np.float64))
            return mat.reshape(rows, cols).astype(np.float32)
        if kind != b"CM ":
            raise ArkFormatError(f"unsupported compressed format {kind!r}")
        min_value, value_range, rows, cols = _GLOBAL_HEADER.unpack(
            buf.read(_GLOBAL_HEADER.size))
        if cols == 0:
            raise ArkFormatError("empty compressed matrix")
        payload = buf.read(cols * 8 + rows * cols)
        if _native is not None:
            return _native.decode_compressed(payload, min_value, value_range,
                                             rows, cols)
        return _decode_compressed(payload, min_value, value_range, rows, cols)

    _, rows = struct.unpack("<bi", buf.read(5))
    _, cols = struct.unpack("<bi", buf.read(5))
    if kind[:1] == b"F":
        mat = np.frombuffer(buf.read(rows * cols * 4), dtype="<f4")
    elif kind[:1] == b"D":
        mat = np.frombuffer(buf.read(rows * cols * 8), dtype="<f8")
    else:
        raise ArkFormatError(f"unsupported matrix kind {kind!r}")
    return mat.reshape(rows, cols)


def read_ark_matrix(ark_path: str, offset: int = 0) -> np.ndarray:
    """Read the matrix stored at ``offset`` in ``ark_path``.

    Mirrors ArkReader.read_ark (kaldi_io.py:81-119) including compressed-ark
    support, but decodes with numpy instead of per-element struct calls.
    """
    with open(ark_path, "rb") as f:
        f.seek(int(offset))
        return read_matrix(f)


def iter_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Sequentially iterate (utt_id, matrix) pairs of a standard Kaldi ark.

    Requires the Kaldi-conformant layout ``utt_id + ' ' + '\\0B...'`` (which
    this module's writer produces; the reference's writer output is only
    readable via scp, see module docstring).
    """
    size = os.path.getsize(ark_path)
    with open(ark_path, "rb") as f:
        while f.tell() < size:
            key_bytes = bytearray()
            while True:
                ch = f.read(1)
                if not ch:
                    return
                if ch == b" ":
                    break
                key_bytes.extend(ch)
            yield key_bytes.decode("utf-8"), read_matrix(f)


class ScpReader:
    """Random/sequential access over an scp index (ArkReader equivalent)."""

    def __init__(self, scp_path: str):
        self.entries = read_scp(scp_path)
        self._by_id = {u: (p, o) for u, p, o in self.entries}

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def utt_ids(self) -> List[str]:
        return [u for u, _, _ in self.entries]

    def read_utt(self, utt_id: str) -> np.ndarray:
        path, offset = self._by_id[utt_id]
        return read_ark_matrix(path, offset)

    def read_index(self, index: int) -> Tuple[str, np.ndarray]:
        utt_id, path, offset = self.entries[index]
        return utt_id, read_ark_matrix(path, offset)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for i in range(len(self.entries)):
            yield self.read_index(i)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _encode_compressed(mat: np.ndarray) -> bytes:
    """Encode a matrix as Kaldi CompressedMatrix format 1 ("BCM ") body.

    Inverse of :func:`_decode_compressed` (the read path the reference keeps
    at io_funcs/kaldi_io.py:121-161; the reference has NO compressed writer).
    Follows Kaldi's quantization scheme: a global float32 [min, range], four
    per-column uint16 percentile anchors (0/25/75/100), and one uint8 per
    element quantized piecewise-linearly over [p0,p25], [p25,p75], [p75,p100]
    with 64/128/63 steps. Fully vectorized.
    """
    # quantize from float32 values (CompressedMatrix is a float32 format);
    # keeps the numpy and native paths bit-identical for any input dtype
    mat = np.asarray(mat, dtype=np.float32)
    mat64 = mat.astype(np.float64)
    if mat64.ndim != 2 or mat64.shape[1] == 0 or mat64.shape[0] == 0:
        raise ValueError(f"cannot compress matrix of shape {mat64.shape}")
    if not np.all(np.isfinite(mat64)):
        raise ValueError("cannot compress a matrix with non-finite values")
    rows, cols = mat64.shape
    # Global header stores float32; quantize against the float32 values the
    # reader will parse back, so roundtrip matches the decoder exactly.
    min_value = float(np.float32(mat64.min()))
    value_range = float(np.float32(mat64.max() - min_value))
    if value_range <= 0.0:
        value_range = 1.0  # Kaldi's guard for constant matrices

    if rows <= 8:
        # Stock Kaldi's kAutomaticMethod: too few rows for meaningful
        # column percentiles -> format 2, two uint16 codes per element,
        # row-major (compressed-matrix.cc kTwoByte).
        codes = np.clip((mat64 - min_value) / value_range, 0.0, 1.0)
        codes = np.floor(codes * 65535.0 + 0.499).astype("<u2")
        return (b"\0BCM2 " + _GLOBAL_HEADER.pack(min_value, value_range,
                                                 rows, cols)
                + codes.tobytes())

    header = b"\0BCM " + _GLOBAL_HEADER.pack(min_value, value_range,
                                             rows, cols)
    if _native is not None and hasattr(_native, "encode_compressed"):
        return header + _native.encode_compressed(
            np.asarray(mat, np.float32), min_value, value_range)

    def to_u16(x: np.ndarray) -> np.ndarray:
        f = np.clip((x - min_value) / value_range, 0.0, 1.0)
        return np.floor(f * 65535.0 + 0.499).astype(np.int64)

    col = np.ascontiguousarray(mat64.T)          # [cols, rows], column-major
    s = np.sort(col, axis=1)
    i25 = min(rows // 4, rows - 1)
    i75 = min(3 * (rows // 4), rows - 1)
    # Percentile anchors forced strictly increasing (Kaldi ComputeColHeader).
    p0 = np.minimum(to_u16(s[:, 0]), 65532)
    p25 = np.minimum(np.maximum(to_u16(s[:, i25]), p0 + 1), 65533)
    p75 = np.minimum(np.maximum(to_u16(s[:, i75]), p25 + 1), 65534)
    p100 = np.maximum(to_u16(s[:, rows - 1]), p75 + 1)
    headers = np.stack([p0, p25, p75, p100], axis=1).astype("<u2")

    # Quantize elements against the *dequantized* anchors (what readers use).
    f = min_value + value_range * (1.0 / 65535.0) * headers.astype(np.float64)
    f0, f25, f75, f100 = (f[:, k:k + 1] for k in range(4))
    lo = np.clip(np.floor((col - f0) / (f25 - f0) * 64.0 + 0.5), 0, 64)
    mid = np.clip(64.0 + np.floor((col - f25) / (f75 - f25) * 128.0 + 0.5),
                  64, 192)
    hi = np.clip(192.0 + np.floor((col - f75) / (f100 - f75) * 63.0 + 0.5),
                 192, 255)
    quant = np.where(col < f25, lo, np.where(col < f75, mid, hi))

    return header + headers.tobytes() + quant.astype(np.uint8).tobytes()


def _format_text_matrix(mat: np.ndarray) -> bytes:
    """Kaldi text-mode matrix body (" [\\n  row\\n  row ]\\n"); floats at
    9 significant digits so float32 values round-trip exactly."""
    lines = [b" ["]
    for row in mat:
        lines.append(b"\n  " + " ".join(f"{v:.9g}" for v in row)
                     .encode("ascii"))
    lines.append(b" ]\n")
    return b"".join(lines)


class ArkWriter:
    """Write float32 matrices to .ark with a paired .scp (kaldi_io.py:244-283).

    Unlike the reference we keep the ark file handle open across writes and
    emit the Kaldi-standard space between utt id and binary marker.
    ``text=True`` writes copy-feats ark,t:-style text archives instead.
    """

    def __init__(self, scp_path: str, compress: bool = False,
                 text: bool = False):
        if compress and text:
            raise ValueError("text archives cannot be compressed")
        self.scp_path = scp_path
        self.compress = compress
        self.text = text
        self._scp = open(scp_path, "w")
        self._arks = {}

    def write_next_utt(self, ark_path: str, utt_id: str,
                       utt_mat: np.ndarray,
                       compress: Optional[bool] = None) -> None:
        mat = np.ascontiguousarray(utt_mat, dtype="<f4")
        if mat.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {mat.shape}")
        rows, cols = mat.shape
        ark = self._arks.get(ark_path)
        if ark is None:
            ark = open(ark_path, "ab")
            self._arks[ark_path] = ark
        ark.write(utt_id.encode("utf-8") + b" ")
        pos = ark.tell()
        use_compress = self.compress if compress is None else compress
        if self.text:
            ark.write(_format_text_matrix(mat))
        elif use_compress:
            ark.write(_encode_compressed(mat))
        else:
            ark.write(b"\0BFM ")
            ark.write(struct.pack("<bi", 4, rows))
            ark.write(struct.pack("<bi", 4, cols))
            ark.write(mat.tobytes())
        ark.flush()
        self._scp.write(f"{utt_id} {ark_path}:{pos}\n")
        self._scp.flush()

    def close(self) -> None:
        for ark in self._arks.values():
            ark.close()
        self._arks.clear()
        self._scp.close()

    def __enter__(self) -> "ArkWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_matrix(buf, mat: np.ndarray, compress: bool = False) -> None:
    """Write one binary matrix body (no key) to a file object.

    ``compress=True`` emits Kaldi CompressedMatrix format 1 ("\0BCM ", the
    equivalent of Kaldi's copy-feats --compress=true); otherwise a plain
    float32 "\0BFM " matrix.
    """
    if compress:
        buf.write(_encode_compressed(mat))
        return
    mat = np.ascontiguousarray(mat, dtype="<f4")
    rows, cols = mat.shape
    buf.write(b"\0BFM ")
    buf.write(struct.pack("<bi", 4, rows))
    buf.write(struct.pack("<bi", 4, cols))
    buf.write(mat.tobytes())
