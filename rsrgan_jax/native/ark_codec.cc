// Fast Kaldi ark codec primitives.
//
// Native counterpart of rsrgan_jax/data/kaldi_ark.py for the hot paths the
// reference suffered on (the per-element compressed-ark dequantization at
// io_funcs/kaldi_io.py:149-160 — SURVEY.md flags it as the data-prep
// bottleneck). Exposed via ctypes from rsrgan_jax/native/__init__.py.
//
// Build: bash rsrgan_jax/native/build.sh  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Decode Kaldi CompressedMatrix format 1 ("BCM ").
//
// payload: num_cols per-column headers (4 x uint16 percentiles) followed by
//          the uint8 matrix stored column-major.
// out:     row-major float32 [num_rows, num_cols].
void decode_compressed_ark(const uint8_t* payload, float min_value,
                           float value_range, int32_t num_rows,
                           int32_t num_cols, float* out) {
  const uint16_t* headers = reinterpret_cast<const uint16_t*>(payload);
  const uint8_t* data = payload + static_cast<size_t>(num_cols) * 8;
  const float u16_scale = value_range * 1.52590218966964e-05f;  // 1/65535

  for (int32_t c = 0; c < num_cols; ++c) {
    const float p0 = min_value + u16_scale * headers[c * 4 + 0];
    const float p25 = min_value + u16_scale * headers[c * 4 + 1];
    const float p75 = min_value + u16_scale * headers[c * 4 + 2];
    const float p100 = min_value + u16_scale * headers[c * 4 + 3];
    // Precompute the 256-entry dequantization table for this column: the
    // piecewise-linear char->float map (kaldi_io.py:128-136) has only 256
    // possible inputs, so table lookup beats per-element branching.
    float table[256];
    const float s_lo = (p25 - p0) * (1.0f / 64.0f);
    const float s_mid = (p75 - p25) * (1.0f / 128.0f);
    const float s_hi = (p100 - p75) * (1.0f / 63.0f);
    for (int v = 0; v < 64; ++v) table[v] = p0 + s_lo * v;
    for (int v = 64; v <= 192; ++v) table[v] = p25 + s_mid * (v - 64);
    for (int v = 193; v < 256; ++v) table[v] = p75 + s_hi * (v - 192);

    const uint8_t* col = data + static_cast<size_t>(c) * num_rows;
    for (int32_t r = 0; r < num_rows; ++r) {
      out[static_cast<size_t>(r) * num_cols + c] = table[col[r]];
    }
  }
}

// Encode a row-major float32 [num_rows, num_cols] matrix as Kaldi
// CompressedMatrix format 1 ("BCM ") — the inverse of
// decode_compressed_ark, bit-identical to the numpy encoder in
// rsrgan_jax/data/kaldi_ark.py (_encode_compressed): anchor arithmetic in
// double, same floor(+0.499)/floor(+0.5) roundings and clamp chain.
//
// min_value/value_range: the float32 global header values (caller
// computes and writes the 16-byte GlobalHeader itself).
// out: num_cols*8 bytes of uint16 headers, then the uint8 payload
//      column-major — exactly the bytes that follow the GlobalHeader.
// scratch: num_rows * (num_cols + 1) floats (column-major copy + sort
//          buffer) — the caller allocates.
void encode_compressed_ark(const float* mat, float min_value,
                           float value_range, int32_t num_rows,
                           int32_t num_cols, uint8_t* out, float* scratch) {
  uint16_t* headers = reinterpret_cast<uint16_t*>(out);
  uint8_t* data = out + static_cast<size_t>(num_cols) * 8;

  const int32_t i25 = num_rows / 4 < num_rows - 1 ? num_rows / 4
                                                  : num_rows - 1;
  const int32_t q75 = 3 * (num_rows / 4);
  const int32_t i75 = q75 < num_rows - 1 ? q75 : num_rows - 1;

  // one cache-blocked transpose up front: every later pass is contiguous
  float* colmaj = scratch + num_rows;
  constexpr int32_t BLK = 64;
  for (int32_t r0 = 0; r0 < num_rows; r0 += BLK) {
    const int32_t r1 = r0 + BLK < num_rows ? r0 + BLK : num_rows;
    for (int32_t c0 = 0; c0 < num_cols; c0 += BLK) {
      const int32_t c1 = c0 + BLK < num_cols ? c0 + BLK : num_cols;
      for (int32_t r = r0; r < r1; ++r) {
        for (int32_t c = c0; c < c1; ++c) {
          colmaj[static_cast<size_t>(c) * num_rows + r] =
              mat[static_cast<size_t>(r) * num_cols + c];
        }
      }
    }
  }

  for (int32_t c = 0; c < num_cols; ++c) {
    const float* colv = colmaj + static_cast<size_t>(c) * num_rows;
    std::memcpy(scratch, colv, sizeof(float) * num_rows);
    // selection instead of a full sort: nth_element yields the exact same
    // order statistics as np.sort at i25/i75/min/max, at O(n)
    std::nth_element(scratch, scratch + i25, scratch + num_rows);
    // read v25/vmin BEFORE the second selection: it re-partitions
    // [i25, end) and scratch[i25] would no longer be the i25-th statistic
    const float v25 = scratch[i25];
    const float vmin = *std::min_element(scratch, scratch + i25 + 1);
    std::nth_element(scratch + i25, scratch + i75, scratch + num_rows);
    const float v75 = scratch[i75];
    const float vmax = *std::max_element(scratch + i75,
                                         scratch + num_rows);

    auto to_u16 = [&](double x) -> int64_t {
      double f = (x - min_value) / value_range;
      if (f < 0.0) f = 0.0;
      if (f > 1.0) f = 1.0;
      return static_cast<int64_t>(std::floor(f * 65535.0 + 0.499));
    };
    int64_t p0 = to_u16(vmin);
    if (p0 > 65532) p0 = 65532;
    int64_t p25 = to_u16(v25);
    if (p25 < p0 + 1) p25 = p0 + 1;
    if (p25 > 65533) p25 = 65533;
    int64_t p75 = to_u16(v75);
    if (p75 < p25 + 1) p75 = p25 + 1;
    if (p75 > 65534) p75 = 65534;
    int64_t p100 = to_u16(vmax);
    if (p100 < p75 + 1) p100 = p75 + 1;
    headers[c * 4 + 0] = static_cast<uint16_t>(p0);
    headers[c * 4 + 1] = static_cast<uint16_t>(p25);
    headers[c * 4 + 2] = static_cast<uint16_t>(p75);
    headers[c * 4 + 3] = static_cast<uint16_t>(p100);

    const double u16s = value_range * (1.0 / 65535.0);
    const double f0 = min_value + u16s * static_cast<double>(p0);
    const double f25 = min_value + u16s * static_cast<double>(p25);
    const double f75 = min_value + u16s * static_cast<double>(p75);
    const double f100 = min_value + u16s * static_cast<double>(p100);
    const double w_lo = f25 - f0;
    const double w_mid = f75 - f25;
    const double w_hi = f100 - f75;

    uint8_t* col = data + static_cast<size_t>(c) * num_rows;
    for (int32_t r = 0; r < num_rows; ++r) {
      const double x = colv[r];
      double q;
      if (x < f25) {
        q = std::floor((x - f0) / w_lo * 64.0 + 0.5);
        if (q < 0.0) q = 0.0;
        if (q > 64.0) q = 64.0;
      } else if (x < f75) {
        q = 64.0 + std::floor((x - f25) / w_mid * 128.0 + 0.5);
        if (q < 64.0) q = 64.0;
        if (q > 192.0) q = 192.0;
      } else {
        q = 192.0 + std::floor((x - f75) / w_hi * 63.0 + 0.5);
        if (q < 192.0) q = 192.0;
        if (q > 255.0) q = 255.0;
      }
      col[r] = static_cast<uint8_t>(q);
    }
  }
}

// Batch float32 <-> CMVN transform helpers (apply / denormalize) used by
// the store builder on multi-GB corpora.
void apply_cmvn(const float* feats, const float* mean, const float* istd,
                int64_t rows, int64_t cols, float* out) {
  for (int64_t r = 0; r < rows; ++r) {
    const float* row = feats + r * cols;
    float* orow = out + r * cols;
    for (int64_t c = 0; c < cols; ++c) {
      orow[c] = (row[c] - mean[c]) * istd[c];
    }
  }
}

}  // extern "C"
