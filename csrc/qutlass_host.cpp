// qutlass_tpu native host library.
//
// The reference implements its host-side layer in C++ (bindings,
// validation, layout transforms — qutlass/csrc/bindings.cpp,
// qutlass/utils.py's swizzle).  This rebuild keeps the device path in
// XLA/Pallas; this library is the native host runtime:
//
//   * fp64 golden quantizers (the numerics spec, reference
//     tests/mxfp4_test.py:45-184) at C speed for validating large
//     tensors and for offline weight preparation,
//   * scalar codecs for e2m1 / e8m0 / e4m3,
//   * the cuBLAS 128x4 block-scale swizzle (reference utils.py:160-193)
//     for exporting quantized tensors to CUTLASS/cuBLAS runtimes.
//
// Exposed as a plain C ABI consumed via ctypes
// (qutlass_tpu/runtime/host_lib.py).  Build: `make -C csrc`.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr double kE2M1Grid[8] = {0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0};

// RTNE onto the e2m1 grid with even-code tie-break
// (cvt.rn.satfinite.e2m1x2 semantics; tests/mxfp4_test.py:45-81).
inline uint8_t e2m1_rtne_code(double x) {
  uint8_t sign = std::signbit(x) ? 8 : 0;
  double a = std::fabs(x);
  if (std::isnan(a)) return 0;
  if (a >= 6.0) return sign | 7;
  uint8_t mag;
  if (a <= 2.0) {
    double r = std::nearbyint(a * 2.0);  // assumes FE_TONEAREST (ties-even)
    mag = (uint8_t)r;
  } else if (a <= 4.0) {
    mag = (uint8_t)(2.0 + std::nearbyint(a));
  } else {
    mag = (uint8_t)(4.0 + std::nearbyint(a * 0.5));
  }
  return sign | mag;
}

inline double e2m1_decode(uint8_t code) {
  double v = kE2M1Grid[code & 7];
  return (code & 8) ? -v : v;
}

// pow2-floor of a positive double, clamped to the e8m0 byte range.
inline uint8_t e8m0_from_value(double s) {
  if (!(s > 0.0)) return 0;
  int e = (int)std::floor(std::log2(s));
  return (uint8_t)std::clamp(e + 127, 0, 254);
}

inline double e8m0_decode(uint8_t b) { return std::ldexp(1.0, (int)b - 127); }

inline uint8_t e4m3_from_value(double x) {
  uint8_t sign = std::signbit(x) ? 0x80 : 0;
  double a = std::fabs(x);
  if (std::isnan(a)) return sign | 0x7F;
  a = std::min(a, 448.0);
  if (a < std::ldexp(1.0, -6)) {  // subnormal: step 2^-9
    int m = (int)std::nearbyint(a * 512.0);
    return sign | (uint8_t)m;
  }
  int e = (int)std::floor(std::log2(a));
  double m = a / std::ldexp(1.0, e);         // [1, 2)
  int mant = (int)std::nearbyint((m - 1.0) * 8.0);
  if (mant == 8) { mant = 0; ++e; }
  if (e > 8 || (e == 8 && mant > 6)) { e = 8; mant = 6; }  // clamp to 448
  return sign | (uint8_t)(((e + 7) << 3) | mant);
}

inline double e4m3_decode(uint8_t b) {
  double sign = (b & 0x80) ? -1.0 : 1.0;
  int e = (b >> 3) & 0xF;
  int m = b & 7;
  if (e == 15 && m == 7) return NAN;
  double v = e == 0 ? m * std::ldexp(1.0, -9)
                    : (1.0 + m / 8.0) * std::ldexp(1.0, e - 7);
  return sign * v;
}

inline double bf16_round(double x) {
  float f = (float)x;
  uint32_t u;
  std::memcpy(&u, &f, 4);
  uint32_t lsb = (u >> 16) & 1;
  u += 0x7FFF + lsb;
  u &= 0xFFFF0000u;
  std::memcpy(&f, &u, 4);
  return (double)f;
}

}  // namespace

extern "C" {

// Rotate rows of x[rows, k] by h[rot, rot] per contiguous rot-chunk
// (fp64), then MX-quantize each 32-group: emits packed e2m1 (2/byte,
// low nibble first) and e8m0 scale bytes.  method: 0=quest, 1=abs_max.
// Mirrors the fp64 golden model exactly.
void qutlass_quantize_mx_golden(const float* x, const float* h, int64_t rows,
                                int64_t k, int rot, int method,
                                uint8_t* out_packed, uint8_t* out_scales,
                                uint8_t* out_mask /* nullable */) {
  const int64_t groups = k / 32;
  double* xh = new double[k];
  double* hrot = new double[(int64_t)rot * rot];
  for (int64_t i = 0; i < (int64_t)rot * rot; ++i) hrot[i] = h[i];

  for (int64_t r = 0; r < rows; ++r) {
    const float* xr = x + r * k;
    // rotation per rot-chunk
    for (int64_t c = 0; c < k / rot; ++c) {
      for (int j = 0; j < rot; ++j) {
        double acc = 0.0;
        for (int i = 0; i < rot; ++i)
          acc += (double)xr[c * rot + i] * hrot[(int64_t)i * rot + j];
        xh[c * rot + j] = acc;
      }
    }
    for (int64_t g = 0; g < groups; ++g) {
      const double* grp = xh + g * 32;
      double scale;
      if (method == 0) {
        double s1 = 0, s2 = 0;
        for (int i = 0; i < 32; ++i) { s1 += grp[i]; s2 += grp[i] * grp[i]; }
        double mean = s1 / 32.0;
        double var = s2 / 32.0 - mean * mean;
        scale = var >= 0 ? std::sqrt(var) * (2.92247856 / 6.0) + 1e-8 : 1.0;
      } else {
        double amax = 0;
        for (int i = 0; i < 32; ++i) amax = std::max(amax, std::fabs(grp[i]));
        scale = amax + 1e-8;
      }
      uint8_t sb = e8m0_from_value(scale);
      double sf = e8m0_decode(sb);
      out_scales[r * groups + g] = sb;
      for (int i = 0; i < 32; i += 2) {
        double q0 = grp[i] / sf, q1 = grp[i + 1] / sf;
        if (method == 1) { q0 *= 3.0; q1 *= 3.0; }
        uint8_t c0 = e2m1_rtne_code(q0), c1 = e2m1_rtne_code(q1);
        out_packed[r * (k / 2) + g * 16 + i / 2] = (uint8_t)(c0 | (c1 << 4));
        if (out_mask) {
          int64_t e0 = g * 32 + i, e1 = e0 + 1;
          uint8_t* mb = out_mask + r * (k / 8);
          if (std::fabs(q0) < 6.0) mb[e0 >> 3] |= (uint8_t)(1u << (e0 & 7));
          if (std::fabs(q1) < 6.0) mb[e1 >> 3] |= (uint8_t)(1u << (e1 & 7));
        }
      }
    }
  }
  delete[] xh;
  delete[] hrot;
}

// Dequantize packed e2m1 + e8m0 scales to float32 (exact).
void qutlass_dequantize_mx(const uint8_t* packed, const uint8_t* scales,
                           int64_t rows, int64_t k, float alpha_inv,
                           float* out) {
  const int64_t groups = k / 32;
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t g = 0; g < groups; ++g) {
      double sf = e8m0_decode(scales[r * groups + g]);
      for (int i = 0; i < 16; ++i) {
        uint8_t b = packed[r * (k / 2) + g * 16 + i];
        out[r * k + g * 32 + 2 * i] = (float)(e2m1_decode(b & 0xF) * sf * alpha_inv);
        out[r * k + g * 32 + 2 * i + 1] =
            (float)(e2m1_decode(b >> 4) * sf * alpha_inv);
      }
    }
  }
}

// cuBLAS/Blackwell 128x4 block-scale swizzle (reference utils.py:160-193)
// for exporting row-major [rows, cols] scale bytes to GPU runtimes.
// rows % 128 == 0, cols % 4 == 0; out has the same number of bytes.
void qutlass_to_blocked_swizzled(const uint8_t* in, int64_t rows,
                                 int64_t cols, uint8_t* out) {
  const int64_t nrb = rows / 128, ncb = cols / 4;
  int64_t idx = 0;
  for (int64_t rb = 0; rb < nrb; ++rb)
    for (int64_t cb = 0; cb < ncb; ++cb)
      for (int64_t r = 0; r < 32; ++r)
        for (int64_t rr = 0; rr < 4; ++rr)
          for (int64_t c = 0; c < 4; ++c)
            out[idx++] = in[(rb * 128 + rr * 32 + r) * cols + cb * 4 + c];
}

// Scalar codec entry points (validation / tooling).
uint8_t qutlass_e2m1_encode(double x) { return e2m1_rtne_code(x); }
double qutlass_e2m1_decode(uint8_t c) { return e2m1_decode(c); }
uint8_t qutlass_e4m3_encode(double x) { return e4m3_from_value(x); }
double qutlass_e4m3_decode(uint8_t b) { return e4m3_decode(b); }
uint8_t qutlass_e8m0_encode(double s) { return e8m0_from_value(s); }
double qutlass_e8m0_decode(uint8_t b) { return e8m0_decode(b); }
double qutlass_bf16_round(double x) { return bf16_round(x); }

int qutlass_host_abi_version() { return 1; }

}  // extern "C"
