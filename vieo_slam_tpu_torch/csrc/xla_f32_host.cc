// The CPU build of xla_f32.cuh: plain loops over the stage functions, with
// a C interface for ctypes (ops/xla_f32.py).  Built by g++ at first use
// with -ffp-contract=off; csrc/xla_f32.cu is the card's build of the same
// functions.

#include "xla_f32.cuh"

extern "C" {

// out[o * so + r * sro] = tap sum of output o over src[k * sk + r * sr]:
// taps k0[o] .. k0[o] + nt[o] - 1 with weights w[off[o] ...].
void xf_resize_pass(const float* src, long sk, long sr, long n_rows,
                    int n_out, const int* k0, const int* nt, const int* off,
                    const float* w, int order, int kc, float* out, long so,
                    long sro) {
  for (int o = 0; o < n_out; ++o)
    for (long r = 0; r < n_rows; ++r)
      out[o * so + r * sro] =
          xla_tapsum(src + r * sr, sk, w + off[o], k0[o], nt[o], order, kc);
}

// angle[i] of the 31x31 patch at patches + i * sn (rows sy apart);
// moments, when not null, gets (m01, m10) of each.
void xf_ic_angle(const float* patches, long n, long sn, long sy,
                 const float* mask, float* angle, float* moments) {
  for (long i = 0; i < n; ++i) {
    float m01, m10;
    xla_ic_moments(patches + i * sn, sy, mask, &m01, &m10);
    angle[i] = xf_atan2f_xla(m01, m10);
    if (moments) {
      moments[2 * i] = m01;
      moments[2 * i + 1] = m10;
    }
  }
}

// Rotated-BRIEF words of [n, 47, 47] blurred patches.  box: [n, 4] int32
// (lo_x, hi_x, lo_y, hi_y) bounds of the taps in patch coordinates.
// pattern: [512, 2] f32 (px, py), pairs of consecutive points.
void xf_brief(const float* patches, long n, const float* angle,
              const int* box, const float* pattern, int* desc) {
  for (long i = 0; i < n; ++i) {
    const float c = xf_cosf(angle[i]), s = xf_sinf(angle[i]);
    const float* p = patches + i * 47 * 47;
    const int* b = box + 4 * i;
    for (int w = 0; w < 8; ++w) {
      unsigned int word = 0;
      for (int bit = 0; bit < 32; ++bit) {
        float v[2];
        for (int e = 0; e < 2; ++e) {
          const float* pt = pattern + 2 * (2 * (32 * w + bit) + e);
          int rx, ry;
          xla_brief_tap(c, s, pt[0], pt[1], &rx, &ry);
          int ix = rx + 23, iy = ry + 23;
          ix = ix < b[0] ? b[0] : (ix > b[1] ? b[1] : ix);
          iy = iy < b[2] ? b[2] : (iy > b[3] ? b[3] : iy);
          v[e] = p[iy * 47 + ix];
        }
        word |= (unsigned int)(v[0] < v[1]) << bit;
      }
      desc[i * 8 + w] = (int)word;
    }
  }
}

// Valid 7x7 Gaussian of [n, hs, ws] -> [n, hs - 6, ws - 6]: along rows
// (x) first, then columns (y).  tmp: [hs, ws - 6] scratch.
void xf_blur7(const float* src, long n, int hs, int ws, const float* k,
              float* tmp, float* out) {
  const int wo = ws - 6, ho = hs - 6;
  for (long i = 0; i < n; ++i) {
    const float* s = src + i * hs * ws;
    for (int y = 0; y < hs; ++y)
      for (int x = 0; x < wo; ++x) tmp[y * wo + x] = xla_blur7_sum(s + y * ws + x, 1, k);
    float* o = out + i * ho * wo;
    for (int y = 0; y < ho; ++y)
      for (int x = 0; x < wo; ++x) o[y * wo + x] = xla_blur7_sum(tmp + y * wo + x, wo, k);
  }
}

void xf_atan2(const float* y, const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = xf_atan2f_xla(y[i], x[i]);
}

void xf_atan2_glibc(const float* y, const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = xf_atan2f(y[i], x[i]);
}

void xf_sin(const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = xf_sinf(x[i]);
}

void xf_cos(const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = xf_cosf(x[i]);
}

}  // extern "C"
