// glibc 2.36's atan2f, sinf and cosf (x86-64), reproduced bit for bit as
// __host__ __device__ functions.
//
// The JAX package's XLA CPU programs call the C library for these (the
// object code of an `atan2` fusion leaves `atan2f` undefined, a fused
// sin + cos calls `sincosf`), so the reference's angles and BRIEF rotations
// are glibc's bits.  The card's libdevice and the host's own libm round
// otherwise; these functions do not depend on either.
//
// - atan2f: fdlibm's e_atan2f.c + s_atanf.c in single precision, no fused
//   operation (glibc builds them for baseline x86-64, SSE2 only; |y/x|
//   cut-offs at 2^60).
// - sinf / cosf / sincosf: Szabolcs Nagy's double-precision evaluation
//   (sincosf.h).  On a CPU with FMA and AVX2 glibc runs the build made with
//   -mfma -mavx2, in which GCC fused every `a + b * c` of the polynomials and
//   of the fast argument reduction into one fma; the explicit fma() calls
//   below are those, and every other operation is rounded on its own.  The
//   constants are the ones in libm.so.6's __sincosf_table and __inv_pio4.
//
// Build with fused multiply-add contraction off (g++ -ffp-contract=off,
// nvcc -fmad=false): every operation here must round where it is written.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define XF_HD __host__ __device__ __forceinline__
#else
#define XF_HD static inline
#endif

XF_HD uint32_t xf_asuint(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

XF_HD float xf_asfloat(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

// ---------------------------------------------------------------------------
// atanf / atan2f (fdlibm, single precision)
// ---------------------------------------------------------------------------

XF_HD float xf_atanf(float x) {
  const float atanhi[4] = {4.6364760399e-01f, 7.8539812565e-01f,
                           9.8279368877e-01f, 1.5707962513e+00f};
  const float atanlo[4] = {5.0121582440e-09f, 3.7748947079e-08f,
                           3.4473217170e-08f, 7.5497894159e-08f};
  const float aT[11] = {3.3333334327e-01f,  -2.0000000298e-01f,
                        1.4285714924e-01f,  -1.1111110449e-01f,
                        9.0908870101e-02f,  -7.6918758452e-02f,
                        6.6610731184e-02f,  -5.8335702866e-02f,
                        4.9768779427e-02f,  -3.6531571299e-02f,
                        1.6285819933e-02f};
  const uint32_t hx = xf_asuint(x);
  const uint32_t ix = hx & 0x7fffffffu;
  int id;
  if (ix >= 0x4c000000u) {                  // |x| >= 2^25
    if (ix > 0x7f800000u) return x + x;     // NaN
    return ((int32_t)hx > 0) ? atanhi[3] + atanlo[3] : -atanhi[3] - atanlo[3];
  }
  if (ix < 0x3ee00000u) {                   // |x| < 0.4375
    if (ix < 0x31000000u) return x;         // |x| < 2^-29
    id = -1;
  } else {
    x = fabsf(x);
    if (ix < 0x3f980000u) {                 // |x| < 1.1875
      if (ix < 0x3f300000u) {               // 7/16 <= |x| < 11/16
        id = 0;
        x = (2.0f * x - 1.0f) / (2.0f + x);
      } else {                              // 11/16 <= |x| < 19/16
        id = 1;
        x = (x - 1.0f) / (x + 1.0f);
      }
    } else if (ix < 0x401c0000u) {          // |x| < 2.4375
      id = 2;
      x = (x - 1.5f) / (1.0f + 1.5f * x);
    } else {                                // 2.4375 <= |x| < 2^25
      id = 3;
      x = -1.0f / x;
    }
  }
  const float z = x * x;
  const float w = z * z;
  const float s1 = z * (aT[0] + w * (aT[2] + w * (aT[4] + w * (aT[6]
                   + w * (aT[8] + w * aT[10])))));
  const float s2 = w * (aT[1] + w * (aT[3] + w * (aT[5] + w * (aT[7]
                   + w * aT[9]))));
  if (id < 0) return x - x * (s1 + s2);
  const float r = atanhi[id] - ((x * (s1 + s2) - atanlo[id]) - x);
  return ((int32_t)hx < 0) ? -r : r;
}

// A subnormal flushed to a zero of its sign (x86's DAZ and FTZ modes).
XF_HD float xf_flush(float v) {
  const uint32_t u = xf_asuint(v);
  return ((u & 0x7f800000u) == 0) ? xf_asfloat(u & 0x80000000u) : v;
}

// glibc's atan2f; with `daz` as XLA's CPU runtime runs it (denormals-are-zero
// and flush-to-zero set): the division sees subnormal operands as zeros and
// a subnormal quotient or result becomes zero.
XF_HD float xf_atan2f_impl(float y, float x, bool daz) {
  const float tiny = 1.0e-30f, pi_o_4 = 7.8539818525e-01f,
              pi_o_2 = 1.5707963705e+00f, pi = 3.1415927410e+00f,
              pi_lo = -8.7422776573e-08f;
  const int32_t hx = (int32_t)xf_asuint(x), hy = (int32_t)xf_asuint(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return x + y;   // NaN
  if (hx == 0x3f800000) return xf_atanf(y);                 // x = 1
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);        // 2 sign(x) + sign(y)
  if (iy == 0) {
    switch (m) {
      case 0:
      case 1: return y;
      case 2: return pi + tiny;
      default: return -pi - tiny;
    }
  }
  if (ix == 0) return (hy < 0) ? -pi_o_2 - tiny : pi_o_2 + tiny;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return pi_o_4 + tiny;
        case 1: return -pi_o_4 - tiny;
        case 2: return 3.0f * pi_o_4 + tiny;
        default: return -3.0f * pi_o_4 - tiny;
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return pi + tiny;
      default: return -pi - tiny;
    }
  }
  if (iy == 0x7f800000) return (hy < 0) ? -pi_o_2 - tiny : pi_o_2 + tiny;
  const int32_t k = (iy - ix) >> 23;
  float z;
  if (k > 60) z = pi_o_2 + 0.5f * pi_lo;          // |y/x| > 2^60
  else if (hx < 0 && k < -60) z = 0.0f;           // |y|/x < -2^60
  else if (daz) z = xf_flush(xf_atanf(xf_flush(fabsf(xf_flush(y) / xf_flush(x)))));
  else z = xf_atanf(fabsf(y / x));
  float r;
  switch (m) {
    case 0: r = z; break;
    case 1: r = xf_asfloat(xf_asuint(z) ^ 0x80000000u); break;
    case 2: r = pi - (z - pi_lo); break;
    default: r = (z - pi_lo) - pi;
  }
  return daz ? xf_flush(r) : r;
}

// glibc 2.36's atan2f.
XF_HD float xf_atan2f(float y, float x) { return xf_atan2f_impl(y, x, false); }
// atan2 as the JAX package's XLA CPU programs compute it.
XF_HD float xf_atan2f_xla(float y, float x) { return xf_atan2f_impl(y, x, true); }

// ---------------------------------------------------------------------------
// sinf / cosf (double-precision evaluation, FMA build)
// ---------------------------------------------------------------------------

struct XfSincos {
  double sign[4], hpi_inv, hpi, c0, c1, s1, c2, s2, c3, s3, c4;
};

#define XF_SINCOS_TABLE                                                      \
  {{{1.0, -1.0, -1.0, 1.0}, 0x1.45f306dc9c883p+23, 0x1.921fb54442d18p+0,     \
    0x1.0p+0, -0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3,                  \
    0x1.55553e1068f19p-5, 0x1.1107605230bc4p-7, -0x1.6c087e89a359dp-10,      \
    -0x1.994eb3774cf24p-13, 0x1.99343027bf8c3p-16},                          \
   {{1.0, -1.0, -1.0, 1.0}, 0x1.45f306dc9c883p+23, 0x1.921fb54442d18p+0,     \
    -0x1.0p+0, 0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3,                  \
    -0x1.55553e1068f19p-5, 0x1.1107605230bc4p-7, 0x1.6c087e89a359dp-10,      \
    -0x1.994eb3774cf24p-13, -0x1.99343027bf8c3p-16}}
#define XF_INV_PIO4                                                          \
  {0xa2u,       0xa2f9u,     0xa2f983u,   0xa2f9836eu, 0xf9836e4eu,          \
   0x836e4e44u, 0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u,          \
   0x29fc2757u, 0xfc2757d1u, 0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu,          \
   0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u, 0xc0db6295u, 0xdb629599u,          \
   0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u}

static const XfSincos xf_sincos_host[2] = XF_SINCOS_TABLE;
static const uint32_t xf_inv_pio4_host[24] = XF_INV_PIO4;
#ifdef __CUDACC__
__constant__ XfSincos xf_sincos_dev[2] = XF_SINCOS_TABLE;
__constant__ uint32_t xf_inv_pio4_dev[24] = XF_INV_PIO4;
#endif

XF_HD const XfSincos* xf_sincos_table(int which) {
#ifdef __CUDA_ARCH__
  return &xf_sincos_dev[which];
#else
  return &xf_sincos_host[which];
#endif
}

XF_HD uint32_t xf_inv_pio4(int i) {
#ifdef __CUDA_ARCH__
  return xf_inv_pio4_dev[i];
#else
  return xf_inv_pio4_host[i];
#endif
}

XF_HD int xf_abstop12(float x) { return (int)((xf_asuint(x) >> 20) & 0x7ff); }

// sinf_poly: the sine polynomial when (n & 1) == 0, else the cosine one.
XF_HD float xf_sinf_poly(double x, double x2, const XfSincos* p, int n) {
  if ((n & 1) == 0) {
    const double x3 = x * x2;
    const double s1 = fma(x2, p->s3, p->s2);
    const double x7 = x3 * x2;
    const double s = fma(x3, p->s1, x);
    return (float)fma(x7, s1, s);
  }
  const double x4 = x2 * x2;
  const double c2 = fma(x2, p->c4, p->c3);
  const double c1 = fma(x2, p->c1, p->c0);
  const double x6 = x4 * x2;
  const double c = fma(x4, p->c2, c1);
  return (float)fma(x6, c2, c);
}

// x - n * pi/2 with n = round(x * 2/pi) through the 2^24-scaled integer.
XF_HD double xf_reduce_fast(double x, const XfSincos* p, int* np) {
  const double r = x * p->hpi_inv;
  const int n = ((int32_t)r + 0x800000) >> 24;
  *np = n;
  return fma(-(double)n, p->hpi, x);
}

XF_HD double xf_reduce_large(uint32_t xi, int* np) {
  const int base = (xi >> 26) & 15;
  const int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = (uint64_t)(uint32_t)(xi * xf_inv_pio4(base));
  const uint64_t res1 = (uint64_t)xi * xf_inv_pio4(base + 4);
  const uint64_t res2 = (uint64_t)xi * xf_inv_pio4(base + 8);
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  const double x = (double)(int64_t)res0;
  *np = (int)n;
  return x * 0x1.921fb54442d18p-62;
}

// sin (cos_flag 0) or cos (cos_flag 1) of y.
XF_HD float xf_sincosf_one(float y, int cos_flag) {
  double x = y;
  int n;
  const XfSincos* p = xf_sincos_table(0);
  if (xf_abstop12(y) < xf_abstop12(0x1.921fb6p-1f)) {       // |y| < pi/4
    const double x2 = x * x;
    if (xf_abstop12(y) < xf_abstop12(0x1p-12f)) return cos_flag ? 1.0f : y;
    return xf_sinf_poly(x, x2, p, cos_flag);
  }
  if (xf_abstop12(y) < xf_abstop12(120.0f)) {
    x = xf_reduce_fast(x, p, &n);
    const double s = p->sign[n & 3];
    if (n & 2) p = xf_sincos_table(1);
    return xf_sinf_poly(x * s, x * x, p, n ^ cos_flag);
  }
  if (xf_abstop12(y) < xf_abstop12(INFINITY)) {
    const uint32_t xi = xf_asuint(y);
    const int sign = xi >> 31;
    x = xf_reduce_large(xi, &n);
    const double s = p->sign[(n + sign) & 3];
    if ((n + sign) & 2) p = xf_sincos_table(1);
    return xf_sinf_poly(x * s, x * x, p, n ^ cos_flag);
  }
  return (y - y) / (y - y);                                   // inf or NaN
}

XF_HD float xf_sinf(float y) { return xf_sincosf_one(y, 0); }
XF_HD float xf_cosf(float y) { return xf_sincosf_one(y, 1); }
