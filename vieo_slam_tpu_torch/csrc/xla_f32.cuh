// The JAX package's ORB extraction stages in the f32 operation order that
// XLA's CPU backend gives them (JAX 0.9.0, x64 off), as __host__ __device__
// functions: built with g++ for the CPU (xla_f32_host.cc) and with nvcc for
// the card (xla_f32.cu), so both compute the reference's bits.
//
// How each order was read (scripts/xla_order.py repeats the checks):
// - XLA_FLAGS=--xla_dump_to=DIR writes each fusion's optimized LLVM IR and
//   object file.  LLVM contracts a multiply feeding an add into one fma
//   (vfmadd in the object code); which product it fuses is fixed below.
// - A `dot` runs in XLA's runtime library (Eigen's tensor contraction); its
//   order per output was found by experiment, bit for bit on random inputs:
//   see xla_tapsum.
//
// Build with contraction off (g++ -ffp-contract=off, nvcc -fmad=false): the
// fma() calls here are the only fused operations.

#pragma once

#include "libm_f32.cuh"

// Orders of one resize contraction (Eigen's runtime dot): a sum of the
// consecutive taps k0 .. k0+n-1 of a weight column (2-4 at the pyramid's
// scale of 1.2) against `src[k * sk]`.
enum XlaDotOrder {
  // k split into blocks of kc; within a block an fma chain in k order from
  // the first rounded product; the block sums added in order.
  XLA_DOT_CHAIN = 0,
  // as CHAIN, but even k and odd k accumulate apart (two fma chains) and
  // meet at the end of each block.
  XLA_DOT_EVEN_ODD = 1,
  // rounded products; the pair (2j, 2j+1) is added first, then the pairs in
  // order.
  XLA_DOT_PAIRS = 2,
};

XF_HD float xla_tapsum(const float* src, long sk, const float* w, int k0,
                       int n, int order, int kc) {
  if (order == XLA_DOT_PAIRS) {
    float acc = 0.0f;
    bool have = false;
    for (int i = 0; i < n;) {
      const int k = k0 + i;
      float s = w[i] * src[(long)k * sk];
      if ((k & 1) == 0 && i + 1 < n) {
        s = s + w[i + 1] * src[(long)(k + 1) * sk];
        i += 2;
      } else {
        i += 1;
      }
      acc = have ? acc + s : s;
      have = true;
    }
    return acc;
  }
  float r = 0.0f;
  bool have_r = false;
  for (int i = 0; i < n;) {
    const int blk = (k0 + i) / kc;
    float c = 0.0f, d = 0.0f;
    bool hc = false, hd = false;
    for (; i < n && (k0 + i) / kc == blk; ++i) {
      const int k = k0 + i;
      const float v = src[(long)k * sk];
      if (order == XLA_DOT_CHAIN || (k & 1) == 0) {
        c = hc ? fmaf(w[i], v, c) : w[i] * v;
        hc = true;
      } else {
        d = hd ? fmaf(w[i], v, d) : w[i] * v;
        hd = true;
      }
    }
    const float b = hc ? (hd ? c + d : c) : d;
    r = have_r ? r + b : b;
    have_r = true;
  }
  return r;
}

// The IC moments (m01, m10) of a 31x31 patch under the disc mask, as the
// reference's two fusions compute einsum("nyx,x->n") / ("nyx,y->n"): a
// masked fma chain along the reduced axis, then a 31-term dot.
// - m01: row sums along x, then a scalar fma chain over y.
// - m10: column sums along y; the dot over x runs vectorized for x < 24 in
//   eight lanes (x mod 8, lane 0 starting at +0, the others at -0), the
//   lanes x and x+4 are added, then (l0 + l2) + (l1 + l3), and x = 24..30
//   follow as a scalar fma chain.
XF_HD void xla_ic_moments(const float* p, long sy, const float* mask,
                          float* m01_out, float* m10_out) {
  float m01 = 0.0f;
  for (int y = 0; y < 31; ++y) {
    float r = fmaf(p[y * sy], mask[y * 31], 0.0f);
    for (int x = 1; x < 31; ++x) r = fmaf(p[y * sy + x], mask[y * 31 + x], r);
    m01 = fmaf(r, (float)(y - 15), m01);
  }
  float col[31];
  for (int x = 0; x < 31; ++x) {
    float c = fmaf(p[x], mask[x], 0.0f);
    for (int y = 1; y < 31; ++y) c = fmaf(p[y * sy + x], mask[y * 31 + x], c);
    col[x] = c;
  }
  float lane[8];
  for (int j = 0; j < 8; ++j) lane[j] = (j == 0) ? 0.0f : -0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 8; ++j) {
      const int x = 8 * i + j;
      lane[j] = fmaf(col[x], (float)(x - 15), lane[j]);
    }
  float b[4];
  for (int j = 0; j < 4; ++j) b[j] = lane[j + 4] + lane[j];
  float m10 = (b[0] + b[2]) + (b[1] + b[3]);
  for (int x = 24; x < 31; ++x) m10 = fmaf(col[x], (float)(x - 15), m10);
  *m01_out = m01;
  *m10_out = m10;
}

// One 7-tap Gaussian sum: the reference's Python sum of products, with LLVM
// fusing the first add as fma(v0, k0, v1 * k1) and each later one as an fma.
XF_HD float xla_blur7_sum(const float* v, long stride, const float* k) {
  float t = fmaf(v[0], k[0], v[stride] * k[1]);
  for (int i = 2; i < 7; ++i) t = fmaf(v[i * stride], k[i], t);
  return t;
}

// A rotated BRIEF tap offset: x' = fma(c, px, -(s * py)),
// y' = fma(s, px, c * py), each rounded half to even.
XF_HD void xla_brief_tap(float c, float s, float px, float py, int* rx,
                         int* ry) {
  *rx = (int)rintf(fmaf(c, px, -(s * py)));
  *ry = (int)rintf(fmaf(s, px, c * py));
}
