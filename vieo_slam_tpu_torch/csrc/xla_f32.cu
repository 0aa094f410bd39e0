// The card's build of xla_f32.cuh: the ORB extraction stages in the
// operation order of the JAX package's XLA CPU programs, so the H100
// computes the reference's f32 bits (ops/xla_f32.py; xla_f32_host.cc is the
// CPU build of the same functions).  Built with -fmad=false: the fma()
// calls of the header are the only fused operations.
//
// These kernels replace library calls of the plain path (two matrix
// products a pyramid level, a reduction, atan2, sin and cos), not TPU
// kernels.  They are simple one-thread-an-output kernels: the pyramid is
// some 2 M taps a frame, the tail some 2400 keypoints.

#include <cuda_runtime.h>

#include "xla_f32.cuh"

namespace {

constexpr int THREADS = 256;

inline unsigned blocks_for(long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

__global__ void resize_pass_kernel(const float* src, long sk, long sr,
                                   long n_rows, int n_out, const int* k0,
                                   const int* nt, const int* off,
                                   const float* w, int order, int kc,
                                   float* out, long so, long sro) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)n_out * n_rows) return;
  // Consecutive threads take consecutive rows r: the coalesced axis of src
  // for the row pass (sr = 1).
  const int o = (int)(i / n_rows);
  const long r = i % n_rows;
  out[o * so + r * sro] =
      xla_tapsum(src + r * sr, sk, w + off[o], k0[o], nt[o], order, kc);
}

__global__ void ic_angle_kernel(const float* patches, long n, long sn,
                                long sy, const float* mask, float* angle,
                                float* moments) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m01, m10;
  xla_ic_moments(patches + i * sn, sy, mask, &m01, &m10);
  angle[i] = xf_atan2f_xla(m01, m10);
  if (moments) {
    moments[2 * i] = m01;
    moments[2 * i + 1] = m10;
  }
}

__global__ void brief_kernel(const float* patches, long n,
                             const float* angle, const int* box,
                             const float* pattern, int* desc) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 8) return;
  const long i = t / 8;
  const int w = (int)(t % 8);
  const float c = xf_cosf(angle[i]), s = xf_sinf(angle[i]);
  const float* p = patches + i * 47 * 47;
  const int* b = box + 4 * i;
  unsigned int word = 0;
  for (int bit = 0; bit < 32; ++bit) {
    float v[2];
    for (int e = 0; e < 2; ++e) {
      const float* pt = pattern + 2 * (2 * (32 * w + bit) + e);
      int rx, ry;
      xla_brief_tap(c, s, pt[0], pt[1], &rx, &ry);
      int ix = min(max(rx + 23, b[0]), b[1]);
      int iy = min(max(ry + 23, b[2]), b[3]);
      v[e] = p[iy * 47 + ix];
    }
    word |= (unsigned int)(v[0] < v[1]) << bit;
  }
  desc[i * 8 + w] = (int)word;
}

struct Gauss7 {
  float k[7];
};

__global__ void blur7_rows_kernel(const float* src, long n, int hs, int ws,
                                  Gauss7 g, float* tmp) {
  const int wo = ws - 6;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * hs * wo) return;
  const long row = t / wo;                  // image i, row y
  const int x = (int)(t % wo);
  tmp[t] = xla_blur7_sum(src + row * ws + x, 1, g.k);
}

__global__ void blur7_cols_kernel(const float* tmp, long n, int hs, int ws,
                                  Gauss7 g, float* out) {
  const int wo = ws - 6, ho = hs - 6;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * ho * wo) return;
  const long i = t / ((long)ho * wo);
  const int y = (int)((t / wo) % ho), x = (int)(t % wo);
  out[t] = xla_blur7_sum(tmp + (i * hs + y) * wo + x, wo, g.k);
}

__global__ void unary_kernel(const float* a, const float* b, float* out,
                             long n, int op) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = op == 0 ? xf_atan2f_xla(a[i], b[i])
                   : (op == 1 ? xf_sinf(a[i]) : xf_cosf(a[i]));
}

}  // namespace

extern "C" {

int vs_xf_resize_pass(const float* src, long sk, long sr, long n_rows,
                      int n_out, const int* k0, const int* nt, const int* off,
                      const float* w, int order, int kc, float* out, long so,
                      long sro, void* stream) {
  const long total = (long)n_out * n_rows;
  if (total <= 0) return 0;
  resize_pass_kernel<<<blocks_for(total), THREADS, 0, (cudaStream_t)stream>>>(
      src, sk, sr, n_rows, n_out, k0, nt, off, w, order, kc, out, so, sro);
  return (int)cudaGetLastError();
}

int vs_xf_ic_angle(const float* patches, long n, long sn, long sy,
                   const float* mask, float* angle, float* moments,
                   void* stream) {
  if (n <= 0) return 0;
  ic_angle_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      patches, n, sn, sy, mask, angle, moments);
  return (int)cudaGetLastError();
}

int vs_xf_brief(const float* patches, long n, const float* angle,
                const int* box, const float* pattern, int* desc,
                void* stream) {
  if (n <= 0) return 0;
  brief_kernel<<<blocks_for(n * 8), THREADS, 0, (cudaStream_t)stream>>>(
      patches, n, angle, box, pattern, desc);
  return (int)cudaGetLastError();
}

int vs_xf_blur7(const float* src, long n, int hs, int ws, const float* k,
                float* tmp, float* out, void* stream) {
  if (n <= 0 || hs < 7 || ws < 7) return (int)cudaErrorInvalidValue;
  Gauss7 g;
  for (int i = 0; i < 7; ++i) g.k[i] = k[i];
  const cudaStream_t st = (cudaStream_t)stream;
  blur7_rows_kernel<<<blocks_for(n * hs * (ws - 6)), THREADS, 0, st>>>(
      src, n, hs, ws, g, tmp);
  blur7_cols_kernel<<<blocks_for(n * (hs - 6) * (ws - 6)), THREADS, 0, st>>>(
      tmp, n, hs, ws, g, out);
  return (int)cudaGetLastError();
}

// op 0: atan2(a, b); 1: sin(a); 2: cos(a).
int vs_xf_unary(const float* a, const float* b, float* out, long n, int op,
                void* stream) {
  if (n <= 0) return 0;
  unary_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(a, b, out,
                                                                   n, op);
  return (int)cudaGetLastError();
}

}  // extern "C"
