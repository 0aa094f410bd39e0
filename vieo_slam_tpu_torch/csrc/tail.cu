// The whole ORB keypoint tail in one launch per image (B5): 53x53 clamped
// window, IC-angle moments over the 31x31 disc, in-window separable 7-tap
// Gaussian (53 -> 47), rotated-BRIEF 256 pair taps, bit compare and pack.
//
// Replaces vieo_slam_tpu/ops/pallas_tail.py tail_fused_multi_kernel /
// tail_fused_kernel (_kernel).  Bound on the H100: each level image is
// read once and 40 bytes leave per keypoint, against about 70 thousand
// f32 operations per keypoint (the two blur passes dominate), so bytes
// and operations are of the same order and the script that times the
// kernel computes both.  Design: one block of 256 threads per keypoint;
// all pyramid levels of an image (or of a stereo pair) go into ONE
// launch -- the per-level image and center pointers travel by value in a
// kernel-parameter struct, so there is no stacked atlas, no padded copy
// and no table in device memory.  A block finds its level from the
// prefix of per-level counts, reads its window into shared memory with
// the edge clamp folded into the index arithmetic (so a window never
// sees a neighbouring level), and keeps window, row-blurred and blurred
// patch in shared memory; only the angle and 8 descriptor words are
// written.  Thread b rotates pair b and a warp ballot packs 32 bits.
//
// Bit-exact to the plain PyTorch version (ops/cuda_tail.py
// tail_fused_multi_plain) by construction: every product and sum is a
// separately rounded f32 operation (__fmul_rn / __fadd_rn, so nvcc fuses
// nothing), the moment sums run as the same fixed halving tree over 1024
// zero-padded products, the blur accumulates its 7 taps left to right,
// cos/sin are m10/r and m01/r with correctly rounded sqrt and divide,
// and the taps round half-to-even (rintf).  Only atan2f is a library
// function.

#include <cuda_runtime.h>

namespace {

constexpr int R = 26;             // raw window radius (BRIEF_R + blur halo)
constexpr int D = 2 * R + 1;      // 53
constexpr int RB = 23;            // blurred patch radius (BRIEF_R)
constexpr int DB = 2 * RB + 1;    // 47
constexpr int RP = 15;            // IC-angle disc radius (PATCH_RADIUS)
constexpr int DP = 2 * RP + 1;    // 31
constexpr int C0 = R - RP;        // 11: offset of the 31x31 centre
constexpr int THREADS = 256;      // one thread per descriptor bit
constexpr int MAX_LEVELS = 32;    // (level, image) entries per launch

struct Levels {
  const float* img[MAX_LEVELS];
  const int* uv[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int start[MAX_LEVELS + 1];      // first keypoint of each entry; [n] = total
  int n;
  float k[7];                     // Gaussian taps
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
tail_fused_kernel(const Levels lv, const float* __restrict__ pattern,
                  float* __restrict__ angle, int* __restrict__ desc) {
  __shared__ float patch[D * D];
  __shared__ float hb[D * DB];
  __shared__ float vb[DB * DB];
  __shared__ float red[2][THREADS];
  __shared__ float cs[2];

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  int l = 0;
  while (l + 1 < lv.n && n >= lv.start[l + 1]) ++l;
  const float* __restrict__ img = lv.img[l];
  const int H = lv.H[l], W = lv.W[l];
  const int* c = lv.uv[l] + 2 * (n - lv.start[l]);
  const int cx = clampi(c[0], 0, W - 1);
  const int cy = clampi(c[1], 0, H - 1);

  // 1. the clamped 53x53 window
  for (int i = t; i < D * D; i += THREADS) {
    const int py = i / D, px = i - py * D;
    const int y = clampi(cy + py - R, 0, H - 1);
    const int x = clampi(cx + px - R, 0, W - 1);
    patch[i] = img[(size_t)y * W + x];
  }
  __syncthreads();

  // 2. intensity-centroid moments: products patch * (mask * coord) of the
  // 31x31 centre, zero-padded to 1024 and summed by halving
  // (s[i] += s[i + half], half = 512 .. 1).
  float p10[4], p01[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = t + j * THREADS;
    float a = 0.f, b = 0.f;
    if (i < DP * DP) {
      const int y = i / DP, x = i - y * DP;
      const int dx = x - RP, dy = y - RP;
      const float m = (dx * dx + dy * dy <= RP * RP) ? 1.f : 0.f;
      const float v = patch[(C0 + y) * D + C0 + x];
      a = __fmul_rn(v, __fmul_rn(m, (float)dx));
      b = __fmul_rn(v, __fmul_rn(m, (float)dy));
    }
    p10[j] = a;
    p01[j] = b;
  }
  red[0][t] = __fadd_rn(__fadd_rn(p10[0], p10[2]), __fadd_rn(p10[1], p10[3]));
  red[1][t] = __fadd_rn(__fadd_rn(p01[0], p01[2]), __fadd_rn(p01[1], p01[3]));
  __syncthreads();
  for (int half = THREADS / 2; half >= 32; half >>= 1) {
    if (t < half) {
      red[0][t] = __fadd_rn(red[0][t], red[0][t + half]);
      red[1][t] = __fadd_rn(red[1][t], red[1][t + half]);
    }
    __syncthreads();
  }
  if (t < 32) {
    float m10 = red[0][t], m01 = red[1][t];
#pragma unroll
    for (int half = 16; half >= 1; half >>= 1) {
      m10 = __fadd_rn(m10, __shfl_down_sync(0xffffffffu, m10, half));
      m01 = __fadd_rn(m01, __shfl_down_sync(0xffffffffu, m01, half));
    }
    if (t == 0) {
      const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(m10, m10),
                                           __fmul_rn(m01, m01)));
      cs[0] = r > 0.f ? __fdiv_rn(m10, r) : 1.f;
      cs[1] = r > 0.f ? __fdiv_rn(m01, r) : 0.f;
      angle[n] = atan2f(m01, m10);
    }
  }

  // 3. separable valid blur, rows then columns, taps left to right
  for (int i = t; i < D * DB; i += THREADS) {
    const int y = i / DB, x = i - y * DB;
    const float* p = patch + y * D + x;
    float acc = __fmul_rn(p[0], lv.k[0]);
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = __fadd_rn(acc, __fmul_rn(p[j], lv.k[j]));
    hb[i] = acc;
  }
  __syncthreads();
  for (int i = t; i < DB * DB; i += THREADS) {
    const float* p = hb + i;
    float acc = __fmul_rn(p[0], lv.k[0]);
#pragma unroll
    for (int j = 1; j < 7; ++j)
      acc = __fadd_rn(acc, __fmul_rn(p[j * DB], lv.k[j]));
    vb[i] = acc;
  }
  __syncthreads();

  // 4. rotated BRIEF: thread b compares the two taps of pair b
  const float ca = cs[0], sa = cs[1];
  const float4 q = reinterpret_cast<const float4*>(pattern)[t];  // x1 y1 x2 y2
  const int x1 = clampi((int)rintf(__fsub_rn(__fmul_rn(ca, q.x),
                                             __fmul_rn(sa, q.y))) + RB, 0, DB - 1);
  const int y1 = clampi((int)rintf(__fadd_rn(__fmul_rn(sa, q.x),
                                             __fmul_rn(ca, q.y))) + RB, 0, DB - 1);
  const int x2 = clampi((int)rintf(__fsub_rn(__fmul_rn(ca, q.z),
                                             __fmul_rn(sa, q.w))) + RB, 0, DB - 1);
  const int y2 = clampi((int)rintf(__fadd_rn(__fmul_rn(sa, q.z),
                                             __fmul_rn(ca, q.w))) + RB, 0, DB - 1);
  const bool bit = vb[y1 * DB + x1] < vb[y2 * DB + x2];
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if ((t & 31) == 0) desc[n * 8 + (t >> 5)] = (int)word;
}

}  // namespace

// Host arrays imgs/uvs (device pointers), H, W, counts have n_levels
// entries (1 <= n_levels <= 32, sum(counts) > 0: the Python wrapper splits
// longer lists and answers an empty one without a launch); taps has 7;
// pattern is a device array of 256 x (x1, y1, x2, y2) f32, 16-byte aligned.
extern "C" int vs_tail_fused(const void* const* imgs, const void* const* uvs,
                             const int* H, const int* W, const int* counts,
                             int n_levels, const float* taps,
                             const float* pattern, float* angle, int* desc,
                             void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  int total = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool on = l < n_levels;
    lv.img[l] = on ? (const float*)imgs[l] : nullptr;
    lv.uv[l] = on ? (const int*)uvs[l] : nullptr;
    lv.H[l] = on ? H[l] : 0;
    lv.W[l] = on ? W[l] : 0;
    lv.start[l] = total;
    if (on) total += counts[l];
  }
  lv.start[MAX_LEVELS] = total;
  lv.n = n_levels;
  for (int j = 0; j < 7; ++j) lv.k[j] = taps[j];
  if (total <= 0) return (int)cudaErrorInvalidValue;
  tail_fused_kernel<<<total, THREADS, 0, (cudaStream_t)stream>>>(
      lv, pattern, angle, desc);
  return (int)cudaGetLastError();
}
