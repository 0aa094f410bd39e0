// The whole ORB keypoint tail in one launch per image or stereo pair (B5):
// 53x53 clamped window, IC-angle moments over the 31x31 disc, in-window
// separable 7-tap Gaussian (53 -> 47), rotated-BRIEF 256 pair taps, bit
// compare and pack.
//
// Replaces vieo_slam_tpu/ops/pallas_tail.py tail_fused_multi_kernel /
// tail_fused_kernel (_kernel).  Bound on the H100: each level image is
// read once and 40 bytes leave per keypoint, against some 40 thousand f32
// operations per keypoint (the row blur dominates), so bytes and
// operations are of the same order and the script that times the kernel
// computes both.  What the time goes to is instruction issue, latency
// chains, shared-memory bank conflicts and the L2 reads of the windows,
// so the design cuts instructions, keeps every chain short and passes
// three barriers (the first design passed seven).  One block of 256
// threads per keypoint; all (level, image) entries of a call go into ONE
// launch through the table of levels.cuh.
//   1. the window: a warp walks rows, its lanes on columns (no divide),
//      all its rows in flight before the shared-memory stores; a window
//      inside its image takes no clamp.  The thread's BRIEF pair is read
//      meanwhile.  Barrier.
//   2. moment products: thread t holds positions t + 256 j (j < 4) of the
//      1024 zero-padded ones, the weights mask * dx and mask * dy read
//      from a table (L1-resident, coalesced), and sums them as the halving
//      steps 512 and 256 pair them.  Barrier.
//   3. warp 0 finishes the moments while warps 1-7 compute the row blur
//      (53 x 47) into shared memory.
//      - Moments: lane l adds the 8 warps' sums of position l in the order
//        of halving steps 128, 64 and 32, in registers, and
//        __shfl_down_sync does 16 .. 1; lane 0 turns them into cos, sin
//        and the angle.
//        (One warp holding all 32 products of a lane made a serial chain
//        that the whole block waited for.)
//      - Row blur: a thread takes a 12-column segment of one row, lanes on
//        rows (the odd row stride keeps them on distinct banks), and
//        slides a window of 7 registers along it: one shared-memory read
//        an output instead of seven.  Barrier.
//   4. thread b rotates pair b and takes the column blur at its two taps
//      only, straight from the row-blurred patch (512 of the 2209 outputs
//      a full column pass would make); a warp ballot packs 32 bits.
// Shared memory: window, row-blurred patch and 8 x 32 moment sums, 23 KB
// a block (the first design also kept the 47x47 column-blurred patch, 32 KB
// in all).
//
// Bit-exact to the plain PyTorch version (ops/cuda_tail.py
// tail_fused_multi_plain) by construction: every product and sum is a
// separately rounded f32 operation (__fmul_rn / __fadd_rn, so nvcc fuses
// nothing), the moment sums run as the same fixed halving tree over 1024
// zero-padded products, the blur accumulates its 7 taps left to right in
// rows and then in columns (a tap's column blur is the value the full
// pass would hold there), cos/sin are m10/r and m01/r with correctly
// rounded sqrt and divide, and the taps round half-to-even (rintf).  Only
// atan2f is a library function.

#include "levels.cuh"

namespace {

using vs::clampi;
using vs::Levels;

constexpr int R = 26;             // raw window radius (BRIEF_R + blur halo)
constexpr int D = 2 * R + 1;      // 53
constexpr int RB = 23;            // blurred patch radius (BRIEF_R)
constexpr int DB = 2 * RB + 1;    // 47
constexpr int RP = 15;            // IC-angle disc radius (PATCH_RADIUS)
constexpr int DP = 2 * RP + 1;    // 31
constexpr int C0 = R - RP;        // 11: offset of the 31x31 centre
constexpr int THREADS = 256;      // one thread per descriptor bit
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = (D + WARPS - 1) / WARPS;   // window rows a warp loads
constexpr int SEG = 12;                         // row-blur outputs a thread
constexpr int NSEG = (DB + SEG - 1) / SEG;      // segments a row: 4
static_assert(D * NSEG <= THREADS - 32, "row blur needs warps 1-7");
constexpr int NW = 1024;                        // moment weights a moment

struct Taps {
  float k[7];                     // Gaussian taps
};

// The moment products of position i = 31 y + x (zero from 961 on): patch *
// (mask * dx) and patch * (mask * dy) over the 31x31 centre, the weights
// read from a table (L1-resident, coalesced across the warp).
__device__ __forceinline__ float2 moment_products(const float* patch,
                                                  const float* __restrict__ w,
                                                  int i, int y, int x) {
  if (i >= DP * DP) return make_float2(0.f, 0.f);
  const float v = patch[(C0 + y) * D + C0 + x];
  return make_float2(__fmul_rn(v, __ldg(w + i)),
                     __fmul_rn(v, __ldg(w + NW + i)));
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// The column blur at (x, y) of the 47x47 blurred patch, from the
// row-blurred patch hb [53][47]: taps top to bottom, as the full pass.
__device__ __forceinline__ float blur_col(const float* hb, int x, int y,
                                          const Taps& t) {
  const float* p = hb + y * DB + x;
  float acc = __fmul_rn(p[0], t.k[0]);
#pragma unroll
  for (int j = 1; j < 7; ++j)
    acc = __fadd_rn(acc, __fmul_rn(p[j * DB], t.k[j]));
  return acc;
}

__device__ __forceinline__ int tap(float v) {
  return clampi((int)rintf(v) + RB, 0, DB - 1);
}

__global__ void __launch_bounds__(THREADS)
tail_fused_kernel(const Levels lv, const Taps taps,
                  const float* __restrict__ pattern,
                  const float* __restrict__ weights,
                  float* __restrict__ angle, int* __restrict__ desc) {
  __shared__ float patch[D * D];
  __shared__ float hb[D * DB];
  __shared__ float2 red[WARPS][32];  // per-thread moment partial sums
  __shared__ float cs[2];

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int l = vs::level_of(lv, n);
  const float* __restrict__ img = lv.img[l];
  const int H = lv.H[l], W = lv.W[l];
  const int* c = lv.uv[l] + 2 * (n - lv.start[l]);
  const int x0 = clampi(c[0], 0, W - 1) - R;   // window origin in the image
  const int y0 = clampi(c[1], 0, H - 1) - R;
  const bool inside = x0 >= 0 && y0 >= 0 && x0 + D <= W && y0 + D <= H;
  // pair t of the BRIEF pattern (x1, y1, x2, y2), read while the window
  // loads
  const float4 q = reinterpret_cast<const float4*>(pattern)[t];

  // 1. the clamped 53x53 window: rows warp + 8 j, columns lane and lane + 32
  {
    const int px1 = lane + 32;
    const int gx0 = inside ? x0 + lane : clampi(x0 + lane, 0, W - 1);
    const int gx1 = inside ? x0 + px1 : clampi(x0 + px1, 0, W - 1);
    float a[ROWS], b[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int py = warp + j * WARPS;
      if (py < D) {
        const int gy = inside ? y0 + py : clampi(y0 + py, 0, H - 1);
        const float* __restrict__ row = img + (size_t)gy * W;
        a[j] = __ldg(row + gx0);
        if (px1 < D) b[j] = __ldg(row + gx1);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int py = warp + j * WARPS;
      if (py < D) {
        patch[py * D + lane] = a[j];
        if (px1 < D) patch[py * D + px1] = b[j];
      }
    }
  }
  __syncthreads();

  // 2. moments: products patch * (mask * coord) of the 31x31 centre,
  // zero-padded to 1024 and summed by halving (s[i] += s[i + half], half =
  // 512 .. 1).  Thread t holds i = t + 256 j and sums halves 512 and 256
  // in registers; warp 0 sums 128, 64 and 32 across the 8 warps (lane l
  // from red[w][l]) and __shfl_down_sync does 16 .. 1.
  {
    // i = t + 256 j = 31 (yt + 8 j) + xt + 8 j: (y, x) step by (8, 8),
    // with a carry when x passes 30
    float2 p[4];
    const int yt = t / DP, xt = t - yt * DP;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = xt + 8 * j, c = x >= DP;
      p[j] = moment_products(patch, weights, t + 256 * j, yt + 8 * j + c,
                             x - DP * c);
    }
    red[warp][lane] = add2(add2(p[0], p[2]), add2(p[1], p[3]));
  }
  __syncthreads();

  if (warp == 0) {
    float2 m = add2(add2(add2(red[0][lane], red[4][lane]),
                         add2(red[2][lane], red[6][lane])),
                    add2(add2(red[1][lane], red[5][lane]),
                         add2(red[3][lane], red[7][lane])));
#pragma unroll
    for (int half = 16; half >= 1; half >>= 1) {
      m.x = __fadd_rn(m.x, __shfl_down_sync(0xffffffffu, m.x, half));
      m.y = __fadd_rn(m.y, __shfl_down_sync(0xffffffffu, m.y, half));
    }
    if (lane == 0) {
      const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(m.x, m.x),
                                           __fmul_rn(m.y, m.y)));
      cs[0] = r > 0.f ? __fdiv_rn(m.x, r) : 1.f;
      cs[1] = r > 0.f ? __fdiv_rn(m.y, r) : 0.f;
      angle[n] = atan2f(m.y, m.x);
    }
  } else {
    // 3. row blur (valid, 53 rows x 47 columns) in warps 1-7: thread j
    // takes row y and a segment of 12 columns, lanes on rows (a row stride
    // of 53 words keeps the lanes on distinct banks), and slides a window
    // of 7 registers along it: one shared-memory read an output.
    const int j = t - 32;
    if (j < D * NSEG) {
      const int s = j / D, y = j - s * D;
      const int nx = min(SEG, DB - s * SEG);
      const float* p = patch + y * D + s * SEG;
      float* h = hb + y * DB + s * SEG;
      float w0 = p[0], w1 = p[1], w2 = p[2], w3 = p[3], w4 = p[4],
            w5 = p[5];
#pragma unroll
      for (int x = 0; x < SEG; ++x) {
        if (x < nx) {
          const float w6 = p[x + 6];
          float acc = __fmul_rn(w0, taps.k[0]);
          acc = __fadd_rn(acc, __fmul_rn(w1, taps.k[1]));
          acc = __fadd_rn(acc, __fmul_rn(w2, taps.k[2]));
          acc = __fadd_rn(acc, __fmul_rn(w3, taps.k[3]));
          acc = __fadd_rn(acc, __fmul_rn(w4, taps.k[4]));
          acc = __fadd_rn(acc, __fmul_rn(w5, taps.k[5]));
          acc = __fadd_rn(acc, __fmul_rn(w6, taps.k[6]));
          h[x] = acc;
          w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; w5 = w6;
        }
      }
    }
  }
  __syncthreads();

  // 4. rotated BRIEF: thread b blurs and compares the two taps of pair b
  const float ca = cs[0], sa = cs[1];
  const int x1 = tap(__fsub_rn(__fmul_rn(ca, q.x), __fmul_rn(sa, q.y)));
  const int y1 = tap(__fadd_rn(__fmul_rn(sa, q.x), __fmul_rn(ca, q.y)));
  const int x2 = tap(__fsub_rn(__fmul_rn(ca, q.z), __fmul_rn(sa, q.w)));
  const int y2 = tap(__fadd_rn(__fmul_rn(sa, q.z), __fmul_rn(ca, q.w)));
  const bool bit = blur_col(hb, x1, y1, taps) < blur_col(hb, x2, y2, taps);
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) desc[n * 8 + warp] = (int)word;
}

}  // namespace

// One launch for n_levels entries (1 <= n_levels <= 32; the Python wrapper
// splits longer lists and answers an all-empty one without a launch).
// `table` is a host array of n_levels rows (image pointer, centers pointer,
// H, W, count) of 64-bit integers, H, W >= 1, sum of counts > 0; taps has 7
// entries; pattern is a device array of 256 x (x1, y1, x2, y2) f32,
// 16-byte aligned; weights a device array of 2 x 1024 f32, the moment
// weights mask * dx, then mask * dy, of the 961 disc-square positions in
// row-major order (entries from 961 on are not read).  Keypoint j of the
// launch (entries in order) writes angle[j] and desc[8 j .. 8 j + 7].
extern "C" int vs_tail_fused(const long long* table, int n_levels,
                             const float* taps, const float* pattern,
                             const float* weights, float* angle, int* desc,
                             void* stream) {
  Levels lv;
  const int total = vs::fill_levels(table, n_levels, &lv);
  if (total <= 0) return (int)cudaErrorInvalidValue;
  Taps k;
  for (int j = 0; j < 7; ++j) k.k[j] = taps[j];
  tail_fused_kernel<<<total, THREADS, 0, (cudaStream_t)stream>>>(
      lv, k, pattern, weights, angle, desc);
  return (int)cudaGetLastError();
}
