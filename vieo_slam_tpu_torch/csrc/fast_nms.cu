// FAST-9/16 score at two thresholds + 3x3 NMS + threshold blend for all
// pyramid levels of all images of a frame in ONE launch (B1).
//
// Replaces vieo_slam_tpu/ops/pallas_fast.py fast_nms_blend (_kernel).
// Bound on the H100: 8 bytes of device traffic per pixel.  The full test
// and the sums at both thresholds are some 400 f32 operations, but only
// about one pixel in ten needs more than the 4-tap reject (about 20), so
// the operations that the data asks for stay below the bytes.  Design:
//   - one launch: the per-level image pointers, sizes and a prefix of tile
//     counts travel by value in a kernel-parameter struct (up to 32
//     levels); a block finds its level from the prefix.  The small top
//     levels fill the tail of the big ones instead of each being a launch
//     that cannot fill the card;
//   - a block of 256 threads computes a 32x32 tile of scores, of which the
//     inner 30x30 are its outputs and the 1-pixel ring feeds the NMS (14 %
//     more scores than outputs).  1024 scores are exactly four rounds of
//     the block, so no lane idles in a round, and a warp is one score row,
//     so every tap is a conflict-free shared-memory read;
//   - test first, score second, and both only where they can matter.
//     Pass 1 runs a 4-tap reject on every pixel: any 9 consecutive circle
//     positions hold at least two of the compass taps 0, 4, 8, 12, so a
//     corner at either threshold has two compass taps brighter, or two
//     darker, than the lower threshold.  The survivors are compacted into
//     a list in shared memory (one ballot and one atomic a warp).  Pass 2
//     walks the list with every lane busy: the 16-bit brighter and darker
//     masks, a run of 9 by and-rotate doubling on the word, and the
//     exceedance sums only where a test passes.  Pass 3 walks the list
//     again for the 3x3 NMS and the blend of the pixels that have a
//     score; pass 4 copies the result tile out, coalesced.  The cost of
//     the expensive parts follows the number of corner candidates, not the
//     number of warps that hold one;
//   - the taps are literal offsets (no index tables), so every read is a
//     shared-memory load with an immediate offset;
//   - staging is plain coalesced loads into shared memory with the edge
//     clamp folded into the index.  TMA tensor tiles are not the tool: their
//     out-of-bounds fill is zero where the circle needs the edge-clamped
//     value, and a tensor map per level would have to be encoded on the
//     host on every call.
//
// Bit-exact to the plain PyTorch composition (ops/cuda_fast.py
// fast_nms_blend_plain): the 16 exceedance adds run in circle order from
// 0, scores outside the image are zeroed before the NMS, the NMS keeps
// c >= max, and the boost is one f32 add.  There are no multiplies, so FMA
// contraction cannot change a result.

#include <cuda_runtime.h>

namespace {

constexpr int ST = 32;               // score tile side
constexpr int OT = ST - 2;           // outputs per tile side
constexpr int P = 4;                 // 3 circle halo + 1 NMS halo
constexpr int LT = OT + 2 * P;       // staged image tile side (38)
constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 32;       // (level, image) entries per launch

struct Levels {
  const float* img[MAX_LEVELS];
  float* out[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];
  int start[MAX_LEVELS + 1];         // first tile of each entry; [n] = total
  int n;
};

// The Bresenham circle of radius 3, clockwise from 12 o'clock: F(k, dx, dy).
#define FAST_TAPS(F)                                                        \
  F(0, 0, -3) F(1, 1, -3) F(2, 2, -2) F(3, 3, -1) F(4, 3, 0) F(5, 3, 1)     \
  F(6, 2, 2) F(7, 1, 3) F(8, 0, 3) F(9, -1, 3) F(10, -2, 2) F(11, -3, 1)    \
  F(12, -3, 0) F(13, -3, -1) F(14, -2, -2) F(15, -1, -3)

// Any run of >= 9 consecutive set bits among 16 circular positions.
__device__ __forceinline__ bool arc9(unsigned m) {
  const unsigned x = m | (m << 16);
  unsigned r = x & (x >> 1);
  r &= r >> 2;
  r &= r >> 4;
  r &= x >> 8;
  return (r & 0xffffu) != 0;
}

__device__ __forceinline__ bool is_corner(const float (&d)[16], float th) {
  unsigned above = 0, below = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    above |= (unsigned)(d[k] > th) << k;
    below |= (unsigned)(d[k] < -th) << k;
  }
  return arc9(above) || arc9(below);
}

__device__ __forceinline__ float exceedance(const float (&d)[16], float th) {
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    sb += fmaxf(d[k] - th, 0.f);
    sd += fmaxf(-d[k] - th, 0.f);
  }
  return fmaxf(sb, sd);
}

// The 16 circle differences around score-tile pixel i.
__device__ __forceinline__ void circle(const float* tile, int i,
                                       float (&d)[16]) {
  const float* ctr = tile + ((i >> 5) + 3) * LT + (i & 31) + 3;
  const float c = *ctr;
#define TAP(k, dx, dy) d[k] = ctr[(dy) * LT + (dx)] - c;
  FAST_TAPS(TAP)
#undef TAP
}

__global__ void __launch_bounds__(THREADS)
fast_nms_blend_kernel(const Levels lv, float th_hi, float th_lo, float boost) {
  __shared__ float tile[LT * LT];
  __shared__ float s_hi[ST * ST];
  __shared__ float s_lo[ST * ST];
  __shared__ float res[ST * ST];
  __shared__ unsigned short list[ST * ST];
  __shared__ int n_list;

  const int tid = threadIdx.x, lane = tid & 31;
  int l = 0;
  while (l + 1 < lv.n && (int)blockIdx.x >= lv.start[l + 1]) ++l;
  const float* __restrict__ img = lv.img[l];
  const int H = lv.H[l], W = lv.W[l];
  const int t = blockIdx.x - lv.start[l];
  const int x0 = (t % lv.tiles_x[l]) * OT;     // first output pixel
  const int y0 = (t / lv.tiles_x[l]) * OT;

  if (tid == 0) n_list = 0;
  for (int i = tid; i < LT * LT; i += THREADS) {
    const int ty = i / LT, tx = i - ty * LT;
    const int gy = min(max(y0 + ty - P, 0), H - 1);
    const int gx = min(max(x0 + tx - P, 0), W - 1);
    tile[i] = img[(size_t)gy * W + gx];
  }
  __syncthreads();

  // Pass 1: the compass reject for the 32x32 score tile (origin one pixel
  // above and left of the outputs).  ST * ST is a multiple of THREADS, so
  // whole warps take every round.
  const float th_min = fminf(th_hi, th_lo);
  for (int i = tid; i < ST * ST; i += THREADS) {
    const int gy = y0 + (i >> 5) - 1, gx = x0 + (i & 31) - 1;
    s_hi[i] = 0.f;
    s_lo[i] = 0.f;
    res[i] = 0.f;
    bool keep = false;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* ctr = tile + ((i >> 5) + 3) * LT + (i & 31) + 3;
      const float c = *ctr;
      const float d0 = ctr[-3 * LT] - c, d4 = ctr[3] - c;
      const float d8 = ctr[3 * LT] - c, d12 = ctr[-3] - c;
      const int above = (d0 > th_min) + (d4 > th_min) + (d8 > th_min) +
                        (d12 > th_min);
      const int below = (d0 < -th_min) + (d4 < -th_min) + (d8 < -th_min) +
                        (d12 < -th_min);
      keep = above >= 2 || below >= 2;
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (m) {
      const int first = __ffs(m) - 1;
      int base = 0;
      if (lane == first) base = atomicAdd(&n_list, __popc(m));
      base = __shfl_sync(0xffffffffu, base, first);
      if (keep)
        list[base + __popc(m & ((1u << lane) - 1))] = (unsigned short)i;
    }
  }
  __syncthreads();

  // Pass 2: the full test and the scores of the listed pixels.
  const int n = n_list;
#pragma unroll 1
  for (int k = tid; k < n; k += THREADS) {
    const int i = list[k];
    float d[16];
    circle(tile, i, d);
    if (is_corner(d, th_lo)) s_lo[i] = exceedance(d, th_lo);
    if (is_corner(d, th_hi)) s_hi[i] = exceedance(d, th_hi);
  }
  __syncthreads();

  // Pass 3: 3x3 NMS on both maps and the blend, for the listed pixels of
  // the inner 30x30 that have a score (any other output is 0).
#pragma unroll 1
  for (int k = tid; k < n; k += THREADS) {
    const int i = list[k];
    const int sy = i >> 5, sx = i & 31;
    const float c_hi = s_hi[i], c_lo = s_lo[i];
    if (sy < 1 || sy > OT || sx < 1 || sx > OT || (c_hi == 0.f && c_lo == 0.f))
      continue;
    float m_hi = c_hi, m_lo = c_lo;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        m_hi = fmaxf(m_hi, s_hi[i + dy * ST + dx]);
        m_lo = fmaxf(m_lo, s_lo[i + dy * ST + dx]);
      }
    const float n_hi = c_hi >= m_hi ? c_hi : 0.f;
    const float n_lo = c_lo >= m_lo ? c_lo : 0.f;
    res[i] = n_hi > 0.f ? n_hi + boost : n_lo;
  }
  __syncthreads();

  // Pass 4: the 30x30 outputs, one row of the tile a warp.
  float* __restrict__ out = lv.out[l];
  for (int i = tid; i < ST * ST; i += THREADS) {
    const int sy = i >> 5, sx = i & 31;
    const int x = x0 + sx - 1, y = y0 + sy - 1;
    if (sy >= 1 && sy <= OT && sx >= 1 && sx <= OT && x < W && y < H)
      out[(size_t)y * W + x] = res[i];
  }
}

}  // namespace

// One launch for n_levels images (1 <= n_levels <= 32; the Python wrapper
// splits longer lists).  `table` is a host array of n_levels rows
// (image pointer, H, W) of 64-bit integers, H, W >= 1; the score map of
// entry l is written at out + sum of H * W of the entries before it.
extern "C" int vs_fast_nms_blend_multi(const long long* table, int n_levels,
                                       float* out, float th_hi, float th_lo,
                                       float boost, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  int tiles = 0;
  size_t px = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool on = l < n_levels;
    const int H = on ? (int)table[3 * l + 1] : 0;
    const int W = on ? (int)table[3 * l + 2] : 0;
    if (on && (H < 1 || W < 1)) return (int)cudaErrorInvalidValue;
    lv.img[l] = on ? reinterpret_cast<const float*>(table[3 * l]) : nullptr;
    lv.out[l] = on ? out + px : nullptr;
    lv.H[l] = H;
    lv.W[l] = W;
    lv.tiles_x[l] = (W + OT - 1) / OT;
    lv.start[l] = tiles;
    tiles += lv.tiles_x[l] * ((H + OT - 1) / OT);
    px += (size_t)H * W;
  }
  lv.start[MAX_LEVELS] = tiles;
  lv.n = n_levels;
  fast_nms_blend_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
      lv, th_hi, th_lo, boost);
  return (int)cudaGetLastError();
}
