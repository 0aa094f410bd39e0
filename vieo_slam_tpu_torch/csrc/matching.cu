// Masked Hamming distance + per-row best/second/argbest + per-column best
// row (B3), and the same with the projection-search mask built in the
// kernel (B4).
//
// Replaces vieo_slam_tpu/ops/pallas_matching.py fused_best2 (_kernel) and
// fused_projection_best2 (_proj_kernel).
//
// What bounds them on the H100.  B4 reads O(M + N) bytes and tests every
// (row, column) cell against the pixel window and the level gate (about 11
// f32 operations a cell); only the cells that pass -- a fraction of a
// percent on a tracking slab -- pay the 8 XOR + 8 popcount of a Hamming
// distance.  So B4 is bound by the window operations, at a few
// microseconds, which is the order of one launch.  B3 reads one mask byte
// per cell, and those M x N bytes are its bound.
//
// Design (one entry point = a fill launch, the main launch and a finishing
// launch, all enqueued by the same C call):
//   - one warp per row, 16 rows a block: the warp keeps the row's 8
//     descriptor words and (u, v, r^2, level) in registers and walks the
//     columns 128 a step, four consecutive columns a lane.  Register tiles
//     of 2 and 4 rows a thread were measured and were slower (a thread's
//     candidates serialize, and the slowest warp sets the kernel's time);
//     blocks of 4 and 8 warps were slower too (more blocks stage the
//     column side);
//   - the column side is staged once per block in dynamic shared memory:
//     the descriptors as they lie in device memory (32 bytes a column, a
//     straight 16-byte copy), and for B4 (u, v, level-or-NaN for an invalid
//     column) as three plain arrays read back as conflict-free float4s.
//     That is 48 bytes a column, 61 KB at 1200 columns (above 48 KB, so the
//     launch raises cudaFuncAttributeMaxDynamicSharedMemorySize); columns
//     are tiled by 2048, so their number is not limited.  The copy is a
//     few plain loads a thread against thousands of operations, so there
//     is nothing for cp.async or a double buffer to hide.  B3 reads its
//     mask four columns a 32-bit load;
//   - a masked cell makes no atomic and runs no popcount: the lane packs
//     the four cells' tests into a bit mask and only walks the set bits
//     (one rolled loop, so the rare path stays small in the instruction
//     cache).  The column best row is still a reduction across blocks:
//     each candidate cell is packed into one key (dist << 22) | row, so an
//     integer min orders by distance and then by the lowest row.  A
//     candidate makes one shared-memory atomicMin, and the block flushes
//     the columns it touched with one global atomicMin each.  The fill
//     launch sets every column key to (511 << 22) | 0, which is what an
//     empty column must resolve to, and the finishing launch strips the
//     keys to their row, so there is no PyTorch operation after the
//     kernel.  Letting the last block to finish strip them (threadfence +
//     a counter) saves the third launch but was measured slower: every
//     block pays the fence, the atomic and a barrier, 0.0005-0.0012 ms of
//     kernel time, and a wrapper call took no less;
//   - rows are complete inside one block (no split over columns), so the
//     (best, argbest, second) triples need no merge across blocks: lanes
//     merge by shuffles with ties to the lowest column;
//   - every load of a row's or a column's metadata is unconditional, so
//     that they are in flight together: the kernel is a chain of a few
//     device-memory round trips, and each one saved is half a microsecond;
//   - B4's window test rounds each multiply and add on its own
//     (__fmul_rn / __fadd_rn), so no FMA moves the window boundary relative
//     to the plain version; r^2 is computed once per row.
//
// Tensor cores: the Hamming part could run as a 1-bit mma (m16n8k256
// and.popc, d = |a| + |b| - 2 popc(a & b), exact in integers), but that
// computes all M x N distances.  At the tracking shape (4096 x 1200) that
// is 4.9 M distances of which some ten thousand are candidates.  What is
// computed for every cell is the window test, f32 compare work the tensor
// cores do not do, and what the candidates cost is not popcount arithmetic
// (a few hundred thousand instructions) but the latency of the slowest
// warp's serial candidates.  So the mma route was not taken.
//
// No [M, N] distance matrix exists outside registers.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int INF_D = 1 << 30;
constexpr int ROW_BITS = 22;
constexpr int ROW_MASK = (1 << ROW_BITS) - 1;
constexpr int KEY_EMPTY = 511 << ROW_BITS;     // no candidate: row 0
constexpr int WARPS = 16;                       // rows per block
constexpr int THREADS = WARPS * 32;
constexpr int CPL = 4;                          // columns per lane per step
constexpr int STEP = 32 * CPL;                  // columns per warp per step
constexpr int TILE = 2048;                      // most columns per shared tile
constexpr int COL_BYTES = 32 + 4 + 12;          // shared bytes per column
constexpr unsigned FULL = 0xffffffffu;

// The projection side, as the caller's tensors come.
struct Proj {
  const float* uv_a;                // [M, 2]
  const float* radius_a;            // [M]
  const int* level_a;               // [M]
  const unsigned char* valid_a;     // [M] bool
  const float* uv_b;                // [N, 2]
  const int* level_b;               // [N]
  const unsigned char* valid_b;     // [N] bool
  float tol;
};

__device__ __forceinline__ void merge(int& b, int& bi, int& s, int ob, int obi,
                                      int os) {
  if (ob < b || (ob == b && obi < bi)) {
    s = min(os, b);
    b = ob;
    bi = obi;
  } else {
    s = min(s, ob);
  }
}

__device__ __forceinline__ int hamming8(const int (&a)[8], const int4* b) {
  const int4 lo = b[0], hi = b[1];
  return ((__popc(a[0] ^ lo.x) + __popc(a[1] ^ lo.y)) +
          (__popc(a[2] ^ lo.z) + __popc(a[3] ^ lo.w))) +
         ((__popc(a[4] ^ hi.x) + __popc(a[5] ^ hi.y)) +
          (__popc(a[6] ^ hi.z) + __popc(a[7] ^ hi.w)));
}

__global__ void best2_fill_kernel(int* __restrict__ colkey, int N) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < N) colkey[j] = KEY_EMPTY;
}

__global__ void best2_finish_kernel(int* __restrict__ colkey, int N) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < N) colkey[j] &= ROW_MASK;
}

template <bool PROJ>
__global__ void __launch_bounds__(THREADS)
best2_kernel(const int* __restrict__ A, const int* __restrict__ B,
             const unsigned char* __restrict__ mask, const Proj p, int M,
             int N, int tile, int mask_words, int* __restrict__ idx,
             int* __restrict__ best, int* __restrict__ second,
             int* __restrict__ colkey) {
  // tile columns of: descriptors [tile][8], keys [tile] and, for B4,
  // u [tile], v [tile], level [tile].
  extern __shared__ int4 smem[];
  int4* sB = smem;
  int* skey = reinterpret_cast<int*>(sB + 2 * tile);
  float* su = reinterpret_cast<float*>(skey + tile);
  float* sv = su + tile;
  float* sl = sv + tile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.x * WARPS + warp;
  const bool live = row < M;

  // The warp's row: descriptor and (u, v, r^2, level).  Every load is
  // unconditional, so that they are all in flight at once.
  int a[8];
  {
    const int4* ap = reinterpret_cast<const int4*>(A + (size_t)(live ? row : 0) * 8);
    const int4 lo = __ldg(ap), hi = __ldg(ap + 1);
    a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
    a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
  }
  float qu = 0.f, qv = 0.f, ql = 0.f;
  float qr2 = -1.f;                 // a sum of squares is never <= -1
  if (PROJ) {
    const int r0 = live ? row : 0;
    qu = p.uv_a[2 * r0];
    qv = p.uv_a[2 * r0 + 1];
    ql = (float)p.level_a[r0];
    const float rad = p.radius_a[r0];
    if (live && p.valid_a[r0] && rad >= 0.f) qr2 = __fmul_rn(rad, rad);
  }
  int b = INF_D, bi = INT32_MAX, s = INF_D;

  for (int t0 = 0; t0 < N; t0 += tile) {
    const int nt = min(tile, N - t0);
    const int ntp = (nt + STEP - 1) / STEP * STEP;
    __syncthreads();                // the previous tile's flush has read skey
    const int4* Bt = reinterpret_cast<const int4*>(B) + 2 * (size_t)t0;
    for (int i = tid; i < 2 * nt; i += THREADS) sB[i] = __ldg(Bt + i);
    for (int j = tid; j < ntp; j += THREADS) {
      skey[j] = KEY_EMPTY;
      if (PROJ) {
        const int g = min(t0 + j, N - 1);
        const float u = p.uv_b[2 * g], v = p.uv_b[2 * g + 1];
        const float lvl = (float)p.level_b[g];
        const bool on = p.valid_b[g] && j < nt;
        su[j] = u;
        sv[j] = v;
        // an invalid or padding column fails the level gate
        sl[j] = on ? lvl : CUDART_NAN_F;
      }
    }
    __syncthreads();

    for (int c0 = lane * CPL; c0 < ntp; c0 += STEP) {
      unsigned ok = 0;
      if (PROJ) {
        const float4 u4 = *reinterpret_cast<const float4*>(su + c0);
        const float4 v4 = *reinterpret_cast<const float4*>(sv + c0);
        const float4 l4 = *reinterpret_cast<const float4*>(sl + c0);
        const float cu[CPL] = {u4.x, u4.y, u4.z, u4.w};
        const float cv[CPL] = {v4.x, v4.y, v4.z, v4.w};
        const float cl[CPL] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const float du = qu - cu[c], dv = qv - cv[c];
          const bool within =
              __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= qr2;
          const bool lvl_ok = fabsf(ql - cl[c]) <= p.tol;
          ok |= (unsigned)(within && lvl_ok) << c;
        }
      } else if (live && c0 < nt) {
        const unsigned char* mp = mask + (size_t)row * N + t0 + c0;
        unsigned w = 0;
        if (mask_words) {           // N % 4 == 0 and the base is aligned
          w = __ldg(reinterpret_cast<const unsigned*>(mp));
        } else {
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            if (c0 + c < nt) w |= (unsigned)__ldg(mp + c) << (8 * c);
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          ok |= (unsigned)(((w >> (8 * c)) & 0xffu) != 0) << c;
      }
      // The rare path, one rolled loop so that it stays small in the
      // instruction cache.
#pragma unroll 1
      for (; ok; ok &= ok - 1) {
        const int c = c0 + __ffs(ok) - 1;
        const int j = t0 + c;
        const int d = hamming8(a, sB + 2 * c);
        if (d < b || (d == b && j < bi)) {
          s = b;
          b = d;
          bi = j;
        } else if (d < s) {
          s = d;
        }
        atomicMin(&skey[c], (d << ROW_BITS) | row);
      }
    }
    __syncthreads();
    for (int j = tid; j < nt; j += THREADS) {
      const int k = skey[j];
      if (k != KEY_EMPTY) atomicMin(&colkey[t0 + j], k);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(FULL, b, off);
    const int obi = __shfl_down_sync(FULL, bi, off);
    const int os = __shfl_down_sync(FULL, s, off);
    merge(b, bi, s, ob, obi, os);
  }
  if (lane == 0 && live) {
    idx[row] = b == INF_D ? 0 : bi;
    best[row] = b;
    second[row] = s;
  }
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

// out: 3 M + N ints -- idx [M], best [M], second [M], column best row [N].
// M, N > 0: the Python wrappers answer empty
// inputs without a launch.
template <bool PROJ>
int launch(const int* A, const int* B, const unsigned char* mask,
           const Proj& p, int M, int N, int* out, void* stream) {
  if (M <= 0 || N <= 0 || M > ROW_MASK + 1) return (int)cudaErrorInvalidValue;
  if (!aligned(A, 16) || !aligned(B, 16))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  int* colkey = out + 3 * (size_t)M;
  best2_fill_kernel<<<(N + 255) / 256, 256, 0, st>>>(colkey, N);
  const int mask_words = !PROJ && N % 4 == 0 && aligned(mask, 4);
  const int tile = min(TILE, (N + STEP - 1) / STEP * STEP);
  if (tile * COL_BYTES > 48 * 1024)     // more is opt-in, per device
    cudaFuncSetAttribute(best2_kernel<PROJ>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         TILE * COL_BYTES);
  best2_kernel<PROJ><<<(M + WARPS - 1) / WARPS, THREADS, tile * COL_BYTES,
                       st>>>(A, B, mask, p, M, N, tile, mask_words, out,
                             out + M, out + 2 * (size_t)M, colkey);
  best2_finish_kernel<<<(N + 255) / 256, 256, 0, st>>>(colkey, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vs_fused_best2(const int* A, const int* B,
                              const unsigned char* mask, int M, int N,
                              int* out, void* stream) {
  return launch<false>(A, B, mask, Proj{}, M, N, out, stream);
}

extern "C" int vs_fused_projection_best2(
    const int* A, const int* B, const float* uv_a, const float* radius_a,
    const int* level_a, const unsigned char* valid_a, const float* uv_b,
    const int* level_b, const unsigned char* valid_b, float tol, int M, int N,
    int* out, void* stream) {
  const Proj p{uv_a, radius_a, level_a, valid_a, uv_b, level_b, valid_b, tol};
  return launch<true>(A, B, nullptr, p, M, N, out, stream);
}
