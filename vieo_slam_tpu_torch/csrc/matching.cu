// Masked Hamming distance + per-row best/second/argbest + per-column best
// row (B3), and the same with the projection-search mask built in the
// kernel (B4).
//
// Replaces vieo_slam_tpu/ops/pallas_matching.py fused_best2 (_kernel) and
// fused_projection_best2 (_proj_kernel).  Bound on the H100: operations --
// 8 XOR + 8 popcount + 8 add per descriptor pair against a few bytes per
// pair (the B3 mask byte; B4 reads only O(M + N) bytes).  Design:
//   - one warp per row, lanes strided over the columns, each lane keeping
//     a (best, argbest, second) triple in registers, merged across the warp
//     with shuffles; ties go to the lowest column index;
//   - the column best row is a reduction across blocks, which the TPU
//     carried across sequential grid steps and the GPU cannot.  Each
//     (row, column) cell is packed into one 32-bit key
//     (min(dist, 511) << 22) | row, so an integer atomicMin orders by
//     distance, then by lowest row -- the TPU's strict-< tile combine.  A
//     masked cell counts as 511, so a column with no candidate resolves to
//     row 0 as argmin does.  A block reduces its rows into shared memory
//     first and issues one global atomicMin per column;
//   - B4 computes du*du + dv*dv <= r*r with explicitly rounded multiplies
//     and adds so no FMA moves the window boundary relative to the plain
//     version.
// No [M, N] distance matrix exists outside registers.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int INF_D = 1 << 30;
constexpr int WARPS = 8;
constexpr int ROWS_PER_BLOCK = 32;
constexpr unsigned FULL = 0xffffffffu;

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

template <bool PROJ>
__global__ void best2_kernel(const int* __restrict__ A,
                             const int* __restrict__ B,
                             const unsigned char* __restrict__ mask,
                             const float4* __restrict__ am,
                             const float4* __restrict__ bm, float tol, int M,
                             int N, int* __restrict__ idx,
                             int* __restrict__ best, int* __restrict__ second,
                             int* __restrict__ colkey) {
  extern __shared__ int skey[];
  const int tid = threadIdx.x;
  for (int j = tid; j < N; j += blockDim.x) skey[j] = INT_MAX;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * ROWS_PER_BLOCK;
  for (int rr = warp; rr < ROWS_PER_BLOCK; rr += WARPS) {
    const int row = row0 + rr;
    if (row >= M) break;
    int a[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = __ldg(A + row * 8 + w);
    float4 q = make_float4(0.f, 0.f, -1.f, 0.f);
    if (PROJ) q = am[row];
    int b = INF_D, bi = INT_MAX, s = INF_D;
    for (int j = lane; j < N; j += 32) {
      bool ok;
      if (PROJ) {
        const float4 c = bm[j];
        const float du = q.x - c.x, dv = q.y - c.y;
        const bool within =
            __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= __fmul_rn(q.z, q.z);
        const bool lvl_ok = fabsf(q.w - c.z) <= tol;
        ok = within && lvl_ok && (q.z >= 0.f) && (c.w > 0.f);
      } else {
        ok = mask[(size_t)row * N + j] != 0;
      }
      int d = INF_D;
      if (ok) {
        d = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) d += __popc(a[w] ^ __ldg(B + j * 8 + w));
      }
      if (d < b || (d == b && j < bi)) {
        s = b;
        b = d;
        bi = j;
      } else if (d < s) {
        s = d;
      }
      atomicMin(&skey[j], (min(d, 511) << 22) | row);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_down_sync(FULL, b, off);
      const int obi = __shfl_down_sync(FULL, bi, off);
      const int os = __shfl_down_sync(FULL, s, off);
      merge(b, bi, s, ob, obi, os);
    }
    if (lane == 0) {
      idx[row] = bi;
      best[row] = b;
      second[row] = s;
    }
  }
  __syncthreads();
  for (int j = tid; j < N; j += blockDim.x) atomicMin(&colkey[j], skey[j]);
}

// M, N > 0: the Python wrappers answer empty inputs without a launch.
template <bool PROJ>
int launch(const int* A, const int* B, const unsigned char* mask,
           const float4* am, const float4* bm, float tol, int M, int N,
           int* idx, int* best, int* second, int* colkey, void* stream) {
  const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  best2_kernel<PROJ><<<blocks, WARPS * 32, N * sizeof(int),
                       (cudaStream_t)stream>>>(A, B, mask, am, bm, tol, M, N,
                                               idx, best, second, colkey);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vs_fused_best2(const int* A, const int* B,
                              const unsigned char* mask, int M, int N,
                              int* idx, int* best, int* second, int* colkey,
                              void* stream) {
  return launch<false>(A, B, mask, nullptr, nullptr, 0.f, M, N, idx, best,
                       second, colkey, stream);
}

extern "C" int vs_fused_projection_best2(const int* A, const int* B,
                                         const float* am, const float* bm,
                                         float tol, int M, int N, int* idx,
                                         int* best, int* second, int* colkey,
                                         void* stream) {
  return launch<true>(A, B, nullptr, reinterpret_cast<const float4*>(am),
                      reinterpret_cast<const float4*>(bm), tol, M, N, idx,
                      best, second, colkey, stream);
}
