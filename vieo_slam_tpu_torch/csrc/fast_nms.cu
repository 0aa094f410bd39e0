// FAST-9/16 score at two thresholds + 3x3 NMS + threshold blend, one
// pyramid level per launch (B1).
//
// Replaces vieo_slam_tpu/ops/pallas_fast.py fast_nms_blend (_kernel).
// Bound on the H100: about 300 f32 operations per pixel against 8 bytes
// of device traffic, so operations, not bytes, are the limit.  Design:
// one thread per output pixel; a block stages its 32x8 output tile plus a
// 4-pixel edge-clamped halo (3 for the circle, 1 for the NMS) in shared
// memory once, computes both score maps on the tile plus a 1-pixel ring
// into shared memory, then does the NMS and blend from there.  Nothing
// but the input image and the output map touches device memory.
//
// Bit-exact to the plain PyTorch composition (ops/orb.py fast_score_maps
// + nms3 + blend): the 16 exceedance adds run in circle order, scores
// outside the image are zeroed before the NMS, the NMS keeps c >= max,
// and the boost is one f32 add.  There are no multiplies, so FMA
// contraction cannot change a result.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int P = 4;                 // 3 circle halo + 1 NMS halo
constexpr int LX = TX + 2 * P;       // staged image tile width
constexpr int LY = TY + 2 * P;
constexpr int SX = TX + 2;           // score tile incl. 1-pixel NMS ring
constexpr int SY = TY + 2;

__constant__ int kCX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__global__ void fast_nms_blend_kernel(const float* __restrict__ img,
                                      float* __restrict__ out, int H, int W,
                                      float th_hi, float th_lo, float boost) {
  __shared__ float tile[LY][LX];
  __shared__ float s_hi[SY][SX];
  __shared__ float s_lo[SY][SX];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  constexpr int NT = TX * TY;

  for (int i = tid; i < LY * LX; i += NT) {
    const int ty = i / LX, tx = i - (i / LX) * LX;
    const int gy = min(max(y0 + ty - P, 0), H - 1);
    const int gx = min(max(x0 + tx - P, 0), W - 1);
    tile[ty][tx] = img[gy * W + gx];
  }
  __syncthreads();

  for (int i = tid; i < SY * SX; i += NT) {
    const int sy = i / SX, sx = i - (i / SX) * SX;
    const int gy = y0 + sy - 1, gx = x0 + sx - 1;
    float hi = 0.f, lo = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int cy = sy + 3, cx = sx + 3;       // center in the image tile
      const float c = tile[cy][cx];
      int cb_hi = 0, cd_hi = 0, cb_lo = 0, cd_lo = 0, ok_hi = 0, ok_lo = 0;
      float sb_hi = 0.f, sd_hi = 0.f, sb_lo = 0.f, sd_lo = 0.f;
#pragma unroll
      for (int k = 0; k < 24; ++k) {
        const int j = k & 15;
        const float d = tile[cy + kCY[j]][cx + kCX[j]] - c;
        cb_hi = d > th_hi ? cb_hi + 1 : 0;
        cd_hi = d < -th_hi ? cd_hi + 1 : 0;
        cb_lo = d > th_lo ? cb_lo + 1 : 0;
        cd_lo = d < -th_lo ? cd_lo + 1 : 0;
        ok_hi = max(ok_hi, max(cb_hi, cd_hi));
        ok_lo = max(ok_lo, max(cb_lo, cd_lo));
        if (k < 16) {
          sb_hi += fmaxf(d - th_hi, 0.f);
          sd_hi += fmaxf(-d - th_hi, 0.f);
          sb_lo += fmaxf(d - th_lo, 0.f);
          sd_lo += fmaxf(-d - th_lo, 0.f);
        }
      }
      hi = ok_hi >= 9 ? fmaxf(sb_hi, sd_hi) : 0.f;
      lo = ok_lo >= 9 ? fmaxf(sb_lo, sd_lo) : 0.f;
    }
    s_hi[sy][sx] = hi;
    s_lo[sy][sx] = lo;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int sy = threadIdx.y + 1, sx = threadIdx.x + 1;
  float m_hi = s_hi[sy][sx], m_lo = s_lo[sy][sx];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      m_hi = fmaxf(m_hi, s_hi[sy + dy][sx + dx]);
      m_lo = fmaxf(m_lo, s_lo[sy + dy][sx + dx]);
    }
  const float c_hi = s_hi[sy][sx], c_lo = s_lo[sy][sx];
  const float n_hi = c_hi >= m_hi ? c_hi : 0.f;
  const float n_lo = c_lo >= m_lo ? c_lo : 0.f;
  out[y * W + x] = n_hi > 0.f ? n_hi + boost : n_lo;
}

}  // namespace

extern "C" int vs_fast_nms_blend(const float* img, float* out, int H, int W,
                                 float th_hi, float th_lo, float boost,
                                 void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  fast_nms_blend_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, out, H, W, th_hi, th_lo, boost);
  return (int)cudaGetLastError();
}
