// Square patch gather around integer centers with edge clamping (B2), for
// all pyramid levels of all images of a frame in ONE launch.
//
// Replaces vieo_slam_tpu/ops/pallas_gather.py gather_patches_kernel
// (_kernel).  Bound on the H100: bytes -- each patch element is one f32
// read and one f32 write, no arithmetic; at 1200 keypoints a frame image
// the 13.5 MB of 53x53 patches written dominate.  Design:
//   - one launch: the (level, image) table of levels.cuh by value, a block
//     finds its entry from the prefix of counts, so the small top levels
//     and the second image of a stereo pair share the grid of the big
//     ones (the per-level launches of the first design left the card
//     mostly empty: level 7 has ~70 keypoints);
//   - one block of 8 warps per keypoint; a warp walks window rows, its
//     lanes on columns (two column slots cover d <= 64), so no index is
//     divided and every warp load and store is one contiguous run of a
//     row;
//   - all rows of a warp are loaded into registers before any is stored:
//     16 independent loads in flight per thread at d = 53;
//   - a window inside its image takes no clamp; one that crosses the edge
//     clamps each row and each column slot once (the clamp is folded into
//     the index, so no padded copy of the image is made -- the TPU kernel
//     needed an aligned, padded VMEM copy and one-hot selects).
// Exact f32: every output element is a copied input element.

#include "levels.cuh"

namespace {

using vs::clampi;
using vs::Levels;

constexpr int WARPS = 8;           // warps a block, one keypoint a block
constexpr int ROWS = 8;            // window rows a warp has in flight
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const Levels lv, float* __restrict__ out, int r) {
  const int k = blockIdx.x;
  const int l = vs::level_of(lv, k);
  const float* __restrict__ img = lv.img[l];
  const int H = lv.H[l], W = lv.W[l];
  const int* c = lv.uv[l] + 2 * (k - lv.start[l]);
  const int d = 2 * r + 1;
  const int x0 = clampi(c[0], 0, W - 1) - r;   // window origin in the image
  const int y0 = clampi(c[1], 0, H - 1) - r;
  const bool inside = x0 >= 0 && y0 >= 0 && x0 + d <= W && y0 + d <= H;
  float* __restrict__ o = out + (size_t)k * d * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int c0 = 0; c0 < d; c0 += 64) {
    const int px0 = c0 + lane, px1 = px0 + 32;
    const bool on0 = px0 < d, on1 = px1 < d;
    const int gx0 = inside ? x0 + px0 : clampi(x0 + px0, 0, W - 1);
    const int gx1 = inside ? x0 + px1 : clampi(x0 + px1, 0, W - 1);
    for (int r0 = warp; r0 < d; r0 += WARPS * ROWS) {
      float a[ROWS], b[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int py = r0 + j * WARPS;
        if (py < d) {
          const int gy = inside ? y0 + py : clampi(y0 + py, 0, H - 1);
          const float* __restrict__ row = img + (size_t)gy * W;
          if (on0) a[j] = __ldg(row + gx0);
          if (on1) b[j] = __ldg(row + gx1);
        }
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int py = r0 + j * WARPS;
        if (py < d) {
          if (on0) o[py * d + px0] = a[j];
          if (on1) o[py * d + px1] = b[j];
        }
      }
    }
  }
}

}  // namespace

// One launch for n_levels entries (1 <= n_levels <= 32; the Python wrapper
// splits longer lists and answers an all-empty one without a launch).
// `table` is a host array of n_levels rows (image pointer, centers pointer,
// H, W, count) of 64-bit integers, H, W >= 1, sum of counts > 0; the
// patches of entry l start at out + (2r+1)^2 * (sum of the counts before
// it).
extern "C" int vs_gather_patches_multi(const long long* table, int n_levels,
                                       float* out, int r, void* stream) {
  Levels lv;
  const int total = vs::fill_levels(table, n_levels, &lv);
  if (total <= 0 || r < 0) return (int)cudaErrorInvalidValue;
  gather_patches_kernel<<<total, THREADS, 0, (cudaStream_t)stream>>>(lv, out,
                                                                    r);
  return (int)cudaGetLastError();
}
