// Square patch gather around integer centers with edge clamping (B2).
//
// Replaces vieo_slam_tpu/ops/pallas_gather.py gather_patches_kernel
// (_kernel).  Bound on the H100: bytes -- each patch element is one f32
// read and one f32 write, no arithmetic.  Design: one block per keypoint;
// its threads walk the d*d patch in row-major order, so neighbouring
// threads read neighbouring image pixels and write neighbouring output
// words.  The edge clamp is folded into the index arithmetic, so no
// padded copy of the image is made (the TPU kernel needed an aligned,
// padded VMEM copy and one-hot selects).  Exact f32: every output element
// is a copied input element.

#include <cuda_runtime.h>

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ img,
                                      const int* __restrict__ centers,
                                      float* __restrict__ out, int H, int W,
                                      int r) {
  const int n = blockIdx.x;
  const int d = 2 * r + 1;
  const int cx = min(max(centers[2 * n], 0), W - 1);
  const int cy = min(max(centers[2 * n + 1], 0), H - 1);
  float* o = out + (size_t)n * d * d;
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
    const int py = i / d, px = i - (i / d) * d;
    const int y = min(max(cy + py - r, 0), H - 1);
    const int x = min(max(cx + px - r, 0), W - 1);
    o[i] = img[y * W + x];
  }
}

}  // namespace

// N > 0: the Python wrapper answers an empty center list without a launch.
extern "C" int vs_gather_patches(const float* img, const int* centers,
                                 float* out, int H, int W, int N, int r,
                                 void* stream) {
  gather_patches_kernel<<<N, 256, 0, (cudaStream_t)stream>>>(img, centers,
                                                             out, H, W, r);
  return (int)cudaGetLastError();
}
