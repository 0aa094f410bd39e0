// The (level, image) table that kernels B2 and B5 take in one launch.
//
// One launch covers up to 32 entries: the pyramid levels of one image, or
// of the two images of a stereo pair.  Pointers, sizes and the prefix of
// per-entry keypoint counts travel by value in a kernel-parameter struct,
// so there is no stacked atlas, no padded copy and no table in device
// memory.  A block finds its entry from the prefix.

#pragma once

#include <cuda_runtime.h>

namespace vs {

constexpr int MAX_LEVELS = 32;    // (level, image) entries per launch

struct Levels {
  const float* img[MAX_LEVELS];   // [H, W] f32 level image
  const int* uv[MAX_LEVELS];      // [count, 2] int32 centers (x, y)
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int start[MAX_LEVELS + 1];      // first keypoint of each entry; [n] = total
  int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The entry that keypoint k (0 <= k < total) belongs to; empty entries are
// skipped because their start equals the next one's.
__device__ __forceinline__ int level_of(const Levels& lv, int k) {
  int l = 0;
  while (l + 1 < lv.n && k >= lv.start[l + 1]) ++l;
  return l;
}

// Fills `lv` from a host table of n_levels rows (image pointer, centers
// pointer, H, W, count) of 64-bit integers.  Returns the total count, or -1
// when n_levels is outside 1..32, an image is empty or a count is negative.
inline int fill_levels(const long long* table, int n_levels, Levels* lv) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
  long long total = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    static const long long off[5] = {0, 0, 0, 0, 0};
    const long long* row = l < n_levels ? table + 5 * l : off;
    if (l < n_levels && (row[2] < 1 || row[3] < 1 || row[4] < 0)) return -1;
    lv->img[l] = reinterpret_cast<const float*>(row[0]);
    lv->uv[l] = reinterpret_cast<const int*>(row[1]);
    lv->H[l] = (int)row[2];
    lv->W[l] = (int)row[3];
    lv->start[l] = (int)total;
    total += row[4];
    if (total > 0x7fffffffLL) return -1;
  }
  lv->start[MAX_LEVELS] = (int)total;
  lv->n = n_levels;
  return (int)total;
}

}  // namespace vs
