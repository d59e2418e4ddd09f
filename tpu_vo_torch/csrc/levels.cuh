// The pyramid-level table that kernels B1 (select.cu), B2 (patch.cu) and
// B3 (fast.cu) take by value, so that one launch covers every level of a
// pyramid; and the SM count that the persistent grids of patch_probe.cu
// and describe.cu are sized from.
//
// The C entry points receive it as a plain struct (ctypes.Structure
// `ops/levels.LevelTable`, same field order) and hand it to the kernel as
// a __grid_constant__ parameter: no host-to-device copy, no sync. A block
// finds its level by scanning the <= 8 prefix offsets in `first`.

#pragma once

#include <cuda_runtime.h>

namespace tvo {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_DEVICES = 16;  // devices whose launch queries are kept

struct LevelTable {
  int n;                            // levels in use
  int total;                        // B1: tiles of all levels; B2: slots of a frame
  const float* img[MAX_LEVELS];     // (B, H, W) f32 level, contiguous
  int* packed[MAX_LEVELS];          // B1 out: (B, Hp2, Wout) int32
  float* harris[MAX_LEVELS];        // B1 out: (B, H, W) f32
  int H[MAX_LEVELS], W[MAX_LEVELS];
  int Hp2[MAX_LEVELS], Wout[MAX_LEVELS];  // B1: ceil(H / 2), W + W % 2
  int idx_bits[MAX_LEVELS];               // B1: bit_length(H * W - 1)
  int first[MAX_LEVELS];  // B1: the level's first tile (set by the launcher); B2: its first slot;
                          // B3: its first block (set by the launcher)
  float* score[MAX_LEVELS];           // B3 out: (B, H, W) f32
  unsigned char* corner[MAX_LEVELS];  // B3 out: (B, H, W) bool
};

// The level whose [first[l], first[l + 1]) range holds i.
__device__ __forceinline__ int level_of(const LevelTable& t, int i) {
  int l = 0;
#pragma unroll
  for (int j = 1; j < MAX_LEVELS; ++j)
    if (j < t.n && t.first[j] <= i) l = j;
  return l;
}

// SMs of the current device, or -1 on an error; asked once a process and
// device.
inline int sm_count() {
  static int known[MAX_DEVICES];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < MAX_DEVICES && known[dev]) return known[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (dev < MAX_DEVICES) known[dev] = n;
  return n;
}

}  // namespace tvo
