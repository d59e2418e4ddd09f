// Kernel B2: per-keypoint 43x43 window extraction, batched over frames.
//
// Replaces tpu_vo/ops/patch_pallas.py `extract_patches_pallas` (Pallas
// body `_extract_kernel`). Window n of frame b starts at
// clip(y - 21, 0, H' - 43), clip(x - 21, 0, W' - 43) of the level
// zero-padded to H' = max(H, 43), W' = max(W, 43), exactly like the
// plain version ops/patch.py `extract_patches_reference`.
//
// What bounds it on an H100: bytes. It is a pure copy with no arithmetic:
// 7.4 KB written per keypoint, 8.9 MB per frame of 1200 keypoints and
// 284 MB for a 32-frame batch, ~85 us at 3.35 TB/s. The TPU kernel's phase-shifted copies and
// (48, 128) aligned bands existed to satisfy DMA tiling; here one block
// per keypoint reads its rows straight from global memory with
// neighbouring threads on neighbouring columns (coalesced within a row),
// and the 1.9 MB level stays in the 50 MB L2 across the keypoints that
// share it.

#include <cuda_runtime.h>

namespace {

constexpr int R = 21;
constexpr int S = 2 * R + 1;  // 43
constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
extract_kernel(const float* __restrict__ img, const int* __restrict__ ys,
               const int* __restrict__ xs, float* __restrict__ out, int H,
               int W, int N) {
  const int n = blockIdx.x, b = blockIdx.y;
  const int y = ys[b * N + n], x = xs[b * N + n];
  const int y0 = min(max(y - R, 0), max(H, S) - S);
  const int x0 = min(max(x - R, 0), max(W, S) - S);
  const float* src = img + (size_t)b * H * W;
  float* dst = out + ((size_t)b * N + n) * S * S;
  for (int i = threadIdx.x; i < S * S; i += NT) {
    const int r = i / S, c = i - r * S;
    const int gy = y0 + r, gx = x0 + c;
    dst[i] = (gy < H && gx < W) ? src[(size_t)gy * W + gx] : 0.f;
  }
}

}  // namespace

extern "C" int tvo_extract_patches(const void* img, const void* ys,
                                   const void* xs, void* out, int B, int H,
                                   int W, int N, void* stream) {
  const dim3 grid(N, B);
  extract_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const int*)ys, (const int*)xs, (float*)out, H, W, N);
  return (int)cudaGetLastError();
}
