// Kernel B3: FAST-9/16 arc margins of one pyramid level, batched.
//
// Replaces tpu_vo/ops/fast_pallas.py `fast_margin_pallas` (Pallas body
// `_margin_kernel`). Per pixel it computes the 16 circle differences
// d_k = v - c_k, the dark margin max_k min(d_k .. d_k+8) and the bright
// margin max_k min(-d_k .. -d_k+8) over the 16 nine-long circular arcs,
// margin = max(dark, bright), and writes
//
//   corner = margin > thr inside the 3-pixel border, else false,
//   score  = corner ? max(margin, thr) - 1 : 0,
//
// as f32 score and one byte of corner per pixel (the torch.bool layout).
// Its plain PyTorch version is features/fast.py `fast_score_map`; every
// step is a subtraction, min, max or negation of f32 values, each rounded
// alone, so the two agree bit for bit on finite f32 input.
//
// What bounds it on an H100: arithmetic and bytes about equally. Each
// pixel reads 4 bytes and writes 5 (~0.12 ms of HBM time for the 46.2 M
// pixels of 8 levels x 32 frames at 3.35 TB/s) and costs ~180 f32
// operations (~0.12 ms at 67 TFLOP/s). The TPU kernel built 16 rolled
// copies of the image in XLA (16x the bytes), cast to bf16 and padded to
// (96, 128) tiles; here one block per 32x32 output tile loads its 38x38
// haloed input once into shared memory (zero past the image edge: no
// interior pixel's circle reaches it), and one thread per pixel reads its
// 16 circle pixels from there. The arc minima share a tree
// (min2 -> min4 -> min8 -> min9), as in the TPU kernel. Batch and tiles
// are grid dimensions, so a level is one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 3;
constexpr int IMG = TILE + 2 * HALO;  // 38: input tile with halo
constexpr int NT = 256;               // threads per block

// Bresenham circle of radius 3 in OpenCV's makeOffsets order.
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

// max over the 16 circular arcs of the min of 9 consecutive values
__device__ __forceinline__ float arc_max_min(const float (&x)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(x[k], x[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m8[k] = fminf(m4[k], m4[(k + 4) & 15]);
  float out = fminf(m8[0], x[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) out = fmaxf(out, fminf(m8[k], x[(k + 8) & 15]));
  return out;
}

__global__ void __launch_bounds__(NT)
fast_margin_kernel(const float* __restrict__ img, float* __restrict__ score,
                   uint8_t* __restrict__ corner, int H, int W, float thr) {
  __shared__ float s_img[IMG][IMG];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  const float* src = img + (size_t)b * H * W;

  for (int i = tid; i < IMG * IMG; i += NT) {
    const int r = i / IMG, c = i - r * IMG;
    const int gy = r0 - HALO + r, gx = c0 - HALO + c;
    s_img[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? src[gy * W + gx] : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += NT) {
    const int r = i / TILE, c = i - r * TILE;
    const int gy = r0 + r, gx = c0 + c;
    if (gy >= H || gx >= W) continue;
    const bool inner = gy >= HALO && gy < H - HALO && gx >= HALO && gx < W - HALO;
    bool is_corner = false;
    float s = 0.f;
    if (inner) {
      const float v = s_img[r + HALO][c + HALO];
      float d[16], nd[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        d[k] = v - s_img[r + HALO + c_dy[k]][c + HALO + c_dx[k]];
        nd[k] = -d[k];
      }
      const float margin = fmaxf(arc_max_min(d), arc_max_min(nd));
      is_corner = margin > thr;
      if (is_corner) s = fmaxf(margin, thr) - 1.0f;
    }
    const size_t o = ((size_t)b * H + gy) * W + gx;
    score[o] = s;
    corner[o] = is_corner ? 1 : 0;
  }
}

}  // namespace

extern "C" int tvo_fast_margin(const void* img, void* score, void* corner, int B,
                               int H, int W, float thr, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  fast_margin_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)score, (uint8_t*)corner, H, W, thr);
  return (int)cudaGetLastError();
}
