// Kernel B1: fused keypoint selection for one pyramid level, batched.
//
// Replaces tpu_vo/ops/select_pallas.py `fused_select_maps` (Pallas body
// `_select_kernel`). Per output pixel it computes FAST-9/16 arc margins,
// the strict 3x3 non-max suppression, the edgeThreshold border mask, the
// dense Harris response (3x3 Sobel, 7x7 box sums, k = 0.04, scale^4),
// the packed int32 key (score << idx_bits) | (mask - bitrev(flat_idx))
// and the vertical 2-row max of the keys. Its plain PyTorch version is
// ops/select.py `select_maps_reference`; the two agree bit for bit.
//
// What bounds it on an H100: arithmetic, not bytes. A 1241x376 level is
// 1.9 MB of f32 in and ~2.8 MB out, under a microsecond of HBM time at
// 3.35 TB/s, while each pixel costs ~300 flops of FAST min/max trees and
// ~60 of Sobel/box/Harris. So every intermediate (scores, gradients,
// box sums, keys) stays in shared memory and registers: one block per
// 32x32 output tile loads its 40x40 haloed input once (4-pixel halo:
// FAST radius 3 + NMS 1, Sobel 1 + box 3), zero-filled past the image
// edge (only pixels inside the >= 4-pixel border can be kept, and none of
// them reads past the edge). Batch and tiles are grid dimensions, so a
// 32-frame level is one launch. The library is built with -fmad=false so
// the Harris sums and products round exactly like the eager plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int IMG = TILE + 2 * HALO;  // 40: input tile with halo
constexpr int SC = TILE + 2;          // 34: FAST margins, tile + NMS ring
constexpr int GR = TILE + 6;          // 38: Sobel products, tile + box ring
constexpr int NT = 256;               // threads per block

// Bresenham circle of radius 3 in OpenCV's makeOffsets order.
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

__global__ void __launch_bounds__(NT)
select_kernel(const float* __restrict__ img, int* __restrict__ packed,
              float* __restrict__ harris, int H, int W, int Hp2, int Wout,
              float thr, int border, int idx_bits, float k, float scale4) {
  __shared__ float s_img[IMG][IMG];
  __shared__ float s_margin[SC][SC];
  __shared__ float s_p[3][GR][GR];      // Ix*Ix, Iy*Iy, Ix*Iy
  __shared__ float s_h[3][GR][TILE];    // horizontal box sums
  __shared__ int s_key[TILE][TILE];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  const float* src = img + (size_t)b * H * W;

  // 1. haloed input tile, zero past the image edge
  for (int i = tid; i < IMG * IMG; i += NT) {
    const int r = i / IMG, c = i - r * IMG;
    const int gy = r0 - HALO + r, gx = c0 - HALO + c;
    s_img[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? src[gy * W + gx] : 0.f;
  }
  __syncthreads();

  // 2. FAST-9/16 margins on the tile plus a 1-pixel ring; margin =
  //    max(best dark arc, best bright arc). Integer-valued, exact.
  for (int i = tid; i < SC * SC; i += NT) {
    const int r = i / SC, c = i - r * SC;
    const int cy = r + HALO - 1, cx = c + HALO - 1;
    const float v = s_img[cy][cx];
    float d[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) d[j] = v - s_img[cy + c_dy[j]][cx + c_dx[j]];
    float dark = -1e30f, bright = -1e30f;
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      float mn = d[a], mx = d[a];
#pragma unroll
      for (int j = 1; j < 9; ++j) {
        mn = fminf(mn, d[(a + j) & 15]);
        mx = fmaxf(mx, d[(a + j) & 15]);
      }
      dark = fmaxf(dark, mn);
      bright = fmaxf(bright, -mx);
    }
    s_margin[r][c] = fmaxf(dark, bright);
  }

  // 3. Sobel products on the tile plus a 3-pixel ring, in the plain
  //    version's order of operations
  for (int i = tid; i < GR * GR; i += NT) {
    const int r = i / GR, c = i - r * GR;
    const int y = r + HALO - 3, x = c + HALO - 3;
    const float ix = ((s_img[y][x + 1] - s_img[y][x - 1]) * 2.0f
                      + (s_img[y - 1][x + 1] - s_img[y - 1][x - 1]))
                     + (s_img[y + 1][x + 1] - s_img[y + 1][x - 1]);
    const float iy = ((s_img[y + 1][x] - s_img[y - 1][x]) * 2.0f
                      + (s_img[y + 1][x - 1] - s_img[y - 1][x - 1]))
                     + (s_img[y + 1][x + 1] - s_img[y - 1][x + 1]);
    s_p[0][r][c] = ix * ix;
    s_p[1][r][c] = iy * iy;
    s_p[2][r][c] = ix * iy;
  }
  __syncthreads();

  // 4. horizontal 7-tap box sums: (acc + x[c+d]) + x[c-d], d = 1..3
  for (int i = tid; i < 3 * GR * TILE; i += NT) {
    const int q = i / (GR * TILE);
    const int rem = i - q * GR * TILE;
    const int r = rem / TILE, c = rem - r * TILE + 3;
    float acc = s_p[q][r][c];
#pragma unroll
    for (int d = 1; d <= 3; ++d) acc = (acc + s_p[q][r][c + d]) + s_p[q][r][c - d];
    s_h[q][r][c - 3] = acc;
  }
  __syncthreads();

  // 5. vertical box sums, Harris, NMS, border and the packed key
  const uint32_t mask = (1u << idx_bits) - 1u;
  for (int i = tid; i < TILE * TILE; i += NT) {
    const int r = i / TILE, c = i - r * TILE;
    const int gy = r0 + r, gx = c0 + c;
    float s3[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float out = s_h[q][r + 3][c];
#pragma unroll
      for (int d = 1; d <= 3; ++d) out = (out + s_h[q][r + 3 + d][c]) + s_h[q][r + 3 - d][c];
      s3[q] = out;
    }
    const float a = s3[0], bb = s3[1], cc = s3[2];
    const float resp = (a * bb - cc * cc - k * (a + bb) * (a + bb)) * scale4;
    const bool inb = gy >= border && gy < H - border && gx >= border && gx < W - border;
    if (gy < H && gx < W) harris[((size_t)b * H + gy) * W + gx] = inb ? resp : 0.f;

    const float m = s_margin[r + 1][c + 1];
    const bool corner = m > thr;
    const float score = corner ? fmaxf(m, thr) - 1.0f : 0.f;
    float nmax = -1e30f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dx == 0 && dy == 0) continue;
        const float mn = s_margin[r + 1 + dy][c + 1 + dx];
        nmax = fmaxf(nmax, mn > thr ? fmaxf(mn, thr) - 1.0f : 0.f);
      }
    int key = 0;
    if (corner && score > nmax && inb) {
      const uint32_t flat = (uint32_t)gy * (uint32_t)W + (uint32_t)gx;
      const uint32_t rev = __brev(flat) >> (32 - idx_bits);
      key = (int)(((uint32_t)score << idx_bits) | (mask - rev));
    }
    s_key[r][c] = key;
  }
  __syncthreads();

  // 6. vertical 2-row max-pool of the keys
  for (int i = tid; i < (TILE / 2) * TILE; i += NT) {
    const int pr = i / TILE, c = i - pr * TILE;
    const int gy2 = r0 / 2 + pr, gx = c0 + c;
    if (gy2 < Hp2 && gx < Wout)
      packed[((size_t)b * Hp2 + gy2) * Wout + gx] = max(s_key[2 * pr][c], s_key[2 * pr + 1][c]);
  }
}

}  // namespace

extern "C" int tvo_select_maps(const void* img, void* packed, void* harris, int B,
                               int H, int W, int Hp2, int Wout, float thr,
                               int border, int idx_bits, float k, float scale4,
                               void* stream) {
  const dim3 grid((Wout + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  select_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)img, (int*)packed, (float*)harris, H, W, Hp2, Wout, thr,
      border, idx_bits, k, scale4);
  return (int)cudaGetLastError();
}
