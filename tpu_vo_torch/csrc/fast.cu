// Kernel B3: FAST-9/16 arc margins of every pyramid level, batched, in
// one launch.
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
// What bounds it on an H100: bytes. Each pixel reads 4 bytes and writes 5:
// 0.124 ms at 3.35 TB/s for the 46.2 M pixels of 8 levels x 32 frames.
// Counted as lane-instructions (one min, max, add or compare per lane per
// clock), the work below is 16 per interior pixel and 108 more per compass
// candidate, under the bytes on the main path's levels. The first port
// spent 8 launches (one per level, each with its wrapper's host work and
// its partial last wave), computed every pixel's 16 differences and both
// full arc trees (about 180 operations), loaded its tile by scalar reads
// with a division per element and stored one value per thread. This
// design:
//
// - One launch for all levels and frames: a flat block index runs over
//   levels x frames x tiles, and a block finds its level in the
//   __grid_constant__ level table (levels.cuh; the launcher fills in the
//   first block of each level).
// - Compass rejection, as in kernel B1 (select.cu): a nine-long arc of the
//   16-circle holds at least two of the compass points {0, 4, 8, 12}, so a
//   pixel with fewer than two of them past thr on either side (d > thr or
//   -d > thr; d > thr is what margin > thr needs on the arc) has margin <=
//   thr: not a corner, score 0. 4 differences and 8 compares decide it.
//   Each warp appends its candidates (__ballot_sync, one shared atomic) to
//   the block's list, and B1's exact cut-down arc scan (47 min/max per
//   polarity instead of 144) runs on the list, 32 candidates to a warp.
// - The haloed (70, 70) tile of a 64 x 64 output tile comes in by 4-B
//   cp.async, every copy issued before one wait; the loop walks rows by
//   warp and columns by lane, with no division. Past the level's edge a
//   copy of 0 source bytes writes 0 (no interior pixel's circle reaches
//   it).
// - Scores and corners are staged in shared memory and leave row by row,
//   a warp a row, each lane a 4-B score and a 1-B corner of consecutive
//   pixels: 128 B and 32 B a store instruction. A tile row starts at any
//   4-B boundary of the output (W is odd on most levels), so 16-B stores
//   of each row (elements one by one up to its first 16-B boundary and
//   after its last) took more instructions and more time
//   (tools/fast_ablation), and so did 32 x 64 tiles (more halo, more
//   blocks).
// - 48,276 B of static shared memory and 55 registers (ptxas -v, sm_90a):
//   4 blocks of 256 threads per SM.
//
// A pipelined persistent form (each block walking tiles, the next tile's
// input in flight while it computes) was slower than one tile a block:
// four blocks a SM already overlap one block's loads with another's
// compute.

#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"

namespace {

using tvo::LevelTable;

constexpr int TH = 64;                // tile rows
constexpr int TW = 64;                // tile columns
constexpr int HALO = 3;
constexpr int IH = TH + 2 * HALO;     // 70: input tile rows with halo
constexpr int IW = TW + 2 * HALO;     // 70: input tile columns with halo
constexpr int NT = 256;               // threads per block
constexpr int NWARPS = NT / 32;
constexpr int PIX = TH * TW;          // 4096 output pixels per tile
constexpr unsigned FULL = 0xffffffffu;

// Offset in the input tile of FAST circle point j (radius-3 Bresenham
// circle in OpenCV's makeOffsets order); j is a constant after unrolling.
__device__ __forceinline__ int circle(int j) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  return dy[j] * IW + dx[j];
}

// max over the 16 nine-long arcs of min(d over the arc) when Min is true
// (the dark margin); min over the arcs of max(d) otherwise (minus the
// bright margin). For even k the arcs at k and k + 1 share m8 = d[k+1 ..
// k+8]; the better of the two is m8 against the better of d[k], d[k+9].
// (select.cu's arc_extreme.)
template <bool Min>
__device__ __forceinline__ float arc_extreme(const float (&d)[16]) {
  auto in = [](float a, float b) { return Min ? fminf(a, b) : fmaxf(a, b); };
  auto out = [](float a, float b) { return Min ? fmaxf(a, b) : fminf(a, b); };
  float q[8], r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = in(d[2 * i + 1], d[(2 * i + 2) & 15]);  // d[2i+1 .. 2i+2]
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = in(q[i], q[(i + 1) & 7]);             // d[2i+1 .. 2i+4]
  float best = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float m8 = in(r[i], r[(i + 2) & 7]);                              // d[2i+1 .. 2i+8]
    const float u = in(m8, out(d[2 * i], d[(2 * i + 9) & 15]));
    best = i == 0 ? u : out(best, u);
  }
  return best;
}

__global__ void __launch_bounds__(NT)
fast_margin_kernel(const __grid_constant__ LevelTable t, float thr) {
  __shared__ float s_img[IH * IW];
  __shared__ float s_score[PIX];
  __shared__ uint8_t s_corner[PIX];
  __shared__ short s_cand[PIX];
  __shared__ int s_ncand;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lv = tvo::level_of(t, blockIdx.x);
  const int H = t.H[lv], W = t.W[lv];
  const int tiles_x = (W + TW - 1) / TW, tiles = tiles_x * ((H + TH - 1) / TH);
  const int i = blockIdx.x - t.first[lv];
  const int b = i / tiles, tile = i - b * tiles;
  const int r0 = (tile / tiles_x) * TH;
  const int c0 = (tile - (tile / tiles_x) * tiles_x) * TW;
  const size_t frame = (size_t)b * H * W;

  // 1. the haloed input tile by asynchronous copies, all issued before
  //    the wait; 0 past the level's edge (a copy of 0 source bytes)
  {
    const float* src = t.img[lv] + frame;
    const uint32_t s_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_img));
    for (int r = warp; r < IH; r += NWARPS) {
      const int gy = r0 - HALO + r;
      const bool row_ok = gy >= 0 && gy < H;
#pragma unroll
      for (int c = lane; c < IW; c += 32) {
        const int gx = c0 - HALO + c;
        const bool ok = row_ok && gx >= 0 && gx < W;
        const float* g = ok ? src + (size_t)gy * W + gx : src;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s_addr + 4u * (r * IW + c)),
                     "l"(g), "r"(ok ? 4 : 0)
                     : "memory");
      }
    }
    if (tid == 0) s_ncand = 0;
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __syncthreads();

  // 2. the compass test on the interior pixels; every score and corner
  //    starts at 0, and each warp appends its candidates to the block's
  //    list (the trip count is the same for every thread, so whole warps
  //    vote)
  for (int base = 0; base < PIX; base += NT) {
    const int p = base + tid;
    const int r = p / TW, c = p % TW;  // TW is a power of two: a shift and a mask
    const int gy = r0 + r, gx = c0 + c;
    bool cand = false;
    if (gy >= HALO && gy < H - HALO && gx >= HALO && gx < W - HALO) {
      const float* q = &s_img[(r + HALO) * IW + c + HALO];
      const float v = q[0];
      const float d0 = v - q[circle(0)], d4 = v - q[circle(4)];
      const float d8 = v - q[circle(8)], d12 = v - q[circle(12)];
      const int dark = (d0 > thr) + (d4 > thr) + (d8 > thr) + (d12 > thr);
      const int bright = (-d0 > thr) + (-d4 > thr) + (-d8 > thr) + (-d12 > thr);
      cand = dark >= 2 || bright >= 2;
    }
    const unsigned vote = __ballot_sync(FULL, cand);
    if (vote != 0u) {
      int slot = 0;
      if (lane == 0) slot = atomicAdd(&s_ncand, __popc(vote));
      slot = __shfl_sync(FULL, slot, 0) + __popc(vote & ((1u << lane) - 1u));
      if (cand) s_cand[slot] = (short)p;
    }
    s_score[p] = 0.f;
    s_corner[p] = 0;
  }
  __syncthreads();

  // 3. the exact arc scan of the candidates, 32 to a warp
  const int ncand = s_ncand;
  for (int j = tid; j < ncand; j += NT) {
    const int p = s_cand[j];
    const float* q = &s_img[(p / TW + HALO) * IW + p % TW + HALO];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = q[0] - q[circle(k)];
    const float m = fmaxf(arc_extreme<true>(d), -arc_extreme<false>(d));
    if (m > thr) {
      s_score[p] = fmaxf(m, thr) - 1.0f;
      s_corner[p] = 1;
    }
  }
  __syncthreads();

  // 4. the outputs, a warp a tile row, a lane a pixel
  const int n = min(TW, W - c0);
  for (int r = warp; r < TH && r0 + r < H; r += NWARPS) {
    float* score = t.score[lv] + frame + (size_t)(r0 + r) * W + c0;
    uint8_t* corner = t.corner[lv] + frame + (size_t)(r0 + r) * W + c0;
    for (int c = lane; c < n; c += 32) {
      score[c] = s_score[r * TW + c];
      corner[c] = s_corner[r * TW + c];
    }
  }
}

}  // namespace

// The table's block offsets are filled in here: level l's blocks are its
// frames x tiles, frame-major.
extern "C" int tvo_fast_margin_levels(LevelTable t, int B, float thr, void* stream) {
  t.total = 0;
  for (int l = 0; l < t.n; ++l) {
    t.first[l] = t.total;
    t.total += B * ((t.H[l] + TH - 1) / TH) * ((t.W[l] + TW - 1) / TW);
  }
  if (t.total == 0) return 0;
  fast_margin_kernel<<<t.total, NT, 0, (cudaStream_t)stream>>>(t, thr);
  return (int)cudaGetLastError();
}

// Registers per thread of the kernel (into *regs) and its blocks per SM on
// the current device; -1 on an error.
extern "C" int tvo_fast_margin_occupancy(int* regs) {
  cudaFuncAttributes attr;
  int blocks = 0;
  if (cudaFuncGetAttributes(&attr, fast_margin_kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fast_margin_kernel, NT, 0) !=
          cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  return blocks;
}
