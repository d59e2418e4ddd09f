// Kernel B1: fused keypoint selection for every pyramid level, batched,
// in one launch.
//
// Replaces tpu_vo/ops/select_pallas.py `fused_select_maps` (Pallas body
// `_select_kernel`). Per output pixel it computes FAST-9/16 arc margins,
// the strict 3x3 non-max suppression, the edgeThreshold border mask, the
// dense Harris response (3x3 Sobel, 7x7 box sums, k = 0.04, scale^4),
// the packed int32 key (score << idx_bits) | (mask - bitrev(flat_idx))
// and the vertical 2-row max of the keys. Its plain PyTorch version is
// ops/select.py `select_maps_reference`; the two agree bit for bit.
//
// What bounds it on an H100: issued instructions, not bytes. A 32-frame,
// 8-level pyramid is 185 MB of f32 in and 277 MB out (0.138 ms at 3.35
// TB/s). The first design spent about 304 lane-instructions per pixel on
// FAST alone: all 16 nine-long arcs, 8 mins and 8 maxes each, over a 34x34
// ring for each 32x32 tile, on every pixel of every level, at most one
// min/max per lane per clock. It ran in 8 launches (one per level, each
// ending in a partial wave) with 6 phases, 47,040 B of shared memory and 4
// blocks per SM, and loaded its tile one dependent load per row at a time.
// What this design does about it:
//
// - One launch for all levels: the grid is (tiles of all levels, B) and a
//   block finds its level in the __grid_constant__ level table
//   (levels.cuh). A tile wholly outside the border's rows or columns
//   writes zeros and computes nothing; FAST runs only on the border plus
//   its NMS ring.
// - Compass rejection: a nine-long arc of the 16-circle holds at least two
//   of the compass points {0, 4, 8, 12}, so a pixel with fewer than two of
//   them past thr on either side has margin <= thr: not a corner, score 0.
//   4 differences and 8 compares decide it. Each warp appends its
//   candidates (__ballot_sync, one shared atomic) to the block's list, and
//   the arc scan then runs on the list, 32 candidates to a warp: on the
//   main path's frames 25% of the pixels inside the border.
// - A cheaper exact arc scan for the candidates: for even k the arcs
//   starting at k and k + 1 share d[k+1 .. k+8], whose min comes from a
//   tree of pairwise mins (24 for all 8 k), and max over the two arcs =
//   min(m8, max(d[k], d[k+9])). 47 min/max per polarity, 94 for both (the
//   bright side as min over arcs of the max, negated), from 288. fminf and
//   fmaxf of finite values are exact in any order.
// - Counted per pixel, as lane-instructions (loads and index arithmetic
//   not counted): FAST before 16 + 288 = 304 on every pixel of a 34x34
//   ring per tile; now 4 differences + 8 compares + 4 to combine = 16 on
//   pixels of the border plus the NMS ring, and 12 differences + 94 min/max
//   + 2 = 108 more per candidate.
// - The tile comes in by cp.async, every copy issued before the first
//   wait. Sobel walks column strips with its 3x3 neighbourhood in
//   registers; a thread makes 8 horizontal box sums from 14 products in
//   registers; the last phase gives a thread 4 rows of one column (10
//   loads for 4 vertical sums per product), reads FAST scores made once
//   per pixel, and folds the 2-row max-pool (no key tile). Odd row strides
//   (39, 33) keep the strided phases free of bank conflicts.
// - 4 syncs, 40,928 B of static shared memory (the input tile shares its
//   memory with the box sums: it is dead by then); ptxas -v for sm_90a: 47
//   registers, no spills, so 5 blocks per SM.
//
// The Harris arithmetic keeps the plain version's order of operations, and
// the library is built with -fmad=false, so every sum and product rounds
// as the eager plain version's do.
//
// The kernel is a template on kHarris. The true instance is the design
// above. The false instance is the Pallas kernel's with_harris=False, kept
// for the A/B probe (tpu_vo_torch/tools/harris_candidate_probe) that asks
// what share of the kernel dense Harris takes: it skips the Sobel products
// (2b), the horizontal box sums (3) and the vertical sums and response of
// step 4, writes a zero Harris map (the border tiles' early-out as well),
// and gives the same packed keys bit for bit. Its shared memory is the
// input tile, the scores and the candidate list only (no s_p, and s_buf
// holds the 40x40 tile, not the box sums).

#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"

namespace {

using tvo::LevelTable;

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int IMG = TILE + 2 * HALO;  // 40: input tile with halo
constexpr int SC = TILE + 2;          // 34: FAST margins, tile + NMS ring
constexpr int GR = TILE + 6;          // 38: Sobel products, tile + box ring
constexpr int PS = GR + 1;            // 39: s_p's odd row stride, no bank conflicts
constexpr int HS = TILE + 1;          // 33: the box sums' row stride, the same
constexpr int SOBEL_ROWS = 10;        // rows of a Sobel column strip
constexpr int SOBEL_STRIPS = (GR + SOBEL_ROWS - 1) / SOBEL_ROWS;  // 4
constexpr int HSEG = 8;               // box sums per thread in phase 3
constexpr int NT = 256;               // threads per block
constexpr int QROWS = TILE / (NT / 32);  // 4 output rows per thread in phase 4
constexpr int MIN_BLOCKS = 5;         // blocks per SM asked of ptxas
constexpr unsigned FULL = 0xffffffffu;

// Offset in the input tile of FAST circle point j (radius-3 Bresenham
// circle in OpenCV's makeOffsets order); j is a constant after unrolling.
__device__ __forceinline__ int circle(int j) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  return dy[j] * IMG + dx[j];
}

// max over the 16 nine-long arcs of min(d over the arc) when Min is true
// (the dark margin); min over the arcs of max(d) otherwise (minus the
// bright margin). For even k the arcs at k and k + 1 share m8 = d[k+1 ..
// k+8]; the better of the two is m8 against the better of d[k], d[k+9].
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

template <bool kHarris>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
select_kernel(const __grid_constant__ LevelTable t, float thr, int border, float k,
              float scale4) {
  __shared__ float s_score[SC][SC];              // FAST score, 0 off corners
  __shared__ float s_p[kHarris ? 3 : 1][kHarris ? GR : 1][kHarris ? PS : 1];  // Ix*Ix, Iy*Iy, Ix*Iy
  __shared__ float s_buf[kHarris ? 3 * GR * HS : IMG * IMG];  // input tile, then box sums
  __shared__ bool s_corner[SC][SC];
  __shared__ short s_cand[SC * SC];              // the compass candidates' indices
  __shared__ int s_ncand;
  float(*s_img)[IMG] = reinterpret_cast<float(*)[IMG]>(s_buf);
  float(*s_h)[GR][HS] = reinterpret_cast<float(*)[GR][HS]>(s_buf);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lv = tvo::level_of(t, blockIdx.x);
  const int H = t.H[lv], W = t.W[lv], Hp2 = t.Hp2[lv], Wout = t.Wout[lv];
  const int tiles_x = (Wout + TILE - 1) / TILE;
  const int tile = blockIdx.x - t.first[lv];
  const int r0 = (tile / tiles_x) * TILE;
  const int c0 = (tile % tiles_x) * TILE;
  const int b = blockIdx.y;
  int* packed = t.packed[lv] + (size_t)b * Hp2 * Wout;
  float* harris = t.harris[lv] + (size_t)b * H * W;

  // A tile outside the border's rows or columns has only zero outputs.
  if (r0 + TILE <= border || r0 >= H - border || c0 + TILE <= border || c0 >= W - border) {
    for (int i = tid; i < TILE * TILE; i += NT) {
      const int gy = r0 + (i >> 5), gx = c0 + (i & 31);
      if (gy < H && gx < W) harris[(size_t)gy * W + gx] = 0.f;
      if ((i >> 5) < TILE / 2 && r0 / 2 + (i >> 5) < Hp2 && gx < Wout)
        packed[(size_t)(r0 / 2 + (i >> 5)) * Wout + gx] = 0;
    }
    return;
  }

  // 1. haloed input tile by asynchronous copies, all issued before the
  //    first wait; zero past the image edge (a copy of 0 source bytes)
  {
    const float* src = t.img[lv] + (size_t)b * H * W;
    const uint32_t s_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_buf));
#pragma unroll
    for (int i = tid; i < IMG * IMG; i += NT) {
      const int r = i / IMG, c = i - r * IMG;
      const int gy = r0 - HALO + r, gx = c0 - HALO + c;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* g = ok ? src + (size_t)gy * W + gx : src;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s_addr + 4u * i), "l"(g),
                   "r"(ok ? 4 : 0)
                   : "memory");
    }
    if (tid == 0) s_ncand = 0;
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __syncthreads();

  // 2a. The compass test on the tile plus its NMS ring, where a kept pixel
  //     can read FAST scores: rows and columns [border - 1, dim - border].
  //     Every score starts at 0; each warp appends its candidates to the
  //     block's list (the trip count is the same for every thread, so
  //     whole warps vote).
  const int ylo = border - 1 - (r0 - 1), yhi = H - border - (r0 - 1);
  const int xlo = border - 1 - (c0 - 1), xhi = W - border - (c0 - 1);
#pragma unroll 1
  for (int base = 0; base < SC * SC; base += NT) {
    const int i = base + tid;
    const int r = i / SC, c = i - r * SC;
    const bool need = i < SC * SC && r >= ylo && r <= yhi && c >= xlo && c <= xhi;
    bool cand = false;
    if (need) {
      const float* p = &s_img[r + HALO - 1][c + HALO - 1];
      const float v = p[0];
      const float d0 = v - p[circle(0)], d4 = v - p[circle(4)];
      const float d8 = v - p[circle(8)], d12 = v - p[circle(12)];
      const int dark = (d0 > thr) + (d4 > thr) + (d8 > thr) + (d12 > thr);
      const int bright = (-d0 > thr) + (-d4 > thr) + (-d8 > thr) + (-d12 > thr);
      cand = dark >= 2 || bright >= 2;
    }
    const unsigned vote = __ballot_sync(FULL, cand);
    if (vote != 0u) {
      int slot = 0;
      if (lane == 0) slot = atomicAdd(&s_ncand, __popc(vote));
      slot = __shfl_sync(FULL, slot, 0) + __popc(vote & ((1u << lane) - 1u));
      if (cand) s_cand[slot] = (short)i;
    }
    if (i < SC * SC) {
      s_score[r][c] = 0.f;
      s_corner[r][c] = false;
    }
  }

  // 2b. Sobel products on the tile plus a 3-pixel ring, in the plain
  //     version's order of operations; a thread walks down a column strip
  //     of SOBEL_ROWS rows with its 3x3 neighbourhood in registers
  if constexpr (kHarris) {
#pragma unroll 1
    for (int i = tid; i < GR * SOBEL_STRIPS; i += NT) {
      const int x = i % GR, ra = (i / GR) * SOBEL_ROWS, rb = min(ra + SOBEL_ROWS, GR);
      float a0 = s_img[ra][x], a1 = s_img[ra][x + 1], a2 = s_img[ra][x + 2];
      float b0 = s_img[ra + 1][x], b1 = s_img[ra + 1][x + 1], b2 = s_img[ra + 1][x + 2];
#pragma unroll 2
      for (int r = ra; r < rb; ++r) {
        const float e0 = s_img[r + 2][x], e1 = s_img[r + 2][x + 1], e2 = s_img[r + 2][x + 2];
        const float ix = ((b2 - b0) * 2.0f + (a2 - a0)) + (e2 - e0);
        const float iy = ((e1 - a1) * 2.0f + (e0 - a0)) + (e2 - a2);
        s_p[0][r][x] = ix * ix;
        s_p[1][r][x] = iy * iy;
        s_p[2][r][x] = ix * iy;
        a0 = b0, a1 = b1, a2 = b2;
        b0 = e0, b1 = e1, b2 = e2;
      }
    }
  }
  __syncthreads();

  // 2c. FAST scores and corner flags of the candidates, 32 to a warp
#pragma unroll 1
  for (int j = tid; j < s_ncand; j += NT) {
    const int i = s_cand[j];
    const int r = i / SC, c = i - r * SC;
    const float* p = &s_img[r + HALO - 1][c + HALO - 1];
    float d[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) d[q] = p[0] - p[circle(q)];
    const float m = fmaxf(arc_extreme<true>(d), -arc_extreme<false>(d));
    s_score[r][c] = m > thr ? fmaxf(m, thr) - 1.0f : 0.f;
    s_corner[r][c] = m > thr;
  }
  __syncthreads();

  // 3. horizontal 7-tap box sums, (acc + x[c+d]) + x[c-d], d = 1..3, into
  //    the input tile's memory; a thread makes HSEG sums of one row from
  //    HSEG + 6 products in registers
  if constexpr (kHarris) {
#pragma unroll 1
    for (int i = tid; i < GR * (TILE / HSEG); i += NT) {
      const int r = i / (TILE / HSEG), cs = (i % (TILE / HSEG)) * HSEG;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float x[HSEG + 6];
#pragma unroll
        for (int j = 0; j < HSEG + 6; ++j) x[j] = s_p[q][r][cs + j];
#pragma unroll
        for (int o = 0; o < HSEG; ++o) {
          float acc = x[o + 3];
#pragma unroll
          for (int d = 1; d <= 3; ++d) acc = (acc + x[o + 3 + d]) + x[o + 3 - d];
          s_h[q][r][cs + o] = acc;
        }
      }
    }
    __syncthreads();
  }

  // 4. per thread a column of QROWS rows: vertical box sums, Harris, NMS,
  //    border, the packed keys and their 2-row max
  const uint32_t mask = (1u << t.idx_bits[lv]) - 1u;
  const int bits = t.idx_bits[lv];
  const int c = lane, r = warp * QROWS, gx = c0 + c;
  float s3[QROWS][3];
  if constexpr (kHarris) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float col[QROWS + 6];
#pragma unroll
      for (int j = 0; j < QROWS + 6; ++j) col[j] = s_h[q][r + j][c];
#pragma unroll
      for (int h = 0; h < QROWS; ++h) {
        float o = col[3 + h];
#pragma unroll
        for (int d = 1; d <= 3; ++d) o = (o + col[3 + h + d]) + col[3 + h - d];
        s3[h][q] = o;
      }
    }
  }
  int key2 = 0;
#pragma unroll
  for (int h = 0; h < QROWS; ++h) {
    const int gy = r0 + r + h;
    float resp = 0.f;
    if constexpr (kHarris) {
      const float a = s3[h][0], bb = s3[h][1], cc = s3[h][2];
      resp = (a * bb - cc * cc - k * (a + bb) * (a + bb)) * scale4;
    }
    const bool inb = gy >= border && gy < H - border && gx >= border && gx < W - border;
    if (gy < H && gx < W) harris[(size_t)gy * W + gx] = inb ? resp : 0.f;
    float nmax = -1e30f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (i != 1 || j != 1) nmax = fmaxf(nmax, s_score[r + h + i][c + j]);
    const float score = s_score[r + h + 1][c + 1];
    if (s_corner[r + h + 1][c + 1] && score > nmax && inb) {
      const uint32_t flat = (uint32_t)gy * (uint32_t)W + (uint32_t)gx;
      const uint32_t rev = __brev(flat) >> (32 - bits);
      key2 = max(key2, (int)(((uint32_t)score << bits) | (mask - rev)));
    }
    if (h & 1) {
      const int gy2 = (r0 + r + h) / 2;
      if (gy2 < Hp2 && gx < Wout) packed[(size_t)gy2 * Wout + gx] = key2;
      key2 = 0;
    }
  }
}

}  // namespace

// The table's tile offsets are filled in here, from H and Wout; with_harris
// 0 launches the instance without Harris (a zero Harris map).
extern "C" int tvo_select_maps_levels(LevelTable t, int B, float thr, int border, float k,
                                      float scale4, int with_harris, void* stream) {
  t.total = 0;
  for (int l = 0; l < t.n; ++l) {
    t.first[l] = t.total;
    t.total += ((t.H[l] + TILE - 1) / TILE) * ((t.Wout[l] + TILE - 1) / TILE);
  }
  const dim3 grid(t.total, B);
  if (with_harris)
    select_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(t, thr, border, k, scale4);
  else
    select_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(t, thr, border, k, scale4);
  return (int)cudaGetLastError();
}

// Registers per thread of one instance (into *regs) and its blocks per SM
// on the current device; -1 on an error.
extern "C" int tvo_select_maps_occupancy(int with_harris, int* regs) {
  const void* fn = with_harris ? (const void*)select_kernel<true> : (const void*)select_kernel<false>;
  cudaFuncAttributes attr;
  int blocks = 0;
  if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, 0) != cudaSuccess)
    return -1;
  *regs = attr.numRegs;
  return blocks;
}
