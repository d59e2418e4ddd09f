// Kernel B2: per-keypoint 43x43 window extraction for every pyramid
// level's slots, batched over frames, in one launch.
//
// Replaces tpu_vo/ops/patch_pallas.py `extract_patches_pallas` (Pallas
// body `_extract_kernel`). Slot n of frame b belongs to the level whose
// range of the level table (levels.cuh) holds n; its window starts at
// clip(y - 21, 0, H' - 43), clip(x - 21, 0, W' - 43) of that level
// zero-padded to H' = max(H, 43), W' = max(W, 43), exactly like the plain
// version ops/patch.py `extract_patches_reference`.
//
// What bounds it on an H100: bytes. It is a copy with no arithmetic: 7,396
// B written per slot, 284 MB for 32 frames of 1200 slots, 85 us at 3.35
// TB/s; the windows' level pixels come mostly from L2. The first design
// gave each window a 128-thread block: 38,400 blocks a run, each thread
// about 15 dependent load -> store pairs, so few bytes were in flight per
// SM (0.8 TB/s written), in 8 launches. This one:
//
// - One launch for all levels: the grid covers the B x N slots of the
//   concatenated slot order that detect_and_compute uses, and each window
//   finds its level in the __grid_constant__ table.
// - Four consecutive windows per block, staged in shared memory: 4 x 7,396
//   B = 29,584 B, a multiple of 16, and so is its offset in the output.
//   Each thread issues all of its 29 element copies (cp.async, 4 B each,
//   coalesced along a window row) before it waits for any, so about 7,400
//   are in flight per block without holding registers (32 registers, 7
//   blocks per SM; the same loads through registers took 80 registers and
//   3 blocks per SM). Then the block writes the span with one
//   cp.async.bulk shared -> global store (the TMA unit's non-tensor copy).
//   The last block, with fewer than 4 windows, stores its elements one by
//   one.
// - The loads stay plain coalesced element loads: a window's rows start at
//   any column, and a level's pitch (4,964 B at level 0) is not a multiple
//   of 16, so TMA tensor loads or 16-B copies would need padded levels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"

namespace {

using tvo::LevelTable;

constexpr int R = 21;
constexpr int S = 2 * R + 1;               // 43
constexpr int WIN = S * S;                 // 1849 floats per window
constexpr int PER_BLOCK = 4;               // windows staged per block
constexpr int SPAN = PER_BLOCK * WIN;      // 7396 floats, 29,584 B
constexpr int NT = 256;
constexpr int MIN_BLOCKS = 7;              // blocks per SM: 7 x 29,664 B of shared memory

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
extract_kernel(const __grid_constant__ LevelTable t, const int* __restrict__ ys,
               const int* __restrict__ xs, float* __restrict__ out, int n_windows) {
  __shared__ alignas(16) float s_win[SPAN];
  __shared__ const float* s_src[PER_BLOCK];  // the window's first pixel
  __shared__ int s_pitch[PER_BLOCK], s_rows[PER_BLOCK], s_cols[PER_BLOCK];

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * PER_BLOCK;
  const int nwin = min(PER_BLOCK, n_windows - w0);
  if (tid < nwin) {
    const int wi = w0 + tid;
    const int b = wi / t.total, n = wi - b * t.total;
    const int lv = tvo::level_of(t, n);
    const int H = t.H[lv], W = t.W[lv];
    const int y0 = min(max(ys[wi] - R, 0), max(H, S) - S);
    const int x0 = min(max(xs[wi] - R, 0), max(W, S) - S);
    s_src[tid] = t.img[lv] + ((size_t)b * H + y0) * W + x0;
    s_pitch[tid] = W;
    s_rows[tid] = H - y0;  // window rows inside the level
    s_cols[tid] = W - x0;
  }
  __syncthreads();

  // every element's copy is issued before the first wait; a source
  // size of 0 fills the zero padding past the level's edge
  const int total = nwin * WIN;
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(s_win));
#pragma unroll 4
  for (int e = tid; e < total; e += NT) {
    const int j = e / WIN, rem = e - j * WIN;
    const int r = rem / S, c = rem - r * S;
    const bool ok = r < s_rows[j] && c < s_cols[j];
    const float* g = ok ? s_src[j] + (size_t)r * s_pitch[j] + c : s_src[j];
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s_base + 4u * e), "l"(g),
                 "r"(ok ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  float* dst = out + (size_t)w0 * WIN;
  if (nwin < PER_BLOCK) {  // the tail: fewer than 4 windows, scalar stores
    __syncthreads();
    for (int e = tid; e < total; e += NT) dst[e] = s_win[e];
    return;
  }
  // make the generic-proxy writes visible to the bulk copy, then one
  // thread stores the span and waits until it has been read out
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
                 "r"(static_cast<uint32_t>(__cvta_generic_to_shared(s_win))),
                 "r"(static_cast<uint32_t>(SPAN * sizeof(float)))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

}  // namespace

extern "C" int tvo_extract_patches_levels(LevelTable t, const void* ys, const void* xs,
                                          void* out, int B, void* stream) {
  const int n_windows = B * t.total;
  const int blocks = (n_windows + PER_BLOCK - 1) / PER_BLOCK;
  extract_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(t, (const int*)ys, (const int*)xs,
                                                          (float*)out, n_windows);
  return (int)cudaGetLastError();
}
