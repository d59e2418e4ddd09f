// Kernel "describe": the intensity-centroid angle, the 7x7 Gaussian blur
// and the steered rBRIEF-256 bits of every 43x43 window, in one launch.
//
// Replaces no Pallas kernel: tpu_vo computes these from kernel B2's
// windows in XLA (tpu_vo/features/patches.py `angles_from_patches`,
// `descriptor_bits_from_patches`). Its plain PyTorch version is
// ops/describe.py `describe_windows_reference` (features/patches.py's
// functions), which ran eagerly on the card before: some 25 passes, each
// over a (B, N, 43, 37) or (B, N, 37, 37) f32 temporary in device memory.
//
// What bounds it on an H100: bytes. Each window is read once, 7,396 B
// (1.14 GB for 128 frames of 1200 slots, 0.34 ms at 3.35 TB/s); it writes
// 260 B a window. Its arithmetic, ~35 k single float operations a window
// (the 43x37 horizontal pass, the vertical pass at the 512 sampled points
// only, the moments and the offsets), takes about as long at 33.5 T
// operations/s, so neither may be wasted. This design:
//
// - No intermediate leaves shared memory. B2 writes windows in groups of 4
//   (29,584 B, a multiple of 16); one cp.async.bulk on an mbarrier brings a
//   group into shared memory, with no thread's registers spent on the
//   load. A persistent block (grid from an occupancy query, once a
//   process and device) starts the next group's copy as soon as the
//   horizontal pass has read the current one, so the copy overlaps the
//   sampling. A group of fewer than 4 windows (the tail) or an unaligned
//   input is loaded element by element.
// - Two warps a window reduce its 31x31 moments by shuffles; one thread a
//   window makes the angle and its cosine and sine. All threads run the
//   horizontal pass (43x37 a window, in shared memory), then thread t
//   makes bit t of each window: two steered offsets, the vertical pass at
//   those two points, round and clamp, one compare, one byte stored.
//
// Bit for bit the eager ops: the moments are sums of products of integers
// (pixels 0..255 on the pyramid's integer grid, weights -15..15) below
// 2^24, exact in any order. Every other step rounds as the eager ops do,
// each product and sum on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn; the library is built with -fmad=false as well), the blur in
// the left-fold tap order of features/patches.blur_patches, rintf for
// torch.round, and the precise cosf/sinf that torch.cos/torch.sin call.
// The constants (taps, polynomial, eps, deg-to-rad, the moment circle's
// umax) come from the Python module at launch, the 512 pattern points as
// the device tensors of features/brief.

#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"

namespace tvo {

// The constants of the eager code, passed by value at launch (ctypes
// Structure ops/describe.DescribeConsts, same field order).
struct DescribeConsts {
  float taps[7];                       // the blur's float32 taps
  float p1, p3, p5, p7, eps, deg2rad;  // fast_atan2_deg's polynomial and eps; brief's deg-to-rad
  int umax[16];                        // the moment circle's half-width a row, |v| = 0..15
};

}  // namespace tvo

namespace {

using Consts = tvo::DescribeConsts;
using tvo::MAX_DEVICES;
using tvo::sm_count;

constexpr int S = 43;                      // window side
constexpr int WIN = S * S;                 // 1849 floats
constexpr int PER_BLOCK = 4;               // windows a group
constexpr int SPAN = PER_BLOCK * WIN;      // 7396 floats, 29,584 B
constexpr int KS = 7;                      // blur taps
constexpr int BS = S - (KS - 1);           // 37: the blurred side
constexpr int HP = S * BS;                 // 1591 floats: a window's horizontal pass
constexpr int SR = BS / 2;                 // 18: sample radius
constexpr int HALF = 15;                   // moment patch radius
constexpr int MC = S / 2;                  // 21: the window's centre
constexpr int BITS = 256;
constexpr int NT = 256;                    // threads: one a bit
constexpr int MIN_BLOCKS = 4;              // 4 x 55,152 B of shared memory fit an SM

static_assert(NT == BITS, "thread t makes bit t of each window");
static_assert(NT / 32 == 2 * PER_BLOCK, "two warps a window make its moments");

struct Smem {
  uint64_t bar;
  alignas(16) float raw[SPAN];
  float h[PER_BLOCK * HP];
  float mom[PER_BLOCK][2][2];              // [window][warp][m10, m01]
  float cs[PER_BLOCK][2];                  // [window][cos, sin]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// OpenCV's fastAtan2 in degrees, as orientation.fast_atan2_deg rounds it.
__device__ __forceinline__ float fast_atan2_deg(float y, float x, const Consts& k) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float c = ax >= ay ? __fdiv_rn(ay, __fadd_rn(ax, k.eps))
                           : __fdiv_rn(ax, __fadd_rn(ay, k.eps));
  const float c2 = __fmul_rn(c, c);
  float p = __fadd_rn(__fmul_rn(k.p7, c2), k.p5);
  p = __fadd_rn(__fmul_rn(p, c2), k.p3);
  p = __fadd_rn(__fmul_rn(p, c2), k.p1);
  p = __fmul_rn(p, c);
  float a = ax >= ay ? p : __fsub_rn(90.0f, p);
  if (x < 0.0f) a = __fsub_rn(180.0f, a);
  if (y < 0.0f) a = __fsub_rn(360.0f, a);
  return a;
}

// The blurred value at (y, x) of the 37x37 grid from a window's horizontal
// pass h (43x37): the vertical taps in left-fold order, rounded half to
// even and clamped to [0, 255].
__device__ __forceinline__ float blurred_at(const float* h, int y, int x, const Consts& k) {
  const float* col = h + y * BS + x;
  float acc = __fmul_rn(col[0], k.taps[0]);
#pragma unroll
  for (int i = 1; i < KS; ++i) acc = __fadd_rn(acc, __fmul_rn(col[i * BS], k.taps[i]));
  return fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
}

// The sample at pattern point (px, py) steered by (a, b) = (cos, sin).
__device__ __forceinline__ float sample(const float* h, float px, float py, float a, float b,
                                        const Consts& k) {
  const int dx = (int)rintf(__fsub_rn(__fmul_rn(px, a), __fmul_rn(py, b)));
  const int dy = (int)rintf(__fadd_rn(__fmul_rn(px, b), __fmul_rn(py, a)));
  return blurred_at(h, dy + SR, dx + SR, k);
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
describe_kernel(const float* __restrict__ raw, float* __restrict__ ang,
                unsigned char* __restrict__ bits, int n_windows, const __grid_constant__ Consts k,
                const float* __restrict__ pat_x, const float* __restrict__ pat_y) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem& s = *reinterpret_cast<Smem*>(smem_bytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (n_windows + PER_BLOCK - 1) / PER_BLOCK;
  // a full group of an aligned input comes in by one bulk copy
  const bool aligned = (reinterpret_cast<uintptr_t>(raw) & 15) == 0;
  auto bulk = [&](int g) { return aligned && (g + 1) * PER_BLOCK <= n_windows; };
  auto fetch = [&](int g) {
    bulk_load(s.raw, raw + (size_t)g * SPAN, SPAN * sizeof(float), &s.bar);
  };

  // thread t makes bit t: samples 2t and 2t + 1 of the pattern
  const float px0 = pat_x[2 * tid], py0 = pat_y[2 * tid];
  const float px1 = pat_x[2 * tid + 1], py1 = pat_y[2 * tid + 1];

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&s.bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && blockIdx.x < groups && bulk(blockIdx.x)) fetch(blockIdx.x);

  uint32_t parity = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int w0 = g * PER_BLOCK, nwin = min(PER_BLOCK, n_windows - w0);
    if (bulk(g)) {
      bar_wait(&s.bar, parity);
      parity ^= 1u;
    } else {
      const float* src = raw + (size_t)w0 * WIN;
      for (int e = tid; e < nwin * WIN; e += NT) s.raw[e] = src[e];
      __syncthreads();
    }

    // moments: warps 2w and 2w + 1 take rows v <= 0 and v > 0 of window w,
    // lane l the column u = l - 15
    {
      const int w = warp >> 1, half = warp & 1;
      if (w < nwin) {
        float m10 = 0.0f, m01 = 0.0f;
        const int u = lane - HALF;
        if (lane <= 2 * HALF) {
          const float* p = s.raw + w * WIN + MC * S + MC + u;
          for (int v = half ? 1 : -HALF; v <= (half ? HALF : 0); ++v) {
            if (abs(u) <= k.umax[abs(v)]) {
              const float x = p[v * S];
              m10 = __fadd_rn(m10, __fmul_rn(x, (float)u));
              m01 = __fadd_rn(m01, __fmul_rn(x, (float)v));
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          m10 = __fadd_rn(m10, __shfl_xor_sync(0xffffffffu, m10, o));
          m01 = __fadd_rn(m01, __shfl_xor_sync(0xffffffffu, m01, o));
        }
        if (lane == 0) {
          s.mom[w][half][0] = m10;
          s.mom[w][half][1] = m01;
        }
      }
    }
    // horizontal pass: every row, the 37 blurred columns
    for (int e = tid; e < nwin * HP; e += NT) {
      const int w = e / HP, rem = e - w * HP;
      const int r = rem / BS, c = rem - r * BS;
      const float* x = s.raw + w * WIN + r * S + c;
      float acc = __fmul_rn(x[0], k.taps[0]);
#pragma unroll
      for (int i = 1; i < KS; ++i) acc = __fadd_rn(acc, __fmul_rn(x[i], k.taps[i]));
      s.h[e] = acc;
    }
    __syncthreads();

    // the window's raw pixels are read: bring in this block's next group
    const int next = g + gridDim.x;
    if (tid == 0 && next < groups && bulk(next)) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fetch(next);
    }
    if (tid < nwin) {
      const float m10 = __fadd_rn(s.mom[tid][0][0], s.mom[tid][1][0]);
      const float m01 = __fadd_rn(s.mom[tid][0][1], s.mom[tid][1][1]);
      const float a = fast_atan2_deg(m01, m10, k);
      ang[w0 + tid] = a;
      const float rad = __fmul_rn(a, k.deg2rad);
      s.cs[tid][0] = cosf(rad);
      s.cs[tid][1] = sinf(rad);
    }
    __syncthreads();

    for (int w = 0; w < nwin; ++w) {
      const float* h = s.h + w * HP;
      const float a = s.cs[w][0], b = s.cs[w][1];
      const float v0 = sample(h, px0, py0, a, b, k);
      const float v1 = sample(h, px1, py1, a, b, k);
      bits[(size_t)(w0 + w) * BITS + tid] = v0 < v1;
    }
    __syncthreads();  // h and cs are rewritten by the next group
  }
}

// Blocks of describe_kernel that fit on one SM of the current device, or
// -1 on an error; asked once a process and device.
int blocks_per_sm() {
  static int known[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < MAX_DEVICES && known[dev] > 0) return known[dev];
  int blocks = 0;
  if (cudaFuncSetAttribute(describe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, describe_kernel, NT,
                                                    sizeof(Smem)) != cudaSuccess)
    return -1;
  if (dev < MAX_DEVICES) known[dev] = blocks;
  return blocks;
}

}  // namespace

// raw: (n_windows, 43, 43) f32, contiguous; ang: (n_windows,) f32; bits:
// (n_windows, 256) bool; pat_x, pat_y: the 512 pattern points, f32.
extern "C" int tvo_describe_windows(const void* raw, void* ang, void* bits, int n_windows,
                                    tvo::DescribeConsts k, const void* pat_x, const void* pat_y,
                                    void* stream) {
  const int per_sm = blocks_per_sm(), sms = sm_count();
  if (per_sm < 0 || sms < 0) return (int)cudaErrorInvalidValue;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const int groups = (n_windows + PER_BLOCK - 1) / PER_BLOCK;
  const int blocks = min(groups, per_sm * sms);
  describe_kernel<<<blocks, NT, sizeof(Smem), (cudaStream_t)stream>>>(
      (const float*)raw, (float*)ang, (unsigned char*)bits, n_windows, k,
      (const float*)pat_x, (const float*)pat_y);
  return (int)cudaGetLastError();
}
