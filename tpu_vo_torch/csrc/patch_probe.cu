// Kernels P1, P2 and P3: keypoint windows staged through shared memory
// with bands in flight.
//
// Replace the three Pallas kernels of tools/patch_slots_probe.py, the
// probe that chose kernel B2's design: P1 `build` (body `_kernel`), P2
// `build_v2` (body `_v2_kernel`) and P3 `build_v3` (body `_v3_kernel`).
// Each gives keypoint k of frame b a (48, 43) f32 window out of a band of
// the zero-padded level copied to shared memory; the plain versions and
// the index formulas are in ops/patch_probe.py.
//
// The TPU kernels start one strided DMA per keypoint into VMEM, with
// NSLOTS copies in flight, each completing on its own DMA semaphore, and
// KP_CHUNK keypoints per grid step. Here one block takes KP_CHUNK
// keypoints, and each of its NSLOTS slots in shared memory has one
// mbarrier in place of the semaphore: warp 0 starts a band by setting the
// barrier's expected bytes and issuing one bulk asynchronous copy
// (cp.async.bulk, the TMA unit's non-tensor copy) per band row; every
// thread waits on the barrier's phase, writes the window, and the slot is
// refilled with the band NSLOTS keypoints ahead.
//
// What bounds them on an H100: P1 and P3 are copies, bound by bytes
// (each window's 8,256 B out, and the level pixels they hold in). P2 is
// bound by its f32 operations: it keeps the TPU kernel's two one-hot
// products, (48, 128) x (128, 43) and (48, 48) x (48, 43) per window, on
// the CUDA cores in f32 (each sum has one non-zero term, so it is exact
// for finite pixels; no TF32 or bf16 product, which would round them).
// The bands are what the probe varies, so they keep the TPU kernels'
// sizes (56 x lanes, 48 x 128, 56 x 128 f32): NSLOTS of them must fit in
// a block's 227 KB of shared memory, which the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 21;
constexpr int S = 2 * R + 1;       // 43, window columns
constexpr int ROWS = 48;           // window rows
constexpr int BAND_ROWS = 56;      // P1's band rows, P3's slot rows
constexpr int PHASE_LANES = 128;   // P2's and P3's band columns
constexpr int NT = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The slots' barriers, each expecting one arrival (the one that sets its
// bytes) per phase. Called by thread 0.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  for (int s = 0; s < n; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&bars[s])),
                 "r"(1u)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void wait_barrier(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Start copying a (rows, lanes) band at src (row pitch `pitch` floats)
// into dst (row pitch `lanes`); completes the barrier's current phase.
// Called by the 32 threads of warp 0. Source and destination rows are
// 16-byte aligned: the wrapper pads the level to a pitch of a multiple
// of 64 floats and the bands start at multiples of 64 columns.
__device__ __forceinline__ void start_band(float* dst, const float* src, int rows,
                                           int lanes, int pitch, uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const uint32_t row_bytes = 4u * lanes;
  // the slot was last read by the generic proxy; order those reads
  // before the asynchronous proxy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_addr(bar)),
                 "r"(row_bytes * rows)
                 : "memory");
  __syncwarp();
  for (int r = lane; r < rows; r += 32)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst + r * lanes)),
        "l"(src + (size_t)r * pitch), "r"(row_bytes), "r"(smem_addr(bar))
        : "memory");
}

// The slot pipeline of one block over its jn keypoints: `start(j, slot)`
// (warp 0) begins keypoint j's band, `emit(j, slot)` (all threads) writes
// its window once the band has arrived.
template <class Start, class Emit>
__device__ __forceinline__ void run_slots(int jn, int nslots, uint64_t* bars, Start start,
                                          Emit emit) {
  if (threadIdx.x < 32)
    for (int j = 0; j < min(nslots, jn); ++j) start(j, j);
  for (int j = 0; j < jn; ++j) {
    const int slot = j % nslots;
    wait_barrier(&bars[slot], (j / nslots) & 1);
    emit(j, slot);
    __syncthreads();  // every thread is done with the slot
    if (threadIdx.x < 32 && j + nslots < jn) start(j + nslots, slot);
  }
}

// P1's (56, lanes) band of the level padded to (Hp, Wp): at row r8 =
// clip(floor8(r0), 0, Hp - 56) and column cc = min(c128, (W / 128 + 1) *
// 128 - lanes), with the window at row offset r0 - r8 and lane roll
// c0 - c128. The clamp of cc leaves the roll as it is: the TPU kernel's
// windows near the right edge come out shifted left, and so do these.
struct Band {
  int row, col, roff, coff;
  __device__ Band(int y, int x, int H, int W, int Hp, int lanes) {
    const int r0 = clampi(y - R, 0, H - ROWS), c0 = clampi(x - R, 0, W - S);
    row = clampi(r0 / 8 * 8, 0, max(Hp - BAND_ROWS, 0));
    col = min(c0 / 128 * 128, (W / 128 + 1) * 128 - lanes);
    roff = r0 - row;
    coff = c0 % 128;
  }
};

// P1: compact, the window at (roff, coff) of the band, the roll wrapping
// at `lanes`, as the TPU kernel's roll and 9-way row dispatch; else the
// band's top-left (48, 43).
__global__ void __launch_bounds__(NT)
band_kernel(const float* __restrict__ img, const int* __restrict__ ys,
            const int* __restrict__ xs, float* __restrict__ out, int H, int W, int N,
            int Hp, int Wp, int kp_chunk, int nslots, int compact, int lanes) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int band = BAND_ROWS * lanes;
  float* slots = reinterpret_cast<float*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + (size_t)nslots * band);
  const int b = blockIdx.y, k0 = blockIdx.x * kp_chunk;
  const int jn = min(kp_chunk, N - k0);
  const float* level = img + (size_t)b * Hp * Wp;
  const int* yk = ys + (size_t)b * N + k0;
  const int* xk = xs + (size_t)b * N + k0;
  if (threadIdx.x == 0) init_barriers(bars, nslots);
  __syncthreads();

  auto start = [&](int j, int slot) {
    const Band p(yk[j], xk[j], H, W, Hp, lanes);
    start_band(slots + (size_t)slot * band, level + (size_t)p.row * Wp + p.col, BAND_ROWS,
               lanes, Wp, &bars[slot]);
  };
  auto emit = [&](int j, int slot) {
    const Band p(yk[j], xk[j], H, W, Hp, lanes);
    const int roff = compact ? p.roff : 0, coff = compact ? p.coff : 0;
    const float* src = slots + (size_t)slot * band;
    float* dst = out + ((size_t)b * N + k0 + j) * ROWS * S;
    for (int i = threadIdx.x; i < ROWS * S; i += NT) {
      const int r = i / S;
      int c = coff + i - r * S;
      if (c >= lanes) c -= lanes;  // the roll wraps (coff + 42 < 2 * lanes)
      dst[i] = src[(roff + r) * lanes + c];
    }
  };
  run_slots(jn, nslots, bars, start, emit);
}

// The (48, 128) band of P2 and P3: in the TPU wrapper, phase copy
// (pr, pc) = ((r0 >> 2) & 1, (c0 >> 6) & 1) at (sr, sc) = (floor8(r0 -
// 4 pr), floor128(c0 - 64 pc)); that is the padded level at (sr + 4 pr,
// sc + 64 pc) = (r0 & ~3, c0 & ~63), with the window at row offset
// r0 & 3 and column offset c0 & 63 in the band.
struct PhaseBand {
  int row, col, roff, coff;
  __device__ PhaseBand(int y, int x, int H, int W) {
    const int r0 = clampi(y - R, 0, H - ROWS), c0 = clampi(x - R, 0, W - S);
    row = r0 & ~3;
    col = c0 & ~63;
    roff = r0 & 3;
    coff = c0 & 63;
  }
};

// P2: the window as oh_r (48, 48) x (band (48, 128) x oh_c (128, 43)),
// oh_c[l][c] = (l == c + coff), oh_r[i][k] = (k == i + roff), each sum
// taken in f32 over all its terms as the TPU kernel's products do. The
// last roff rows have no non-zero term and come out 0.
__global__ void __launch_bounds__(NT)
phase_mxu_kernel(const float* __restrict__ img, const int* __restrict__ ys,
                 const int* __restrict__ xs, float* __restrict__ out, int H, int W, int N,
                 int Hp, int Wp, int kp_chunk, int nslots) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int band = ROWS * PHASE_LANES;
  float* slots = reinterpret_cast<float*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + (size_t)nslots * band);
  float* cols = reinterpret_cast<float*>(bars + nslots);  // (48, 43)
  const int b = blockIdx.y, k0 = blockIdx.x * kp_chunk;
  const int jn = min(kp_chunk, N - k0);
  const float* level = img + (size_t)b * Hp * Wp;
  const int* yk = ys + (size_t)b * N + k0;
  const int* xk = xs + (size_t)b * N + k0;
  if (threadIdx.x == 0) init_barriers(bars, nslots);
  __syncthreads();

  auto start = [&](int j, int slot) {
    const PhaseBand p(yk[j], xk[j], H, W);
    start_band(slots + (size_t)slot * band, level + (size_t)p.row * Wp + p.col, ROWS,
               PHASE_LANES, Wp, &bars[slot]);
  };
  auto emit = [&](int j, int slot) {
    const PhaseBand p(yk[j], xk[j], H, W);
    const float* src = slots + (size_t)slot * band;
    for (int i = threadIdx.x; i < ROWS * S; i += NT) {
      const int k = i / S, c = i - k * S;
      const float* row = src + k * PHASE_LANES;
      float acc = 0.f;
      for (int l = 0; l < PHASE_LANES; ++l) acc += row[l] * (l == c + p.coff ? 1.f : 0.f);
      cols[i] = acc;
    }
    __syncthreads();
    float* dst = out + ((size_t)b * N + k0 + j) * ROWS * S;
    for (int i = threadIdx.x; i < ROWS * S; i += NT) {
      const int r = i / S, c = i - r * S;
      float acc = 0.f;
      for (int k = 0; k < ROWS; ++k) acc += (k == r + p.roff ? 1.f : 0.f) * cols[k * S + c];
      dst[i] = acc;
    }
  };
  run_slots(jn, nslots, bars, start, emit);
}

// P3: the band in rows 0..47 of a 56-row slot whose rows 48..55 are zero;
// the window is the slot rolled by coff lanes, from row roff, as the TPU
// kernel's roll and 4-way row dispatch.
__global__ void __launch_bounds__(NT)
phase_roll_kernel(const float* __restrict__ img, const int* __restrict__ ys,
                  const int* __restrict__ xs, float* __restrict__ out, int H, int W, int N,
                  int Hp, int Wp, int kp_chunk, int nslots) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int band = BAND_ROWS * PHASE_LANES;
  float* slots = reinterpret_cast<float*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + (size_t)nslots * band);
  const int b = blockIdx.y, k0 = blockIdx.x * kp_chunk;
  const int jn = min(kp_chunk, N - k0);
  const float* level = img + (size_t)b * Hp * Wp;
  const int* yk = ys + (size_t)b * N + k0;
  const int* xk = xs + (size_t)b * N + k0;
  constexpr int tail = (BAND_ROWS - ROWS) * PHASE_LANES;
  for (int i = threadIdx.x; i < nslots * tail; i += NT)
    slots[(size_t)(i / tail) * band + ROWS * PHASE_LANES + i % tail] = 0.f;
  if (threadIdx.x == 0) init_barriers(bars, nslots);
  __syncthreads();

  auto start = [&](int j, int slot) {
    const PhaseBand p(yk[j], xk[j], H, W);
    start_band(slots + (size_t)slot * band, level + (size_t)p.row * Wp + p.col, ROWS,
               PHASE_LANES, Wp, &bars[slot]);
  };
  auto emit = [&](int j, int slot) {
    const PhaseBand p(yk[j], xk[j], H, W);
    const float* src = slots + (size_t)slot * band;
    float* dst = out + ((size_t)b * N + k0 + j) * ROWS * S;
    for (int i = threadIdx.x; i < ROWS * S; i += NT) {
      const int r = i / S, c = i - r * S;
      dst[i] = src[(p.roff + r) * PHASE_LANES + ((p.coff + c) & (PHASE_LANES - 1))];
    }
  };
  run_slots(jn, nslots, bars, start, emit);
}

template <class Kernel, class... Args>
int launch(Kernel kernel, int B, int N, int kp_chunk, size_t smem, void* stream,
           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kp_chunk - 1) / kp_chunk, B);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// img: (B, Hp, Wp) f32, the level zero-padded as ops/patch_probe.py pads
// it; ys, xs: (B, N) int32; out: (B, N, 48, 43) f32.
extern "C" int tvo_band_windows(const void* img, const void* ys, const void* xs, void* out,
                                int B, int H, int W, int N, int Hp, int Wp, int kp_chunk,
                                int nslots, int compact, int lanes, void* stream) {
  const size_t smem = (size_t)nslots * (4 * BAND_ROWS * lanes + 8);
  return launch(band_kernel, B, N, kp_chunk, smem, stream, (const float*)img,
                (const int*)ys, (const int*)xs, (float*)out, H, W, N, Hp, Wp, kp_chunk,
                nslots, compact, lanes);
}

// roll = 0: P2 (one-hot products); roll = 1: P3 (roll and row offset).
extern "C" int tvo_phase_windows(const void* img, const void* ys, const void* xs, void* out,
                                 int B, int H, int W, int N, int Hp, int Wp, int kp_chunk,
                                 int nslots, int roll, void* stream) {
  if (roll) {
    const size_t smem = (size_t)nslots * (4 * BAND_ROWS * PHASE_LANES + 8);
    return launch(phase_roll_kernel, B, N, kp_chunk, smem, stream, (const float*)img,
                  (const int*)ys, (const int*)xs, (float*)out, H, W, N, Hp, Wp, kp_chunk,
                  nslots);
  }
  const size_t smem = (size_t)nslots * (4 * ROWS * PHASE_LANES + 8) + 4 * ROWS * S;
  return launch(phase_mxu_kernel, B, N, kp_chunk, smem, stream, (const float*)img,
                (const int*)ys, (const int*)xs, (float*)out, H, W, N, Hp, Wp, kp_chunk,
                nslots);
}
