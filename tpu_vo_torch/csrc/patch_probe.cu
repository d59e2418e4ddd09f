// Kernels P1, P2 and P3: keypoint windows staged through shared memory
// with bands in flight.
//
// Replace the three Pallas kernels of tools/patch_slots_probe.py, the
// probe that chose kernel B2's design: P1 `build` (body `_kernel`), P2
// `build_v2` (body `_v2_kernel`) and P3 `build_v3` (body `_v3_kernel`).
// Each gives keypoint k of frame b a (48, 43) f32 window out of a band of
// the level copied to shared memory; the plain versions and the index
// formulas are in ops/patch_probe.py.
//
// P1 keeps the first port's structure: one block per KP_CHUNK keypoints,
// NSLOTS (56, lanes) bands in flight, each filled by one cp.async.bulk
// per row of the zero-padded level and completing on its own mbarrier
// (the TPU kernel's DMA semaphore), one block-wide barrier per window.
//
// P2 and P3 share one pipeline, built for this card:
//
// - What bounds them: bytes. Each window is 8,256 B out, and the level
//   pixels the windows cover come in once: 45.5 MB for the probe's 4096
//   windows, 0.0137 ms at 3.35 TB/s. The bands the probe varies keep the
//   TPU kernels' 48 x 128 f32 (24,576 B a slot); they come from L2, 100
//   MB a call, three times the windows' bytes.
// - One warp per window, one slot per warp. A block of min(NSLOTS, 8)
//   warps walks chunks of KP_CHUNK keypoints (a persistent grid: as many
//   blocks as fit on the SMs, each taking chunk after chunk); keypoint j
//   of a chunk goes to warp j mod warps, and each warp owns NSLOTS /
//   warps slots. A warp refills its slot itself once it is done with it,
//   so no block-wide barrier runs per window: a __syncwarp, then the next
//   band's copies. The copies are cp.async (each thread's own copy, not
//   the asynchronous proxy, so no proxy fence comes before a refill), one
//   commit group per band; cp.async.wait_group keeps a warp's other bands
//   in flight while it waits for the oldest. On an H100, 8 warps with a
//   slot each beat 4 warps with two: these kernels wait on latency, and
//   more warps hide more of it.
// - No padded copy of the level: the kernels read the caller's level.
//   Band rows never pass the level (r0 <= H - 48), but band columns may
//   pass W; cp.async's source size zero-fills them, which P2 needs (its
//   products multiply them by 0, and 0 x NaN is not 0). A band row whose
//   start is 16-B aligned comes in as 32 16-B copies, any other row as
//   128 4-B copies: the level's pitch (1241 floats) leaves 3 rows in 4
//   unaligned, so a bulk or tensor copy would need the pad back. (Copying
//   each row's aligned 132-float superset in 16-B pieces was slower.)
// - A slot's 16-B chunks are XOR-swizzled by row (chunk q of row n at
//   q ^ 4 (n & 1)), so that P2's 16-B fragment loads (4 lanes per row, 2
//   rows per quarter-warp) hit 32 distinct banks.
// - The window leaves in 16-B stores, 516 float4s of its contiguous 8,256
//   B; the rows past 48 - (r0 & 3) are written as zeros. P3 reads each
//   float4's four elements from the slot, row and column advanced by
//   adding, not dividing; P2 stages the window in its slot once the band
//   is read and copies it out.
// - P2 runs the TPU kernel's two one-hot products on the tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 accumulate; HMMA in the SASS),
//   transposed so that the column product's accumulators are the row
//   product's A fragments in registers, as FlashAttention-2 keeps P:
//   cols^T (48, 48) = oh_c^T (48, 128) x band^T (128, 48), then out^T
//   (48, 48) = cols^T x oh_r^T (48, 48); the one-hot operands are built
//   from lane indices and never stored. Exactness: each band value x is
//   split in registers into three bf16 parts by truncation (hi = x with
//   its low 16 bits cleared, r = x - hi, mid = r with its low 16 bits
//   cleared, lo = r - mid), each exact in bf16 (f32's 24 significant bits
//   are three times bf16's 8). Each part goes through both products: a
//   product with 1.0 is exact, and each sum has one non-zero term, so
//   every partial result is exact. The parts are added as (hi + mid) +
//   lo in f32; both additions are exact, so the result is x bit for bit
//   (a -0 pixel comes out +0, equal in value, as the f32 products of the
//   first port gave it). Domain: finite pixels whose lo part is not
//   subnormal, which holds for every |x| >= 2^-100 and for 0. The
//   products cost 2.43 MFLOP of bf16 a window as mma.sync tiles them,
//   0.010 ms for 4096 at the card's bf16 peak, under the bytes bound; the
//   issue of about 600 mma.sync, the splits (three times per value, once
//   per m-tile) and the fragment loads set P2's pace. wgmma is not used:
//   its 64-row tiles across four warps do not fit one 48 x 43 window per
//   warp, and the products are too small to need its rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 21;
constexpr int S = 2 * R + 1;       // 43, window columns
constexpr int ROWS = 48;           // window rows
constexpr int BAND_ROWS = 56;      // P1's band rows
constexpr int PHASE_LANES = 128;   // P2's and P3's band columns
constexpr int NT = 256;
constexpr int WIN = ROWS * S;            // 2064 floats, 8,256 B per window
constexpr int WIN4 = WIN / 4;            // 516 float4s
constexpr int PHASE_BAND = ROWS * PHASE_LANES;
constexpr int MAX_WARPS = 8;

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

// ---- P2 and P3 ----------------------------------------------------------

// The (48, 128) band of P2 and P3: in the TPU wrapper, phase copy
// (pr, pc) = ((r0 >> 2) & 1, (c0 >> 6) & 1) at (sr, sc) = (floor8(r0 -
// 4 pr), floor128(c0 - 64 pc)); that is the level at (sr + 4 pr, sc + 64
// pc) = (r0 & ~3, c0 & ~63), with the window at row offset r0 & 3 and
// column offset c0 & 63 in the band. Rows row..row + 47 lie inside the
// level; columns from col + ncols on lie past it and are zero.
struct PhaseBand {
  int row, col, roff, coff, ncols;
  __device__ PhaseBand(int y, int x, int H, int W) {
    const int r0 = clampi(y - R, 0, H - ROWS), c0 = clampi(x - R, 0, W - S);
    row = r0 & ~3;
    col = c0 & ~63;
    roff = r0 & 3;
    coff = c0 & 63;
    ncols = min(PHASE_LANES, W - col);
  }
};

// Float index of band element (n, k) in a slot: 16-B chunks swizzled by row.
__device__ __forceinline__ int swz(int n, int k) {
  return n * PHASE_LANES + ((((k >> 2) ^ ((n & 1) << 2))) << 2) + (k & 3);
}

// The warp's walk over the windows: chunk after chunk of kp_chunk
// windows (blockIdx.x, + gridDim.x, ...), keypoint j = warp, + warps, ...
// of each. Windows are numbered b * N + k.
struct Walk {
  int chunk, j;
  __device__ int window(int kp_chunk) const { return chunk * kp_chunk + j; }
  __device__ bool valid(int kp_chunk, int total) const {
    return j < kp_chunk && window(kp_chunk) < total;
  }
  __device__ void next(int warp, int warps, int kp_chunk, int total) {
    j += warps;
    if (j >= kp_chunk || window(kp_chunk) >= total) {
      chunk += gridDim.x;
      j = warp;
    }
  }
};

// Issue the copies of window `win`'s band into `slot` (all 32 lanes).
__device__ __forceinline__ void copy_band(float* slot, const float* __restrict__ img,
                                          const int* __restrict__ ys,
                                          const int* __restrict__ xs, int win, int H, int W,
                                          int N, int lane) {
  const PhaseBand p(ys[win], xs[win], H, W);
  const float* src = img + ((size_t)(win / N) * H + p.row) * W + p.col;
  const uint32_t base = smem_addr(slot);
#pragma unroll 2
  for (int n = 0; n < ROWS; ++n) {
    const float* row = src + (size_t)n * W;
    if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      const int k = 4 * lane, have = clampi(p.ncols - k, 0, 4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(base + 4u * swz(n, k)),
                   "l"(have ? row + k : row), "r"(4 * have)
                   : "memory");
    } else {
#pragma unroll
      for (int k = lane; k < PHASE_LANES; k += 32) {
        const bool in = k < p.ncols;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(base + 4u * swz(n, k)),
                     "l"(in ? row + k : row), "r"(in ? 4 : 0)
                     : "memory");
      }
    }
  }
}

// Wait until at most `n` of the thread's cp.async groups are pending
// (the count must be an immediate).
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

// The slot pipeline of one warp: its slots are the block's slots
// warp, warp + warps, ...; `emit(win, slot, band)` writes window win once
// its band has arrived in slot, and may then use the slot as scratch. A group is committed for every slot
// refill, empty or not, so that the oldest band is always `nmine - 1`
// groups back.
template <class Emit>
__device__ __forceinline__ void run_warp(float* slots, const float* __restrict__ img,
                                         const int* __restrict__ ys,
                                         const int* __restrict__ xs, int H, int W, int N,
                                         int total, int kp_chunk, int nslots, int warps,
                                         Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nmine = (nslots - warp + warps - 1) / warps;  // this warp's slots
  Walk fill{(int)blockIdx.x, warp}, use = fill;
  for (int i = 0; i < nmine; ++i) {
    if (fill.valid(kp_chunk, total)) {
      copy_band(slots + (size_t)(warp + i * warps) * PHASE_BAND, img, ys, xs,
                fill.window(kp_chunk), H, W, N, lane);
      fill.next(warp, warps, kp_chunk, total);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int i = 0; use.valid(kp_chunk, total); i = (i + 1 == nmine) ? 0 : i + 1) {
    float* slot = slots + (size_t)(warp + i * warps) * PHASE_BAND;
    wait_groups(nmine - 1);
    __syncwarp();
    const int win = use.window(kp_chunk);
    emit(win, slot, PhaseBand(ys[win], xs[win], H, W));
    __syncwarp();  // every lane is done with the slot
    if (fill.valid(kp_chunk, total)) {
      copy_band(slot, img, ys, xs, fill.window(kp_chunk), H, W, N, lane);
      fill.next(warp, warps, kp_chunk, total);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    use.next(warp, warps, kp_chunk, total);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// P3: out[r][c] = band[roff + r][coff + c] for r + roff < 48, else 0 (the
// TPU kernel's lane roll by coff, which never wraps: coff + 42 < 128,
// and its row offset); 16-B stores, lane l starting at element 4 l.
__global__ void __launch_bounds__(MAX_WARPS * 32)
phase_roll_kernel(const float* __restrict__ img, const int* __restrict__ ys,
                  const int* __restrict__ xs, float* __restrict__ out, int H, int W, int N,
                  int total, int kp_chunk, int nslots, int warps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* slots = reinterpret_cast<float*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int r_lane = 4 * lane / S, c_lane = 4 * lane - r_lane * S;
  run_warp(slots, img, ys, xs, H, W, N, total, kp_chunk, nslots, warps,
           [&](int win, const float* slot, const PhaseBand& p) {
             float4* dst = reinterpret_cast<float4*>(out + (size_t)win * WIN);
             int r = r_lane, c = c_lane;
             for (int f = lane; f < WIN4; f += 32) {
               float v[4];
               int rr = r, cc = c;
#pragma unroll
               for (int e = 0; e < 4; ++e) {
                 v[e] = rr + p.roff < ROWS ? slot[swz(rr + p.roff, cc + p.coff)] : 0.f;
                 if (++cc == S) {
                   cc = 0;
                   ++rr;
                 }
               }
               dst[f] = make_float4(v[0], v[1], v[2], v[3]);
               // the next float4 is 128 elements on: 2 rows and 42 columns
               c += S - 1;
               r += 2;
               if (c >= S) {
                 c -= S;
                 ++r;
               }
             }
           });
}

// bf16x2 one-hot pair: 1.0 in the low half where e == 0, in the high half
// where e == 1, else 0 (e: the selected index minus the pair's first
// index). PTX clamps a shift past 32 bits to 32, which gives 0.
__device__ __forceinline__ uint32_t onehot2(int e) {
  uint32_t v;
  asm("shl.b32 %0, %1, %2;" : "=r"(v) : "r"(0x3F80u), "r"(static_cast<uint32_t>(16 * e)));
  return v;
}

// bf16x2 of two f32 values that are exact in bf16: their upper halves.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// d += a (16x16 bf16, row) x b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = (hi + mid) + lo, each part exact in bf16 (see the note above).
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
  const float r = __fsub_rn(x, hi);
  mid = __uint_as_float(__float_as_uint(r) & 0xFFFF0000u);
  lo = __fsub_rn(r, mid);
}

// The column product of m-tile mi (window columns 16 mi ..) for the
// three parts: acc[part][nj] = oh_c^T (16, 128) x part(band)^T (128, 8),
// band rows 8 nj ... Lane (g, t) = (lane / 4, lane % 4) holds fragment
// rows g, g + 8 and columns 2t, 2t + 1 (+ 8), as mma.sync lays them out.
// Within each k-step of 16, fragment columns 2t, 2t + 1, 2t + 8, 2t + 9
// stand for band columns 4t .. 4t + 3 in both operands (a one-hot sum
// does not depend on its order), so a lane loads its B values with one
// 16-B load.
__device__ __forceinline__ void column_product(float (&acc)[3][6][4], const float* slot,
                                               int mi, int coff, int g, int t) {
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int nj = 0; nj < 6; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[part][nj][i] = 0.f;
#pragma unroll 2  // fully unrolled, P2 needs more than 255 registers and spills
  for (int ks = 0; ks < PHASE_LANES / 16; ++ks) {
    // oh_c^T[m][k] = (k == m + coff), m = 16 mi + row, k = 16 ks + 4t + j
    const int d = 16 * mi + g + coff - 16 * ks - 4 * t;
    const uint32_t a[4] = {onehot2(d), onehot2(d + 8), onehot2(d - 2), onehot2(d + 6)};
#pragma unroll
    for (int nj = 0; nj < ROWS / 8; ++nj) {
      const float4 v = *reinterpret_cast<const float4*>(slot + swz(8 * nj + g, 16 * ks + 4 * t));
      float h[4], m[4], l[4];
      split3(v.x, h[0], m[0], l[0]);
      split3(v.y, h[1], m[1], l[1]);
      split3(v.z, h[2], m[2], l[2]);
      split3(v.w, h[3], m[3], l[3]);
      mma(acc[0][nj], a, bf16x2(h[0], h[1]), bf16x2(h[2], h[3]));
      mma(acc[1][nj], a, bf16x2(m[0], m[1]), bf16x2(m[2], m[3]));
      mma(acc[2][nj], a, bf16x2(l[0], l[1]), bf16x2(l[2], l[3]));
    }
  }
}

// The row product of one m-tile for each part, from the column product's
// accumulators in registers, the parts added as (hi + mid) + lo:
// fin[nj] = out^T (16 window columns, window rows 8 nj ..).
__device__ __forceinline__ void row_product(float (&fin)[6][4], const float (&acc)[3][6][4],
                                            int roff, int g, int t) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    float o[6][4] = {};
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      // the accumulators of n-tiles 2kk, 2kk + 1 are this A fragment
      const float(&c0)[4] = acc[part][2 * kk];
      const float(&c1)[4] = acc[part][2 * kk + 1];
      const uint32_t a[4] = {bf16x2(c0[0], c0[1]), bf16x2(c0[2], c0[3]), bf16x2(c1[0], c1[1]),
                             bf16x2(c1[2], c1[3])};
#pragma unroll
      for (int nj = 0; nj < ROWS / 8; ++nj) {
        // oh_r^T[k][r] = (k == r + roff), k = 16 kk + row, r = 8 nj + col
        const int e = 8 * nj + g + roff - 16 * kk - 2 * t;
        mma(o[nj], a, onehot2(e), onehot2(e - 8));
      }
    }
#pragma unroll
    for (int nj = 0; nj < 6; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        fin[nj][i] = part == 0 ? o[nj][i] : __fadd_rn(fin[nj][i], o[nj][i]);
  }
}

// Write m-tile mi of out^T (window column 16 mi + g (+ 8), row 8 nj + 2t
// (+ 1)) into the (48, 43) window at `stage`.
__device__ __forceinline__ void stage_tile(float* stage, const float (&fin)[6][4], int mi,
                                           int g, int t) {
  const int ca = 16 * mi + g, cb = ca + 8;
#pragma unroll
  for (int nj = 0; nj < 6; ++nj) {
    const int r = 8 * nj + 2 * t;
    if (ca < S) {
      stage[r * S + ca] = fin[nj][0];
      stage[(r + 1) * S + ca] = fin[nj][1];
    }
    if (cb < S) {
      stage[r * S + cb] = fin[nj][2];
      stage[(r + 1) * S + cb] = fin[nj][3];
    }
  }
}

// P2: per m-tile of 16 window columns, the column product for all three
// parts, then per part the row product from the accumulators in
// registers, the parts summed in order; the three m-tiles' sums stay in
// registers until the band is read, then the slot holds the window for
// its 16-B stores.
__global__ void __launch_bounds__(MAX_WARPS * 32)
phase_mxu_kernel(const float* __restrict__ img, const int* __restrict__ ys,
                 const int* __restrict__ xs, float* __restrict__ out, int H, int W, int N,
                 int total, int kp_chunk, int nslots, int warps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* slots = reinterpret_cast<float*>(smem_raw);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  run_warp(slots, img, ys, xs, H, W, N, total, kp_chunk, nslots, warps,
           [&](int win, float* slot, const PhaseBand& p) {
             float fin[3][6][4];
#pragma unroll
             for (int mi = 0; mi < 3; ++mi) {
               float acc[3][6][4];
               column_product(acc, slot, mi, p.coff, g, t);
               row_product(fin[mi], acc, p.roff, g, t);
             }
             __syncwarp();  // the band is read; the slot becomes the window's stage
#pragma unroll
             for (int mi = 0; mi < 3; ++mi) stage_tile(slot, fin[mi], mi, g, t);
             __syncwarp();
             const float4* src = reinterpret_cast<const float4*>(slot);
             float4* dst = reinterpret_cast<float4*>(out + (size_t)win * WIN);
             for (int f = lane; f < WIN4; f += 32) dst[f] = src[f];
           });
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

constexpr int MAX_DEVICES = 16;
constexpr int MAX_SLOTS = 64;

size_t phase_smem(int nslots) { return (size_t)nslots * PHASE_BAND * 4; }

// Blocks of P2 (roll = 0) or P3 (roll = 1) that fit on one SM, or -1 on an
// error. The largest shared-memory size is allowed once per process and
// device, and the answer is kept per (device, kernel, nslots, warps).
int phase_blocks_per_sm(int nslots, int warps, int roll) {
  static bool allowed[MAX_DEVICES][2];
  static int known[MAX_DEVICES][2][MAX_SLOTS + 1][MAX_WARPS + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || warps < 1 || warps > MAX_WARPS) return -1;
  const void* kernel = roll ? (const void*)phase_roll_kernel : (const void*)phase_mxu_kernel;
  const bool cached = dev < MAX_DEVICES && nslots <= MAX_SLOTS;
  if (cached && known[dev][roll][nslots][warps] > 0) return known[dev][roll][nslots][warps];
  if (!(dev < MAX_DEVICES && allowed[dev][roll])) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin) !=
            cudaSuccess)
      return -1;
    if (dev < MAX_DEVICES) allowed[dev][roll] = true;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, warps * 32,
                                                    phase_smem(nslots)) !=
      cudaSuccess)
    return -1;
  if (cached) known[dev][roll][nslots][warps] = blocks;
  return blocks;
}

int sm_count() {
  static int known[MAX_DEVICES];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < MAX_DEVICES && known[dev]) return known[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (dev < MAX_DEVICES) known[dev] = n;
  return n;
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

// Blocks per SM of P2 (roll = 0) or P3 (roll = 1); 0 where none fits, -1
// on an error.
extern "C" int tvo_phase_windows_blocks_per_sm(int nslots, int warps, int roll) {
  return phase_blocks_per_sm(nslots, warps, roll);
}

// img: (B, H, W) f32, the caller's level; ys, xs: (B, N) int32; out:
// (B, N, 48, 43) f32, 16-B aligned. roll = 0: P2 (one-hot products);
// roll = 1: P3 (roll and row offset). `warps` warps per block.
extern "C" int tvo_phase_windows(const void* img, const void* ys, const void* xs, void* out,
                                 int B, int H, int W, int N, int kp_chunk, int nslots,
                                 int warps, int roll, void* stream) {
  const int per_sm = phase_blocks_per_sm(nslots, warps, roll), sms = sm_count();
  if (per_sm < 0 || sms < 0) return (int)cudaErrorInvalidValue;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const int total = B * N, chunks = (total + kp_chunk - 1) / kp_chunk;
  const int blocks = min(chunks, per_sm * sms);
  const size_t smem = phase_smem(nslots);
  auto kernel = roll ? phase_roll_kernel : phase_mxu_kernel;
  kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)img, (const int*)ys, (const int*)xs, (float*)out, H, W, N, total,
      kp_chunk, nslots, warps);
  return (int)cudaGetLastError();
}
