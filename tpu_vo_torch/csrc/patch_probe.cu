// Kernels P1, P2 and P3: keypoint windows staged through shared memory
// with slots in flight.
//
// Replace the three Pallas kernels of tools/patch_slots_probe.py, the
// probe that chose kernel B2's design: P1 `build` (body `_kernel`), P2
// `build_v2` (body `_v2_kernel`) and P3 `build_v3` (body `_v3_kernel`).
// Each gives keypoint k of frame b the (48, 43) f32 window that the TPU
// kernel cuts out of a band of the level; the plain versions and the
// index formulas are in ops/patch_probe.py.
//
// All three share one pipeline, built for this card:
//
// - What bounds them: bytes. Each window is 8,256 B out, and the level
//   pixels the windows cover come in once: 45.5 MB for the probe's 4096
//   windows, 0.0137 ms at 3.35 TB/s (P1's windows cover 45.5 MB too).
// - One warp per window, one slot per warp. A block of min(NSLOTS, 8)
//   warps walks chunks of KP_CHUNK keypoints (a persistent grid: as many
//   blocks as fit on the SMs, each taking chunk after chunk); keypoint j
//   of a chunk goes to warp j mod warps, and each warp owns NSLOTS /
//   warps slots. A warp refills its slot itself once it is done with it,
//   so no block-wide barrier runs per window: a __syncwarp, then the next
//   window's copies. The copies are cp.async (each thread's own copy, not
//   the asynchronous proxy, so no proxy fence comes before a refill), one
//   commit group per slot fill; cp.async.wait_group keeps a warp's other
//   slots in flight while it waits for the oldest. On an H100, 8 warps
//   with a slot each beat 4 warps with two: these kernels wait on
//   latency, and more warps hide more of it.
// - No padded copy of the level: the kernels read the caller's level,
//   and cp.async's source size zero-fills what lies past it.
// - The window leaves in 16-B stores, 516 float4s of its contiguous 8,256
//   B.
//
// P1 stages what the window reads, not the TPU kernel's whole (56,
// lanes) band (57,344 B at 256 lanes, of which 4 slots filled a block):
// element (r, j) of the window, in the window's own order, so a slot is
// the 8,256-B window and 28 fit in a block. The level pixel it holds is
// the TPU kernel's (`BandWindow`): row r0 + r with `compact` (r8 + r
// without); column c + j, less `lanes` where the roll wraps (coff + j >=
// lanes, at 128 lanes: the window's columns are then two runs of the
// level). No element reaches the TPU kernel's padding (rows stay below
// r0 + 48 <= H since r8 <= r0, columns below floor128(c0) + 43 <= W); a
// copy past the level would zero-fill all the same. A lane copies
// elements lane, lane + 32, ... by 4-B cp.async, its row and column
// advanced by adding, not dividing (rows of the level start at any 4-B
// boundary, so 16-B copies would need the pad back); the slot then goes
// out as it is.
//
// P2 and P3 copy a (48, 128) band per window:
//
// - The bands the probe varies keep the TPU kernels' 48 x 128 f32 (24,576
//   B a slot); they come from L2, 100 MB a call, three times the windows'
//   bytes. Band rows never pass the level (r0 <= H - 48), but band columns
//   may pass W; cp.async's source size zero-fills them, which P2 needs
//   (its products multiply them by 0, and 0 x NaN is not 0). A band row
//   whose start is 16-B aligned comes in as 32 16-B copies, any other row
//   as 128 4-B copies: the level's pitch (1241 floats) leaves 3 rows in 4
//   unaligned, so a bulk or tensor copy would need the pad back. (Copying
//   each row's aligned 132-float superset in 16-B pieces was slower.)
// - A slot's 16-B chunks are XOR-swizzled by row (chunk q of row n at
//   q ^ 4 (n & 1)), so that P2's 16-B fragment loads (4 lanes per row, 2
//   rows per quarter-warp) hit 32 distinct banks.
// - The rows past 48 - (r0 & 3) are written as zeros. P3 reads each
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
constexpr int BAND_ROWS = 56;      // the TPU kernel P1's band rows
constexpr int PHASE_LANES = 128;   // P2's and P3's band columns
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

// The slot pipeline of one warp: its slots are the block's slots warp,
// warp + warps, ... of `slot_floats` floats each; `copy(slot, win)` (all
// 32 lanes) issues the copies of window win into slot, and `emit(win,
// slot)` writes window win once they have arrived, and may then use the
// slot as scratch. A group is committed for every slot refill, empty or
// not, so that the oldest fill is always `nmine - 1` groups back.
template <class Copy, class Emit>
__device__ __forceinline__ void run_warp(float* slots, int slot_floats, int total, int kp_chunk,
                                         int nslots, int warps, Copy copy, Emit emit) {
  const int warp = threadIdx.x >> 5;
  const int nmine = (nslots - warp + warps - 1) / warps;  // this warp's slots
  Walk fill{(int)blockIdx.x, warp}, use = fill;
  for (int i = 0; i < nmine; ++i) {
    if (fill.valid(kp_chunk, total)) {
      copy(slots + (size_t)(warp + i * warps) * slot_floats, fill.window(kp_chunk));
      fill.next(warp, warps, kp_chunk, total);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int i = 0; use.valid(kp_chunk, total); i = (i + 1 == nmine) ? 0 : i + 1) {
    float* slot = slots + (size_t)(warp + i * warps) * slot_floats;
    wait_groups(nmine - 1);
    __syncwarp();
    emit(use.window(kp_chunk), slot);
    __syncwarp();  // every lane is done with the slot
    if (fill.valid(kp_chunk, total)) {
      copy(slot, fill.window(kp_chunk));
      fill.next(warp, warps, kp_chunk, total);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    use.next(warp, warps, kp_chunk, total);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// P1's window source: element (r, j) of keypoint (y, x)'s window is the
// TPU kernel's band element, level pixel (row + r, col + j), less `lanes`
// columns from j = wrap on (the roll wraps at lanes: at 128 lanes on most
// keypoints), 0 past the level (never reached). The band starts at column cc = min(c128,
// (W / 128 + 1) * 128 - lanes); the clamp leaves the roll by coff = c0 -
// c128 as it is, so near the right edge the window comes out shifted
// left, as the TPU kernel's does. With compact the window sits at row r0
// of the level; without, it is the band's top-left (48, 43), from row r8
// = clip(floor8(r0), 0, hp - 56) with hp = max(ceil8(H), 56).
struct BandWindow {
  int row, col, wrap;
  __device__ BandWindow(int y, int x, int H, int W, int lanes, int compact) {
    const int r0 = clampi(y - R, 0, H - ROWS), c0 = clampi(x - R, 0, W - S);
    const int c128 = c0 & ~127, cc = min(c128, (W / 128 + 1) * 128 - lanes);
    const int hp = max((H + 7) & ~7, BAND_ROWS);
    const int coff = compact ? c0 - c128 : 0;
    row = compact ? r0 : clampi(r0 & ~7, 0, max(hp - BAND_ROWS, 0));
    col = cc + coff;
    wrap = lanes - coff;
  }
};

// P1: the window's 2064 elements into the slot in the window's order
// (element e = 43 r + j at e), then out by 16-B stores.
__global__ void __launch_bounds__(MAX_WARPS * 32)
band_kernel(const float* __restrict__ img, const int* __restrict__ ys,
            const int* __restrict__ xs, float* __restrict__ out, int H, int W, int N, int total,
            int kp_chunk, int nslots, int warps, int compact, int lanes) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* slots = reinterpret_cast<float*>(smem_raw);
  const int lane = threadIdx.x & 31;
  run_warp(
      slots, WIN, total, kp_chunk, nslots, warps,
      [&](float* slot, int win) {
        const BandWindow p(ys[win], xs[win], H, W, lanes, compact);
        const float* level = img + (size_t)(win / N) * H * W;
        const uint32_t base = smem_addr(slot);
        int r = 0, j = lane;  // element e = (r, j): j < 43, and 32 < 43 wraps j once at most
        for (int e = lane; e < WIN; e += 32) {
          const int gy = p.row + r, gx = p.col + j - (j >= p.wrap ? lanes : 0);
          const bool in = gy < H && gx < W;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(base + 4u * e),
                       "l"(in ? level + (size_t)gy * W + gx : level), "r"(in ? 4 : 0)
                       : "memory");
          j += 32;
          if (j >= S) {
            j -= S;
            ++r;
          }
        }
      },
      [&](int win, const float* slot) {
        const float4* src = reinterpret_cast<const float4*>(slot);
        float4* dst = reinterpret_cast<float4*>(out + (size_t)win * WIN);
        for (int f = lane; f < WIN4; f += 32) dst[f] = src[f];
      });
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
  run_warp(slots, PHASE_BAND, total, kp_chunk, nslots, warps,
           [&](float* slot, int win) { copy_band(slot, img, ys, xs, win, H, W, N, lane); },
           [&](int win, const float* slot) {
             const PhaseBand p(ys[win], xs[win], H, W);
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
  run_warp(slots, PHASE_BAND, total, kp_chunk, nslots, warps,
           [&](float* slot, int win) { copy_band(slot, img, ys, xs, win, H, W, N, lane); },
           [&](int win, float* slot) {
             const PhaseBand p(ys[win], xs[win], H, W);
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

constexpr int MAX_DEVICES = 16;
constexpr int MAX_SLOTS = 64;
constexpr int NKERNELS = 3;  // 0: P2, 1: P3, 2: P1

const void* window_kernel(int k) {
  return k == 0 ? (const void*)phase_mxu_kernel
                : k == 1 ? (const void*)phase_roll_kernel : (const void*)band_kernel;
}

// Shared memory of a block of kernel k with nslots slots: P2's and P3's
// slots hold a (48, 128) band, P1's a (48, 43) window.
size_t window_smem(int k, int nslots) { return (size_t)nslots * 4 * (k == 2 ? WIN : PHASE_BAND); }

// Blocks of kernel k that fit on one SM of the current device, or -1 on an
// error. The largest shared-memory size is allowed once per process and
// device, and the answer is kept per (device, kernel, nslots, warps).
int blocks_per_sm(int k, int nslots, int warps) {
  static bool allowed[MAX_DEVICES][NKERNELS];
  static int known[MAX_DEVICES][NKERNELS][MAX_SLOTS + 1][MAX_WARPS + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || k < 0 || k >= NKERNELS || warps < 1 ||
      warps > MAX_WARPS || nslots < 1)
    return -1;
  const void* kernel = window_kernel(k);
  const bool cached = dev < MAX_DEVICES && nslots <= MAX_SLOTS;
  if (cached && known[dev][k][nslots][warps] > 0) return known[dev][k][nslots][warps];
  if (!(dev < MAX_DEVICES && allowed[dev][k])) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin) !=
            cudaSuccess)
      return -1;
    if (dev < MAX_DEVICES) allowed[dev][k] = true;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, warps * 32,
                                                    window_smem(k, nslots)) != cudaSuccess)
    return -1;
  if (cached) known[dev][k][nslots][warps] = blocks;
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

// The persistent grid of kernel k: as many blocks as fit on the SMs, at
// most one per chunk of kp_chunk windows; 0 where none fits, -1 on an
// error.
int persistent_blocks(int k, int total, int kp_chunk, int nslots, int warps) {
  const int per_sm = blocks_per_sm(k, nslots, warps), sms = sm_count();
  if (per_sm <= 0 || sms < 0) return per_sm < 0 || sms < 0 ? -1 : 0;
  return min((total + kp_chunk - 1) / kp_chunk, per_sm * sms);
}

int launch_error(int blocks) {
  return blocks < 0 ? (int)cudaErrorInvalidValue : (int)cudaErrorInvalidConfiguration;
}

}  // namespace

// Blocks per SM of P2 (kernel = 0), P3 (1) or P1 (2); 0 where none fits,
// -1 on an error.
extern "C" int tvo_windows_blocks_per_sm(int kernel, int nslots, int warps) {
  return blocks_per_sm(kernel, nslots, warps);
}

// P1. img: (B, H, W) f32, the caller's level; ys, xs: (B, N) int32; out:
// (B, N, 48, 43) f32, 16-B aligned. `warps` warps per block.
extern "C" int tvo_band_windows(const void* img, const void* ys, const void* xs, void* out,
                                int B, int H, int W, int N, int kp_chunk, int nslots, int warps,
                                int compact, int lanes, void* stream) {
  const int total = B * N, blocks = persistent_blocks(2, total, kp_chunk, nslots, warps);
  if (blocks <= 0) return launch_error(blocks);
  band_kernel<<<blocks, warps * 32, window_smem(2, nslots), (cudaStream_t)stream>>>(
      (const float*)img, (const int*)ys, (const int*)xs, (float*)out, H, W, N, total, kp_chunk,
      nslots, warps, compact, lanes);
  return (int)cudaGetLastError();
}

// P2 and P3. img: (B, H, W) f32, the caller's level; ys, xs: (B, N) int32;
// out: (B, N, 48, 43) f32, 16-B aligned. roll = 0: P2 (one-hot products);
// roll = 1: P3 (roll and row offset). `warps` warps per block.
extern "C" int tvo_phase_windows(const void* img, const void* ys, const void* xs, void* out,
                                 int B, int H, int W, int N, int kp_chunk, int nslots,
                                 int warps, int roll, void* stream) {
  const int total = B * N, blocks = persistent_blocks(roll, total, kp_chunk, nslots, warps);
  if (blocks <= 0) return launch_error(blocks);
  auto kernel = roll ? phase_roll_kernel : phase_mxu_kernel;
  kernel<<<blocks, warps * 32, window_smem(roll, nslots), (cudaStream_t)stream>>>(
      (const float*)img, (const int*)ys, (const int*)xs, (float*)out, H, W, N, total,
      kp_chunk, nslots, warps);
  return (int)cudaGetLastError();
}
