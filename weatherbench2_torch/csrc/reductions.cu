// Fused multi-region weighted reductions for Hopper (sm_90a), plain C ABI.
//
// Both kernels reduce rows of per-cell statistics against a small (R, L)
// region-weight matrix W (area weight x region mask, R <= 16):
//
//   sums[s, r, b] = sum_l stat_s[b, l] * W[r, l]
//
// Kernel 1 replaces weatherbench2_tpu/ops/reductions.py:_fused_kernel
// (fused_deterministic_sums). For (B, L) forecast f, truth t and
// climatology c it produces 8 statistics per (region, row), over cells
// where none of f, t, c is NaN, with a = f - c, c' = t - c:
//   0..5: sum W.(f-t), W.(f-t)^2, W.|f-t|, W.a.c', W.a^2, W.c'^2
//   6:    sum W.valid                (wsum_valid)
//   7:    sum (W > 0).isnan(f|t|c)   (nan_w; weighted by W > 0, not W)
// Without a climatology (c == nullptr) it computes the same function with
// c = 0 and does not read a third array: the main path's deterministic
// tier has no climatology, so this cuts its bytes by a third.
//
// Kernel 2 replaces weatherbench2_tpu/ops/reductions.py:_region_sums_kernel
// (fused_region_sums). For (N, L) rows x, each row with its own NaN mask:
//   0: sum W.x0   1: sum W.valid   2: sum (W > 0).isnan(x)
//
// Bound on the card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 on the CUDA
// cores, 495 TFLOP/s TF32 on the tensor cores). Per cell, kernel 1 reads 8
// bytes (12 with a climatology) and does 8R multiply-adds; kernel 2 reads 4
// bytes and does 3R. With up to four regions both are memory-bound by a wide
// margin. At the official thirteen regions the fp32 multiply-adds alone
// (104 per 12 bytes) would take as long on the CUDA cores as the bytes take
// to arrive, and 8 x 16 accumulators a thread leave one block resident per
// SM. So the 16-byte paths come as two cores, chosen by the Python wrapper:
//
//  * CUDA-core core (pass1_vec4; R <= 4 only: kernel 1 on the wrapper's
//    plan, kernel 2 as the baseline its tensor-core core is timed against).
//    One warp per row, eight rows per block; a lane covers four cells per step with
//    16-byte loads, the next step's loads started before this step's
//    arithmetic; the block's rows share a double-buffered shared-memory
//    copy of each (4, 128-cell) tile of W; NSTAT x 4 sums a thread,
//    reduced over the 32 lanes by a fixed xor-shuffle tree.
//  * Tensor-core core (pass1_mma; R > 4, and kernel 2 at any R, where it
//    is the faster one at three regions too). Both kernels are the skinny
//    product out[16 regions, rows] = W[16, cells] . stat[cells, rows], so
//    one mma.sync.m16n8k8 (TF32 in, fp32 out) takes W's (16, 8 cells) as A
//    and one statistic of 8 cells x 8 rows as B; a thread holds 4 sums per
//    statistic instead of 16. Precision: every operand that is not exactly
//    a TF32 number is split, v = hi + lo with hi = tf32(v) and lo =
//    v - hi (of which the tensor core reads the upper 19 bits), and W.s
//    is the three products Wlo.shi + Whi.slo + Whi.shi (3xTF32); the 0/1
//    masks are exact, so the valid-weight sum takes Whi and Wlo and the
//    NaN-hit sum takes (W > 0) alone. The tensor
//    core does not round its running sum to nearest, so a chain of MMAs
//    runs for one 32-cell stage only (12 MMAs into a zeroed accumulator),
//    which is then added to the thread's fp32 sum on the CUDA cores.
//    The statistics themselves are fp32 on the CUDA cores (stats_of).
//    Range: the split is of finite numbers. An infinite statistic (an
//    infinite input, or a square that overflows) has hi = inf and lo = NaN,
//    so this core's sums of that (statistic, row) come out NaN in every
//    region, where an fp32 matmul (and the CUDA-core cores) give +-inf in
//    the regions whose positive weights meet infinities of one sign and
//    NaN elsewhere (0 x inf). So nonfinite_fixup, after pass 2, tests each
//    row's sums (a thread a row) and redoes the rows with a sum that is
//    not finite, all threads of the row's block together: each statistic
//    that is not finite there gets, region by region, the value fp32
//    gives. Every region of such a statistic is +-inf or NaN (a region
//    either holds the cell or weighs it zero), so no finite sum is lost.
//    Passes 1 and 2 are not changed by it. A finite sum that overflows, or
//    a weight within 2^-12 of the largest float, is not repaired: weights
//    and fields of this framework are far from either.
//    Layout: the cell index is summed over, so any assignment of cells to
//    k works if A and B agree. A lane (g = lane / 4, tig = lane % 4) reads
//    the four cells 16j + 4tig .. +3 of row g with one 16-byte load (four
//    lanes cover 64 contiguous bytes of a row, a warp eight rows) and uses
//    them as k = tig, tig + 4 of two MMA steps: no transposition and no
//    cross-lane traffic for the data. The loads are cp.async (16 bytes,
//    .cg, with an L2 hint that fetches the row's next stage too) into a
//    ring of four stages in dynamic shared memory that is private to each
//    thread (it reads back only what it copied), so data needs
//    cp.async.wait_group and no barrier. W is shared: per stage, two
//    warps load the (16, 32-cell) tile one stage ahead into registers,
//    split it once and store Whi, Wlo and (W > 0) to shared memory in
//    fragment order (one conflict-free 16-byte read per fragment); the one
//    barrier per stage orders those stores. A block of eight warps holds
//    64 rows (kernel 1) or 128 rows (kernel 2, two 8-row tiles a warp), so
//    at 0.25 degrees W crosses L2 twice or once, not sixteen times.
//  * Any L or alignment that the 16-byte paths cannot take goes to
//    pass1_scalar: one cell per lane step, 4-byte loads, any R.
//  * In every core a block covers one slice [l0, l1) of the cell axis and
//    writes partial[split, stat, r, row]; pass 2 sums the splits of each
//    output in a fixed order. No floating-point atomics: the same inputs
//    give the same bits on every run. The wrapper picks the number of
//    splits so that the grid fills the 132 SMs even for 126 rows.
//  * Columns past L and rows past B contribute nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block in pass 1
constexpr unsigned kFull = 0xffffffffu;

// KIND 0: deterministic with climatology, 1: deterministic without,
// 2: generic region sums.
template <int KIND>
struct Stats {
  static constexpr int N = KIND == 2 ? 3 : 8;
};

// The statistics of one cell (f, t, c; or x in a, for KIND 2).
template <int KIND>
__device__ __forceinline__ void stats_of(float f, float t, float cl,
                                         float (&s)[Stats<KIND>::N]) {
  if constexpr (KIND == 2) {
    const bool nan = isnan(f);
    s[0] = nan ? 0.f : f;
    s[1] = nan ? 0.f : 1.f;
    s[2] = nan ? 1.f : 0.f;
  } else {
    const bool nan = isnan(f) || isnan(t) || isnan(cl);
    if (nan) {
      f = 0.f;
      t = 0.f;
      cl = 0.f;
    }
    const float d = f - t;
    const float an = f - cl;
    const float cn = t - cl;
    s[0] = d;
    s[1] = d * d;
    s[2] = fabsf(d);
    s[3] = an * cn;
    s[4] = an * an;
    s[5] = cn * cn;
    s[6] = nan ? 0.f : 1.f;
    s[7] = nan ? 1.f : 0.f;
  }
}

// acc[k][r] += s[k] * W (the NaN-hit row by W > 0), region r of RP.
template <int NS, int RP>
__device__ __forceinline__ void accumulate(float (&acc)[NS][RP],
                                           const float (&s)[NS], float wr,
                                           int r) {
  const float wp = wr > 0.f ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) acc[k][r] = fmaf(s[k], wr, acc[k][r]);
  acc[NS - 1][r] = fmaf(s[NS - 1], wp, acc[NS - 1][r]);
}

// The 32 lanes' sums of each (stat, region) by a fixed xor tree; lane 0
// writes partial[split, stat, r, row].
template <int NS, int RP>
__device__ __forceinline__ void write_partials(float (&acc)[NS][RP],
                                               int lane, int split, int row,
                                               int rows, int R,
                                               float* __restrict__ partial) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      if (r < R) {
        float v = acc[k][r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(kFull, v, off);
        if (lane == 0)
          partial[((static_cast<int64_t>(split) * NS + k) * R + r) * rows +
                  row] = v;
      }
    }
  }
}

// Pass 1, one cell per lane step: any L, any alignment.
template <int KIND, int RP>
__global__ void __launch_bounds__(kWarps * 32)
pass1_scalar(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, const float* __restrict__ w,
             int rows, int64_t L, int R, int64_t split_len,
             float* __restrict__ partial) {
  constexpr int NS = Stats<KIND>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int split = blockIdx.y;
  if (row >= rows) return;  // whole warp: no block-wide barrier follows
  const int64_t l0 = split * split_len;
  const int64_t l1 = min(L, l0 + split_len);
  const int64_t base = static_cast<int64_t>(row) * L;

  float acc[NS][RP];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[k][r] = 0.f;

  for (int64_t l = l0 + lane; l < l1; l += 32) {
    const float f = __ldg(a + base + l);
    const float t = KIND == 2 ? 0.f : __ldg(b + base + l);
    const float cl = KIND == 0 ? __ldg(c + base + l) : 0.f;
    float s[NS];
    stats_of<KIND>(f, t, cl, s);
#pragma unroll
    for (int r = 0; r < RP; ++r)
      if (r < R) accumulate(acc, s, __ldg(w + r * L + l), r);
  }
  write_partials(acc, lane, split, row, rows, R, partial);
}

// Pass 1, four cells per lane step with 16-byte loads, for L % 4 == 0 and
// aligned arrays. A block step covers 128 cells of its eight rows: the
// step's (RP, 128) tile of W is loaded once into shared memory (double
// buffered, the next tile loading while this one is used) and read by all
// eight warps, and each warp starts its next step's data loads before this
// step's arithmetic.
template <int KIND, int RP>
__global__ void __launch_bounds__(kWarps * 32)
pass1_vec4(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, const float* __restrict__ w,
           int rows, int64_t L, int R, int64_t split_len,
           float* __restrict__ partial) {
  constexpr int NS = Stats<KIND>::N;
  __shared__ float4 wtile[2][RP][32];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int split = blockIdx.y;
  const bool active = row < rows;  // idle warps still load W and sync
  const int64_t L4 = L >> 2;
  const int64_t q0 = (split * split_len) >> 2;  // split_len % 128 == 0
  const int64_t q1 = min(L4, q0 + (split_len >> 2));
  const int n_steps = static_cast<int>((q1 - q0 + 31) / 32);
  const int64_t base = static_cast<int64_t>(active ? row : 0) * L4;
  const float4* __restrict__ a4 = reinterpret_cast<const float4*>(a) + base;
  const float4* __restrict__ b4 =
      KIND == 2 ? nullptr : reinterpret_cast<const float4*>(b) + base;
  const float4* __restrict__ c4 =
      KIND == 0 ? reinterpret_cast<const float4*>(c) + base : nullptr;
  const float4* __restrict__ w4 = reinterpret_cast<const float4*>(w);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  auto load_w = [&](int step, int buf) {
    for (int i = threadIdx.x; i < RP * 32; i += kWarps * 32) {
      const int r = i >> 5;
      const int64_t q = q0 + step * 32 + (i & 31);
      wtile[buf][r][i & 31] = (r < R && q < q1) ? __ldg(w4 + r * L4 + q)
                                                : zero;
    }
  };
  auto load_data = [&](int64_t q, float4& va, float4& vb, float4& vc) {
    va = vb = vc = zero;
    if (active && q < q1) {
      va = __ldg(a4 + q);
      if constexpr (KIND != 2) vb = __ldg(b4 + q);
      if constexpr (KIND == 0) vc = __ldg(c4 + q);
    }
  };

  float acc[NS][RP];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[k][r] = 0.f;

  float4 va, vb, vc;
  load_w(0, 0);
  load_data(q0 + lane, va, vb, vc);
  __syncthreads();
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    const int64_t q = q0 + step * 32 + lane;
    float4 na, nb, nc;
    load_data(q + 32, na, nb, nc);
    if (step + 1 < n_steps) load_w(step + 1, buf ^ 1);
    if (active && q < q1) {
      float s[4][NS];
      stats_of<KIND>(va.x, vb.x, vc.x, s[0]);
      stats_of<KIND>(va.y, vb.y, vc.y, s[1]);
      stats_of<KIND>(va.z, vb.z, vc.z, s[2]);
      stats_of<KIND>(va.w, vb.w, vc.w, s[3]);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        if (r < R) {
          const float4 wv = wtile[buf][r][lane];
          accumulate(acc, s[0], wv.x, r);
          accumulate(acc, s[1], wv.y, r);
          accumulate(acc, s[2], wv.z, r);
          accumulate(acc, s[3], wv.w, r);
        }
      }
    }
    va = na;
    vb = nb;
    vc = nc;
    // this tile read and the next one written before either is reused
    __syncthreads();
  }
  if (active) write_partials(acc, lane, split, row, rows, R, partial);
}

// ---------------------------------------------------------------------------
// Tensor-core core (see the header). Geometry of one block:
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kStages = 4;               // depth of the cp.async ring
constexpr int kRegionTiles = 2;          // 8-row tiles a warp of kernel 2
constexpr int kStageCells = 32;          // cells per pipeline stage
constexpr int kJ = kStageCells / 16;     // 16-byte steps a lane per stage
constexpr int kWFragF4 = 3 * kJ * 2 * 32;  // Whi, Wlo, W>0 of one stage
// Stages between two flushes of the MMA accumulators into the fp32 sums.
// One is what ships; kernel_lab.py builds longer chains to record the
// error that each leaves against float64 sums.
#ifndef WB2_CHAIN_STAGES
#define WB2_CHAIN_STAGES 1
#endif

template <int KIND>
struct Mma {
  // 8-row tiles per warp
  static constexpr int NT = KIND == 2 ? kRegionTiles : 1;
  static constexpr int NARR = KIND == 0 ? 3 : KIND == 1 ? 2 : 1;
  static constexpr int STAGES = kStages;
  static constexpr int ROWS = kMmaWarps * 8 * NT;  // rows per block
  static constexpr int STAGE_F4 = NARR * kJ * NT * kMmaThreads;
  static constexpr size_t SMEM = (STAGES * STAGE_F4 + 2 * kWFragF4) * 16;
};

// v = hi + lo. hi is v rounded to TF32 (nearest, ties away from zero: an
// integer add and mask, which rounds as cvt.rna.tf32.f32 does and is the
// cheaper instruction); v - hi is exact in fp32, and the tensor core reads
// its upper 19 bits. Finite v only: see "Range" in the header.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += A(16x8, row) . B(8x8, col), TF32 operands, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; n = 0 writes zeros instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // the L2 hint fetches the row's next 128 bytes (the next stage) too
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int KIND>
__global__ void __launch_bounds__(kMmaThreads, 2)
pass1_mma(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ c, const float* __restrict__ w,
          int rows, int64_t L, int R, int64_t split_len,
          float* __restrict__ partial) {
  using M = Mma<KIND>;
  constexpr int NS = Stats<KIND>::N;
  constexpr int NT = M::NT;
  extern __shared__ float4 smem[];
  float4* const ring = smem;
  uint4* const wfrag = reinterpret_cast<uint4*>(smem + M::STAGES * M::STAGE_F4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * M::ROWS + (tid >> 5) * 8 * NT;
  const bool warp_active = row0 < rows;
  const int64_t l0 = split * split_len;  // split_len % kStageCells == 0
  const int64_t l1 = min(L, l0 + split_len);
  const int n_it = static_cast<int>((l1 - l0 + kStageCells - 1) / kStageCells);
  const float* const arrs[3] = {a, b, c};

  // This thread's 16-byte pieces of stage s, into ring slot s % STAGES.
  auto prefetch = [&](int s) {
    if (s < n_it) {
      float4* const slot = ring + (s % M::STAGES) * M::STAGE_F4 + tid;
      const int64_t cell = l0 + static_cast<int64_t>(s) * kStageCells + 4 * tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = row0 + nt * 8 + g;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int64_t cj = cell + 16 * j;
          const bool ok = row < rows && cj < l1;
          const int64_t off = ok ? static_cast<int64_t>(row) * L + cj : 0;
#pragma unroll
          for (int arr = 0; arr < M::NARR; ++arr)
            cp_async16(slot + ((arr * kJ + j) * NT + nt) * kMmaThreads,
                       arrs[arr] + off, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();  // one group per stage, empty past the end
  };

  // W's (16, 32-cell) tile of stage s: threads 0..63 each load regions g
  // and g + 8 of four cells, split them and store them in fragment order.
  float4 wa, wb;
  auto load_w = [&](int s) {
    wa = wb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < 32 * kJ && s < n_it) {
      const int64_t cell = l0 + static_cast<int64_t>(s) * kStageCells +
                           16 * (tid >> 5) + 4 * tig;
      if (cell < l1) {
        if (g < R)
          wa = __ldg(reinterpret_cast<const float4*>(w + g * L + cell));
        if (g + 8 < R)
          wb = __ldg(reinterpret_cast<const float4*>(w + (g + 8) * L + cell));
      }
    }
  };
  auto store_w = [&](int s) {
    if (tid < 32 * kJ) {
      uint4* const dst =
          wfrag + (s & 1) * kWFragF4 + (tid >> 5) * 2 * 32 + lane;
      const float v[2][4] = {{wa.x, wb.x, wa.y, wb.y},
                             {wa.z, wb.z, wa.w, wb.w}};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t hi[4], lo[4], pos[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(v[ks][i], hi[i], lo[i]);
          pos[i] = v[ks][i] > 0.f ? 0x3f800000u : 0u;
        }
        dst[(0 * kJ * 2 + ks) * 32] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        dst[(1 * kJ * 2 + ks) * 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        dst[(2 * kJ * 2 + ks) * 32] =
            make_uint4(pos[0], pos[1], pos[2], pos[3]);
      }
    }
  };

  float sum[NT][NS][4];   // fp32 sums, added to on the CUDA cores
  float chain[NT][NS][4]; // MMA accumulators of the running chain
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[nt][k][i] = chain[nt][k][i] = 0.f;

#pragma unroll
  for (int s = 0; s < M::STAGES - 1; ++s) prefetch(s);
  load_w(0);
  store_w(0);

  for (int it = 0; it < n_it; ++it) {
    load_w(it + 1);
    prefetch(it + M::STAGES - 1);
    cp_async_wait<M::STAGES - 1>();  // this thread's pieces of stage `it`
    __syncthreads();  // W of stage `it` stored; W of stage it - 1 read
    if (warp_active) {
      const float4* const slot = ring + (it % M::STAGES) * M::STAGE_F4 + tid;
      const uint4* const wf = wfrag + (it & 1) * kWFragF4 + lane;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint4 whi = wf[(0 * kJ * 2 + j * 2 + ks) * 32];
          const uint4 wlo = wf[(1 * kJ * 2 + j * 2 + ks) * 32];
          const uint4 wpos = wf[(2 * kJ * 2 + j * 2 + ks) * 32];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float4 va = slot[((0 * kJ + j) * NT + nt) * kMmaThreads];
            float4 vb = va, vc = va;
            if constexpr (KIND != 2)
              vb = slot[((1 * kJ + j) * NT + nt) * kMmaThreads];
            if constexpr (KIND == 0)
              vc = slot[((2 * kJ + j) * NT + nt) * kMmaThreads];
            float s0[NS], s1[NS];
            stats_of<KIND>(ks ? va.z : va.x, ks ? vb.z : vb.x,
                           KIND == 0 ? (ks ? vc.z : vc.x) : 0.f, s0);
            stats_of<KIND>(ks ? va.w : va.y, ks ? vb.w : vb.y,
                           KIND == 0 ? (ks ? vc.w : vc.y) : 0.f, s1);
            const uint32_t v0 = __float_as_uint(s0[NS - 2]);
            const uint32_t v1 = __float_as_uint(s1[NS - 2]);
#pragma unroll
            for (int k = 0; k < NS - 2; ++k) {
              uint32_t h0, h1, e0, e1;
              split_tf32(s0[k], h0, e0);
              split_tf32(s1[k], h1, e1);
              mma_tf32(chain[nt][k], wlo, h0, h1);
              mma_tf32(chain[nt][k], whi, e0, e1);
              mma_tf32(chain[nt][k], whi, h0, h1);
            }
            // 0/1 masks are exact in TF32
            mma_tf32(chain[nt][NS - 2], wlo, v0, v1);
            mma_tf32(chain[nt][NS - 2], whi, v0, v1);
            mma_tf32(chain[nt][NS - 1], wpos, __float_as_uint(s0[NS - 1]),
                     __float_as_uint(s1[NS - 1]));
          }
        }
      }
      if ((it + 1) % WB2_CHAIN_STAGES == 0 || it + 1 == n_it) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int k = 0; k < NS; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              sum[nt][k][i] += chain[nt][k][i];
              chain[nt][k][i] = 0.f;
            }
      }
    }
    store_w(it + 1);  // its slot was last read in stage it - 1
  }

  // sum[nt][k][i]: region g (i < 2) or g + 8, row 2 tig + (i & 1) of tile nt
  if (warp_active) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + (i >> 1) * 8;
          const int row = row0 + nt * 8 + 2 * tig + (i & 1);
          if (r < R && row < rows)
            partial[((static_cast<int64_t>(split) * NS + k) * R + r) * rows +
                    row] = sum[nt][k][i];
        }
  }
}

// Pass 2: out[i] = sum over splits of partial[split, i], in split order.
__global__ void pass2(const float* __restrict__ partial, int n_splits,
                      int64_t n_out, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n_out) return;
  // eight loads in flight, added in split order
  float acc = 0.f;
  int s = 0;
  for (; s + 8 <= n_splits; s += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __ldg(partial + (s + u) * n_out + i);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; s < n_splits; ++s) acc += __ldg(partial + s * n_out + i);
  out[i] = acc;
}

// The rows of a tensor-core launch with a sum that is not finite, redone as
// fp32 gives them (see the header). A thread tests one row's sums (out is
// (stats, R, rows): a warp reads 32 consecutive rows of each), then the
// block's threads redo each of its marked rows together, classifying the
// row's cells. Bits per weighted statistic: r for an infinity of either
// sign or a NaN statistic meeting region r's weight where fp32 makes NaN
// of it (a NaN statistic, or a zero weight), and r, 16 + r for +inf, -inf
// meeting a positive weight.
constexpr int kFixupThreads = 256;

template <int KIND>
__global__ void __launch_bounds__(kFixupThreads)
nonfinite_fixup(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ w,
                int rows, int64_t L, int R, float* __restrict__ out) {
  constexpr int NS = Stats<KIND>::N;
  constexpr int NW = KIND == 2 ? 1 : 6;  // the statistics summed with W
  __shared__ int marked[kFixupThreads];
  __shared__ int n_marked;
  __shared__ unsigned nan_bits[NW], sign_bits[NW];
  if (threadIdx.x == 0) n_marked = 0;
  __syncthreads();
  const int own = blockIdx.x * kFixupThreads + threadIdx.x;
  if (own < rows) {
    bool finite = true;
#pragma unroll 8
    for (int k = 0; k < NS * R; ++k)
      finite &= isfinite(out[static_cast<int64_t>(k) * rows + own]);
    if (!finite) marked[atomicAdd(&n_marked, 1)] = own;
  }
  __syncthreads();
  for (int j = 0; j < n_marked; ++j) {
    const int row = marked[j];
    if (threadIdx.x < NW) {
      nan_bits[threadIdx.x] = 0;
      sign_bits[threadIdx.x] = 0;
    }
    __syncthreads();
    unsigned nb[NW] = {}, sb[NW] = {};
    for (int64_t l = threadIdx.x; l < L; l += blockDim.x) {
      const int64_t i = static_cast<int64_t>(row) * L + l;
      float s[NS];
      stats_of<KIND>(a[i], KIND == 2 ? 0.f : b[i], KIND == 0 ? c[i] : 0.f, s);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (isfinite(s[k])) continue;
        for (int r = 0; r < R; ++r) {
          const float wv = w[static_cast<int64_t>(r) * L + l];
          if (isnan(s[k]) || wv == 0.f) {
            nb[k] |= 1u << r;
          } else {
            sb[k] |= 1u << (s[k] > 0.f ? r : 16 + r);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if (nb[k]) atomicOr(nan_bits + k, nb[k]);
      if (sb[k]) atomicOr(sign_bits + k, sb[k]);
    }
    __syncthreads();
    for (int j2 = threadIdx.x; j2 < NW * R; j2 += blockDim.x) {
      const int k = j2 / R, r = j2 % R;
      const bool nan = (nan_bits[k] >> r) & 1u;
      const bool pos = (sign_bits[k] >> r) & 1u;
      const bool neg = (sign_bits[k] >> (16 + r)) & 1u;
      const float inf = __int_as_float(0x7f800000);
      if (nan || pos || neg)
        out[(static_cast<int64_t>(k) * R + r) * rows + row] =
            nan || (pos && neg) ? __int_as_float(0x7fc00000)
                                : pos ? inf : -inf;
    }
    __syncthreads();  // the shared bits are reset for the next row
  }
}

cudaError_t finish(const float* partial, int n_splits, int64_t n_out,
                   float* out, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  pass2<<<static_cast<unsigned>((n_out + threads - 1) / threads), threads, 0,
          stream>>>(partial, n_splits, n_out, out);
  return cudaGetLastError();
}

// The cores, as the wrapper names them.
constexpr int kCoreScalar = 0;
constexpr int kCoreVec4 = 1;
constexpr int kCoreMma = 2;

template <int KIND>
cudaError_t launch(int core, const float* a, const float* b, const float* c,
                   const float* w, int rows, int64_t L, int R, int n_splits,
                   int64_t split_len, float* partial, float* out,
                   cudaStream_t stream) {
  if (rows <= 0 || L <= 0 || R <= 0 || R > 16 || n_splits <= 0 ||
      n_splits > 65535 || split_len <= 0)
    return cudaErrorInvalidValue;
  auto aligned = [](const float* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // the 16-byte cores take what the wrapper's plan promises, nothing else
  if (core != kCoreScalar &&
      !(L % 4 == 0 && aligned(a) && aligned(b) && aligned(c) && aligned(w) &&
        split_len % (core == kCoreVec4 ? 128 : kStageCells) == 0))
    return cudaErrorInvalidValue;
  const dim3 simt_grid((rows + kWarps - 1) / kWarps, n_splits);
  if (core == kCoreMma) {
    using M = Mma<KIND>;
    cudaError_t err = cudaFuncSetAttribute(
        pass1_mma<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(M::SMEM));
    if (err != cudaSuccess) return err;
    dim3 grid((rows + M::ROWS - 1) / M::ROWS, n_splits);
    pass1_mma<KIND><<<grid, kMmaThreads, M::SMEM, stream>>>(
        a, b, c, w, rows, L, R, split_len, partial);
    err = finish(partial, n_splits,
                 static_cast<int64_t>(Stats<KIND>::N) * R * rows, out, stream);
    if (err != cudaSuccess) return err;
    nonfinite_fixup<KIND>
        <<<(rows + kFixupThreads - 1) / kFixupThreads, kFixupThreads, 0,
           stream>>>(a, b, c, w, rows, L, R, out);
    return cudaGetLastError();
  } else if (core == kCoreVec4) {
    if (R > 4) return cudaErrorInvalidValue;  // the wrapper plans it so
    pass1_vec4<KIND, 4><<<simt_grid, kWarps * 32, 0, stream>>>(
        a, b, c, w, rows, L, R, split_len, partial);
  } else if (core != kCoreScalar) {
    return cudaErrorInvalidValue;
  } else if (R <= 4) {
    pass1_scalar<KIND, 4><<<simt_grid, kWarps * 32, 0, stream>>>(
        a, b, c, w, rows, L, R, split_len, partial);
  } else if (R <= 8) {
    pass1_scalar<KIND, 8><<<simt_grid, kWarps * 32, 0, stream>>>(
        a, b, c, w, rows, L, R, split_len, partial);
  } else {
    pass1_scalar<KIND, 16><<<simt_grid, kWarps * 32, 0, stream>>>(
        a, b, c, w, rows, L, R, split_len, partial);
  }
  return finish(partial, n_splits,
                static_cast<int64_t>(Stats<KIND>::N) * R * rows, out, stream);
}

}  // namespace

extern "C" {

// core: 0 one cell a step (any L, any alignment), 1 CUDA cores with 16-byte
// loads (R <= 4), 2 tensor cores; 1 and 2 need L % 4 == 0, 16-byte aligned
// arrays and split_len a multiple of 128 (core 1) or 32 (core 2).

// Kernel 1. f, t, (c or null): (rows, L); w: (R, L); partial:
// (n_splits, 8, R, rows) scratch; out: (8, R, rows). Returns cudaError_t.
int wb2_fused_deterministic_sums(const float* f, const float* t,
                                 const float* c, const float* w, int rows,
                                 int64_t L, int R, int core, int n_splits,
                                 int64_t split_len, float* partial,
                                 float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (c != nullptr)
    return launch<0>(core, f, t, c, w, rows, L, R, n_splits, split_len,
                     partial, out, s);
  return launch<1>(core, f, t, nullptr, w, rows, L, R, n_splits, split_len,
                   partial, out, s);
}

// Kernel 2. x: (rows, L); w: (R, L); partial: (n_splits, 3, R, rows)
// scratch; out: (3, R, rows). Returns cudaError_t.
int wb2_fused_region_sums(const float* x, const float* w, int rows,
                          int64_t L, int R, int core, int n_splits,
                          int64_t split_len, float* partial, float* out,
                          void* stream) {
  return launch<2>(core, x, nullptr, nullptr, w, rows, L, R, n_splits,
                   split_len, partial, out,
                   static_cast<cudaStream_t>(stream));
}

const char* wb2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
