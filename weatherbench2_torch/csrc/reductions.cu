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
// c = 0 and does not read a third array.
//
// Kernel 2 replaces weatherbench2_tpu/ops/reductions.py:_region_sums_kernel
// (fused_region_sums). For (N, L) rows x, each row with its own NaN mask:
//   0: sum W.x0   1: sum W.valid   2: sum (W > 0).isnan(x)
//
// Bound on the card (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 on the CUDA
// cores, 495 TFLOP/s TF32 on the tensor cores). Per cell, kernel 1 reads 8
// bytes (12 with a climatology) and does 8R multiply-adds; kernel 2 reads 4
// bytes and does 3R. Up to four regions, both are memory-bound by a wide
// margin on the CUDA cores. Above four, the fp32 multiply-adds (128 per 8
// bytes for kernel 1 at sixteen regions) would take longer on the CUDA
// cores than the bytes take to arrive, so they go to the tensor cores with
// an error-corrected TF32 split (3xTF32, 672 TF32 flops a cell-row for
// kernel 1). There kernel 1 runs at about half its byte bound: the
// products, at mma.sync's rate, and the statistics' CUDA-core work come on
// top of the bytes. A wgmma core (m64n16k8, W split once per weight
// matrix) was measured no faster (PERF.md), so it is not kept. The Python
// wrapper (ops/reductions.py:launch_plan) picks one of four cores:
//
//  * pass1_stream (kernel 2, R <= 4, planned). The GEMV regime: 3R
//    multiply-adds per 4 bytes is far under the CUDA cores' rate, so only
//    the bytes in flight matter. A block holds eight rows (a consumer warp
//    each) and one producer warp. Row segments of 256 cells (1 KB) stream
//    into a four-stage shared-memory ring through 1D TMA bulk copies
//    (cp.async.bulk ... mbarrier::complete_tx::bytes: no tensor map, so the
//    build links no libcuda), issued by the producer's lanes, one copy per
//    row and per region row of W, which the block's eight rows share. Full
//    and empty mbarriers per stage order the ring: 4 KB a warp stay in flight
//    whatever the row count. The wrapper tiles the (rows, cells) plane into
//    blocks of 8 rows x split_len cells so that the last wave of blocks is
//    as full as it can be (few rows: more splits; many rows: whole waves).
//  * pass1_vec4 (kernel 1, R <= 4, planned). One warp per row, eight rows
//    per block; a lane covers four cells per step with 16-byte loads, the
//    next step's loads started before this step's arithmetic; the block's
//    rows share a double-buffered shared-memory copy of each (4, 128-cell)
//    tile of W.
//  * pass1_mma (both kernels, R > 4, planned). The skinny product out[16
//    regions, rows] = W[16, cells] . stat[cells, rows] as mma.sync.m16n8k8
//    (TF32 in, fp32 out): W's (16 regions x 8 cells) is A and a statistic
//    of 8 cells x 8 rows is B. A lane (g = lane / 4, t = lane % 4) reads
//    the cells 16 j + 4 t .. + 3 of its row with one 16-byte cp.async into
//    a four-stage ring private to the thread, and uses them as k = t, t + 4
//    of two MMA steps. W's (16, 32-cell) tile is split by two warps a stage
//    into Whi, Wlo and (W > 0) in shared memory. W.s is Wlo.shi + Whi.slo +
//    Whi.shi, the valid weight Wlo.v + Whi.v, the NaN hits (W > 0).n; a
//    chain runs for one 32-cell stage (12 MMAs into a zeroed accumulator)
//    and is added to the fp32 sums on the CUDA cores, so that the tensor
//    core's truncating adder never runs long. A block of eight warps holds
//    64 rows (kernel 1) or 128 (kernel 2, two 8-row tiles a warp).
//  * pass1_scalar: any L or alignment that the 16-byte cores cannot take;
//    one cell per lane step, 4-byte loads, any R.
//
// Precision of the tensor-core core: every operand that is not exactly a
// TF32 number is split, v = hi + lo with hi = tf32(v), rounded to nearest,
// and lo = v - hi, exact in fp32, of which the tensor core reads the upper
// 19 bits (it truncates): about 21 bits of v are kept. The 0/1 masks are
// exact. Range: the split is of finite numbers. An infinite statistic has
// hi = inf and lo = NaN, so that core's sums of that (statistic, row) come
// out NaN in every region, where fp32 (and the CUDA-core cores) give +-inf
// in the regions whose positive weights meet infinities of one sign and
// NaN elsewhere (0 x inf). So its tail flags each row with a sum that is
// not finite and redoes it as fp32 gives it, region by region
// (repair_rows). A finite sum that overflows, or a weight within 2^-12 of
// the largest float, is not repaired.
//
// One launch a call. Every core covers one slice [l0, l1) of the cell axis
// per block (split) and ends in a tail that sums the splits in split order
// (no floating-point atomics: the same inputs give the same bits on every
// run); where the plan has one split, pass 1 writes out directly.
//  * CUDA-core cores (grids planned in waves): each block publishes its
//    partial, then increments its row block's arrival counter (after
//    __threadfence); the last block to arrive sums that row block's
//    splits and resets the counter.
//  * The tensor-core core (one wave, launched cooperatively, so every block
//    is resident; a block walks several row blocks where the rows
//    outnumber the wave): a grid barrier, then every block sums a slice of
//    all outputs, flagging rows with a sum that is not finite; a second
//    barrier, then every block repairs the flagged rows of its slice.
//    Its partials are large at few rows (16 regions x 8 statistics x 64
//    rows a block, up to 264 splits), so no block sums them alone.
// The splits are summed sixteen loads at a time, in order.
// Columns past L and rows past B contribute nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The launch, as every kernel takes it.
struct Params {
  const float* a;       // f (kernel 1) or x (kernel 2): (rows, L)
  const float* b;       // t or nullptr
  const float* c;       // climatology or nullptr
  const float* w;       // (R, L)
  int rows;
  int R;
  int n_splits;
  int64_t L;
  int64_t split_len;
  float* partial;       // (n_splits, stats, R, rows); == out for one split
  float* out;           // (stats, R, rows)
  int* counters;        // zeroed scratch, left zeroed
};

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

__device__ __forceinline__ int64_t out_index(const Params& p, int split,
                                             int ns, int k, int r, int row) {
  return ((static_cast<int64_t>(split) * ns + k) * p.R + r) * p.rows + row;
}

// The 32 lanes' sums of each (stat, region) by a fixed xor tree; lane 0
// writes partial[split, stat, r, row].
template <int NS, int RP>
__device__ __forceinline__ void write_partials(float (&acc)[NS][RP],
                                               int lane, int split, int row,
                                               const Params& p) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      if (r < p.R) {
        float v = acc[k][r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(kFull, v, off);
        if (lane == 0) p.partial[out_index(p, split, NS, k, r, row)] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tails (see the header).

// src[0] + src[stride] + ... (n terms) added in that order, sixteen loads
// in flight: a split sum is a chain of L2 round trips otherwise.
__device__ __forceinline__ float sum_in_order(const float* src,
                                              int64_t stride, int n) {
  float acc = 0.f;
  int s = 0;
  for (; s + 16 <= n; s += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = __ldcg(src + (s + u) * stride);
#pragma unroll
    for (int u = 0; u < 16; ++u) acc += v[u];
  }
  for (; s < n; ++s) acc += __ldcg(src + s * stride);
  return acc;
}

// The last block of a row block to publish its partial sums the row
// block's splits in split order and leaves the counter (counters[2 +
// row block]; 0 and 1 are grid_sync's) zeroed. Every thread of the block
// calls it.
template <int NS>
__device__ void finish_last_block(const Params& p, int rows_per_block) {
  if (p.n_splits == 1) return;  // pass 1 wrote out
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.counters + 2 + blockIdx.x, 1) == p.n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, p.rows - row0);
  const int64_t stride = static_cast<int64_t>(NS) * p.R * p.rows;
  for (int i = threadIdx.x; i < NS * p.R * nrows; i += blockDim.x) {
    const int64_t idx = static_cast<int64_t>(i / nrows) * p.rows + row0 +
                        i % nrows;
    p.out[idx] = sum_in_order(p.partial + idx, stride, p.n_splits);
  }
  if (threadIdx.x == 0) p.counters[2 + blockIdx.x] = 0;
}

// All blocks of a cooperative launch meet here. counters[0] counts the
// arrivals and counters[1] the barriers passed (it is never reset: a
// block still waiting compares it with what it read), so the pair is
// ready for the next barrier and the next launch.
__device__ void grid_sync(int* counters) {
  const unsigned n = gridDim.x * gridDim.y;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* v = counters;
    const int gen = v[1];
    if (atomicAdd(counters, 1) == static_cast<int>(n) - 1) {
      atomicExch(counters, 0);
      __threadfence();
      atomicAdd(counters + 1, 1);
    } else {
      while (v[1] == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The rows [r0, r1) with a sum that is not finite, redone as fp32 gives
// them (see the header). Such a row is flagged in counters[2 + row] where
// its sums were written (finish_grid, or pass 1 for one split); a thread
// reads one row's flag and clears it, then the block's threads redo each
// flagged row together, classifying the row's cells.
// Bits per weighted statistic: r for an infinity of either sign or a NaN
// statistic meeting region r's weight where fp32 makes NaN of it (a NaN
// statistic, or a zero weight), and r, 16 + r for +inf, -inf meeting a
// positive weight.
constexpr int kRepairRows = 128;  // rows tested at a time (<= blockDim.x)

template <int KIND>
__device__ void repair_rows(const Params& p, int r0, int r1) {
  constexpr int NS = Stats<KIND>::N;
  constexpr int NW = KIND == 2 ? 1 : 6;  // the statistics summed with W
  __shared__ int marked[kRepairRows];
  __shared__ int n_marked;
  __shared__ unsigned nan_bits[NW], sign_bits[NW];
  const int64_t L = p.L;
  const int R = p.R;
  for (int base = r0; base < r1; base += kRepairRows) {
    if (threadIdx.x == 0) n_marked = 0;
    __syncthreads();
    const int own = base + threadIdx.x;
    if (threadIdx.x < kRepairRows && own < r1 && __ldcg(p.counters + 2 + own)) {
      p.counters[2 + own] = 0;
      marked[atomicAdd(&n_marked, 1)] = own;
    }
    __syncthreads();
    const int n = n_marked;
    for (int j = 0; j < n; ++j) {
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
        stats_of<KIND>(p.a[i], KIND == 2 ? 0.f : p.b[i],
                       KIND == 0 ? p.c[i] : 0.f, s);
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          if (isfinite(s[k])) continue;
          for (int r = 0; r < R; ++r) {
            const float wv = p.w[static_cast<int64_t>(r) * L + l];
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
          p.out[(static_cast<int64_t>(k) * R + r) * p.rows + row] =
              nan || (pos && neg) ? __int_as_float(0x7fc00000)
                                  : pos ? inf : -inf;
      }
      __syncthreads();  // the shared bits are reset for the next row
    }
  }
}

// The tensor-core core's tail: every block of the (cooperative, one-wave)
// grid sums a slice of the outputs over the splits, in split order, then
// tests and repairs a slice of the rows.
template <int KIND>
__device__ void finish_grid(const Params& p) {
  constexpr int NS = Stats<KIND>::N;
  const int64_t n_blocks = static_cast<int64_t>(gridDim.x) * gridDim.y;
  const int64_t block = static_cast<int64_t>(blockIdx.y) * gridDim.x +
                        blockIdx.x;
  if (p.n_splits > 1) {
    grid_sync(p.counters);
    const int64_t n_out = static_cast<int64_t>(NS) * p.R * p.rows;
    for (int64_t i = block * blockDim.x + threadIdx.x; i < n_out;
         i += n_blocks * blockDim.x) {
      const float acc = sum_in_order(p.partial + i, n_out, p.n_splits);
      p.out[i] = acc;
      if (!isfinite(acc)) p.counters[2 + i % p.rows] = 1;
    }
  }
  grid_sync(p.counters);
  repair_rows<KIND>(p, static_cast<int>(block * p.rows / n_blocks),
                    static_cast<int>((block + 1) * p.rows / n_blocks));
}

// ---------------------------------------------------------------------------
// Asynchronous copies and barriers.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; n = 0 writes zeros instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  // the L2 hint fetches the row's next 128 bytes (the next stage) too
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;" ::"r"(
          smem_addr(dst)),
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// A 1D TMA bulk copy global -> shared (16-byte aligned, bytes % 16 == 0),
// reported to the barrier as transferred bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// CUDA-core cores.

constexpr int kWarps = 8;  // rows per block of pass1_scalar and pass1_vec4

// Pass 1, one cell per lane step: any L, any alignment.
template <int KIND, int RP>
__global__ void __launch_bounds__(kWarps * 32)
pass1_scalar(const Params p) {
  constexpr int NS = Stats<KIND>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int split = blockIdx.y;
  if (row < p.rows) {
    const int64_t L = p.L;
    const int64_t l0 = split * p.split_len;
    const int64_t l1 = min(L, l0 + p.split_len);
    const int64_t base = static_cast<int64_t>(row) * L;
    float acc[NS][RP];
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int r = 0; r < RP; ++r) acc[k][r] = 0.f;
    for (int64_t l = l0 + lane; l < l1; l += 32) {
      const float f = __ldg(p.a + base + l);
      const float t = KIND == 2 ? 0.f : __ldg(p.b + base + l);
      const float cl = KIND == 0 ? __ldg(p.c + base + l) : 0.f;
      float s[NS];
      stats_of<KIND>(f, t, cl, s);
#pragma unroll
      for (int r = 0; r < RP; ++r)
        if (r < p.R) accumulate(acc, s, __ldg(p.w + r * L + l), r);
    }
    write_partials(acc, lane, split, row, p);
  }
  finish_last_block<NS>(p, kWarps);
}

// Pass 1, four cells per lane step with 16-byte loads, for L % 4 == 0 and
// aligned arrays. A block step covers 128 cells of its eight rows: the
// step's (RP, 128) tile of W is loaded once into shared memory (double
// buffered, the next tile loading while this one is used) and read by all
// eight warps, and each warp starts its next step's data loads before this
// step's arithmetic.
// Registers for three blocks an SM (five without a second array): left
// free, ptxas takes up to 122 for the tail's loads in flight, and two
// blocks an SM run up to 30% slower.
template <int KIND, int RP>
__global__ void __launch_bounds__(kWarps * 32, KIND == 2 ? 5 : 3)
pass1_vec4(const Params p) {
  constexpr int NS = Stats<KIND>::N;
  __shared__ float4 wtile[2][RP][32];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int split = blockIdx.y;
  const bool active = row < p.rows;  // idle warps still load W and sync
  const int64_t L4 = p.L >> 2;
  const int64_t q0 = (split * p.split_len) >> 2;  // split_len % 128 == 0
  const int64_t q1 = min(L4, q0 + (p.split_len >> 2));
  const int n_steps = static_cast<int>((q1 - q0 + 31) / 32);
  const int64_t base = static_cast<int64_t>(active ? row : 0) * L4;
  const float4* __restrict__ a4 = reinterpret_cast<const float4*>(p.a) + base;
  const float4* __restrict__ b4 =
      KIND == 2 ? nullptr : reinterpret_cast<const float4*>(p.b) + base;
  const float4* __restrict__ c4 =
      KIND == 0 ? reinterpret_cast<const float4*>(p.c) + base : nullptr;
  const float4* __restrict__ w4 = reinterpret_cast<const float4*>(p.w);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int R = p.R;

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
  if (active) write_partials(acc, lane, split, row, p);
  finish_last_block<NS>(p, kWarps);
}

// The streaming core of kernel 2 (see the header). Geometry of one block:
constexpr int kStreamRows = 8;     // consumer warps, a row each
constexpr int kStreamThreads = (kStreamRows + 1) * 32;  // + the producer
constexpr int kStreamStages = 4;   // depth of the TMA ring
constexpr int kStreamSeg = 256;    // cells per stage (1 KB a row)
constexpr int kStreamRegions = 4;  // W rows per stage (R <= 4)
constexpr int kStreamSlot = (kStreamRows + kStreamRegions) * kStreamSeg;
constexpr size_t kStreamSmem =
    static_cast<size_t>(kStreamStages) * kStreamSlot * 4 +
    2 * kStreamStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kStreamThreads, 4)  // four blocks an SM
pass1_stream(const Params p) {
  constexpr int NS = 3;
  constexpr int RP = kStreamRegions;
  extern __shared__ __align__(128) float ring[];
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(ring + kStreamStages * kStreamSlot);
  uint64_t* const empty = full + kStreamStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kStreamRows;
  const int n_rows = min(kStreamRows, p.rows - row0);
  const int split = blockIdx.y;
  const int64_t L = p.L;
  const int R = p.R;
  const int64_t l0 = split * p.split_len;  // split_len % 128 == 0
  const int64_t l1 = min(L, l0 + p.split_len);
  const int n_seg = static_cast<int>((l1 - l0 + kStreamSeg - 1) / kStreamSeg);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStreamStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, n_rows);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kStreamRows) {
    // producer: lane i < n_rows copies row i, lane 8 + r region row r
    for (int s = 0; s < n_seg; ++s) {
      const int slot = s % kStreamStages;
      if (s >= kStreamStages)
        mbar_wait(empty + slot, ((s / kStreamStages) - 1) & 1);
      const int64_t cell = l0 + static_cast<int64_t>(s) * kStreamSeg;
      const uint32_t bytes =
          static_cast<uint32_t>(min(static_cast<int64_t>(kStreamSeg),
                                    l1 - cell)) * 4;
      if (lane == 0) mbar_expect(full + slot, bytes * (n_rows + R));
      __syncwarp();
      float* const dst = ring + slot * kStreamSlot;
      if (lane < n_rows)
        bulk_copy(dst + lane * kStreamSeg,
                  p.a + static_cast<int64_t>(row0 + lane) * L + cell, bytes,
                  full + slot);
      else if (lane >= kStreamRows && lane - kStreamRows < R)
        bulk_copy(dst + lane * kStreamSeg,
                  p.w + static_cast<int64_t>(lane - kStreamRows) * L + cell,
                  bytes, full + slot);
    }
  } else if (warp < n_rows) {
    float acc[NS][RP];
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int r = 0; r < RP; ++r) acc[k][r] = 0.f;
    for (int s = 0; s < n_seg; ++s) {
      const int slot = s % kStreamStages;
      mbar_wait(full + slot, (s / kStreamStages) & 1);
      const float* const xs = ring + slot * kStreamSlot + warp * kStreamSeg;
      const float* const ws = ring + slot * kStreamSlot +
                              kStreamRows * kStreamSeg;
      const int n = static_cast<int>(
          min(static_cast<int64_t>(kStreamSeg),
              l1 - l0 - static_cast<int64_t>(s) * kStreamSeg));
#pragma unroll
      for (int q = lane * 4; q < kStreamSeg; q += 128) {
        if (q < n) {
          const float4 v = *reinterpret_cast<const float4*>(xs + q);
          float st[4][NS];
          stats_of<2>(v.x, 0.f, 0.f, st[0]);
          stats_of<2>(v.y, 0.f, 0.f, st[1]);
          stats_of<2>(v.z, 0.f, 0.f, st[2]);
          stats_of<2>(v.w, 0.f, 0.f, st[3]);
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            if (r < R) {
              const float4 wv =
                  *reinterpret_cast<const float4*>(ws + r * kStreamSeg + q);
              accumulate(acc, st[0], wv.x, r);
              accumulate(acc, st[1], wv.y, r);
              accumulate(acc, st[2], wv.z, r);
              accumulate(acc, st[3], wv.w, r);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
    write_partials(acc, lane, split, row0 + warp, p);
  }
  finish_last_block<NS>(p, kStreamRows);
}

// ---------------------------------------------------------------------------
// The tensor-core core (see the header).

// v = hi + lo. hi is v rounded to TF32 (nearest, ties away from zero: an
// integer add and mask, which rounds as cvt.rna.tf32.f32 does and is the
// cheaper instruction); v - hi is exact in fp32, and the tensor core reads
// its upper 19 bits. Finite v only: see "Precision" in the header.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// Geometry of pass1_mma's block:
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

// d += A(16x8, row) . B(8x8, col), TF32 operands, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

template <int KIND>
__global__ void __launch_bounds__(kMmaThreads, 2)
pass1_mma(const Params p) {
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
  const int rows = p.rows;
  const int R = p.R;
  const int64_t L = p.L;
  const int64_t l0 = split * p.split_len;  // split_len % kStageCells == 0
  const int64_t l1 = min(L, l0 + p.split_len);
  const int n_it = static_cast<int>((l1 - l0 + kStageCells - 1) / kStageCells);
  const float* const arrs[3] = {p.a, p.b, p.c};
  // row blocks blockIdx.x, + gridDim.x, ... (more than one where the rows
  // outnumber the resident blocks)
  for (int rb = blockIdx.x; rb * M::ROWS < rows; rb += gridDim.x) {
  const int row0 = rb * M::ROWS + (tid >> 5) * 8 * NT;
  const bool warp_active = row0 < rows;

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
          wa = __ldg(reinterpret_cast<const float4*>(p.w + g * L + cell));
        if (g + 8 < R)
          wb = __ldg(reinterpret_cast<const float4*>(p.w + (g + 8) * L + cell));
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
          if (r < R && row < rows) {
            const float v = sum[nt][k][i];
            p.partial[out_index(p, split, NS, k, r, row)] = v;
            if (p.n_splits == 1 && !isfinite(v)) p.counters[2 + row] = 1;
          }
        }
  }
  __syncthreads();  // the W fragments are rewritten by the next row block
  }
  finish_grid<KIND>(p);
}

// ---------------------------------------------------------------------------
// Launches.

// The cores, as the wrapper names them.
constexpr int kCoreScalar = 0;
constexpr int kCoreVec4 = 1;
constexpr int kCoreMma = 2;
constexpr int kCoreStream = 3;

// What a call site keeps per device: whether the kernel's dynamic
// shared-memory allowance is set (it is not a property of a launch) and
// how many of its blocks the card holds at once.
struct Setup {
  bool done[64];
  int resident[64];
};

template <typename Kernel>
cudaError_t setup(Kernel kernel, int threads, size_t smem, Setup& s,
                  int* resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!s.done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    s.resident[dev] = per_sm * sms;
    s.done[dev] = true;
  }
  *resident = s.resident[dev];
  return cudaSuccess;
}

// One launch with every block resident at once (the tails' grid barrier):
// the plan's splits, and as many row blocks as fit beside them (each
// block then takes every gridDim.x-th row block).
template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, Setup& s, int rows_per_block,
                               int threads, size_t smem, cudaStream_t stream,
                               const Params& p) {
  int resident = 0;
  cudaError_t err = setup(kernel, threads, smem, s, &resident);
  if (err != cudaSuccess) return err;
  if (p.n_splits > resident) return cudaErrorInvalidValue;
  const int row_blocks = (p.rows + rows_per_block - 1) / rows_per_block;
  const dim3 grid(min(row_blocks, resident / p.n_splits), p.n_splits);
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     grid, threads, args, smem, stream);
}

template <int KIND>
cudaError_t launch(int core, Params p, cudaStream_t stream) {
  if (p.rows <= 0 || p.L <= 0 || p.R <= 0 || p.R > 16 || p.n_splits <= 0 ||
      p.n_splits > 65535 || p.split_len <= 0 || p.counters == nullptr ||
      (p.n_splits > 1 && p.partial == nullptr))
    return cudaErrorInvalidValue;
  if (p.n_splits == 1) p.partial = p.out;  // pass 1 writes out
  auto aligned = [](const float* q) {
    return q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  // the 16-byte cores take what the wrapper's plan promises, nothing else:
  // splits of whole block steps (128 cells) or stages (32, tensor cores)
  const int step = core == kCoreMma ? kStageCells : 128;
  if (core != kCoreScalar &&
      !(p.L % 4 == 0 && aligned(p.a) && aligned(p.b) && aligned(p.c) &&
        aligned(p.w) && p.split_len % step == 0))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 simt_grid((p.rows + kWarps - 1) / kWarps, p.n_splits);
  if (core == kCoreMma) {
    static Setup once = {};
    return launch_cooperative(pass1_mma<KIND>, once, Mma<KIND>::ROWS,
                              kMmaThreads, Mma<KIND>::SMEM, stream, p);
  }
  if (core == kCoreStream) {
    if constexpr (KIND != 2) {
      return cudaErrorInvalidValue;  // built for kernel 2
    } else {
      if (p.R > kStreamRegions) return cudaErrorInvalidValue;
      static Setup once = {};
      int resident = 0;
      err = setup(pass1_stream, kStreamThreads, kStreamSmem, once, &resident);
      if (err != cudaSuccess) return err;
      pass1_stream<<<dim3((p.rows + kStreamRows - 1) / kStreamRows,
                          p.n_splits),
                     kStreamThreads, kStreamSmem, stream>>>(p);
      return cudaGetLastError();
    }
  }
  if (core == kCoreVec4) {
    if (p.R > 4) return cudaErrorInvalidValue;  // the wrapper plans it so
    pass1_vec4<KIND, 4><<<simt_grid, kWarps * 32, 0, stream>>>(p);
  } else if (core != kCoreScalar) {
    return cudaErrorInvalidValue;
  } else if (p.R <= 4) {
    pass1_scalar<KIND, 4><<<simt_grid, kWarps * 32, 0, stream>>>(p);
  } else if (p.R <= 8) {
    pass1_scalar<KIND, 8><<<simt_grid, kWarps * 32, 0, stream>>>(p);
  } else {
    pass1_scalar<KIND, 16><<<simt_grid, kWarps * 32, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// core: 0 one cell a step (any L, any alignment), 1 CUDA cores with 16-byte
// loads (R <= 4), 2 tensor cores (mma.sync), 3 the TMA streaming core
// (kernel 2, R <= 4); all but 0 need L % 4 == 0, 16-byte aligned arrays and
// split_len a multiple of 128 (of 32 for the tensor-core core 2).
// partial: (n_splits, stats, R, rows) scratch, unused (may be null) for
// one split. counters: int scratch, zeroed before the first launch, two
// for the grid barrier and, after them, one per row block (cores 0, 1, 3:
// arrival counts) or per row (core 2: non-finite flags); a launch
// leaves them ready for the next.

// Kernel 1. f, t, (c or null): (rows, L); w: (R, L); out: (8, R, rows).
// Returns cudaError_t.
int wb2_fused_deterministic_sums(const float* f, const float* t,
                                 const float* c, const float* w, int rows,
                                 int64_t L,
                                 int R, int core, int n_splits,
                                 int64_t split_len, float* partial,
                                 int* counters, float* out, void* stream) {
  const Params p{f, t, c, w, rows, R, n_splits, L, split_len, partial, out,
                 counters};
  auto s = static_cast<cudaStream_t>(stream);
  if (c != nullptr) return launch<0>(core, p, s);
  return launch<1>(core, p, s);
}

// Kernel 2. x: (rows, L); w: (R, L); out: (3, R, rows). Returns cudaError_t.
int wb2_fused_region_sums(const float* x, const float* w, int rows,
                          int64_t L, int R, int core, int n_splits,
                          int64_t split_len, float* partial, int* counters,
                          float* out, void* stream) {
  const Params p{x, nullptr, nullptr, w, rows, R, n_splits, L, split_len,
                 partial, out, counters};
  return launch<2>(core, p, static_cast<cudaStream_t>(stream));
}

const char* wb2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
