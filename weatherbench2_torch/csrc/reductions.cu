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
// Bound on the card. Per cell, kernel 1 reads 8 bytes (12 with a
// climatology) and does 8R FMAs; kernel 2 reads 4 bytes and does 3R. At
// the main path's R = 3 both are memory-bound by a wide margin (H100 SXM:
// 3.35 TB/s HBM against 67 TFLOP/s fp32, about 20 flop per byte); at the
// official 13-region shape kernel 1 does 104 FMAs per 12 bytes, near that
// balance. The design therefore streams each input byte once with
// coalesced loads and keeps all work in registers:
//
//  * These are skinny reductions, not GEMMs: fp32 FMAs on CUDA cores, no
//    tensor cores and no TF32, so the result is IEEE float32 arithmetic.
//  * Pass 1: one warp per row, eight rows per block; the block covers one
//    slice [l0, l1) of the cell axis. Each lane walks the slice at stride
//    32 (neighbouring lanes on neighbouring addresses) and keeps its
//    NSTAT x RP partial sums in registers. A fixed xor-shuffle tree then
//    reduces the 32 lanes and lane 0 writes partial[split, stat, r, row].
//  * Loads: where L % 4 == 0 and the arrays are 16-byte aligned (every
//    grid the main path meets), a lane step covers four cells with 16-byte
//    loads, and the next step's data loads are issued before this step's
//    arithmetic, so each warp has two steps in flight; otherwise one cell
//    per step with 4-byte loads and W read through the L1.
//  * Pass 2 sums the splits of each output in a fixed order. There is no
//    floating-point atomicAdd, so results do not change from run to run.
//  * W reuse: the eight rows of a block share one shared-memory copy of
//    each W tile (on the 16-byte path), so W crosses L2 once per block,
//    not once per row; blockIdx.x walks rows, so the blocks resident at
//    one time share a cell slice and W crosses HBM about once per slice
//    (at 0.25 degrees and R = 13, W is 54 MB, more than the 50 MB L2).
//  * The number of splits is chosen by the wrapper so that the grid fills
//    the 132 SMs even when B is small (126 rows at 0.25 degrees).
//  * Columns past L and rows past B contribute nothing; L need not be a
//    multiple of anything. Accumulators exist for R rounded up to 4, 8 or
//    16, so at R = 16 a thread holds 128 sums; the unused ones are
//    skipped by a uniform branch.
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
// eight warps, and each warp issues its next step's data loads before this
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

// Pass 2: out[i] = sum over splits of partial[split, i], in split order.
__global__ void pass2(const float* __restrict__ partial, int n_splits,
                      int64_t n_out, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n_out) return;
  float acc = 0.f;
  for (int s = 0; s < n_splits; ++s) acc += partial[s * n_out + i];
  out[i] = acc;
}

template <int KIND, int RP>
cudaError_t launch_rp(const float* a, const float* b, const float* c,
                      const float* w, int rows, int64_t L, int R,
                      int n_splits, int64_t split_len, float* partial,
                      float* out, cudaStream_t stream) {
  constexpr int NS = Stats<KIND>::N;
  dim3 grid((rows + kWarps - 1) / kWarps, n_splits);
  auto aligned = [](const float* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (L % 4 == 0 && split_len % 128 == 0 && aligned(a) && aligned(b) &&
      aligned(c) && aligned(w))
    pass1_vec4<KIND, RP><<<grid, kWarps * 32, 0, stream>>>(
        a, b, c, w, rows, L, R, split_len, partial);
  else
    pass1_scalar<KIND, RP><<<grid, kWarps * 32, 0, stream>>>(
        a, b, c, w, rows, L, R, split_len, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n_out = static_cast<int64_t>(NS) * R * rows;
  const int threads = 256;
  pass2<<<static_cast<unsigned>((n_out + threads - 1) / threads), threads, 0,
          stream>>>(partial, n_splits, n_out, out);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch(const float* a, const float* b, const float* c,
                   const float* w, int rows, int64_t L, int R, int n_splits,
                   int64_t split_len, float* partial, float* out,
                   cudaStream_t stream) {
  if (rows <= 0 || L <= 0 || R <= 0 || n_splits <= 0 || n_splits > 65535)
    return cudaErrorInvalidValue;
  if (R <= 4)
    return launch_rp<KIND, 4>(a, b, c, w, rows, L, R, n_splits, split_len,
                              partial, out, stream);
  if (R <= 8)
    return launch_rp<KIND, 8>(a, b, c, w, rows, L, R, n_splits, split_len,
                              partial, out, stream);
  if (R <= 16)
    return launch_rp<KIND, 16>(a, b, c, w, rows, L, R, n_splits, split_len,
                               partial, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel 1. f, t, (c or null): (rows, L); w: (R, L); partial:
// (n_splits, 8, R, rows) scratch; out: (8, R, rows). Returns cudaError_t.
int wb2_fused_deterministic_sums(const float* f, const float* t,
                                 const float* c, const float* w, int rows,
                                 int64_t L, int R, int n_splits,
                                 int64_t split_len, float* partial,
                                 float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (c != nullptr)
    return launch<0>(f, t, c, w, rows, L, R, n_splits, split_len, partial,
                     out, s);
  return launch<1>(f, t, nullptr, w, rows, L, R, n_splits, split_len,
                   partial, out, s);
}

// Kernel 2. x: (rows, L); w: (R, L); partial: (n_splits, 3, R, rows)
// scratch; out: (3, R, rows). Returns cudaError_t.
int wb2_fused_region_sums(const float* x, const float* w, int rows,
                          int64_t L, int R, int n_splits, int64_t split_len,
                          float* partial, float* out, void* stream) {
  return launch<2>(x, nullptr, nullptr, w, rows, L, R, n_splits, split_len,
                   partial, out, static_cast<cudaStream_t>(stream));
}

const char* wb2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
