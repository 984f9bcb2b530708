// Sorted-segment weighted sum for Hopper (sm_90a), plain C interface.
//
//   out[u, e*C + c] = sum_{n : ids[n] == u} w[n, e] * g[n, c]
//
// Replaces the TPU kernel `sorted_segment_weighted_sum` of
// fusiontransformer_tpu/ops/pallas/segment_sum.py:129 (body `_kernel` at
// :48, `pl.pallas_call` at :224).  That kernel walks the point stream block
// by block on the TPU's sequential grid and carries a sliding accumulator
// window in VMEM from one step to the next.  A GPU grid has no order and no
// carry, so this kernel uses the stream's sortedness instead: ids are
// nondecreasing over the whole array (live ids on [0, nvalid), sentinels
// >= num_out at the tail), so each output row owns a contiguous run of
// points.
//
// What bounds it on an H100: bytes.  g [N, C] and w [N, E] are read once and
// the [num_out, E*C] f32 output is written once; at E = 8 the output write
// dominates.  A few flops per byte.
//
// Design, balanced over points rather than rows:
// * One cooperative launch of as many blocks as fit on the card at once
//   (two phases split by a grid barrier), so a call is one launch.
// * Phase 1: the blocks take the point chunks [b*P, (b+1)*P) in turn (P =
//   `chunk`, 32-128 points, chosen by the wrapper); a chunk's block owns
//   every row that has points in it.  It stages the chunk's ids and w rows
//   in shared memory once, then walks the points in order.  Each thread owns
//   kVec = 4 consecutive columns of g (one 16-byte load per point; C % 4 != 0
//   takes 4-byte loads) and keeps all E of their partial sums in registers,
//   so g is read once and w[n, :] is a shared-memory broadcast.  Eight
//   points' loads are in flight at a time.
// * A row that ends inside the chunk is stored from registers (E 16-byte
//   stores per thread).  A row that crosses the chunk's edge is a long
//   segment split across chunks: the chunk where it begins stores its share
//   in the row's own place in `out`, each later chunk stores its share in
//   its L slot of `lpart`.  Phase 2 adds out[u] + L + L ... in chunk order.
//   So a coarse voxel's hundreds of points are spread over blocks, and the
//   sum is the same bits on every launch: no float atomics.
// * Rows that no point reaches are written as 0: a gap between two live
//   rows by the block whose chunk holds the point after the gap, the rows
//   past the last live row in phase 2 by every block, grid-striding
//   (`live_rows`, the last live id + 1, is written by the block holding the
//   last live point).  Sentinel points (ids >= num_out) are never summed.
// * Unless kPrecise, each product w*g is rounded to bf16 before the f32 sum,
//   as the TPU kernel rounds its one-hot matmul operand; __fmul_rn /
//   __fadd_rn keep the compiler from contracting them into an FMA.  The
//   summation order differs from the plain version's (point order within a
//   chunk, then chunk shares in chunk order).
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phases 2 and 6,
// tools/step_ab.py --k3; PERF.md): 1.7-1.8x its bound summed over a train
// step's calls at E = 1 and at E = 8; a batch-1 call is 12-16 us on the
// device.  Against the same kernel with the carry in a second launch, one
// launch is faster per request from Python and 3-5% slower per train step
// on the device: the blocks take their chunks in a fixed turn, where the
// hardware handed a second wave's blocks to whichever SM came free.
//
// ptxas (chip_smoke.py phase 1, sm_90a): E = 8 100 registers and 4.6 KB of
// shared memory, E = 1 32-64 registers and 1 KB; no spills.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxChunk = 128;  // points per block, at most
constexpr int kUnroll = 8;      // points whose g loads are in flight at once
constexpr int kMaxThreads = 512;

template <int kVec>
__device__ __forceinline__ void load_vec(float (&v)[kVec], const float* p) {
  if constexpr (kVec == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// The same from memory this launch wrote (no read-only cache).
template <int kVec>
__device__ __forceinline__ void load_vec_plain(float (&v)[kVec],
                                               const float* p) {
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// acc += bf16?(w * g), element by element, no contraction.
template <int kVec, bool kPrecise>
__device__ __forceinline__ void add_terms(float (&acc)[kVec], float w,
                                          const float (&g)[kVec]) {
  float p[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) p[k] = __fmul_rn(w, g[k]);
  if constexpr (!kPrecise) {
    if constexpr (kVec == 4) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(p[2], p[3]);
      p[0] = __low2float(a);
      p[1] = __high2float(a);
      p[2] = __low2float(b);
      p[3] = __high2float(b);
    } else {
      p[0] = __bfloat162float(__float2bfloat16_rn(p[0]));
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = __fadd_rn(acc[k], p[k]);
}

// One work item (b, y): points [b*chunk, b*chunk + chunk), weight columns
// [y*kE, y*kE + kE) (masked past e).  `lpart` holds E*C floats per chunk: the
// share of the chunk's first row when that row began in an earlier chunk.
// The share of a row that begins in the chunk and runs past it goes to the
// row's own place in `out`, where the carry adds the later chunks' shares.
template <int kE, int kVec, bool kPrecise>
__device__ __forceinline__ void chunk_sums(const float* __restrict__ g,
                                           const float* __restrict__ w,
                                           const int* __restrict__ ids,
                                           float* __restrict__ out,
                                           float* __restrict__ lpart,
                                           int* __restrict__ live_rows, int n,
                                           int c, int e, int num_out,
                                           int chunk, int b, int y, int* sid,
                                           float* sw, int& s_cnt) {
  const int e0 = y * kE;
  const int n0 = b * chunk;
  const int n1 = min(n, n0 + chunk);
  const int cnt_all = max(n1 - n0, 0);
  const int64_t cols = static_cast<int64_t>(e) * c;
  if (threadIdx.x == 0) s_cnt = 0;
  for (int i = threadIdx.x; i < cnt_all + 2; i += blockDim.x) {
    const int p = n0 - 1 + i;
    sid[i] = p < 0 ? -1 : (p >= n ? INT_MAX : ids[p]);
  }
  for (int i = threadIdx.x; i < cnt_all * kE; i += blockDim.x) {
    const int p = i / kE;
    const int j = i - p * kE;
    sw[i] = e0 + j < e ? w[static_cast<int64_t>(n0 + p) * e + e0 + j] : 0.f;
  }
  __syncthreads();
  // The chunk's live points end where the stream turns to sentinels (or at
  // the chunk's end); the item holding the last live point publishes the
  // live row count, chunk 0 publishes 0 when no point is live.
  for (int i = threadIdx.x; i < cnt_all; i += blockDim.x) {
    const bool live = sid[i + 1] < num_out;
    const bool next_live = sid[i + 2] < num_out;
    if (live && !next_live) {
      s_cnt = i + 1;
      if (y == 0) *live_rows = sid[i + 1] + 1;
    } else if (live && i == cnt_all - 1) {
      s_cnt = cnt_all;
    }
  }
  if (b == 0 && y == 0 && threadIdx.x == 0 && sid[1] >= num_out)
    *live_rows = 0;
  __syncthreads();
  const int cnt = s_cnt;
  if (cnt == 0) return;

  const int first = sid[1];
  const int last = sid[cnt];
  const bool began_before = sid[0] == first;
  float* lslot = lpart + static_cast<int64_t>(b) * cols;
  const int groups = c / kVec;

  for (int cg0 = 0; cg0 < groups; cg0 += blockDim.x) {
    const int cg = cg0 + threadIdx.x;
    const bool act = cg < groups;
    const int col = cg * kVec;
    float acc[kE][kVec];
#pragma unroll
    for (int j = 0; j < kE; ++j)
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[j][k] = 0.f;
    const float zero[kVec] = {};

    auto zero_rows = [&](int lo, int hi) {  // rows [lo, hi) no point reaches
      for (int u = lo; u < hi; ++u)
#pragma unroll
        for (int j = 0; j < kE; ++j)
          if (e0 + j < e)
            store_vec(out + u * cols + static_cast<int64_t>(e0 + j) * c + col,
                      zero);
    };
    auto flush = [&](int u) {
      float* dst = (u == first && began_before) ? lslot : out + u * cols;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        if (e0 + j < e)
          store_vec(dst + static_cast<int64_t>(e0 + j) * c + col, acc[j]);
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[j][k] = 0.f;
      }
    };

    if (act) zero_rows(sid[0] + 1, first);
    int cur = first;
    for (int i0 = 0; i0 < cnt; i0 += kUnroll) {
      float gv[kUnroll][kVec];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (act && i0 + k < cnt) {
          load_vec(gv[k], g + static_cast<int64_t>(n0 + i0 + k) * c + col);
        } else {
#pragma unroll
          for (int q = 0; q < kVec; ++q) gv[k][q] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = i0 + k;
        if (i >= cnt) break;
        const int u = sid[i + 1];
        if (u != cur) {  // block-uniform: every thread walks the same ids
          if (act) {
            flush(cur);
            zero_rows(cur + 1, u);
          }
          cur = u;
        }
#pragma unroll
        for (int j = 0; j < kE; ++j)
          add_terms<kVec, kPrecise>(acc[j], sw[i * kE + j], gv[k]);
      }
    }
    if (act) flush(cur);
  }
}

// A cooperative launch of at most as many blocks as fit on the card at once.
// Phase 1: the blocks take the (chunk, weight group) items in turn.  After
// the grid barrier, phase 2: a row that begins in chunk b and runs past it
// holds chunk b's share in `out`; out[u] = out[u] + L[b+1] + ... in chunk
// order.  Then the rows past the last live one are zeroed.
template <int kE, int kVec, bool kPrecise>
__global__ void __launch_bounds__(kMaxThreads)
    sorted_segment_weighted_sum_kernel(const float* __restrict__ g,
                                       const float* __restrict__ w,
                                       const int* __restrict__ ids,
                                       float* __restrict__ out,
                                       float* __restrict__ lpart,
                                       int* __restrict__ live_rows, int n,
                                       int c, int e, int num_out, int chunk,
                                       int nchunks) {
  // ids[n0 - 1 .. n1]; -1 before the stream, INT_MAX past it
  __shared__ int sid[kMaxChunk + 2];
  __shared__ float sw[kMaxChunk * kE];
  __shared__ int s_cnt;  // live points of the chunk
  const int items = nchunks * ((e + kE - 1) / kE);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    chunk_sums<kE, kVec, kPrecise>(g, w, ids, out, lpart, live_rows, n, c, e,
                                   num_out, chunk, it % nchunks, it / nchunks,
                                   sid, sw, s_cnt);
    __syncthreads();  // the next item reuses sid / sw
  }
  if (nchunks == 0 && blockIdx.x == 0 && threadIdx.x == 0) *live_rows = 0;
  cg::this_grid().sync();

  const int64_t cols = static_cast<int64_t>(e) * c;
  const int64_t step = static_cast<int64_t>(blockDim.x) * kVec;
  for (int b = blockIdx.x; b < nchunks; b += gridDim.x) {
    const int n0 = b * chunk;
    const int n1 = min(n, n0 + chunk);
    const int u = n1 < n ? ids[n1 - 1] : INT_MAX;
    if (!(u < num_out && ids[n1] == u && !(n0 > 0 && ids[n0 - 1] == u)))
      continue;
    float* row = out + u * cols;
    for (int64_t j = threadIdx.x * kVec; j < cols; j += step) {
      float sum[kVec];
      load_vec_plain(sum, row + j);
      for (int b2 = b + 1; b2 < nchunks && ids[b2 * chunk] == u; ++b2) {
        float t[kVec];
        load_vec_plain(t, lpart + static_cast<int64_t>(b2) * cols + j);
#pragma unroll
        for (int k = 0; k < kVec; ++k) sum[k] = __fadd_rn(sum[k], t[k]);
      }
      store_vec(row + j, sum);
    }
  }
  const float zero[kVec] = {};
  for (int64_t u = *live_rows + blockIdx.x; u < num_out; u += gridDim.x)
    for (int64_t j = threadIdx.x * kVec; j < cols; j += step)
      store_vec(out + u * cols + j, zero);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
  }
  return sms;
}

// Blocks of `threads` threads that fit on the card at once, per kernel.
template <int kE, int kVec, bool kPrecise>
int resident_blocks(int threads) {
  static int cache[kMaxThreads / 32 + 1] = {};
  int& nb = cache[threads / 32];
  if (nb == 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sorted_segment_weighted_sum_kernel<kE, kVec, kPrecise>,
            threads, 0) != cudaSuccess)
      return 0;
    nb = per_sm * sm_count();
  }
  return nb;
}

template <int kE, int kVec, bool kPrecise>
cudaError_t launch(const float* g, const float* w, const int* ids, float* out,
                   float* scratch, int n, int c, int e, int num_out, int chunk,
                   cudaStream_t s) {
  int nchunks = n > 0 ? (n + chunk - 1) / chunk : 0;
  const int groups = c / kVec;
  const int threads = min(kMaxThreads, (groups + 31) / 32 * 32);
  const int cap = resident_blocks<kE, kVec, kPrecise>(threads);
  if (cap <= 0) return cudaErrorInvalidConfiguration;
  // A block an item, and at least two an SM for the zero rows past the
  // live ones: every block more is one more arrival at the grid barrier.
  const int64_t items = static_cast<int64_t>(nchunks) * ((e + kE - 1) / kE);
  const int64_t least = 2 * static_cast<int64_t>(sm_count());
  const int64_t want = items > least ? items : least;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  int* live_rows = reinterpret_cast<int*>(scratch);
  float* lpart = scratch + 4;  // 16-byte aligned
  void* args[] = {&g,   &w, &ids, &out,     &lpart, &live_rows,
                  &n,   &c, &e,   &num_out, &chunk, &nchunks};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(
          sorted_segment_weighted_sum_kernel<kE, kVec, kPrecise>),
      dim3(blocks), dim3(threads), args, 0, s);
}

}  // namespace

// scratch: at least 4 + ceil(n / chunk) * e * c floats, 16-byte aligned.
extern "C" int ftx_sorted_segment_weighted_sum(const float* g, const float* w,
                                               const int* ids, float* out,
                                               float* scratch, int n, int c,
                                               int e, int num_out, int chunk,
                                               int precise, void* stream) {
  if (n < 0 || c <= 0 || e <= 0 || num_out < 0 || chunk <= 0 ||
      chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  if (num_out == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads need every row of g 16-byte aligned.
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto run = precise != 0
                 ? (e == 1 ? (vec ? launch<1, 4, true> : launch<1, 1, true>)
                           : (vec ? launch<8, 4, true> : launch<8, 1, true>))
                 : (e == 1 ? (vec ? launch<1, 4, false> : launch<1, 1, false>)
                           : (vec ? launch<8, 4, false> : launch<8, 1, false>));
  return static_cast<int>(
      run(g, w, ids, out, scratch, n, c, e, num_out, chunk, s));
}
