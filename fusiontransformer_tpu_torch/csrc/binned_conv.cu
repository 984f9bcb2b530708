// Grouped binned submanifold conv for Hopper (sm_90a), plain C interface:
// the forward (K1) here, the backward (K2) below.
//
//   out[8*grp + vo, o] = sum_t sum_c feats[src(grp, t*8 + vo), c] * W[t, c, o]
//
// where slot j of 8-voxel group grp carries a source row src[grp, j] and a
// bin id bin[grp, j] = t*8 + vo (tap t of voxel vo in the group); at most one
// slot feeds a bin, and sentinel slots (bin >= 216 or src == V) feed none.
//
// Replaces the TPU kernel `binned_conv_fwd(..., grouped=True)` of
// fusiontransformer_tpu/ops/pallas/binned_conv.py (body `_fwd_kernel`, bins
// built by `_oh216`/`_bin216`) together with the row gather that its caller
// `_subm3gp_impl` (fusiontransformer_tpu/ops/sparse_conv.py) runs before it.
// On the TPU the slot rows are binned by a one-hot MXU matmul and the 27 tap
// products are 27 MXU matmuls over a VMEM-resident tile.  Here the gather is
// done in the kernel: a slot's bin id is its address in a 216-entry table.
//
// What bounds it on an H100: the work is 2*Cin*Cout flops per live slot
// (3-6 live bins per voxel on LiDAR scans at L0-L3) against about
// 2*Cin + 4*Cout bytes per voxel of rows read and written once.  At the
// 32-channel levels that is below the card's bf16 ridge (bytes bound); from
// about 96 channels up it is above it (operations bound).
//
// Two routes, picked by the wrapper from the operand dtype alone:
//
// * bf16 operands, the production path: `binned_conv_fwd_mma_kernel` below,
//   on the tensor cores (mma.sync bf16 -> f32), over a tap-major row table
//   built once a call (see its note).
// * f32 operands, the precise path (JAX's Precision.HIGHEST; the tensor
//   cores have no true f32): `binned_conv_grouped_fwd_kernel`, f32 FMAs on
//   the CUDA cores.  One thread block per 8-voxel group scatters its S slots
//   into a bin table in shared memory (row index per bin, -1 if empty); then,
//   for each tap t that has a live bin, it stages the (up to) 8 rows of that
//   tap in shared memory as xs[c][vo] (zeros for empty bins) and every
//   thread, owning one output channel o (or a few), adds xs[c][vo] *
//   W[t, c, o] into eight f32 accumulators, one per voxel.
//
// Either route visits the taps in a fixed order and sums the channels in a
// fixed order, and writes each output once: no atomics, bitwise repeatable.
// Products and sums are f32.
//
// Per-voxel K-slot maps (K1', K2').  The same kernels replace
// `binned_conv_fwd` / `binned_conv_bwd(..., grouped=False)` and the gathers
// of their callers `_subm3p_impl` / `_subm3p_bwd`.  There voxel v owns slots
// v*K .. v*K + K-1 of maps src, tap [V, K]; read as [V/8, 8K], slot j of
// group grp belongs to voxel j / K of the group and its bin is
// tap*8 + j / K (the TPU kernel's `_oh216` rule with an int k).  The kernels
// read the tap map themselves and apply that rule where they fill the bin
// table (`bin_of`); nothing else changes.  A voxel's live taps are distinct,
// so at most one slot feeds a bin here too.  Any K from 1 to 27 works: the
// TPU kernel's 8K % 128 == 0 is a TPU lane rule.  The work is the same as
// with group-pooled maps (it follows the live slots); the bin table is
// filled from 8K slots instead of S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBins = 216;  // 27 taps x 8 voxels, tap-major
constexpr int kTaps = 27;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The bin of slot j of a group, from its map code.  Group-pooled maps
// (k == 0) carry the bin id itself.  Per-voxel K-slot maps (k > 0) carry a
// tap id and the owning voxel is positional, slot j belonging to voxel j / k;
// the sentinel tap 27 (or any id outside [0, 27)) feeds no bin.
__device__ __forceinline__ int bin_of(int code, int j, int k) {
  if (k == 0) return code;
  return (code >= 0 && code < kTaps) ? code * 8 + j / k : kBins;
}

// kslots: 0 for group-pooled maps (`bins` holds bin ids), K for per-voxel
// K-slot maps (`bins` holds tap ids, s == 8K); see bin_of.
template <typename T, int NPER>
__global__ void binned_conv_grouped_fwd_kernel(
    const T* __restrict__ feats, const int* __restrict__ src,
    const int* __restrict__ bins, const T* __restrict__ w,
    float* __restrict__ out, int v, int s, int kslots, int cin, int cout) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [cin][8]
  __shared__ int row_of_bin[kBins];
  __shared__ int tap_live[kTaps];

  const int grp = blockIdx.x;
  const int tid = threadIdx.x;
  for (int b = tid; b < kBins; b += blockDim.x) row_of_bin[b] = -1;
  for (int t = tid; t < kTaps; t += blockDim.x) tap_live[t] = 0;
  __syncthreads();
  const int* src_g = src + (int64_t)grp * s;
  const int* bin_g = bins + (int64_t)grp * s;
  for (int j = tid; j < s; j += blockDim.x) {
    const int b = bin_of(bin_g[j], j, kslots);
    const int r = src_g[j];
    if (b >= 0 && b < kBins && r >= 0 && r < v) {
      row_of_bin[b] = r;
      tap_live[b >> 3] = 1;
    }
  }
  __syncthreads();

  float acc[NPER][8];
#pragma unroll
  for (int k = 0; k < NPER; ++k) {
#pragma unroll
    for (int vo = 0; vo < 8; ++vo) acc[k][vo] = 0.f;
  }

  for (int t = 0; t < kTaps; ++t) {
    if (!tap_live[t]) continue;  // same value in every thread of the block
    for (int idx = tid; idx < cin * 8; idx += blockDim.x) {
      const int vo = idx / cin;
      const int c = idx - vo * cin;
      const int r = row_of_bin[t * 8 + vo];
      xs[c * 8 + vo] = r >= 0 ? to_float(feats[(int64_t)r * cin + c]) : 0.f;
    }
    __syncthreads();
    const T* wt = w + (int64_t)t * cin * cout;
#pragma unroll
    for (int k = 0; k < NPER; ++k) {
      const int o = tid + k * blockDim.x;
      if (o < cout) {
#pragma unroll 4
        for (int c = 0; c < cin; ++c) {
          const float wv = to_float(wt[(int64_t)c * cout + o]);
          const float4 x0 = smem4[c * 2];
          const float4 x1 = smem4[c * 2 + 1];
          acc[k][0] += x0.x * wv;
          acc[k][1] += x0.y * wv;
          acc[k][2] += x0.z * wv;
          acc[k][3] += x0.w * wv;
          acc[k][4] += x1.x * wv;
          acc[k][5] += x1.y * wv;
          acc[k][6] += x1.z * wv;
          acc[k][7] += x1.w * wv;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < NPER; ++k) {
    const int o = tid + k * blockDim.x;
    if (o < cout) {
#pragma unroll
      for (int vo = 0; vo < 8; ++vo) {
        out[((int64_t)grp * 8 + vo) * cout + o] = acc[k][vo];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward (K2).  Replaces `binned_conv_bwd(..., grouped=True)` (body
// `_bwd_kernel`) of fusiontransformer_tpu/ops/pallas/binned_conv.py together
// with the dout row gather its caller `_subm3gp_bwd` runs before it.
//
// Submanifold mirror symmetry (offsets[26-t] == -offsets[t]) makes bin t of
// a group's binned dout tile hold bd[u, t] = dout[nbr(u, t)]: the same maps
// as the forward, read with dout in place of feats.  Then
//
//   dX[u]     = sum_t bd[u, t] @ W[26-t]^T      (K1's structure, with the
//                                                tap-reversed, transposed W)
//   dW[26-t]  = sum_u feats[u]^T (x) bd[u, t]
//
// dX is the forward's function on (dout, W'), W'[t] = W[26-t]^T.  With bf16
// operands it runs `binned_conv_fwd_mma_kernel`, which reads W'[t] straight
// from W[26-t] (non-transposed ldmatrix on its [Cin, Cout] panel), over the
// one row table that the dW kernel reads too.  With f32 operands it runs the
// CUDA-core forward on W' built by `flip_transpose_kernel` into scratch.
// dW is a reduction over every group:
// the TPU kernel carries it in VMEM across its sequential grid, which a GPU
// grid does not have.  Here the groups split into consecutive chunks; each
// block sums its chunk into a partial dW[chunk] and `reduce_chunks_kernel`
// then sums the partials over chunks in chunk order.  No float atomics
// anywhere: dX and dW are bitwise repeatable.
//
// What bounds it on an H100: the same operations as the forward for each of
// dX and dW (2*Cin*Cout flops per live slot), against rows read once and
// dX/dW written once: bytes bound at the 32-channel levels, operations bound
// from about 96 channels up.  dW has two routes, picked by the wrapper from
// the operand dtype (dX follows the same pick):
//
// * bf16 operands, the production path: `binned_conv_dw_mma_kernel` below,
//   on the tensor cores (see its note).
// * f32 operands, the precise path (JAX's Precision.HIGHEST): the tensor
//   cores have no true f32 (TF32 keeps ~3 digits), so f32 stays on
//   `binned_conv_grouped_dw_kernel`, f32 FMAs on the CUDA cores.  Each block
//   owns one (chunk of groups, 32x32 tile of (Cin, Cout)) and keeps all 27
//   taps of its tile in shared memory, walking its groups in order.
// ---------------------------------------------------------------------------

constexpr int kTile = 32;             // dW tile: 32 Cin x 32 Cout
constexpr int kDwThreads = 256;
constexpr int kTileElems = kTile * kTile;
constexpr int kPerThread = kTileElems / kDwThreads;
static_assert(kDwThreads == 8 * kTile, "one thread per staged feats value");
static_assert(kTileElems % kDwThreads == 0, "whole tile per block");

template <typename T>
__global__ void flip_transpose_kernel(const T* __restrict__ w,
                                      T* __restrict__ wt, int cin, int cout) {
  // wt[t, o, c] = w[26 - t, c, o]
  const int64_t per_tap = (int64_t)cin * cout;
  const int64_t n = kTaps * per_tap;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int t = (int)(i / per_tap);
    const int64_t rem = i - t * per_tap;
    const int o = (int)(rem / cin);
    const int c = (int)(rem - (int64_t)o * cin);
    wt[i] = w[((int64_t)(kTaps - 1 - t) * cin + c) * cout + o];
  }
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads) binned_conv_grouped_dw_kernel(
    const T* __restrict__ dout, const T* __restrict__ feats,
    const int* __restrict__ src, const int* __restrict__ bins,
    float* __restrict__ partial, int v, int s, int kslots, int cin,
    int cout, int groups_per_chunk) {
  // Dynamic shared memory: acc[27][32][32] then ds[27][8][32], f32.
  extern __shared__ float4 dw_smem4[];
  float* acc = reinterpret_cast<float*>(dw_smem4);
  float* ds = acc + kTaps * kTileElems;
  __shared__ float fs[8][kTile];
  __shared__ int row_of_bin[kBins];
  __shared__ int tap_live[kTaps];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int o0 = blockIdx.z * kTile;
  for (int i = tid; i < kTaps * kTileElems; i += kDwThreads) acc[i] = 0.f;

  const int ng = v / 8;
  const int g_begin = chunk * groups_per_chunk;
  const int g_end = min(ng, g_begin + groups_per_chunk);
  for (int grp = g_begin; grp < g_end; ++grp) {
    __syncthreads();  // the previous group is done with the tables and tiles
    for (int b = tid; b < kBins; b += kDwThreads) row_of_bin[b] = -1;
    for (int t = tid; t < kTaps; t += kDwThreads) tap_live[t] = 0;
    __syncthreads();
    const int* src_g = src + (int64_t)grp * s;
    const int* bin_g = bins + (int64_t)grp * s;
    for (int j = tid; j < s; j += kDwThreads) {
      const int b = bin_of(bin_g[j], j, kslots);
      const int r = src_g[j];
      if (b >= 0 && b < kBins && r >= 0 && r < v) {
        row_of_bin[b] = r;
        tap_live[b >> 3] = 1;
      }
    }
    __syncthreads();
    // feats tile of the group's 8 voxels, and the binned dout rows of every
    // live tap (zeros for empty bins).
    {
      const int vo = tid / kTile;
      const int c = tid - vo * kTile;
      const int cc = c0 + c;
      fs[vo][c] = cc < cin
          ? to_float(feats[((int64_t)grp * 8 + vo) * cin + cc]) : 0.f;
    }
    for (int idx = tid; idx < kTaps * 8 * kTile; idx += kDwThreads) {
      const int t = idx / (8 * kTile);
      if (!tap_live[t]) continue;
      const int vo = (idx / kTile) & 7;
      const int o = idx % kTile;
      const int oo = o0 + o;
      const int r = row_of_bin[t * 8 + vo];
      ds[idx] = (r >= 0 && oo < cout)
          ? to_float(dout[(int64_t)r * cout + oo]) : 0.f;
    }
    __syncthreads();
    // Thread tid owns tile elements e = tid + k*256: one column o = tid % 32
    // and the rows c = tid / 32 + 8k.  Its 8 x 4 feats values stay in
    // registers for the whole group and its 8 dout values for the tap, so
    // shared memory serves 16 accesses per 32 FMAs.
    const int o = tid % kTile;
    const int c_base = tid / kTile;
    float fv[kPerThread][8];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
#pragma unroll
      for (int vo = 0; vo < 8; ++vo) {
        fv[k][vo] = fs[vo][c_base + k * (kDwThreads / kTile)];
      }
    }
    for (int t = 0; t < kTaps; ++t) {
      if (!tap_live[t]) continue;  // same value in every thread of the block
      float* a = acc + t * kTileElems;
      const float* d = ds + t * 8 * kTile;
      float dv[8];
#pragma unroll
      for (int vo = 0; vo < 8; ++vo) dv[vo] = d[vo * kTile + o];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int e = tid + k * kDwThreads;
        float sum = a[e];
#pragma unroll
        for (int vo = 0; vo < 8; ++vo) sum += fv[k][vo] * dv[vo];
        a[e] = sum;
      }
    }
  }
  __syncthreads();
  // partial[chunk, 26 - t, c, o]: the tap reversal of dW[26-t].
  for (int t = 0; t < kTaps; ++t) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = tid + k * kDwThreads;
      const int c = c0 + e / kTile;
      const int o = o0 + e % kTile;
      if (c < cin && o < cout) {
        partial[(((int64_t)chunk * kTaps + (kTaps - 1 - t)) * cin + c) * cout
                + o] = acc[t * kTileElems + e];
      }
    }
  }
}

__global__ void reduce_chunks_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int nchunks,
                                     int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < nchunks; ++k) sum += partial[(int64_t)k * n + i];
    out[i] = sum;
  }
}

constexpr size_t kDwSmem =
    sizeof(float) * (kTaps * kTileElems + kTaps * 8 * kTile);

// ---------------------------------------------------------------------------
// Tensor-core dW (bf16 operands).  Replaces the `dwacc_ref` half of
// `_bwd_kernel` (fusiontransformer_tpu/ops/pallas/binned_conv.py, called from
// `binned_conv_bwd`).  By mirror symmetry, bin t of a group holds
// dout[nbr(u, t)], so each tap is one product over the level's voxel axis:
//
//   dW[26 - t] = feats^T @ BD_t,
//   BD_t[u] = dout[row_of_bin(grp(u), t*8 + u%8)]  (0 where the bin is empty)
//
// with M = Cin, N = Cout and the reduction over voxels.
//
// What bounds it on an H100: at the flagship's widths (Cin, Cout 32-384)
// these products are operations bound on the bf16 tensor cores once the
// reduction is fed from shared memory; the CUDA-core kernel above ran them
// as f32 FMAs at 67 TFLOP/s peak, with its accumulators in shared memory and
// three barriers per 8-voxel group.  The gather is not the limit: the rows
// a k-step needs are a few KB (PERF.md, T2/T3 at the flagship's indices).
//
// Design:
// * `bin_rows_kernel` first bins the maps once per call into a tap-major row
//   table rows[t, u] (the dout row feeding bin t of voxel u, -1 if none),
//   with `bin_of`'s rule for either kind of map (the backward's dX reads
//   it too).  A dW block then reads 4 bytes per voxel of its k-step
//   instead of re-scanning the group's S (or 8K) slot codes for every tap
//   and every (Cin, Cout) tile.
// * Taps in the grid: a block owns (one (Cin, Cout) tile of 32 or 64 x 32 or
//   64, one tap t, one chunk of groups).  Looping the 27 taps inside a block
//   would need 27 accumulator sets in registers; one tap keeps the block's
//   accumulator at 8-32 f32 registers a thread.  The feats rows of a chunk
//   are re-read by each tap's blocks, from L2: the grid runs the tiles and
//   taps of one chunk next to each other.
// * The block walks its chunk in k-steps of 64 voxels (8 groups).  Each
//   k-step stages the feats rows [64, Cin tile] (contiguous) and the gathered
//   dout rows [64, Cout tile] of tap t into shared memory as 16-byte
//   cp.async copies, in a 3-stage ring; empty bins and rows past the chunk
//   are zero-filled by cp.async itself (src-size 0), without branches.  The
//   tiles are K-major with XOR-swizzled 16-byte chunks, so ldmatrix.trans
//   reads them without bank conflicts as the A (feats^T) and B (BD_t)
//   fragments of mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Four warps
//   split the tile 2 x 2; the f32 accumulators live in registers.
// * The tensor cores truncate as they accumulate.  Fed one accumulator for
//   a whole chunk (~1000 k16 steps), that bias reached 1.4e-5 of the sum
//   of |terms| on a real bf16 train step (the bound is 2e-5).  So each
//   k-step's products start from zero in registers of their own and are
//   added to the accumulator with f32 round-to-nearest adds.
// * A k-step in which tap t has no live bin (padding groups, taps missing
//   across 64 voxels) skips its MMAs: the block learns it in the barrier
//   (`__syncthreads_or`) it needs anyway.
// * 24-48 KB of shared memory and at most 128 registers a thread: four or
//   more blocks fit on an SM.  The wrapper picks the chunk count for at
//   least two waves over the 132 SMs at every shape the flagship runs, with
//   the partials and the row table within ~64 MB.
// * Each block writes partial[chunk, 26 - t, tile] with plain stores and
//   `reduce_chunks_kernel` sums the chunks in order: bitwise repeatable.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 2 x 2 over the (Cin, Cout) tile
constexpr int kStepVoxels = 64;   // k-step: 8 groups of the reduction axis
constexpr int kStages = 3;        // cp.async ring depth

__global__ void bin_rows_kernel(const int* __restrict__ src,
                                const int* __restrict__ bins,
                                int* __restrict__ rows, int v, int s,
                                int kslots) {
  // rows [27, v], filled with -1 before: rows[t, g*8 + vo] = the source row
  // of bin t*8 + vo of group g.
  const int64_t n = (int64_t)(v / 8) * s;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int g = (int)(i / s);
    const int j = (int)(i - (int64_t)g * s);
    const int b = bin_of(bins[i], j, kslots);
    const int r = src[i];
    if (b >= 0 && b < kBins && r >= 0 && r < v) {
      rows[(int64_t)(b >> 3) * v + g * 8 + (b & 7)] = r;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of 16-byte chunk `chunk` of row `row` in a [64, W] bf16
// tile, W = 32 or 64: the chunks are XOR-swizzled so that the 8 rows one
// ldmatrix reads at one column fall in 8 distinct groups of 4 banks.
template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(W == 32 || W == 64, "tile width 32 or 64");
  if (W == 64) return row * 64 + ((chunk ^ (row & 7)) << 3);
  return row * 32 + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// Stage the 8 values src[0, 8) into dst, those at or past n (and all of
// them unless `ok`) as zeros.  `vec`: src is 16-byte aligned and n >= 8
// wherever ok, so one cp.async copies them (src must then be a readable
// address even when !ok); otherwise plain loads and stores.
__device__ __forceinline__ void stage8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool ok,
                                       int n, bool vec) {
  if (vec) {
    cp_async16(dst, src, ok);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[e] = (ok && e < n) ? src[e] : __float2bfloat16(0.f);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kMmaThreads, 4) binned_conv_dw_mma_kernel(
    const __nv_bfloat16* __restrict__ dout,
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ rows,
    float* __restrict__ partial, int v, int cin, int cout, int chunk_voxels,
    int vec_feats, int vec_dout) {
  constexpr int MT = BM / 32;  // m16 tiles of a warp's BM/2 rows of Cin
  constexpr int NT = BN / 16;  // n8 tiles of a warp's BN/2 columns of Cout
  // Staging: each thread copies 16-byte chunks of rows of the k-step.
  constexpr int F_CPR = BM / 8, F_RPP = kMmaThreads / F_CPR;
  constexpr int D_CPR = BN / 8, D_RPP = kMmaThreads / D_CPR;
  constexpr int F_PASSES = kStepVoxels / F_RPP;
  constexpr int D_PASSES = kStepVoxels / D_RPP;
  extern __shared__ float4 mma_smem4[];
  __nv_bfloat16* sf = reinterpret_cast<__nv_bfloat16*>(mma_smem4);
  __nv_bfloat16* sd = sf + kStages * kStepVoxels * BM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_n = (cout + BN - 1) / BN;
  const int c0 = (blockIdx.x / tiles_n) * BM;
  const int o0 = (blockIdx.x % tiles_n) * BN;
  const int t = blockIdx.y;
  const int chunk = blockIdx.z;
  const int u_begin = chunk * chunk_voxels;
  const int u_end = min(v, u_begin + chunk_voxels);
  const int nsteps = (u_end - u_begin + kStepVoxels - 1) / kStepVoxels;
  const int* rows_t = rows + (int64_t)t * v;
  const int f_row = tid / F_CPR, f_ch = tid % F_CPR, fc = c0 + f_ch * 8;
  const int d_row = tid / D_CPR, d_ch = tid % D_CPR, dc = o0 + d_ch * 8;

  // The dout rows of this thread's copies for the next k-step to stage,
  // loaded one k-step ahead so the row table's latency hides behind MMAs.
  int idx[D_PASSES];
  auto fetch_rows = [&](int step) {
#pragma unroll
    for (int p = 0; p < D_PASSES; ++p) {
      const int u = u_begin + step * kStepVoxels + d_row + p * D_RPP;
      idx[p] = (step < nsteps && u < u_end) ? rows_t[u] : -1;
    }
  };
  // Stage k-step `step` into its ring slot (one commit group, empty past
  // the end); true if one of this thread's dout rows is live.
  auto load_step = [&](int step) {
    bool live = false;
    if (step < nsteps) {
      const int slot = step % kStages;
      const int ub = u_begin + step * kStepVoxels;
      __nv_bfloat16* f = sf + slot * kStepVoxels * BM;
      __nv_bfloat16* d = sd + slot * kStepVoxels * BN;
#pragma unroll
      for (int p = 0; p < F_PASSES; ++p) {
        const int r = f_row + p * F_RPP;
        const bool ok = ub + r < u_end && fc < cin;
        stage8(f + swz<BM>(r, f_ch),
               ok ? feats + (int64_t)(ub + r) * cin + fc : feats, ok,
               cin - fc, vec_feats);
      }
#pragma unroll
      for (int p = 0; p < D_PASSES; ++p) {
        const int r = d_row + p * D_RPP;
        const bool ok = idx[p] >= 0 && dc < cout;
        live |= idx[p] >= 0;
        stage8(d + swz<BN>(r, d_ch),
               ok ? dout + (int64_t)idx[p] * cout + dc : dout, ok,
               cout - dc, vec_dout);
      }
    }
    cp_async_commit();
    return live;
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    }
  }
  unsigned live_bits = 0;  // bit s: this thread's rows in ring slot s live
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    fetch_rows(s);
    if (load_step(s)) live_bits |= 1u << s;
  }
  fetch_rows(kStages - 1);

  const int wm = (warp >> 1) * (BM / 2);  // the warp's rows of the tile
  const int wn = (warp & 1) * (BN / 2);   // and its columns
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kStages - 2>();
    const int slot = step % kStages;
    // Every thread's copies of this k-step have landed, and every warp is
    // done with the slot the next copy overwrites.
    const bool any = __syncthreads_or((live_bits >> slot) & 1u);
    const int next = (step + kStages - 1) % kStages;
    live_bits &= ~(1u << next);
    if (load_step(step + kStages - 1)) live_bits |= 1u << next;
    fetch_rows(step + kStages);
    if (!any) continue;  // tap t has no live bin in these 64 voxels
    const __nv_bfloat16* f = sf + slot * kStepVoxels * BM;
    const __nv_bfloat16* d = sd + slot * kStepVoxels * BN;
    // The tensor cores add into their f32 accumulator with truncation, not
    // round-to-nearest: over a chunk's ~1000 k16 steps that error grows
    // with a bias on sums of one sign.  So each k-step's 64 voxels go into
    // a fresh register set, added to acc in f32 (round-to-nearest) after
    // its 4 k16 steps; two n8 tiles at a time keep the extra registers at
    // 8 * MT.
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      float s[MT][2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][0][e] = s[i][1][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kStepVoxels / 16; ++kk) {
        // A = feats^T: matrices (m 0-7 | 8-15) x (k 0-7 | 8-15) of the
        // K-major tile, transposed by ldmatrix.trans.
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ldsm_x4_t(a[i],
                    f + swz<BM>(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                                (wm + i * 16) / 8 + ((lane >> 3) & 1)));
        }
        // B = BD_t: (k 0-7, 8-15) x (n 0-7, 8-15) of two n8 tiles.
        uint32_t b[4];
        ldsm_x4_t(b, d + swz<BN>(
                         kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                         (wn + jp * 16) / 8 + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816(s[i][0], a[i], b[0], b[1]);
          mma16816(s[i][1], a[i], b[2], b[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][2 * jp][e] += s[i][0][e];
          acc[i][2 * jp + 1][e] += s[i][1][e];
        }
      }
    }
  }

  // partial[chunk, 26 - t, c, o]: the tap reversal of dW[26-t].
  float* out =
      partial + ((int64_t)chunk * kTaps + (kTaps - 1 - t)) * cin * cout;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm + i * 16 + (lane >> 2) + h * 8;
        const int o = o0 + wn + j * 8 + 2 * (lane & 3);
        if (c < cin) {
          if (o < cout) out[(int64_t)c * cout + o] = acc[i][j][2 * h];
          if (o + 1 < cout) {
            out[(int64_t)c * cout + o + 1] = acc[i][j][2 * h + 1];
          }
        }
      }
    }
  }
}

template <int BM, int BN>
int launch_dw_mma(const void* dout, const void* feats, const int* rows,
                  float* partial, int v, int cin, int cout, int nchunks,
                  int chunk_groups, cudaStream_t stream) {
  constexpr int smem =
      (int)sizeof(__nv_bfloat16) * kStages * kStepVoxels * (BM + BN);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      binned_conv_dw_mma_kernel<BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc != 0) return rc;
  const dim3 grid(((cin + BM - 1) / BM) * ((cout + BN - 1) / BN), kTaps,
                  nchunks);
  const int vec_feats = cin % 8 == 0 && (uintptr_t)feats % 16 == 0;
  const int vec_dout = cout % 8 == 0 && (uintptr_t)dout % 16 == 0;
  binned_conv_dw_mma_kernel<BM, BN><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(feats), rows, partial, v, cin, cout,
      chunk_groups * 8, vec_feats, vec_dout);
  return static_cast<int>(cudaGetLastError());
}


// The tap-major row table rows[27, v] of either kind of map: -1, then
// `bin_rows_kernel`.  Built once a call; a backward's dX and dW both read it.
int build_rows(const int* src, const int* bins, int* rows, int v, int s,
               int kslots, cudaStream_t stream) {
  int rc = static_cast<int>(cudaMemsetAsync(
      rows, 0xff, sizeof(int) * (size_t)kTaps * v, stream));
  if (rc != 0) return rc;
  const int64_t nslots = (int64_t)(v / 8) * s;
  const int blocks = (int)((nslots + 255) / 256 < 4096 ? (nslots + 255) / 256
                                                       : 4096);
  if (blocks > 0) {
    bin_rows_kernel<<<blocks, 256, 0, stream>>>(src, bins, rows, v, s,
                                                kslots);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

int launch_dw_tensor_cores(const void* dout, const void* feats,
                           const int* rows, float* partial, int v, int cin,
                           int cout, int tile_m, int tile_n, int nchunks,
                           int chunk_groups, cudaStream_t stream) {
  switch (tile_m * 100 + tile_n) {
    case 3232:
      return launch_dw_mma<32, 32>(dout, feats, rows, partial, v, cin, cout,
                                   nchunks, chunk_groups, stream);
    case 3264:
      return launch_dw_mma<32, 64>(dout, feats, rows, partial, v, cin, cout,
                                   nchunks, chunk_groups, stream);
    case 6432:
      return launch_dw_mma<64, 32>(dout, feats, rows, partial, v, cin, cout,
                                   nchunks, chunk_groups, stream);
    case 6464:
      return launch_dw_mma<64, 64>(dout, feats, rows, partial, v, cin, cout,
                                   nchunks, chunk_groups, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core forward (bf16 operands): K1, K1' and the dX of K2 / K2'.
// Replaces `_fwd_kernel` of fusiontransformer_tpu/ops/pallas/binned_conv.py
// (`binned_conv_fwd`), which runs a block of voxels x 27 taps as bf16 MXU
// dots with f32 accumulation.  Over the row table rows[t, u] (the source row
// of bin t of voxel u, -1 if none):
//
//   out[u] = sum_t BX_t[u] @ W[t],   BX_t[u] = x[rows[t, u]]  (0 if -1)
//
// with M = voxels, N = Cout and the reduction over (live tap, Cin).  For dX,
// x is dout and W[t] is W'[t] = W[26 - t]^T, read from W in place (TW).
//
// What bounds it on an H100: operations bound from about 96 channels up
// (bf16 ridge ~295 flops a byte), bytes bound at the 32-channel levels,
// where the gathered 64-byte rows dominate (PERF.md has the bounds).  The
// CUDA-core kernel above ran the products as f32 FMAs, at most 67 TFLOP/s.
//
// Design:
// * Output-stationary: a block owns 64 voxels x one Cout tile of 32 or 64,
//   with f32 accumulators in registers; four warps split it 2 x 2.
// * The block first fills a [27, 64] row table of its voxels in shared
//   memory and learns which taps have a live bin among them (~20-45% of
//   (64-voxel tile, tap) pairs at L0-L3 on LiDAR scans).  The forward bins
//   the slot codes of its 8 groups itself (`bin_of`), one launch a call and
//   no scratch; a backward's dX reads the [27, V] row table that its dW
//   needs anyway, built once by `bin_rows_kernel`.  The block then walks
//   only the live taps, in tap order, each in k-steps of 32 or 64 channels:
//   a dead (tile, tap) costs nothing beyond its share of the binning.
// * Each k-step stages the gathered rows [64, BK] and the W panel
//   ([BK, BN], or [BN, BK] read from W[26-t] for TW) with 16-byte cp.async
//   in a 3-stage ring; empty bins, channels past Cin and columns past Cout
//   are zero-filled by cp.async itself (src-size 0).  Widths that are not
//   a multiple of 8 (Cin = 4 at the stem) take plain loads with the same
//   zero fill (`stage8`).  Tiles are XOR-swizzled 16-byte chunks, so the
//   ldmatrix reads of A (non-transposed), B ([BK, BN]: .trans; [BN, BK]:
//   non-transposed) are free of bank conflicts.
// * The tensor cores truncate as they accumulate (PERF.md, the dW kernel):
//   each k-step's products start from zero in registers of their own and
//   are added to the accumulator with f32 round-to-nearest adds.
// * Taps in a fixed order, each output written once with plain stores: the
//   result is bitwise repeatable.
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 128;  // 4 warps, 2 x 2 over (voxels, Cout)
constexpr int kFwdTileM = 64;     // voxels of a block
constexpr int kFwdStages = 3;     // cp.async ring depth

template <int BN, int BK, bool TW>
__global__ void __launch_bounds__(kFwdThreads, 4) binned_conv_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ src,
    const int* __restrict__ bins, const int* __restrict__ rows,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int v,
    int s, int kslots, int cin, int cout, int vec_x, int vec_w) {
  constexpr int BM = kFwdTileM;
  constexpr int MT = BM / 32;  // m16 tiles of a warp's 32 voxels
  constexpr int NT = BN / 16;  // n8 tiles of a warp's BN/2 columns
  // A [BM, BK]; B [BK, BN] (n contiguous) or, TW, [BN, BK] (k contiguous).
  constexpr int B_W = TW ? BK : BN;
  constexpr int B_ROWS = TW ? BN : BK;
  constexpr int A_CPR = BK / 8, A_RPP = kFwdThreads / A_CPR;
  constexpr int B_CPR = B_W / 8, B_RPP = kFwdThreads / B_CPR;
  constexpr int A_PASSES = BM / A_RPP, B_PASSES = B_ROWS / B_RPP;
  static_assert(A_PASSES >= 1 && B_PASSES >= 1, "whole tiles per pass");
  extern __shared__ float4 fwd_smem4[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(fwd_smem4);
  __nv_bfloat16* sb = sa + kFwdStages * BM * BK;
  __shared__ int rows_s[kTaps][BM];
  __shared__ int live_taps[kTaps];
  __shared__ unsigned live_mask;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_n = (cout + BN - 1) / BN;
  const int u0 = (blockIdx.x / tiles_n) * BM;
  const int o0 = (blockIdx.x % tiles_n) * BN;

  if (tid == 0) live_mask = 0u;
  unsigned mine = 0u;
  if (rows != nullptr) {
    // The row table's 27 x 64 entries of these voxels.
    for (int i = tid; i < kTaps * BM; i += kFwdThreads) {
      const int t = i / BM;
      const int r = i - t * BM;
      const int row = u0 + r < v ? rows[(int64_t)t * v + u0 + r] : -1;
      rows_s[t][r] = row;
      if (row >= 0) mine |= 1u << t;
    }
  } else {
    // No table: bin the slot codes of the tile's 8 groups here (the maps
    // are [V/8, s], contiguous over the tile; at most one slot a bin).
    for (int i = tid; i < kTaps * BM; i += kFwdThreads) {
      rows_s[i / BM][i % BM] = -1;
    }
    __syncthreads();
    const int g0 = u0 / 8;
    const int ng = min(BM / 8, v / 8 - g0);
    for (int j = tid; j < ng * s; j += kFwdThreads) {
      const int gl = j / s;
      const int slot = j - gl * s;
      const int64_t idx = (int64_t)(g0 + gl) * s + slot;
      const int b = bin_of(bins[idx], slot, kslots);
      const int r = src[idx];
      if (b >= 0 && b < kBins && r >= 0 && r < v) {
        rows_s[b >> 3][gl * 8 + (b & 7)] = r;
        mine |= 1u << (b >> 3);
      }
    }
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if (lane == 0 && mine) atomicOr(&live_mask, mine);
  __syncthreads();
  const unsigned mask = live_mask;
  if (tid < kTaps && ((mask >> tid) & 1u)) {
    live_taps[__popc(mask & ((1u << tid) - 1u))] = tid;
  }
  __syncthreads();
  const int nk = (cin + BK - 1) / BK;
  const int nsteps = __popc(mask) * nk;

  const int a_row = tid / A_CPR, a_ch = tid % A_CPR;
  const int b_row = tid / B_CPR, b_ch = tid % B_CPR;
  // Stage k-step `step` (live tap step / nk, channels (step % nk) * BK on)
  // into its ring slot: one commit group, empty past the end.
  auto load_step = [&](int step) {
    if (step < nsteps) {
      const int slot = step % kFwdStages;
      const int t = live_taps[step / nk];
      const int k0 = (step % nk) * BK;
      __nv_bfloat16* a = sa + slot * BM * BK;
      __nv_bfloat16* b = sb + slot * BK * BN;
#pragma unroll
      for (int p = 0; p < A_PASSES; ++p) {
        const int r = a_row + p * A_RPP;
        const int src = rows_s[t][r];
        const int c = k0 + a_ch * 8;
        const bool ok = src >= 0 && c < cin;
        stage8(a + swz<BK>(r, a_ch), ok ? x + (int64_t)src * cin + c : x, ok,
               cin - c, vec_x);
      }
#pragma unroll
      for (int p = 0; p < B_PASSES; ++p) {
        const int r = b_row + p * B_RPP;
        if (TW) {
          // B[k][n] = W[26 - t][n][k]: W is [27, cout, cin] here.
          const int n = o0 + r, k = k0 + b_ch * 8;
          const bool ok = n < cout && k < cin;
          stage8(b + swz<BK>(r, b_ch),
                 ok ? w + ((int64_t)(kTaps - 1 - t) * cout + n) * cin + k : w,
                 ok, cin - k, vec_w);
        } else {
          const int k = k0 + r, o = o0 + b_ch * 8;
          const bool ok = k < cin && o < cout;
          stage8(b + swz<BN>(r, b_ch),
                 ok ? w + ((int64_t)t * cin + k) * cout + o : w, ok,
                 cout - o, vec_w);
        }
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    }
  }
#pragma unroll
  for (int st = 0; st < kFwdStages - 1; ++st) load_step(st);

  const int wm = (warp >> 1) * (BM / 2);  // the warp's voxels of the tile
  const int wn = (warp & 1) * (BN / 2);   // and its columns
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kFwdStages - 2>();
    // Every thread's copies of this k-step have landed, and every warp is
    // done with the slot the next copy overwrites.
    __syncthreads();
    load_step(step + kFwdStages - 1);
    const int slot = step % kFwdStages;
    const __nv_bfloat16* a = sa + slot * BM * BK;
    const __nv_bfloat16* b = sb + slot * BK * BN;
    // Fresh registers for this k-step's products (the tensor cores truncate
    // as they accumulate), two n8 tiles at a time.
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      float part[MT][2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][0][e] = part[i][1][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: (m 0-7 | 8-15) x (k 0-7 | 8-15) of the row-major tile.
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ldsm_x4(af[i], a + swz<BK>(wm + i * 16 + (lane & 15),
                                     kk * 2 + (lane >> 4)));
        }
        // B: (k 0-7, 8-15) of two n8 tiles, in the order b0 b1 of the
        // first, b0 b1 of the second.
        uint32_t bf[4];
        if (TW) {
          ldsm_x4(bf, b + swz<BK>(wn + jp * 16 + (lane & 7) +
                                      ((lane >> 4) << 3),
                                  kk * 2 + ((lane >> 3) & 1)));
        } else {
          ldsm_x4_t(bf, b + swz<BN>(kk * 16 + (lane & 7) +
                                        (((lane >> 3) & 1) << 3),
                                    (wn + jp * 16) / 8 + (lane >> 4)));
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816(part[i][0], af[i], bf[0], bf[1]);
          mma16816(part[i][1], af[i], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][2 * jp][e] += part[i][0][e];
          acc[i][2 * jp + 1][e] += part[i][1][e];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = u0 + wm + i * 16 + (lane >> 2) + h * 8;
        const int o = o0 + wn + j * 8 + 2 * (lane & 3);
        if (u < v) {
          if (o < cout) out[(int64_t)u * cout + o] = acc[i][j][2 * h];
          if (o + 1 < cout) {
            out[(int64_t)u * cout + o + 1] = acc[i][j][2 * h + 1];
          }
        }
      }
    }
  }
}

template <int BN, int BK, bool TW>
int launch_fwd_mma_tile(const void* x, const int* src, const int* bins,
                        int s, int kslots, const int* rows, const void* w,
                        float* out, int v, int cin, int cout,
                        cudaStream_t stream) {
  constexpr int smem = (int)sizeof(__nv_bfloat16) * kFwdStages *
                       (kFwdTileM * BK + BK * BN);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      binned_conv_fwd_mma_kernel<BN, BK, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc != 0) return rc;
  const int64_t blocks = (int64_t)((v + kFwdTileM - 1) / kFwdTileM) *
                         ((cout + BN - 1) / BN);
  const int vec_x = cin % 8 == 0 && (uintptr_t)x % 16 == 0;
  const int vec_w = (TW ? cin : cout) % 8 == 0 && (uintptr_t)w % 16 == 0;
  binned_conv_fwd_mma_kernel<BN, BK, TW><<<(unsigned)blocks, kFwdThreads, smem,
                                           stream>>>(
      static_cast<const __nv_bfloat16*>(x), src, bins, rows,
      static_cast<const __nv_bfloat16*>(w), out, v, s, kslots, cin, cout,
      vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

// out [v, cout] = the forward's function of x [v, cin] over the row table
// `rows` or, with rows null, over the maps (src, bins [v/8, s], `bin_of`'s
// rule); tw: W is [27, cout, cin] and W[26 - t]^T is tap t's panel (dX).
int launch_fwd_mma(const void* x, const int* src, const int* bins, int s,
                   int kslots, const int* rows, const void* w, float* out,
                   int v, int cin, int cout, int tile_n, int tile_k, bool tw,
                   cudaStream_t stream) {
#define FTX_FWD_MMA(BN, BK, TW)                                              \
  launch_fwd_mma_tile<BN, BK, TW>(x, src, bins, s, kslots, rows, w, out, v, \
                                  cin, cout, stream)
  switch (tile_n * 1000 + tile_k * 10 + (tw ? 1 : 0)) {
    case 32320:
      return FTX_FWD_MMA(32, 32, false);
    case 32640:
      return FTX_FWD_MMA(32, 64, false);
    case 64320:
      return FTX_FWD_MMA(64, 32, false);
    case 64640:
      return FTX_FWD_MMA(64, 64, false);
    case 32321:
      return FTX_FWD_MMA(32, 32, true);
    case 32641:
      return FTX_FWD_MMA(32, 64, true);
    case 64321:
      return FTX_FWD_MMA(64, 32, true);
    case 64641:
      return FTX_FWD_MMA(64, 64, true);
    default:
      return cudaErrorInvalidValue;
  }
#undef FTX_FWD_MMA
}

template <typename T>
int launch(const void* feats, const int* src, const int* bins, const void* w,
           float* out, int v, int s, int kslots, int cin, int cout,
           cudaStream_t stream);

// route 0: dX and dW on the CUDA cores (either dtype; `wt` scratch for the
// flipped, transposed W); route 1: on the tensor cores (bf16 only; `rows`
// scratch for the row table, which both read; wt unused).  The groups split
// into nchunks chunks of chunk_groups consecutive groups (the last one
// shorter).
template <typename T>
int launch_bwd(const void* dout, const void* feats, const int* src,
               const int* bins, const void* w, void* wt, int* rows,
               float* partial, float* dx, float* dw, int v, int s, int kslots,
               int cin, int cout, int route, int tile_m, int tile_n,
               int nchunks, int chunk_groups, int dx_tile_n, int dx_tile_k,
               cudaStream_t stream) {
  const int64_t nw = (int64_t)kTaps * cin * cout;
  const int fill_blocks = (int)((nw + 255) / 256 < 1024 ? (nw + 255) / 256
                                                         : 1024);
  int rc;
  if (route == 1) {
    if (!std::is_same<T, __nv_bfloat16>::value) return cudaErrorInvalidValue;
    rc = build_rows(src, bins, rows, v, s, kslots, stream);
    if (rc != 0) return rc;
    // dX: the forward's function on dout with W'[t] = W[26 - t]^T.
    rc = launch_fwd_mma(dout, src, bins, s, kslots, rows, w, dx, v, cout,
                        cin, dx_tile_n, dx_tile_k, true, stream);
    if (rc != 0) return rc;
    rc = launch_dw_tensor_cores(dout, feats, rows, partial, v, cin, cout,
                                tile_m, tile_n, nchunks, chunk_groups,
                                stream);
  } else {
    flip_transpose_kernel<T><<<fill_blocks, 256, 0, stream>>>(
        static_cast<const T*>(w), static_cast<T*>(wt), cin, cout);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    // dX: the CUDA-core forward on dout with W' ([27, Cout, Cin]).
    rc = launch<T>(dout, src, bins, wt, dx, v, s, kslots, cout, cin, stream);
    if (rc != 0) return rc;
    rc = static_cast<int>(cudaFuncSetAttribute(
        binned_conv_grouped_dw_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem));
    if (rc != 0) return rc;
    const dim3 grid(nchunks, (cin + kTile - 1) / kTile,
                    (cout + kTile - 1) / kTile);
    binned_conv_grouped_dw_kernel<T><<<grid, kDwThreads, kDwSmem, stream>>>(
        static_cast<const T*>(dout), static_cast<const T*>(feats), src, bins,
        partial, v, s, kslots, cin, cout, chunk_groups);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  reduce_chunks_kernel<<<fill_blocks, 256, 0, stream>>>(partial, dw, nchunks,
                                                        nw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* feats, const int* src, const int* bins, const void* w,
           float* out, int v, int s, int kslots, int cin, int cout,
           cudaStream_t stream) {
  const int width = cout < 256 ? cout : 256;
  const int threads = (width + 31) / 32 * 32;
  const int nper = (cout + threads - 1) / threads;
  const dim3 grid(v / 8);
  const size_t smem = sizeof(float) * 8 * cin;
  const T* f = static_cast<const T*>(feats);
  const T* wt = static_cast<const T*>(w);
  switch (nper) {
    case 1:
      binned_conv_grouped_fwd_kernel<T, 1><<<grid, threads, smem, stream>>>(
          f, src, bins, wt, out, v, s, kslots, cin, cout);
      break;
    case 2:
      binned_conv_grouped_fwd_kernel<T, 2><<<grid, threads, smem, stream>>>(
          f, src, bins, wt, out, v, s, kslots, cin, cout);
      break;
    case 3:
      binned_conv_grouped_fwd_kernel<T, 3><<<grid, threads, smem, stream>>>(
          f, src, bins, wt, out, v, s, kslots, cin, cout);
      break;
    case 4:
      binned_conv_grouped_fwd_kernel<T, 4><<<grid, threads, smem, stream>>>(
          f, src, bins, wt, out, v, s, kslots, cin, cout);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

bool valid_tiles(int tile_n, int tile_k) {
  return (tile_n == 32 || tile_n == 64) && (tile_k == 32 || tile_k == 64);
}

// route 0: the CUDA-core kernel (either dtype); route 1: the tensor-core
// kernel (bf16; tile_n, tile_k each 32 or 64).
int fwd(const void* feats, const int* src, const int* bins, const void* w,
        float* out, int v, int s, int kslots, int cin, int cout, int route,
        int tile_n, int tile_k, int dtype, void* stream) {
  if (v < 0 || v % 8 != 0 || s < 0 || cin <= 0 || cin > 1024 || cout <= 0 ||
      cout > 1024) {
    return cudaErrorInvalidValue;
  }
  if (route == 1 && (dtype != 1 || !valid_tiles(tile_n, tile_k))) {
    return cudaErrorInvalidValue;
  }
  if (route != 0 && route != 1) return cudaErrorInvalidValue;
  if (v == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    return launch_fwd_mma(feats, src, bins, s, kslots, nullptr, w, out, v,
                          cin, cout, tile_n, tile_k, false, st);
  }
  if (dtype == 0) {
    return launch<float>(feats, src, bins, w, out, v, s, kslots, cin, cout,
                         st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(feats, src, bins, w, out, v, s, kslots, cin,
                                 cout, st);
  }
  return cudaErrorInvalidValue;
}

int bwd(const void* dout, const void* feats, const int* src, const int* bins,
        const void* w, void* wt, int* rows, float* partial, float* dx,
        float* dw, int v, int s, int kslots, int cin, int cout, int route,
        int tile_m, int tile_n, int nchunks, int chunk_groups, int dx_tile_n,
        int dx_tile_k, int dtype, void* stream) {
  if (v <= 0 || v % 8 != 0 || s < 0 || cin <= 0 || cin > 1024 ||
      cout <= 0 || cout > 1024 || nchunks < 1 || nchunks > 65535 ||
      chunk_groups < 1) {
    return cudaErrorInvalidValue;
  }
  // Every group in exactly one chunk, no chunk empty.
  const int ng = v / 8;
  if ((int64_t)(nchunks - 1) * chunk_groups >= ng ||
      (int64_t)nchunks * chunk_groups < ng) {
    return cudaErrorInvalidValue;
  }
  if (route == 1 && (dtype != 1 || rows == nullptr ||
                     chunk_groups % (kStepVoxels / 8) != 0 ||
                     !valid_tiles(dx_tile_n, dx_tile_k))) {
    return cudaErrorInvalidValue;
  }
  if (route == 0 && wt == nullptr) return cudaErrorInvalidValue;
  if (route != 0 && route != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(dout, feats, src, bins, w, wt, rows, partial, dx,
                             dw, v, s, kslots, cin, cout, route, tile_m,
                             tile_n, nchunks, chunk_groups, dx_tile_n,
                             dx_tile_k, st);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(dout, feats, src, bins, w, wt, rows,
                                     partial, dx, dw, v, s, kslots, cin, cout,
                                     route, tile_m, tile_n, nchunks,
                                     chunk_groups, dx_tile_n, dx_tile_k, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 operands, 1 = bfloat16 operands.  Output is float32.
// Group-pooled maps: src and bins [V/8, s], bins holding bin ids.  route 0:
// the CUDA-core kernel (either dtype; tile_n, tile_k unused); route 1: the
// tensor-core kernel (bf16; (Cout, Cin) tile tile_n x tile_k, each 32 or
// 64).
extern "C" int ftx_binned_conv_grouped_fwd(const void* feats, const int* src,
                                           const int* bins, const void* w,
                                           float* out, int v, int s, int cin,
                                           int cout, int route, int tile_n,
                                           int tile_k, int dtype,
                                           void* stream) {
  return fwd(feats, src, bins, w, out, v, s, 0, cin, cout, route, tile_n,
             tile_k, dtype, stream);
}

// Backward: dx [V, Cin] and dw [27, Cin, Cout], float32.  dout [V, Cout],
// feats [V, Cin] and w [27, Cin, Cout] share one operand dtype (0 = float32,
// 1 = bfloat16).  route 0: dX and dW on the CUDA cores (either dtype; the
// tile arguments unused; wt scratch of 27*Cin*Cout operands); route 1: on
// the tensor cores (bf16; dW tiles tile_m, tile_n each 32 or 64,
// chunk_groups a multiple of 8; dX tiles dx_tile_n (of Cin) x dx_tile_k (of
// Cout), each 32 or 64; rows scratch of 27*V int32, the one row table dX and
// dW read; wt unused).  The groups split into nchunks consecutive chunks of
// chunk_groups groups, the last one shorter, none empty.  partial: scratch
// of nchunks*27*Cin*Cout float32.
extern "C" int ftx_binned_conv_grouped_bwd(
    const void* dout, const void* feats, const int* src, const int* bins,
    const void* w, void* wt, int* rows, float* partial, float* dx, float* dw,
    int v, int s, int cin, int cout, int route, int tile_m, int tile_n,
    int nchunks, int chunk_groups, int dx_tile_n, int dx_tile_k, int dtype,
    void* stream) {
  return bwd(dout, feats, src, bins, w, wt, rows, partial, dx, dw, v, s, 0,
             cin, cout, route, tile_m, tile_n, nchunks, chunk_groups,
             dx_tile_n, dx_tile_k, dtype, stream);
}

// Per-voxel K-slot maps (K1' and K2'): src and tap [V, K] int32, read as the
// grouped layout [V/8, 8K] (the same memory); 1 <= K <= 27.  Otherwise as
// the two functions above.
extern "C" int ftx_binned_conv_slots_fwd(const void* feats, const int* src,
                                         const int* tap, const void* w,
                                         float* out, int v, int k, int cin,
                                         int cout, int route, int tile_n,
                                         int tile_k, int dtype,
                                         void* stream) {
  if (k < 1 || k > kTaps) return cudaErrorInvalidValue;
  return fwd(feats, src, tap, w, out, v, 8 * k, k, cin, cout, route, tile_n,
             tile_k, dtype, stream);
}

extern "C" int ftx_binned_conv_slots_bwd(
    const void* dout, const void* feats, const int* src, const int* tap,
    const void* w, void* wt, int* rows, float* partial, float* dx, float* dw,
    int v, int k, int cin, int cout, int route, int tile_m, int tile_n,
    int nchunks, int chunk_groups, int dx_tile_n, int dx_tile_k, int dtype,
    void* stream) {
  if (k < 1 || k > kTaps) return cudaErrorInvalidValue;
  return bwd(dout, feats, src, tap, w, wt, rows, partial, dx, dw, v, 8 * k,
             k, cin, cout, route, tile_m, tile_n, nchunks, chunk_groups,
             dx_tile_n, dx_tile_k, dtype, stream);
}
