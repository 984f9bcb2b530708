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
// Design: one thread block per 8-voxel group.  The block first scatters its
// S slots into a bin table in shared memory (row index per bin, -1 if empty).
// Then, for each tap t that has a live bin, it stages the (up to) 8 rows of
// that tap in shared memory as xs[c][vo] (zeros for empty bins) and every
// thread, owning one output channel o (or a few), adds
// xs[c][vo] * W[t, c, o] into eight f32 accumulators, one per voxel.  Each
// W panel is read once per live tap and group, for all eight voxels; W is at
// most a few MB and stays in L2.  Taps are visited in fixed order and the
// channel sum in fixed order: no atomics, bitwise repeatable.  Operands are
// bf16 (or f32 for the precise path); products and sums are f32.
//
// What bounds it on an H100: the work is 2*Cin*Cout flops per live slot
// (about 10 live slots per voxel on LiDAR scans) against about
// 2*Cin + 4*Cout bytes per voxel of rows read and written once.  At the
// 32-channel levels that is below the card's bf16 ridge (bytes bound); from
// about 96 channels up it is above it (operations bound).  This simple
// version runs the products on the CUDA cores in f32, eight FMAs per W
// element it loads, so it is far from the bf16 tensor-core rate at the wide
// levels; wgmma tiles over the binned rows are the later step.
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
// dX runs the forward kernel above on (dout, W'), W'[t] = W[26-t]^T built by
// `flip_transpose_kernel` into scratch.  dW is a reduction over every group:
// the TPU kernel carries it in VMEM across its sequential grid, which a GPU
// grid does not have.  Here each block owns one (chunk of groups, 32x32 tile
// of (Cin, Cout)) and keeps all 27 taps of its tile in shared memory; it
// walks its groups in order and writes its partial dW; `reduce_chunks_kernel`
// then sums the partials over chunks in chunk order.  No float atomics
// anywhere: dX and dW are bitwise repeatable.
//
// What bounds it on an H100: the same operations as the forward for each of
// dX and dW (2*Cin*Cout flops per live slot), against rows read once and
// dX/dW written once: bytes bound at the 32-channel levels, operations bound
// from about 96 channels up.  Like the forward, this version runs f32 FMAs
// on the CUDA cores; the dW tile re-reads each live dout row once per
// Cin/32 tile (from L2).
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

template <typename T>
int launch(const void* feats, const int* src, const int* bins, const void* w,
           float* out, int v, int s, int kslots, int cin, int cout,
           cudaStream_t stream);

template <typename T>
int launch_bwd(const void* dout, const void* feats, const int* src,
               const int* bins, const void* w, void* wt, float* partial,
               float* dx, float* dw, int v, int s, int kslots, int cin,
               int cout, int nchunks, cudaStream_t stream) {
  const int64_t nw = (int64_t)kTaps * cin * cout;
  const int fill_blocks = (int)((nw + 255) / 256 < 1024 ? (nw + 255) / 256
                                                         : 1024);
  flip_transpose_kernel<T><<<fill_blocks, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<T*>(wt), cin, cout);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // dX: the forward kernel on dout with W' ([27, Cout, Cin]).
  rc = launch<T>(dout, src, bins, wt, dx, v, s, kslots, cout, cin, stream);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      binned_conv_grouped_dw_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem));
  if (rc != 0) return rc;
  const int ng = v / 8;
  const int gpc = (ng + nchunks - 1) / nchunks;
  const dim3 grid(nchunks, (cin + kTile - 1) / kTile,
                  (cout + kTile - 1) / kTile);
  binned_conv_grouped_dw_kernel<T><<<grid, kDwThreads, kDwSmem, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(feats), src, bins,
      partial, v, s, kslots, cin, cout, gpc);
  rc = static_cast<int>(cudaGetLastError());
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

int fwd(const void* feats, const int* src, const int* bins, const void* w,
        float* out, int v, int s, int kslots, int cin, int cout, int dtype,
        void* stream) {
  if (v < 0 || v % 8 != 0 || s < 0 || cin <= 0 || cin > 1024 || cout <= 0 ||
      cout > 1024) {
    return cudaErrorInvalidValue;
  }
  if (v == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
        const void* w, void* wt, float* partial, float* dx, float* dw, int v,
        int s, int kslots, int cin, int cout, int nchunks, int dtype,
        void* stream) {
  if (v <= 0 || v % 8 != 0 || s < 0 || cin <= 0 || cin > 1024 ||
      cout <= 0 || cout > 1024 || nchunks < 1 || nchunks > v / 8) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(dout, feats, src, bins, w, wt, partial, dx, dw,
                             v, s, kslots, cin, cout, nchunks, st);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(dout, feats, src, bins, w, wt, partial,
                                     dx, dw, v, s, kslots, cin, cout, nchunks,
                                     st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 operands, 1 = bfloat16 operands.  Output is float32.
// Group-pooled maps: src and bins [V/8, s], bins holding bin ids.
extern "C" int ftx_binned_conv_grouped_fwd(const void* feats, const int* src,
                                           const int* bins, const void* w,
                                           float* out, int v, int s, int cin,
                                           int cout, int dtype, void* stream) {
  return fwd(feats, src, bins, w, out, v, s, 0, cin, cout, dtype, stream);
}

// Backward: dx [V, Cin] and dw [27, Cin, Cout], float32.  dout [V, Cout],
// feats [V, Cin] and w [27, Cin, Cout] share one operand dtype (0 = float32,
// 1 = bfloat16).  Scratch from the caller: wt (27*Cin*Cout operands) and
// partial (nchunks*27*Cin*Cout float32); the groups split into nchunks
// consecutive chunks, 1 <= nchunks <= V/8.
extern "C" int ftx_binned_conv_grouped_bwd(
    const void* dout, const void* feats, const int* src, const int* bins,
    const void* w, void* wt, float* partial, float* dx, float* dw, int v,
    int s, int cin, int cout, int nchunks, int dtype, void* stream) {
  return bwd(dout, feats, src, bins, w, wt, partial, dx, dw, v, s, 0, cin,
             cout, nchunks, dtype, stream);
}

// Per-voxel K-slot maps (K1' and K2'): src and tap [V, K] int32, read as the
// grouped layout [V/8, 8K] (the same memory); 1 <= K <= 27.  Otherwise as
// the two functions above.
extern "C" int ftx_binned_conv_slots_fwd(const void* feats, const int* src,
                                         const int* tap, const void* w,
                                         float* out, int v, int k, int cin,
                                         int cout, int dtype, void* stream) {
  if (k < 1 || k > kTaps) return cudaErrorInvalidValue;
  return fwd(feats, src, tap, w, out, v, 8 * k, k, cin, cout, dtype, stream);
}

extern "C" int ftx_binned_conv_slots_bwd(
    const void* dout, const void* feats, const int* src, const int* tap,
    const void* w, void* wt, float* partial, float* dx, float* dw, int v,
    int k, int cin, int cout, int nchunks, int dtype, void* stream) {
  if (k < 1 || k > kTaps) return cudaErrorInvalidValue;
  return bwd(dout, feats, src, tap, w, wt, partial, dx, dw, v, 8 * k, k, cin,
             cout, nchunks, dtype, stream);
}
