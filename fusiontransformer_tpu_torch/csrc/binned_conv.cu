// Grouped binned submanifold conv, forward, for Hopper (sm_90a), plain C
// interface.
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

template <typename T, int NPER>
__global__ void binned_conv_grouped_fwd_kernel(
    const T* __restrict__ feats, const int* __restrict__ src,
    const int* __restrict__ bins, const T* __restrict__ w,
    float* __restrict__ out, int v, int s, int cin, int cout) {
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
    const int b = bin_g[j];
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

template <typename T>
int launch(const void* feats, const int* src, const int* bins, const void* w,
           float* out, int v, int s, int cin, int cout, cudaStream_t stream) {
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
          f, src, bins, wt, out, v, s, cin, cout);
      break;
    case 2:
      binned_conv_grouped_fwd_kernel<T, 2><<<grid, threads, smem, stream>>>(
          f, src, bins, wt, out, v, s, cin, cout);
      break;
    case 3:
      binned_conv_grouped_fwd_kernel<T, 3><<<grid, threads, smem, stream>>>(
          f, src, bins, wt, out, v, s, cin, cout);
      break;
    case 4:
      binned_conv_grouped_fwd_kernel<T, 4><<<grid, threads, smem, stream>>>(
          f, src, bins, wt, out, v, s, cin, cout);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 operands, 1 = bfloat16 operands.  Output is float32.
extern "C" int ftx_binned_conv_grouped_fwd(const void* feats, const int* src,
                                           const int* bins, const void* w,
                                           float* out, int v, int s, int cin,
                                           int cout, int dtype, void* stream) {
  if (v < 0 || v % 8 != 0 || s < 0 || cin <= 0 || cin > 1024 || cout <= 0 ||
      cout > 1024) {
    return cudaErrorInvalidValue;
  }
  if (v == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(feats, src, bins, w, out, v, s, cin, cout, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(feats, src, bins, w, out, v, s, cin, cout,
                                 st);
  }
  return cudaErrorInvalidValue;
}
