// Sorted-segment weighted sum for Hopper (sm_90a), plain C interface.
//
//   out[u, e*C + c] = sum_{n : ids[n] == u} w[n, e] * g[n, c]
//
// Replaces the TPU kernel `sorted_segment_weighted_sum` of
// fusiontransformer_tpu/ops/pallas/segment_sum.py (body `_kernel`).  That
// kernel walks the point stream block by block on the TPU's sequential grid
// and carries a sliding accumulator window in VMEM from one step to the next.
// A GPU grid has no order and no carry, so this kernel uses the stream's
// sortedness instead: ids are nondecreasing over the whole array (live ids
// gapless on [0, nvalid), sentinels >= num_out at the tail), so output row u
// owns the contiguous point range [lower_bound(u), lower_bound(u + 1)).
//
// Design: one thread block per output row.  Two threads find the range by
// binary search; then the block's threads stride over the E*C columns and
// each sums its column over the range in point order.  No atomics: the
// result is bitwise repeatable.  Rows with an empty range are written as 0.
// Unless `precise`, each product w*g is rounded to bf16 before the f32 sum,
// as the TPU kernel rounds its one-hot matmul operand.
//
// What bounds it on an H100: bytes.  Each point row of g and w is read once
// and each output row written once, a few flops per byte; the binary search
// adds log2(N) reads of ids per block, which stay in L2.  Neighbouring threads
// read neighbouring columns of a point row, so the reads coalesce.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int lower_bound(const int* __restrict__ ids, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kPrecise>
__global__ void sorted_segment_weighted_sum_kernel(
    const float* __restrict__ g, const float* __restrict__ w,
    const int* __restrict__ ids, float* __restrict__ out, int n, int c,
    int e) {
  __shared__ int range[2];
  const int u = blockIdx.x;
  if (threadIdx.x == 0) range[0] = lower_bound(ids, n, u);
  if (threadIdx.x == 32) range[1] = lower_bound(ids, n, u + 1);
  __syncthreads();
  const int lo = range[0];
  const int hi = range[1];
  const int cols = e * c;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    const int ei = j / c;
    const int ci = j - ei * c;
    float acc = 0.f;
    for (int p = lo; p < hi; ++p) {
      // __fmul_rn/__fadd_rn: no contraction into an FMA, so the product is
      // rounded before the sum exactly as in the plain version.
      float prod = __fmul_rn(w[(int64_t)p * e + ei], g[(int64_t)p * c + ci]);
      if (!kPrecise) prod = __bfloat162float(__float2bfloat16_rn(prod));
      acc = __fadd_rn(acc, prod);
    }
    out[(int64_t)u * cols + j] = acc;
  }
}

}  // namespace

extern "C" int ftx_sorted_segment_weighted_sum(const float* g, const float* w,
                                               const int* ids, float* out,
                                               int n, int c, int e,
                                               int num_out, int precise,
                                               void* stream) {
  if (n < 0 || c <= 0 || e <= 0 || num_out < 0) return cudaErrorInvalidValue;
  if (num_out == 0) return cudaSuccess;
  const dim3 grid(num_out);
  const dim3 block(128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (precise) {
    sorted_segment_weighted_sum_kernel<true><<<grid, block, 0, s>>>(
        g, w, ids, out, n, c, e);
  } else {
    sorted_segment_weighted_sum_kernel<false><<<grid, block, 0, s>>>(
        g, w, ids, out, n, c, e);
  }
  return static_cast<int>(cudaGetLastError());
}
