// Row-gather probes for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas row-gather probes of
// tools/microbench_dma_gather.py, which ask how fast a kernel can gather
// rows of a bf16 feature table [R, C] by the flagship's slot-map indices:
//
//   T1 gather_blocks8            (mosaic_bs_gather): out rows 8i..8i+7 are
//      table rows 8*(idx[i]/8) .. +7, for i < n/8 (one 8-row block per
//      index, the TPU's smallest DMA block); rows past the table's end read
//      as zero (on the TPU that partial block is undefined).
//   T2 gather_rows_sum_pipelined (dma_chain_gather): sum_i f32(table[idx[i]])
//      with a chain of asynchronous row copies in flight.
//   T3 gather_rows_sum_smem      (vmem_dyn_gather): the same sum with the
//      table resident on chip and rows read there by index.
//
// What bounds them on an H100: bytes, and at one 16384-row call the launch.
// A row is 64 B (C=32) or 256 B (C=128); each index costs one dependent
// 16-byte-granular read, so the rate is set by how many reads are in flight.
//
// Design.  T1: one warp per 8-row block, 16-byte loads (a whole 512 B block
// at C=32 is one load per lane).  T2: each block owns a contiguous slice of
// the indices; each thread owns one 16-byte column chunk of one "row lane"
// and keeps kRing cp.async copies in flight through a ring in shared memory
// (the counterpart of the TPU chain's NBUF=8 row DMAs); a thread reads back
// only the chunks it copied itself, so no block barrier is needed inside the
// loop.  T3: one block's 227 KB cannot hold a 1-2 MB flagship table, so each
// block holds all R rows of a slice of CS columns (CS in {8, 4, 2, 1}, the
// widest that fits) and reads its slice of the indices from there.  T2 and
// T3 sum in f32 registers in a fixed order per thread, then over the block's
// threads in a fixed order, then a second kernel adds the per-block partials
// in block order: no float atomics, bitwise repeatable.  The bf16 rows are
// read as they are (the TPU's f32 copy padded to 128 lanes was Mosaic's DMA
// rule).  An index outside [0, R) is never read: its row counts as zero and,
// where the caller passes an error flag, the flag is set to 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kRing = 8;          // T2: row copies in flight per thread
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: no read, the 16 bytes are zeroed
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

__device__ __forceinline__ void add_bf16x2(float* acc, uint32_t word) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&word);
  const float2 f = __bfloat1622float2(h);
  acc[0] += f.x;
  acc[1] += f.y;
}

// ---- T1 -------------------------------------------------------------------
__global__ void gather_blocks8_kernel(const uint4* __restrict__ feats,
                                      const int* __restrict__ idx,
                                      uint4* __restrict__ out, int rows,
                                      int chunks_per_row, int groups,
                                      int* err) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= groups) return;
  const int r = idx[warp];
  const bool ok = r >= 0 && r < rows;
  if (!ok && lane == 0 && err != nullptr) *err = 1;
  const int first = ok ? (r >> 3) << 3 : 0;
  const int chunks = 8 * chunks_per_row;
  const int live = ok ? min(rows - first, 8) * chunks_per_row : 0;
  const uint4* src = feats + static_cast<int64_t>(first) * chunks_per_row;
  uint4* dst = out + static_cast<int64_t>(warp) * chunks;
  for (int k = lane; k < chunks; k += 32) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < live) v = __ldg(src + k);
    dst[k] = v;
  }
}

// ---- T2 -------------------------------------------------------------------
// Ring layout: [kRing][lanes][cpr] 16-byte chunks, lanes = kThreads / cpr
// row lanes; thread t owns (lane t / cpr, chunk t % cpr).
__global__ void __launch_bounds__(kThreads)
    gather_rows_sum_pipelined_kernel(const uint4* __restrict__ feats,
                                     const int* __restrict__ idx,
                                     float* __restrict__ partial, int rows,
                                     int cpr, int n, int slice, int* err) {
  extern __shared__ uint4 ring[];
  const int lanes = kThreads / cpr;
  const int t = threadIdx.x;
  const int col = t % cpr;
  const int lane = t / cpr;
  const bool active = lane < lanes;
  const int begin = blockIdx.x * slice;
  const int end = min(n, begin + slice);
  const int steps = (end - begin + lanes - 1) / lanes;

  auto fetch = [&](int step) {
    if (!active) return;
    const int i = begin + step * lanes + lane;
    const bool in = step < steps && i < end;
    const int r = in ? idx[i] : 0;
    const bool ok = in && r >= 0 && r < rows;
    if (in && !ok && err != nullptr) *err = 1;
    cp_async16(&ring[((step % kRing) * lanes + lane) * cpr + col],
               feats + static_cast<int64_t>(ok ? r : 0) * cpr + col, ok);
  };

  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < kRing; ++s) {
    fetch(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRing - 1>();
    if (active) {
      const uint4 v = ring[((s % kRing) * lanes + lane) * cpr + col];
      add_bf16x2(acc + 0, v.x);
      add_bf16x2(acc + 2, v.y);
      add_bf16x2(acc + 4, v.z);
      add_bf16x2(acc + 6, v.w);
    }
    fetch(s + kRing);  // refills the slot this thread has just read
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  // Block sum in a fixed order: per column, row lanes 0..lanes-1.
  float* red = reinterpret_cast<float*>(ring);  // [lanes][cpr * 8]
  const int c = cpr * 8;
  if (active) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[lane * c + col * 8 + j] = acc[j];
  }
  __syncthreads();
  for (int j = t; j < c; j += kThreads) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += red[l * c + j];
    partial[static_cast<int64_t>(blockIdx.x) * c + j] = s;
  }
}

// ---- T3 -------------------------------------------------------------------
template <int CS>
struct Cols;
template <>
struct Cols<8> {
  using T = uint4;
  __device__ static void add(float* a, T v) {
    add_bf16x2(a + 0, v.x);
    add_bf16x2(a + 2, v.y);
    add_bf16x2(a + 4, v.z);
    add_bf16x2(a + 6, v.w);
  }
};
template <>
struct Cols<4> {
  using T = uint2;
  __device__ static void add(float* a, T v) {
    add_bf16x2(a + 0, v.x);
    add_bf16x2(a + 2, v.y);
  }
};
template <>
struct Cols<2> {
  using T = uint32_t;
  __device__ static void add(float* a, T v) { add_bf16x2(a, v); }
};
template <>
struct Cols<1> {
  using T = unsigned short;
  __device__ static void add(float* a, T v) {
    a[0] += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&v));
  }
};

// grid (C / CS column slices, splits); block b holds table[:, cs0:cs0+CS].
template <int CS>
__global__ void __launch_bounds__(kThreads)
    gather_rows_sum_smem_kernel(const unsigned short* __restrict__ feats,
                                const int* __restrict__ idx,
                                float* __restrict__ partial, int rows, int c,
                                int n, int slice, int* err) {
  using V = typename Cols<CS>::T;
  extern __shared__ uint4 smem_raw[];
  V* tab = reinterpret_cast<V*>(smem_raw);
  const int cs0 = blockIdx.x * CS;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    tab[r] = *reinterpret_cast<const V*>(feats + static_cast<int64_t>(r) * c +
                                         cs0);
  }
  __syncthreads();
  float acc[CS];
#pragma unroll
  for (int j = 0; j < CS; ++j) acc[j] = 0.f;
  const int begin = blockIdx.y * slice;
  const int end = min(n, begin + slice);
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const int r = idx[i];
    if (r < 0 || r >= rows) {
      if (err != nullptr) *err = 1;
      continue;
    }
    Cols<CS>::add(acc, tab[r]);
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [kThreads][CS]
#pragma unroll
  for (int j = 0; j < CS; ++j) red[threadIdx.x * CS + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < CS) {
    float s = 0.f;
    for (int l = 0; l < kThreads; ++l) s += red[l * CS + threadIdx.x];
    partial[static_cast<int64_t>(blockIdx.y) * c + cs0 + threadIdx.x] = s;
  }
}

// out[j] = sum over blocks b in order of partial[b, j]; 0 when nblocks == 0.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int nblocks,
                                    int c) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < c;
       j += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += partial[static_cast<int64_t>(b) * c + j];
    out[j] = s;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Contiguous index slices of `unit`-aligned length, at most max_blocks.
void split(int n, int unit, int max_blocks, int* slice, int* nblocks) {
  if (n == 0) {
    *slice = unit;
    *nblocks = 0;
    return;
  }
  const int want = std::min(max_blocks, ceil_div(n, unit));
  *slice = ceil_div(ceil_div(n, want), unit) * unit;
  *nblocks = ceil_div(n, *slice);
}

int sum_partials(const float* partial, float* out, int nblocks, int c,
                 cudaStream_t s) {
  sum_partials_kernel<<<ceil_div(c, kThreads), kThreads, 0, s>>>(
      partial, out, nblocks, c);
  return static_cast<int>(cudaGetLastError());
}

template <int CS>
int launch_smem(const void* feats, const int* idx, float* partial, int rows,
                int c, int n, int nsplit, int slice, int* err,
                cudaStream_t s) {
  const size_t table = static_cast<size_t>(rows) * CS * 2;
  const size_t red = static_cast<size_t>(kThreads) * CS * 4;
  const size_t bytes = ((table > red ? table : red) + 15) / 16 * 16;
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  // Allow the full shared memory once per device, so that a launch inside a
  // CUDA graph capture makes no attribute call.
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !allowed[dev]) {
    e = cudaFuncSetAttribute(gather_rows_sum_smem_kernel<CS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) allowed[dev] = true;
  }
  const dim3 grid(c / CS, nsplit);
  gather_rows_sum_smem_kernel<CS><<<grid, kThreads, bytes, s>>>(
      static_cast<const unsigned short*>(feats), idx, partial, rows, c, n,
      slice, err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// T1.  feats [rows, c] bf16, idx [n] int32 (n % 8 == 0, c % 8 == 0),
// out [n, c] bf16; err: nullptr or one int the kernel sets to 1 on an index
// outside [0, rows).
int ftx_gather_blocks8(const void* feats, const int* idx, void* out, int rows,
                       int c, int n, int* err, void* stream) {
  if (rows <= 0 || c <= 0 || c % 8 != 0 || n < 0 || n % 8 != 0)
    return cudaErrorInvalidValue;
  const int groups = n / 8;
  if (groups == 0) return cudaSuccess;
  const int warps_per_block = kThreads / 32;
  gather_blocks8_kernel<<<ceil_div(groups, warps_per_block), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(feats), idx, static_cast<uint4*>(out), rows,
      c / 8, groups, err);
  return static_cast<int>(cudaGetLastError());
}

// T2.  feats [rows, c] bf16 (c % 8 == 0, c <= 2048), idx [n] int32, partial
// [max_blocks, c] f32 scratch (one row per block; at most max_blocks blocks
// run), out [c] f32.
int ftx_gather_rows_sum_pipelined(const void* feats, const int* idx,
                                  float* partial, float* out, int rows, int c,
                                  int n, int max_blocks, int* err,
                                  void* stream) {
  if (rows <= 0 || c <= 0 || c % 8 != 0 || c / 8 > kThreads || n < 0 ||
      max_blocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpr = c / 8;
  const int lanes = kThreads / cpr;
  int slice, nblocks;
  split(n, lanes, max_blocks, &slice, &nblocks);
  if (nblocks > 0) {
    const size_t bytes = static_cast<size_t>(kRing) * lanes * cpr * 16;
    gather_rows_sum_pipelined_kernel<<<nblocks, kThreads, bytes, s>>>(
        static_cast<const uint4*>(feats), idx, partial, rows, cpr, n, slice,
        err);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return sum_partials(partial, out, nblocks, c, s);
}

// T3.  feats [rows, c] bf16, idx [n] int32, cs in {8, 4, 2, 1} dividing c,
// with the column slice [rows, cs] fitting in shared memory; partial
// [max_blocks, c] f32 scratch (about max_blocks blocks run: c / cs column
// slices times the index splits, one partial row per split), out [c] f32.
int ftx_gather_rows_sum_smem(const void* feats, const int* idx, float* partial,
                             float* out, int rows, int c, int cs, int n,
                             int max_blocks, int* err, void* stream) {
  if (rows <= 0 || c <= 0 || cs <= 0 || c % cs != 0 || n < 0 ||
      max_blocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slices = c / cs;
  const int max_splits = std::max(1, ceil_div(max_blocks, slices));
  int slice, nsplit;
  split(n, 4096, max_splits, &slice, &nsplit);
  if (nsplit > 0) {
    int rc;
    switch (cs) {
      case 8:
        rc = launch_smem<8>(feats, idx, partial, rows, c, n, nsplit, slice,
                            err, s);
        break;
      case 4:
        rc = launch_smem<4>(feats, idx, partial, rows, c, n, nsplit, slice,
                            err, s);
        break;
      case 2:
        rc = launch_smem<2>(feats, idx, partial, rows, c, n, nsplit, slice,
                            err, s);
        break;
      case 1:
        rc = launch_smem<1>(feats, idx, partial, rows, c, n, nsplit, slice,
                            err, s);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  return sum_partials(partial, out, nsplit, c, s);
}

}  // extern "C"
