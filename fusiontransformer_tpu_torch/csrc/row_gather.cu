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
// What bounds them on an H100: bytes, and at one 16384-row call the launch
// and the in-launch reduction.  A row is 64 B (C=32) or 256 B (C=128).  On
// the flagship's per-voxel maps most indices name one row, the pad row the
// maps use for an empty slot (84% at L0, 74% at L2), so where a row is read
// from matters as much as how many reads are in flight: in L2 that one
// address sits in one slice, and every copy that skips L1 queues there.
//
// T1: one warp per 8-row block, 16-byte loads (a whole 512 B block at C=32
// is one load per lane).
//
// T2 and T3 stage each block's contiguous slice of the indices into shared
// memory (tiles of kTile, 16-byte loads where aligned) and check the range
// there: no global index load sits between two row reads, and an index
// outside [0, R) is never read (it counts as a zero row and sets the error
// flag).  Threads sum in f32 registers in index order, blocks in a fixed
// order, and the blocks' partials are added in the same launch: the last
// block to finish (a ticket, an unsigned counter, which that block sets back
// to 0 for the next launch or CUDA-graph replay) adds them in block order,
// spread over its threads by column and fixed groups.  One launch a call, no
// float atomics, bitwise repeatable.  The wrapper gives each (device, stream)
// a ticket of its own (a slot of g_tickets): calls on one stream run in turn,
// and calls on two streams may overlap.  A CUDA graph keeps the ticket of the
// stream it was captured on, so replays of one graph must not overlap.
//
// T2: a thread owns one 16-byte column chunk of one "row lane" and keeps
// kRing 16-byte cp.async.ca copies in flight through its own slots of a ring
// in shared memory (the counterpart of the TPU chain's NBUF=8 row DMAs); .ca
// allocates in L1, where the pad row and the Morton-local neighbours hit.  A
// thread reads back only its own copies, so the loop has no block barrier.
// Blocks run in clusters of 8, two blocks an SM's worth; rank 0 adds its
// cluster's block sums through distributed shared memory, so the ticket's
// last block adds one row per cluster.  (Measured and dropped, PERF.md:
// per-row TMA bulk copies from a producer warp, which read through L2 only.)
//
// T3: a cluster of S blocks (S a power of two up to 16, smem_plan in the
// wrapper: 8 at L0, 16 at L2) holds the whole table, all C columns: row r in
// block r % S at local row r / S, filled by 16-byte cp.async (.ca; .cg read
// the same, PERF.md) while the block stages its first index tile (any C: a row is held as ceil(C / 8) 16-byte
// chunks, zero past C, filled by 2-byte loads where C % 8 != 0; rows of more
// than 8 x 512 columns are summed in column windows of at most 512 chunks,
// one thread a chunk).  After a cluster barrier every index reads
// its row's 16-byte chunks from the owning block's shared memory (mapa +
// ld.shared::cluster; ld.shared in its own block).  Each block also holds a
// copy of the table's last row, the pad row of the slot maps, which most
// indices name: those reads stay in the block instead of all going to one.
// The grid is as many clusters as fit on the card at once (occupancy), or
// fewer for a short list, so the table is read from device memory once per
// cluster and each index once.  The cluster's and the grid's sums are as
// T2's.  (Measured and dropped, PERF.md: the same without the pad-row
// copy; all rows of a column slice per block, the design before, in one
// launch.)
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kTile = 2048;       // indices staged in shared memory at once
constexpr int kMaxC = 2048;       // T2's columns: 16-byte chunks, one a thread
constexpr int kRing = 8;          // T2: row copies in flight per thread
constexpr int kT2Cluster = 8;
constexpr int kMaxCluster = 16;   // T3 (a non-portable cluster size)
constexpr int kUnroll = 8;        // T3: remote reads in flight per thread
constexpr int kTicketSlots = 1024;  // TICKET_SLOTS in the wrapper
// The block sum's scratch (floats) for kThr threads and at most 8 * kThr
// columns C: per-lane sums [lanes * C <= 8 * kThr], column group sums
// [max(kThr, C)], the block sum [C].
template <int kThr>
__host__ __device__ constexpr int red_bytes() {
  return 3 * 8 * kThr * 4;
}

__device__ unsigned int g_tickets[kTicketSlots];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, allocated in L1 (.ca); with pred
// false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block `rank`'s address of this block's shared-memory address `a`, and
// 16 or 4 bytes read there (or 16 in this block's shared memory).
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ uint4 ld_cluster16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_bf16x2(float* acc, uint32_t word) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&word);
  const float2 f = __bfloat1622float2(h);
  acc[0] += f.x;
  acc[1] += f.y;
}

// A 16-byte chunk of a row (8 bf16 columns) added to acc[0, 8).
__device__ __forceinline__ void add_chunk(float* acc, uint4 v) {
  add_bf16x2(acc + 0, v.x);
  add_bf16x2(acc + 2, v.y);
  add_bf16x2(acc + 4, v.z);
  add_bf16x2(acc + 6, v.w);
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

// ---- T2 / T3 frame --------------------------------------------------------
// Part `part`'s indices: [part * slice, (part + 1) * slice) of [0, n).
struct Slice {
  int64_t begin, end;
  __device__ Slice(int n, int slice, int part) {
    begin = min(static_cast<int64_t>(n), static_cast<int64_t>(part) * slice);
    end = min(static_cast<int64_t>(n), begin + slice);
  }
  // The length of the tile at t0: at most kTile (0 past the end).
  __device__ int tile(int64_t t0) const {
    return static_cast<int>(max(static_cast<int64_t>(0),
                                min(static_cast<int64_t>(kTile), end - t0)));
  }
};

// sidx[0, len) = src[0, len), -1 where the index is outside [0, rows); sets
// *err on such an index.  16-byte loads where src is 16-byte aligned.
__device__ void stage_indices(int* sidx, const int* __restrict__ src, int len,
                              int rows, int* err) {
  bool bad = false;
  auto fix = [&](int& r) {
    const bool ok = r >= 0 && r < rows;
    bad |= !ok;
    r = ok ? r : -1;
  };
  int k0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(sidx);
    const int n4 = len / 4;
#pragma unroll 4
    for (int k = threadIdx.x; k < n4; k += blockDim.x) {
      int4 v = __ldg(s4 + k);
      fix(v.x);
      fix(v.y);
      fix(v.z);
      fix(v.w);
      d4[k] = v;
    }
    k0 = n4 * 4;
  }
  for (int k = k0 + threadIdx.x; k < len; k += blockDim.x) {
    int r = __ldg(src + k);
    fix(r);
    sidx[k] = r;
  }
  if (bad && err != nullptr) *err = 1;
}

// out[0, c) = sum over rows q in order of partial[q, 0, c) (rows `stride`
// floats apart).  For c <= blockDim.x thread (column j, group g) adds rows
// g, g + G, ... and then the G group sums are added in order (scratch:
// blockDim.x floats of shared memory); else a thread adds a column's rows.
__device__ void sum_rows(const float* partial, float* out, int nrows,
                         int stride, int c, float* scratch) {
  const int groups = c <= static_cast<int>(blockDim.x) ? blockDim.x / c : 1;
  if (groups == 1) {
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      float s = 0.f;
      for (int q = 0; q < nrows; ++q)
        s += __ldcg(partial + static_cast<int64_t>(q) * stride + j);
      out[j] = s;
    }
    return;
  }
  for (int k = threadIdx.x; k < groups * c; k += blockDim.x) {
    const int j = k % c, g = k / c;
    float s = 0.f;
    for (int q = g; q < nrows; q += groups)
      s += __ldcg(partial + static_cast<int64_t>(q) * stride + j);
    scratch[g * c + j] = s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += scratch[g * c + j];
    out[j] = s;
  }
}

// Whether this block is the last of `blocks` to finish (its partial row is
// written); that block resets the ticket.  Every thread gets the answer.
__device__ bool last_block(unsigned int* ticket, unsigned int blocks) {
  __threadfence();
  __syncthreads();
  const bool last = __syncthreads_or(threadIdx.x == 0 &&
                                     atomicAdd(ticket, 1u) == blocks - 1);
  if (last) {
    __threadfence();
    if (threadIdx.x == 0) *ticket = 0u;
  }
  return last;
}

// The block's threads' sums in a fixed order into the block sum (returned,
// c floats in `red`, red_bytes<kThr>()): thread t (row lane t / cpr <
// lanes, chunk t % cpr) holds acc[8] for columns 8 * chunk ..; lanes are
// added in groups g = lane % G, then the G group sums in order.
template <int kThr>
__device__ float* block_sum(const float (&acc)[8], int cpr, float* red) {
  const int c = cpr * 8;
  const int lanes = kThr / cpr;
  const int t = threadIdx.x;
  const int lane = t / cpr;
  float* lane_sums = red;               // [lanes][c]
  float* group_sums = red + lanes * c;  // [G][c]
  float* bsum = group_sums + max(kThr, c);
  if (lane < lanes) {
#pragma unroll
    for (int j = 0; j < 8; ++j) lane_sums[lane * c + (t % cpr) * 8 + j] = acc[j];
  }
  __syncthreads();
  const int groups = c <= kThr ? kThr / c : 1;
  for (int k = t; k < groups * c; k += kThr) {
    const int j = k % c, g = k / c;
    float s = 0.f;
    for (int l = g; l < lanes; l += groups) s += lane_sums[l * c + j];
    group_sums[g * c + j] = s;
  }
  __syncthreads();
  for (int j = t; j < c; j += kThr) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += group_sums[g * c + j];
    bsum[j] = s;
  }
  return bsum;
}

// The grid's sum from the block sums (`bsum`, cp floats at the same
// shared-memory offset in every block): rank 0 of each cluster adds its
// blocks' sums in rank order (distributed shared memory) into its cluster's
// row of `partial` [clusters, cp]; the last cluster's rank 0 adds the rows
// in order into out[0, c), c <= cp.  `scratch`: blockDim.x floats of shared
// memory apart from bsum.
__device__ void cluster_sum(const float* bsum, int cp, int c, float* scratch,
                            float* partial, float* out,
                            unsigned int* ticket) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const unsigned int size = cluster.num_blocks();
  if (cluster.block_rank() == 0) {
    const uint32_t base = smem_u32(bsum);
    const unsigned int id = blockIdx.x / size;
    for (int j = threadIdx.x; j < cp; j += blockDim.x) {
      float s = 0.f;
      for (unsigned int k = 0; k < size; ++k)
        s += ld_cluster_f32(mapa(base + 4 * j, k));
      partial[static_cast<int64_t>(id) * cp + j] = s;
    }
    if (last_block(ticket, gridDim.x / size))
      sum_rows(partial, out, gridDim.x / size, cp, c, scratch);
  }
  cluster.sync();  // no block leaves while rank 0 reads its block sum
}

// ---- T2 -------------------------------------------------------------------
// Ring: [kRing][kThreads] 16-byte slots, thread t's own slot t of each
// stage (at least red_bytes, reused by the block sum); then the index tile.
__global__ void __launch_bounds__(kThreads)
    gather_rows_sum_pipelined_kernel(const uint4* __restrict__ feats,
                                     const int* __restrict__ idx,
                                     float* __restrict__ partial,
                                     float* __restrict__ out, int rows,
                                     int cpr, int n, int slice, int* err,
                                     unsigned int* ticket) {
  extern __shared__ __align__(16) uint4 smem[];
  constexpr int kRingVecs = kRing * kThreads > red_bytes<kThreads>() / 16
                                ? kRing * kThreads
                                : red_bytes<kThreads>() / 16;
  uint4* ring = smem;
  int* sidx = reinterpret_cast<int*>(smem + kRingVecs);
  const int lanes = kThreads / cpr;
  const int t = threadIdx.x;
  const int col = t % cpr;
  const int lane = t / cpr;
  const bool active = lane < lanes;
  const Slice sl(n, slice, blockIdx.x);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int64_t t0 = sl.begin; t0 < sl.end; t0 += kTile) {
    const int len = sl.tile(t0);
    __syncthreads();  // the previous tile's indices are no longer read
    stage_indices(sidx, idx + t0, len, rows, err);
    __syncthreads();
    const int steps = (len + lanes - 1) / lanes;
    auto fetch = [&](int s) {
      const int i = s * lanes + lane;
      const int r = active && i < len ? sidx[i] : -1;
      cp_async16(ring + (s % kRing) * kThreads + t,
                 feats + static_cast<int64_t>(r < 0 ? 0 : r) * cpr + col,
                 r >= 0);
    };
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      fetch(s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kRing - 1>();
      add_chunk(acc, ring[(s % kRing) * kThreads + t]);
      fetch(s + kRing);  // refills the slot this thread has just read
      cp_async_commit();
    }
    cp_async_wait<0>();
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  cluster_sum(block_sum<kThreads>(acc, cpr, red), cpr * 8, cpr * 8, red,
              partial, out, ticket);
}

// ---- T3 -------------------------------------------------------------------
// A row's chunks: ceil(c / 8); the column windows: as few as give each at
// most kThr chunks, of wc chunks each (the last may be shorter).
__host__ __device__ constexpr int t3_windows(int cpr, int threads) {
  return (cpr + threads - 1) / threads;
}

// Shared memory: the block's rows (at least red_bytes, reused by the sums),
// the index tile, the copy of the last row, and with more than one window
// the block sum [8 * cpr] floats.
template <int kThr>
__host__ __device__ constexpr int64_t smem_table_bytes(int rpb, int cpr) {
  return static_cast<int64_t>(rpb) * cpr * 16 > red_bytes<kThr>()
             ? static_cast<int64_t>(rpb) * cpr * 16
             : red_bytes<kThr>();
}

// Table rows r0, r0 + step, ... (nr of them) into dst [nr][cpr] 16-byte
// chunks, columns past c zero: cp.async where c % 8 == 0, else 2-byte loads.
template <int kThr>
__device__ void fill_rows(uint4* dst, const uint16_t* __restrict__ feats,
                          int r0, int step, int nr, int c, int cpr) {
  if (c % 8 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(feats);
    for (int k = threadIdx.x; k < nr * cpr; k += kThr) {
      const int lr = k / cpr, ch = k - lr * cpr;
      cp_async16(dst + k,
                 src + (r0 + static_cast<int64_t>(lr) * step) * cpr + ch);
    }
    return;
  }
  for (int k = threadIdx.x; k < nr * cpr; k += kThr) {
    const int lr = k / cpr, ch = k - lr * cpr;
    const uint16_t* row = feats + (r0 + static_cast<int64_t>(lr) * step) * c;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = ch * 8 + 2 * e;
      const uint32_t lo = j < c ? __ldg(row + j) : 0u;
      const uint32_t hi = j + 1 < c ? __ldg(row + j + 1) : 0u;
      w[e] = lo | (hi << 16);
    }
    dst[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// kWide: rows of more than kThr chunks, summed in column windows; else one
// window, unrolled away.
template <int kThr, bool kWide>
__global__ void __launch_bounds__(kThr)
    gather_rows_sum_smem_kernel(const uint16_t* __restrict__ feats,
                                const int* __restrict__ idx,
                                float* __restrict__ partial,
                                float* __restrict__ out, int rows, int c,
                                int rpb, int n, int slice, int* err,
                                unsigned int* ticket) {
  extern __shared__ __align__(16) uint4 smem[];
  const int cpr = (c + 7) / 8;
  const int wins = kWide ? t3_windows(cpr, kThr) : 1;
  const int wc = (cpr + wins - 1) / wins;
  int* sidx = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) +
                                     smem_table_bytes<kThr>(rpb, cpr));
  uint4* last_row = reinterpret_cast<uint4*>(sidx + kTile);
  float* wide = reinterpret_cast<float*>(last_row + cpr);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const int log_size = __ffs(size) - 1;
  const int t = threadIdx.x;
  // Fill: rows rank, rank + S, ... and the last row.
  const int nr = rows > rank ? (rows - rank + size - 1) / size : 0;
  fill_rows<kThr>(smem, feats, rank, size, nr, c, cpr);
  fill_rows<kThr>(last_row, feats, rows - 1, 0, 1, c, cpr);
  cp_async_commit();
  const Slice sl(n, slice, blockIdx.x);
  const uint32_t row_stride = cpr * 16;
  float acc[8];
  bool filled = false;
  for (int w = 0; w < wins; ++w) {
    // Thread t: chunk w0 + t % wn of the rows of lane t / wn.
    const int w0 = w * wc;
    const int wn = min(wc, cpr - w0);
    const int lanes = kWide ? 1 : kThr / wn;
    const int col = w0 + t % wn;
    const int lane = t / wn;
    const bool active = lane < lanes;
    const uint32_t tab = smem_u32(smem) + col * 16;
    const uint32_t pad = smem_u32(last_row) + col * 16;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int64_t t0 = sl.begin; t0 < sl.end || !filled; t0 += kTile) {
      const int len = sl.tile(t0);
      __syncthreads();
      stage_indices(sidx, idx + t0, len, rows, err);
      if (!filled) {  // the first tile was staged during the fill
        cp_async_wait<0>();
        cluster.sync();
        filled = true;
      } else {
        __syncthreads();
      }
      for (int i0 = lane; i0 < len; i0 += kUnroll * lanes) {
        // The batch's indices first, then its reads, all in flight at once.
        int r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * lanes;
          r[u] = active && i < len ? sidx[i] : -1;
        }
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (r[u] == rows - 1) {
            v[u] = ld_shared16(pad);
          } else if (r[u] >= 0) {
            const int owner = r[u] & (size - 1);
            const uint32_t a = tab + (r[u] >> log_size) * row_stride;
            v[u] = owner == rank ? ld_shared16(a)
                                 : ld_cluster16(mapa(a, owner));
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_chunk(acc, v[u]);
      }
    }
    if (kWide && active) {  // one lane: acc is the block's sum
#pragma unroll
      for (int j = 0; j < 8; ++j) wide[col * 8 + j] = acc[j];
    }
  }
  __syncthreads();
  cluster.sync();  // no block reads this block's rows any more
  float* red = reinterpret_cast<float*>(smem);
  cluster_sum(kWide ? wide : block_sum<kThr>(acc, cpr, red), cpr * 8, c, red,
              partial, out, ticket);
}

// ---- host ------------------------------------------------------------------
int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Let a kernel (0 T2, 1 T3, 2 T3 for wide rows) use all of a block's shared
// memory and clusters of up to 16 blocks, once per device, so that a launch
// inside a CUDA-graph capture makes no attribute call.
cudaError_t allow(const void* kernel, int which) {
  static bool done[64][3];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev][which]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    done[dev][which] = true;
  }
  return cudaSuccess;
}

// Ticket `slot` of this device, nullptr if there is no such slot.
unsigned int* ticket(int slot) {
  void* p = nullptr;
  if (slot < 0 || slot >= kTicketSlots ||
      cudaGetSymbolAddress(&p, g_tickets) != cudaSuccess)
    return nullptr;
  return static_cast<unsigned int*>(p) + slot;
}

constexpr int t2_smem() {
  return (kRing * kThreads * 16 > red_bytes<kThreads>()
              ? kRing * kThreads * 16
              : red_bytes<kThreads>()) +
         kTile * 4;
}

constexpr int kT3Threads = 512;

int64_t t3_smem(int rpb, int cpr) {
  return smem_table_bytes<kT3Threads>(rpb, cpr) + kTile * 4 + cpr * 16 +
         (t3_windows(cpr, kT3Threads) > 1 ? cpr * 32 : 0);
}

// `parts` index parts of `slice` (a multiple of 4) cover the n indices.
bool bad_grid(int n, int64_t parts, int slice) {
  return n < 0 || parts <= 0 || slice <= 0 || slice % 4 != 0 ||
         parts * slice < n;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters,
                                  int size, int threads, int64_t smem,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * size);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether T3 sums rows of c columns in column windows, and its kernel.
bool t3_wide(int c) { return t3_windows(ceil_div(c, 8), kT3Threads) > 1; }

const void* t3_kernel(int c) {
  return t3_wide(c)
             ? reinterpret_cast<const void*>(
                   gather_rows_sum_smem_kernel<kT3Threads, true>)
             : reinterpret_cast<const void*>(
                   gather_rows_sum_smem_kernel<kT3Threads, false>);
}

bool bad_t3(int c, int size, int rpb) {
  return c <= 0 || size < 1 || size > kMaxCluster ||
         (size & (size - 1)) != 0 || rpb <= 0 ||
         t3_smem(rpb, ceil_div(c, 8)) > kMaxSmem;
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

// T2.  feats [rows, c] bf16 (16-byte aligned, c % 8 == 0, c <= 2048), idx
// [n] int32, out [1, c] f32; `clusters` clusters of 8 blocks, block b taking
// indices [b * slice, (b + 1) * slice) (slice % 4 == 0); partial
// [clusters, c] f32 scratch; `slot` the stream's ticket (< 1024).
int ftx_gather_rows_sum_pipelined(const void* feats, const int* idx,
                                  float* partial, float* out, int rows, int c,
                                  int n, int clusters, int slice, int slot,
                                  int* err, void* stream) {
  if (rows <= 0 || c <= 0 || c % 8 != 0 || c > kMaxC ||
      bad_grid(n, static_cast<int64_t>(clusters) * kT2Cluster, slice))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      allow(reinterpret_cast<const void*>(gather_rows_sum_pipelined_kernel),
            0);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned int* tk = ticket(slot);
  if (tk == nullptr) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, clusters, kT2Cluster, kThreads, t2_smem(),
                     static_cast<cudaStream_t>(stream));
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, gather_rows_sum_pipelined_kernel,
      static_cast<const uint4*>(feats), idx, partial, out, rows, c / 8, n,
      slice, err, tk);
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

// T3.  As T2 but any c (16-byte aligned feats where c % 8 == 0), clusters
// of `size` blocks (a power of two up to 16) holding `rpb` rows of the
// table each (size * rpb >= rows), partial [clusters, 8 * ceil(c / 8)].
int ftx_gather_rows_sum_smem(const void* feats, const int* idx, float* partial,
                             float* out, int rows, int c, int size, int rpb,
                             int n, int clusters, int slice, int slot,
                             int* err, void* stream) {
  if (rows <= 0 || bad_t3(c, size, rpb) ||
      static_cast<int64_t>(size) * rpb < rows ||
      bad_grid(n, static_cast<int64_t>(clusters) * size, slice))
    return cudaErrorInvalidValue;
  const bool wide = t3_wide(c);
  const cudaError_t e = allow(t3_kernel(c), wide ? 2 : 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned int* tk = ticket(slot);
  if (tk == nullptr) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, clusters, size, kT3Threads, t3_smem(rpb, ceil_div(c, 8)),
      static_cast<cudaStream_t>(stream));
  const uint16_t* f = static_cast<const uint16_t*>(feats);
  const cudaError_t le =
      wide ? cudaLaunchKernelEx(
                 &cfg, gather_rows_sum_smem_kernel<kT3Threads, true>, f, idx,
                 partial, out, rows, c, rpb, n, slice, err, tk)
           : cudaLaunchKernelEx(
                 &cfg, gather_rows_sum_smem_kernel<kT3Threads, false>, f,
                 idx, partial, out, rows, c, rpb, n, slice, err, tk);
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of T3's kernel (`size` blocks of `rpb` rows of c columns) that
// fit on this card at once; 0 if none (or on an error).
int ftx_gather_rows_sum_smem_clusters(int c, int size, int rpb) {
  if (bad_t3(c, size, rpb) ||
      allow(t3_kernel(c), t3_wide(c) ? 2 : 1) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, 1, size, kT3Threads,
                     t3_smem(rpb, ceil_div(c, 8)), nullptr);
  int num = 0;
  if (cudaOccupancyMaxActiveClusters(&num, t3_kernel(c), &cfg) !=
      cudaSuccess)
    return 0;
  return num;
}

}  // extern "C"
