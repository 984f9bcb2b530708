// Flash attention forward for Hopper (sm_90a), plain C interface.
//
//   out[b, h] = softmax(q[b, h] k[b, h]^T * sm_scale) v[b, h]
//
// q [BH, Nq, 64], k and v [BH, Nk, 64], out [BH, Nq, 64], all bf16; any
// Nq, Nk >= 1; non-causal, forward only.
//
// Replaces the Pallas TPU flash attention that
// tools/microbench_attention.py:42 (`flash_attn`) calls, JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py.  Its arithmetic is
// kept: f32 scores of bf16 operands, an online base-2 softmax carrying the
// row max m, the row sum l and the output accumulator in f32, the
// unnormalised probabilities rounded to bf16 for the PV product, f32
// accumulation, and the result divided by l and rounded to bf16.  The TPU
// kernel needs the sequence length to be a multiple of its 128-wide blocks
// (it raises at the DeiT-B/384 length of 578 tokens); this one masks the
// ragged tail: keys past Nk score -inf before the row max, query rows past
// Nq are not stored.
//
// What bounds it on an H100, at B = 8, H = 12, N = 578 (DeiT-B/384): a call
// moves ~28 MB (8.5 us at 3.35 TB/s), does ~8.2 GFLOP in its two products
// (8.3 us at 989 TFLOP/s) and 32.1 M exponentials (B*H*N^2; the SFUs give
// 16 a clock per SM, CUDA C Programming Guide's throughput table for compute
// capability 9.0: ~7.7 us at 132 SMs x 1.98 GHz).  All three are about
// equal, so the kernel has to keep the tensor cores, the SFUs and the loads
// busy at once.
//
// Design (the shape of FlashAttention-3, Shah et al. 2024, written by hand):
// * Both products on `wgmma.mma_async` (bf16 -> f32): S = Q K^T as
//   m64n64k16 with Q and K read from shared memory (K-major); O += P V as
//   m64n64k16 with P in registers as the A operand and V from shared memory
//   (MN-major).  A consumer warpgroup owns 64 query rows and walks 64-key
//   tiles.  128-key tiles need 48 more score and P registers a thread than
//   the 128 that three blocks to an SM leave; short of registers, ptxas
//   serialised the wgmmas (C7512, 168 a thread) and they ran slower.
// * Loads by TMA: one thread of a producer warp issues 3-D tensor-map
//   loads ([B*H, N, 64], 128-byte swizzle, the layout the wgmma
//   descriptors read) of the Q tile and of a 3-stage K / V ring,
//   completing on mbarriers; rows past N zero-fill inside their own head.  cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so nothing links libcuda.
// * The softmax of S_t runs while the tensor cores run P_{t-1} V_{t-1}:
//   each step issues S_t and the previous PV product as two wgmma groups,
//   waits for the first, runs the softmax, then waits for the second and
//   rescales O (FlashAttention-3's intra-warpgroup pipelining).  Holding a
//   second score tile to hide S_t's own latency made ptxas serialise the
//   wgmmas (C7515), and ran slower.
// * A step is latency-bound (wait for S_t, softmax, wait for PV), so an SM
//   needs several warpgroups in flight.  The producer is a single warp, not
//   a warpgroup, so that three blocks of one consumer warpgroup each (160
//   threads, 128 registers) share an SM, each block a 64-query tile.
//   128-query tiles (two consumer warpgroups a block taking turns to issue
//   their MMAs, ping-pong on named barriers) ran slower at B = 1, 2 and 8
//   on an H100 (PERF.md), and were taken out.
// * The ragged tail: the last key tile masks its dead keys to -inf, and
//   skips the exponentials of 8-key fragments and the PV k-steps of 16 keys
//   that are wholly dead.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 12; PERF.md):
// faster than SDPA at B = 1, level at B = 2, 1.05x slower at B = 8, about
// 4.6x the bound there.
//
// ptxas (chip_smoke.py phase 1, sm_90a): 128 registers, no spills.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim: one 128-byte bf16 row
constexpr int kBlockN = 64;               // keys per tile
constexpr int kStages = 3;                // K / V ring depth
constexpr int kS = kBlockN / 2;           // score registers a thread
constexpr int kP = kBlockN / 4;           // P registers a thread
constexpr int kTileBytes = kBlockN * kD * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Rows [row, row + box) of head `bh` of a [BH, N, 64] tensor map.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(bh)
      : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled tile of 64-wide
// bf16 rows: 8-row atoms of 1024 bytes (SBO), LBO unused, layout SWIZZLE_128B.
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of a wgmma operand across
// the issue / wait statements.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[0..32) (+)= A (smem, K-major) * B (smem, K-major), m64n64k16.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..32) += A (registers) * B (smem, MN-major), m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

struct __align__(1024) Smem {
  __nv_bfloat16 q[64 * kD];
  __nv_bfloat16 k[kStages][kBlockN * kD];
  __nv_bfloat16 v[kStages][kBlockN * kD];
  uint64_t q_full;
  uint64_t k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

// Online softmax of one key tile in place.  s holds this thread's scores of
// rows r and r + 8 (s[4j + 2i + c]: row 16*warp + lane/4 + 8i, key 8j +
// 2*(lane%4) + c of the tile); `live` keys of the tile are real.  On return
// s holds p = 2^(s * scale_log2 - m) and alpha the factor that rescales the
// earlier sums.
__device__ __forceinline__ void softmax_tile(float (&s)[kS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int live, float scale_log2,
                                             int lane) {
  const bool tail = live < kBlockN;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (tail && 8 * j + 2 * (lane & 3) + (e & 1) >= live)
        s[4 * j + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);  // finite: a live key
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    if (tail && 8 * j >= live) {  // a dead fragment: no exponentials
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = 0.f;
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
      l[e >> 1] += s[4 * j + e];
    }
  }
}

// Block: one consumer warpgroup owning 64 query rows, then one producer
// warp; grid (query tiles, B*H).
__global__ void __launch_bounds__(160, 3)
    flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               __nv_bfloat16* __restrict__ out, int nq, int nk,
                               float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tiles = (nk + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 128);
      mbar_init(&sm.v_empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread keeps the ring full.
    if (threadIdx.x == 128) {
      mbar_expect_tx(&sm.q_full, 64 * kD * 2);
      tma_load(sm.q, &tq, &sm.q_full, q0, bh);
      for (int t = 0; t < tiles; ++t) {
        const int st = t % kStages;
        const int par = ((t / kStages) & 1) ^ 1;  // release of tile t - kStages
        if (t >= kStages) mbar_wait(&sm.k_empty[st], par);
        mbar_expect_tx(&sm.k_full[st], kTileBytes);
        tma_load(sm.k[st], &tk, &sm.k_full[st], t * kBlockN, bh);
        if (t >= kStages) mbar_wait(&sm.v_empty[st], par);
        mbar_expect_tx(&sm.v_full[st], kTileBytes);
        tma_load(sm.v[st], &tv, &sm.v_full[st], t * kBlockN, bh);
      }
    }
  } else {
    // ---- consumer warpgroup
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int live_last = nk - (tiles - 1) * kBlockN;  // 1..kBlockN
    auto live = [&](int t) { return t == tiles - 1 ? live_last : kBlockN; };
    const uint64_t dq = make_desc(sm.q);

    float s[kS], o[32];
    uint32_t p[kP];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;

    auto issue_s = [&](int t) {
      const uint64_t dk = make_desc(sm.k[t % kStages]);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // 32 bytes of each row a step
        wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, kk);
    };
    auto issue_pv = [&](int t, int n) {  // n live keys
      const uint64_t dv = make_desc(sm.v[t % kStages]);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)  // 16 key rows a step
        if (16 * kk < n)
          wgmma_rs_n64(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                       p[4 * kk + 3], dv + 128 * kk);
    };
    auto to_p = [&] {
#pragma unroll
      for (int i = 0; i < kP; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };

    mbar_wait(&sm.q_full, 0);

    // Tile 0: S only.
    mbar_wait(&sm.k_full[0], 0);
    reg_fence(s);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    mbar_arrive(&sm.k_empty[0]);
    softmax_tile(s, m, l, alpha, live(0), scale_log2, lane);
    to_p();

    // Tile t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} on the tensor cores;
    // the softmax of S_t runs while the PV product does.
    for (int t = 1; t < tiles; ++t) {
      const int st = t % kStages;
      const int pst = (t - 1) % kStages;
      mbar_wait(&sm.k_full[st], (t / kStages) & 1);
      mbar_wait(&sm.v_full[pst], ((t - 1) / kStages) & 1);
      reg_fence(s);
      reg_fence(o);
      reg_fence(p);
      wgmma_fence();
      issue_s(t);
      wgmma_commit();
      issue_pv(t - 1, kBlockN);
      wgmma_commit();
      wgmma_wait<1>();  // S_t is in; P_{t-1} V_{t-1} may still run
      reg_fence(s);
      mbar_arrive(&sm.k_empty[st]);
      softmax_tile(s, m, l, alpha, live(t), scale_log2, lane);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(p);
      mbar_arrive(&sm.v_empty[pst]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_p();
    }

    // The last tile's PV product.
    const int lst = (tiles - 1) % kStages;
    mbar_wait(&sm.v_full[lst], ((tiles - 1) / kStages) & 1);
    reg_fence(o);
    reg_fence(p);
    wgmma_fence();
    issue_pv(tiles - 1, live_last);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);

    // Row sums over the quad that shares a row, then out = O / l in bf16.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = 1.f / l[i];
    }
    __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * nq * kD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 16 * warp + (lane >> 2) + 8 * i;
      if (row >= nq) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<int64_t>(row) * kD + 8 * j + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * l[i],
                                  o[4 * j + 2 * i + 1] * l[i]);
      }
    }
  }
}

// ---- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [bh, rows, 64] bf16 tensor read in boxes of `box` rows, 128-byte swizzle;
// rows past `rows` read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int bh, int rows, int box) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[3] = {kD, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {kD * 2, static_cast<cuuint64_t>(rows) * kD * 2};
  const cuuint32_t boxd[3] = {kD, static_cast<cuuint32_t>(box), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, boxd, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int nq, int nk, float scale_log2, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, bh, nq, 64) || !encode(&tk, k, bh, nk, kBlockN) ||
      !encode(&tv, v, bh, nk, kBlockN))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_fwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((nq + 63) / 64, bh);
  flash_attention_fwd_kernel<<<grid, 160, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), nq, nk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ftx_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int bh, int nq, int nk,
                                   int head_dim, float scale_log2,
                                   void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || head_dim != kD)
    return cudaErrorInvalidValue;
  if (bh > 65535) return cudaErrorInvalidValue;  // gridDim.y
  return launch(q, k, v, out, bh, nq, nk, scale_log2,
                static_cast<cudaStream_t>(stream));
}
