// Flash attention forward for Hopper (sm_90a), plain C interface.
//
//   out[b, h] = softmax(q[b, h] k[b, h]^T * sm_scale) v[b, h]
//
// q [BH, Nq, 64], k and v [BH, Nk, 64], out [BH, Nq, 64], all bf16; any
// Nq, Nk >= 1; non-causal.
//
// Replaces the Pallas TPU flash attention that
// tools/microbench_attention.py (`flash_attn`) calls, JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py.  Its arithmetic is
// kept: f32 scores of bf16 operands, an online softmax carrying the row max
// m, the row sum l and the output accumulator in f32, the unnormalised
// probabilities rounded to bf16 for the PV product, f32 accumulation, and
// the result divided by l and rounded to bf16.  The TPU kernel needs the
// sequence length to be a multiple of its 128-wide blocks (it raises at the
// DeiT-B/384 length of 578 tokens); this one masks the ragged tail: keys past
// Nk score -inf before the row max, query rows past Nq are not stored.
//
// What bounds it on an H100: at B=8, H=12, N=578 a call moves ~28 MB and
// does ~8.2 GFLOP, ~8.5 us of memory time and ~8.3 us of bf16 tensor-core
// time: it sits at the ridge, so the tensor-core rate of the inner loop
// (mma.sync reaches a fraction of wgmma's) and the blocks in flight decide.
//
// Design: one block of 4 warps per (batch*head, 64-query tile), one warp per
// 16 query rows.  The Q tile and double-buffered 64-key K and V tiles sit in
// shared memory (cp.async, zero-filled past the end, XOR-swizzled 16-byte
// chunks so ldmatrix reads are free of bank conflicts).  Both products run
// on mma.sync m16n8k16 bf16 -> f32; the score fragments are re-packed in
// registers as the A operand of the PV product, as FlashAttention-2 does.
// wgmma and TMA are left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

// Element offset of 16-byte chunk `chunk` (0..7) of row `row` in a [rows, 64]
// bf16 tile: chunks are XOR-swizzled by the row's low 3 bits.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kD + ((chunk ^ (row & 7)) << 3);
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Copy rows [row0, row0 + 64) of a [n, 64] matrix into a swizzled tile;
// rows past n are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int n) {
  for (int c = threadIdx.x; c < 64 * 8; c += kThreads) {
    const int r = c >> 3;
    const int ch = c & 7;
    const bool ok = row0 + r < n;
    cp_async16(tile + swz(r, ch),
               src + static_cast<int64_t>(ok ? row0 + r : 0) * kD + ch * 8,
               ok);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int nq,
                               int nk, float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 sq[kBlockQ * kD];
  __shared__ __align__(128) __nv_bfloat16 sk[2][kBlockK * kD];
  __shared__ __align__(128) __nv_bfloat16 sv[2][kBlockK * kD];

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const __nv_bfloat16* qb = q + bh * nq * kD;
  const __nv_bfloat16* kb = k + bh * nk * kD;
  const __nv_bfloat16* vb = v + bh * nk * kD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = (nk + kBlockK - 1) / kBlockK;

  load_tile(sq, qb, q0, nq);
  load_tile(sk[0], kb, 0, nk);
  load_tile(sv[0], vb, 0, nk);
  cp_async_commit();

  uint32_t qf[4][4];  // A fragments of this warp's 16 rows, 4 steps of d
  float acc[8][4];    // output, 8 tiles of 8 columns of d
  float m[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile(sk[buf ^ 1], kb, (t + 1) * kBlockK, nk);
      load_tile(sv[buf ^ 1], vb, (t + 1) * kBlockK, nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_x4(qf[kk], sq + swz(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
      }
    }

    // S = Q K^T for 64 keys: 8 tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, sk[buf] + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                 kk * 2 + ((lane >> 3) & 1)));
        mma16816(s[2 * np], qf[kk], b[0], b[1]);
        mma16816(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // Online softmax in base 2: scores scaled by sm_scale * log2(e); keys
    // past nk are -inf before the row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * kBlockK + j * 8 + 2 * (lane & 3) + (e & 1);
        s[j][e] = key < nk ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: a tile holds a key
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
        acc[j][e] *= alpha[e >> 1];
      }
    }

    // acc += bf16(P) V: the score fragments of key tiles 2kk, 2kk+1 are the
    // A fragment of key step kk.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, sv[buf] + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                   dp * 2 + (lane >> 4)));
        mma16816(acc[2 * dp], a, b[0], b[1]);
        mma16816(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  // Row sums over the quad that shares a row, then out = acc / l in bf16.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
  __nv_bfloat16* ob = out + bh * nq * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(acc[j][2 * r] * l[r],
                                                     acc[j][2 * r + 1] * l[r]);
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<int64_t>(row) * kD + j * 8 + 2 * (lane & 3)) = h;
    }
  }
}

}  // namespace

extern "C" int ftx_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int bh, int nq, int nk,
                                   int head_dim, float scale_log2,
                                   void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || head_dim != kD)
    return cudaErrorInvalidValue;
  if (bh > 65535) return cudaErrorInvalidValue;  // gridDim.y
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, bh);
  flash_attention_fwd_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      nq, nk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
