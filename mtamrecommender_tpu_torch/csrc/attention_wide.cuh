// Shared pieces of the attention middle's "wide" designs: the forward
// (fused_attention_wide.cu) and the backward (fused_attention_bwd_wide.cu),
// at 65 to 1024 keys (or more than 64 queries) in one softmax row.
//
// A block takes one batch row's kQT query rows and keeps their f32 score
// strip [kQT][Tk] in shared memory: the single-tile kernels' rounding (the
// softmax normalised in f32 over the whole row, the weights rounded to v's
// type after it) with Tk up to 1024, where a whole Tq x Tk tile does not
// fit.  The keys stream through in blocks of KB (32 in bf16, 16 in f32)
// by cp.async into a ring of two buffers (attention_tile.cuh's
// `slice_ring`), the next block copied while the current one is summed.
//
//  - bf16: the products on the tensor cores (attention_tile.cuh's
//    `mma_tile`, mma.sync m16n8k16, f32 accumulators), operands staged in
//    rows padded 16 bytes so ldmatrix meets no bank conflict.
//  - f32: no TF32 (f32 is held to 1e-5): register-tiled FMA from shared
//    memory, 128 threads as kQT rows x 8 key columns.
// Every sum runs in a fixed order: the same inputs give the same bits.
#pragma once

#include "attention_tile.cuh"

namespace attn_wide {

using attn_tile::bf16;
using attn_tile::kNegFill;

constexpr int kThreads = 128;   // 4 warps, every wide kernel
constexpr int kQT = 16;         // query rows a block of the query-side kernels
constexpr int kKT = 32;         // keys a block of the backward's key pass
constexpr int kQB = 32;         // query rows a step of the key pass
constexpr int kStages = 2;      // buffers of the ring

// Tk padded to a multiple of 32: the strip's columns and the backward's
// plane rows
__host__ __device__ constexpr int pad_keys(int Tk) {
  return (Tk + 31) / 32 * 32;
}
// a strip row, in floats: 4Tkp + 16 bytes, so ldmatrix rows of its bf16
// view fall in distinct 16-byte bank groups
__host__ __device__ constexpr int strip_stride(int Tk) {
  return pad_keys(Tk) + 4;
}
// a staged operand row, in elements: D + 8 bf16 or D + 4 f32 (16 bytes)
template <typename T>
__host__ __device__ constexpr int op_stride(int D) {
  return sizeof(T) == 2 ? D + 8 : D + 4;
}
// keys a step of the query-side kernels
template <typename T>
__host__ __device__ constexpr int key_block() {
  return sizeof(T) == 2 ? 32 : 16;
}
// a row of a key block's f32 score planes
template <typename T>
__host__ __device__ constexpr int pc_stride() {
  return key_block<T>() + 4;
}

// ------------------------------------------------------------- copies

// rows r0 .. r0 + n - 1 of an operand (row stride D, from the batch row's
// base `src`) into dst [n][stride]: rows below `valid` copied, zeros
// elsewhere, 16 bytes a piece by cp.async
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* src,
                                           int r0, int n, int valid, int D) {
  constexpr int per = 16 / sizeof(T);
  const int ch = D / per;
  for (int i = threadIdx.x; i < n * ch; i += blockDim.x) {
    const int r = i / ch, c = (i % ch) * per;
    const bool ok = r0 + r < valid;
    tile::cp_async16(dst + r * stride + c,
                     ok ? src + (size_t)(r0 + r) * D + c : src, ok);
  }
}

// the same for the f32 cotangent g into a bf16 tile, rounded on the way
// (plain loads and stores)
__device__ __forceinline__ void stage_rows_rounded(bf16* dst, int stride,
                                                   const float* src, int r0,
                                                   int n, int valid, int D) {
  const int ch = D / 8;
  for (int i = threadIdx.x; i < n * ch; i += blockDim.x) {
    const int r = i / ch, c = (i % ch) * 8;
    __nv_bfloat162 o[4];
    if (r0 + r < valid) {
      const float4* p =
          reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
      const float4 x = p[0], y = p[1];
      o[0] = __floats2bfloat162_rn(x.x, x.y);
      o[1] = __floats2bfloat162_rn(x.z, x.w);
      o[2] = __floats2bfloat162_rn(y.x, y.y);
      o[3] = __floats2bfloat162_rn(y.z, y.w);
    } else {
      o[0] = o[1] = o[2] = o[3] = __floats2bfloat162_rn(0.f, 0.f);
    }
    *reinterpret_cast<uint4*>(dst + r * stride + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// ------------------------------------------------------- score products

// The f32 plane pc [kQT][pc_stride] = A B^T over d: A [kQT][stride] (the
// block's query rows), B [KB][stride] (a key block).  bf16: 16 x 16 tiles
// on the tensor cores, warp w the tiles w, w + 4, ... of the `np` products
// listed; f32: thread t row t / 8, keys t % 8 + 8j, each dot over d in
// order.
__device__ __forceinline__ void block_scores(
    float* pc, int np, const bf16* A0, const bf16* B0, const bf16* A1,
    const bf16* B1, const bf16* A2, const bf16* B2, int stride, int D) {
  constexpr int KB = key_block<bf16>(), PC = pc_stride<bf16>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int u = warp; u < np * (KB / 16); u += kThreads / 32) {
    const int p = u / (KB / 16), n0 = (u % (KB / 16)) * 16;
    const bf16* A = p == 0 ? A0 : p == 1 ? A1 : A2;
    const bf16* B = p == 0 ? B0 : p == 1 ? B1 : B2;
    float c[2][4];
    attn_tile::mma_tile<false, false>(c, A, stride, B, stride, 0, n0, D / 16);
    float* plane = pc + p * kQT * PC;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = plane + g * PC + n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(c[j][0], c[j][1]);
      *reinterpret_cast<float2*>(o + 8 * PC) = make_float2(c[j][2], c[j][3]);
    }
  }
}

__device__ __forceinline__ void block_scores(
    float* pc, int np, const float* A0, const float* B0, const float* A1,
    const float* B1, const float* A2, const float* B2, int stride, int D) {
  constexpr int KB = key_block<float>(), PC = pc_stride<float>();
  const int r = threadIdx.x >> 3, kx = threadIdx.x & 7;
  for (int p = 0; p < np; ++p) {
    const float* A = p == 0 ? A0 : p == 1 ? A1 : A2;
    const float* B = p == 0 ? B0 : p == 1 ? B1 : B2;
    float acc[KB / 8];
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * stride + e);
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(B + (kx + 8 * j) * stride + e);
        acc[j] = fmaf(a.x, b.x, acc[j]);
        acc[j] = fmaf(a.y, b.y, acc[j]);
        acc[j] = fmaf(a.z, b.z, acc[j]);
        acc[j] = fmaf(a.w, b.w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
      pc[p * kQT * PC + r * PC + kx + 8 * j] = acc[j];
  }
}

// ------------------------------------------------------ query products

// The f32 sums of out [kQT][D] += P X over a key block: P [kQT][KB] the
// block's weights (or score gradients) as the input type, row stride sp
// elements; X [KB][stride] the block's staged operand.  bf16: warp w the
// 16-column tiles w and w + 4 (acc[m] for tile w + 4m), the fragments of
// mma_tile; f32: thread t row t / 8, columns 4(t % 8) + 32m (acc[m]), the
// keys in order.
template <typename T>
struct QueryAcc;
template <>
struct QueryAcc<bf16> {
  float c[2][2][4];   // [tile m][n-tile j][fragment]
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) c[m][j][0] = c[m][j][1] = c[m][j][2] =
          c[m][j][3] = 0.f;
  }
};
template <>
struct QueryAcc<float> {
  float v[4][4];      // [column group m][column]
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m][0] = v[m][1] = v[m][2] = v[m][3] = 0.f;
  }
};

__device__ __forceinline__ void query_product(QueryAcc<bf16>& a,
                                              const bf16* P, int sp,
                                              const bf16* X, int stride,
                                              int D) {
  constexpr int KB = key_block<bf16>();
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int nt = warp + 4 * m;
    if (nt < D / 16)
      attn_tile::mma_tile<false, true>(a.c[m], P, sp, X, stride, 0, 16 * nt,
                                       KB / 16, false);
  }
}

__device__ __forceinline__ void query_product(QueryAcc<float>& a,
                                              const float* P, int sp,
                                              const float* X, int stride,
                                              int D) {
  constexpr int KB = key_block<float>();
  const int r = threadIdx.x >> 3, cx = threadIdx.x & 7;
#pragma unroll 4
  for (int c = 0; c < KB; ++c) {
    const float p = P[r * sp + c];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = 4 * cx + 32 * m;
      if (col < D) {
        const float4 x = *reinterpret_cast<const float4*>(X + c * stride + col);
        a.v[m][0] = fmaf(p, x.x, a.v[m][0]);
        a.v[m][1] = fmaf(p, x.y, a.v[m][1]);
        a.v[m][2] = fmaf(p, x.z, a.v[m][2]);
        a.v[m][3] = fmaf(p, x.w, a.v[m][3]);
      }
    }
  }
}

// the block's rows i0 + r < Tq of out [Tq][D] from `a`
template <typename T>
__device__ __forceinline__ void store_query(float* out,
                                            const QueryAcc<T>& a, int i0,
                                            int Tq, int D) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int nt = warp + 4 * m;
      if (nt >= D / 16) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* c = a.c[m][j];
        const int col = 16 * nt + 8 * j + 2 * t;
        if (i0 + g < Tq)
          *reinterpret_cast<float2*>(out + (size_t)(i0 + g) * D + col) =
              make_float2(c[0], c[1]);
        if (i0 + g + 8 < Tq)
          *reinterpret_cast<float2*>(out + (size_t)(i0 + g + 8) * D + col) =
              make_float2(c[2], c[3]);
      }
    }
  } else {
    const int r = threadIdx.x >> 3, cx = threadIdx.x & 7;
    if (i0 + r >= Tq) return;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = 4 * cx + 32 * m;
      if (col < D)
        *reinterpret_cast<float4*>(out + (size_t)(i0 + r) * D + col) =
            make_float4(a.v[m][0], a.v[m][1], a.v[m][2], a.v[m][3]);
    }
  }
}

// a float stored as T (rounded to nearest even in bf16)
template <typename T>
__device__ __forceinline__ void store_as(T* p, float x) {
  if constexpr (sizeof(T) == 2)
    *p = __float2bfloat16_rn(x);
  else
    *p = x;
}

// ---------------------------------------------------------- the middle

// A pair's score before the key mask, and the time mode's gate values:
// the single-tile kernels' formulas (fused_attention.cu's note).
struct Gate {
  float ldt, dec, tqk, sig;
};

template <typename T, int MODE>
__device__ __forceinline__ float pair_score(float s0, float tqk_raw, float tq,
                                            float tk, const T* w1, const T* b1,
                                            const T* wo1, const T* wo2,
                                            const T* bo, size_t gi,
                                            float scale, Gate& gt) {
  using attn_tile::ATT_TIME;
  using attn_tile::ATT_TISAS;
  gt = Gate{0.f, 0.f, 0.f, 0.f};
  if (MODE == ATT_TIME) {
    gt.ldt = log1pf(fabsf(tq - tk));
    gt.dec = tanhf(gt.ldt * port::to_float(w1[gi]) + port::to_float(b1[gi]));
    gt.tqk = tanhf(tqk_raw);
    gt.sig = port::sigmoid(port::to_float(wo1[gi]) * gt.dec +
                           port::to_float(wo2[gi]) * gt.tqk +
                           port::to_float(bo[gi]));
    return s0 * gt.sig * scale;
  }
  if (MODE == ATT_TISAS) {
    gt.ldt = log1pf(fabsf(tq - tk));
    return (s0 + gt.ldt) * scale;
  }
  return s0 * scale;
}

// A warp's softmax over strip row `row` (f32, Tk keys): the max over the
// keys, e = exp(s - max) written over the scores, the sum of e (each lane
// its keys in order, then the warp's butterfly).  Returns the sum.
__device__ __forceinline__ float row_softmax_sums(float* row, int Tk) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int c = lane; c < Tk; c += 32) m = fmaxf(m, row[c]);
  m = port::warp_max(m);
  float sum = 0.f;
  for (int c = lane; c < Tk; c += 32) {
    const float e = expf(row[c] - m);
    row[c] = e;
    sum += e;
  }
  return port::warp_sum(sum);
}

}  // namespace attn_wide
