// Block-tiled matrix products for kernels that own their operands' layout:
// C[m, n] = sum_k A[m, k] B[k, n] over one 128 x 128 output tile a block of
// 256 threads, the k axis in 32-wide slabs staged through shared memory in
// two buffers, each sum in f32 and in a fixed order (no atomics: the same
// inputs give the same bits).  A problem (a struct, see below) says where
// each operand's elements lie in global memory and what the epilogue does;
// the main loops here are shared.
//
//  - bf16 (`mma_gemm`): mma.sync.m16n8k16 on the tensor cores with an f32
//    accumulator; the slabs copied by cp.async, 16 bytes a thread, rows
//    padded 16 bytes so that ldmatrix reads them without bank conflicts;
//    8 warps in 2 (m) x 4 (n), each a 64 x 32 sub-tile.  The copy and
//    fragment helpers are those of fused_attention_blockwise.cu's
//    tensor-core design.
//  - f32 (`fma_gemm`): register-tiled FMA (no TF32), thread (ty, tx) of a
//    16 x 16 grid owns rows ty*4 .. +3 and 64 + ty*4 .. +3 and the same
//    columns of tx, an 8 x 8 tile; both slabs k-major in shared memory so
//    each k reads four float4 and issues 64 FMAs; the next slab's global
//    loads are in registers while the current one is summed.  Each sum
//    runs over k in order.
//
// An operand is stored in global memory either k-contiguous ("row": A as
// [m][k], B as [n][k]) or k-strided ("k-major": A as [k][m], B as [k][n]);
// the problem's A_KMAJOR / B_KMAJOR say which, and the loaders copy
// 16-byte pieces along the contiguous axis.  A problem provides:
//   static constexpr bool A_KMAJOR, B_KMAJOR;
//   int m0(), n0()                       the block's output tile origin
//   int slabs(), k0(int s)               its 32-wide k slabs
//   const T* a_at(int m, int k, bool& ok) the element A[m, k]; ok false
//   const T* b_at(int k, int n, bool& ok) (out of range) reads as zero
//   void epi(int m, int n, float v0, float v1)   C[m, n], C[m, n + 1]
// A piece (8 bf16 or 4 f32 along the contiguous axis) is valid or not as
// a whole, and n is even in epi.
#pragma once

#include "common.cuh"

namespace tile {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;

// ------------------------------------------------------------ bf16 (mma)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16; c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A staged slab: its rows along the stored (not contiguous) axis, each
// padded by 8 elements.  Row-stored: kBM (or kBN) rows of kBK; k-major:
// kBK rows of kBM (kBN).
constexpr int kRowStride = kBK + 8;     // 40 elements, 80 bytes
constexpr int kColStride = kBM + 8;     // 136 elements, 272 bytes
static_assert(kBM == kBN, "one k-major stride for A and B");
constexpr int kSlabElems = kBM * kRowStride > kBK * kColStride
                               ? kBM * kRowStride : kBK * kColStride;

constexpr size_t mma_smem_bytes() {
  return (size_t)2 * 2 * kSlabElems * sizeof(bf16);  // 2 buffers x (A, B)
}

// one operand's slab s of the tile into `dst`, 16 bytes a piece
template <bool KMAJOR, class At>
__device__ __forceinline__ void stage_mma(bf16* dst, int k0, int r0, At at) {
  constexpr int kPieces = kBM * kBK / 8;             // 512
#pragma unroll
  for (int j = 0; j < kPieces / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    bool ok;
    if constexpr (KMAJOR) {                        // [k][r], r contiguous
      const int k = i / (kBM / 8), r = (i % (kBM / 8)) * 8;
      const bf16* src = at(r0 + r, k0 + k, ok);
      cp_async16(dst + k * kColStride + r, src, ok);
    } else {                                       // [r][k], k contiguous
      const int r = i / (kBK / 8), k = (i % (kBK / 8)) * 8;
      const bf16* src = at(r0 + r, k0 + k, ok);
      cp_async16(dst + r * kRowStride + k, src, ok);
    }
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t.  A: a0 (row
// g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols 2t+8, 2t+9), a3 (row
// g+8, cols 2t+8, 2t+9).  B: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8,
// 2t+9).  C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// The 16 x 16 A fragment at (m, k) of a staged slab.
template <bool KMAJOR>
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* s, int m,
                                       int k) {
  const int lane = threadIdx.x & 31;
  if constexpr (KMAJOR)   // stored [k][m]: the transpose of four 8x8 blocks
    ldsm_x4_trans(a, s + (k + (lane >> 4) * 8 + (lane & 7)) * kColStride +
                         m + ((lane >> 3) & 1) * 8);
  else
    ldsm_x4(a, s + (m + (lane & 15)) * kRowStride + k + (lane >> 4) * 8);
}
// The B fragments of two 8-column tiles at (k, n): b[0], b[1] for columns
// n .. n+7, b[2], b[3] for n+8 .. n+15.
template <bool KMAJOR>
__device__ __forceinline__ void frag_b(unsigned (&b)[4], const bf16* s, int k,
                                       int n) {
  const int lane = threadIdx.x & 31;
  if constexpr (KMAJOR)   // stored [k][n]
    ldsm_x4_trans(b, s + (k + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                             kColStride + n + (lane >> 4) * 8);
  else                    // stored [n][k]
    ldsm_x4(b, s + (n + (lane >> 4) * 8 + (lane & 7)) * kRowStride + k +
                   ((lane >> 3) & 1) * 8);
}

template <class P>
__device__ void mma_gemm(const P& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  auto slab = [&](int buf, int op) { return sm + (2 * buf + op) * kSlabElems; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = p.m0(), n0 = p.n0(), ns = p.slabs();
  auto a_at = [&](int m, int k, bool& ok) { return p.a_at(m, k, ok); };
  auto b_at = [&](int n, int k, bool& ok) { return p.b_at(k, n, ok); };
  auto stage = [&](int s, int buf) {
    stage_mma<P::A_KMAJOR>(slab(buf, 0), p.k0(s), m0, a_at);
    stage_mma<P::B_KMAJOR>(slab(buf, 1), p.k0(s), n0, b_at);
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (ns > 0) stage(0, 0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      stage(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sa = slab(s & 1, 0);
    const bf16* sb = slab(s & 1, 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        frag_a<P::A_KMAJOR>(a[i], sa, wm + 16 * i, kk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        frag_b<P::B_KMAJOR>(b[j], sb, kk, wn + 16 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][2 * (j & 1)],
                   b[j >> 1][2 * (j & 1) + 1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wm + 16 * i + g, n = n0 + wn + 8 * j + 2 * t;
      p.epi(m, n, acc[i][j][0], acc[i][j][1]);
      p.epi(m + 8, n, acc[i][j][2], acc[i][j][3]);
    }
}

// ------------------------------------------------------------- f32 (FMA)

constexpr size_t fma_smem_bytes() {
  return (size_t)2 * (kBK * kBM + kBK * kBN) * sizeof(float);
}

// One operand's slab, k-major [kBK][kBM] in shared memory, through
// registers: 4 pieces of 4 floats a thread.  Row-stored operands are
// transposed on the way (a warp's 32 lanes take 32 rows of one k piece,
// so each store fills one shared row without bank conflicts).
template <bool KMAJOR>
struct FmaSlab {
  float4 v[4];
  template <class At>
  __device__ __forceinline__ void load(int k0, int r0, At at) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = threadIdx.x + j * kThreads;
      int r, k;
      if constexpr (KMAJOR) {
        k = i / (kBM / 4);
        r = (i % (kBM / 4)) * 4;
      } else {
        r = i % kBM;
        k = (i / kBM) * 4;
      }
      bool ok;
      const float* src = at(r0 + r, k0 + k, ok);
      v[j] = ok ? *reinterpret_cast<const float4*>(src)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if constexpr (KMAJOR) {
        *reinterpret_cast<float4*>(dst + (i / (kBM / 4)) * kBM +
                                   (i % (kBM / 4)) * 4) = v[j];
      } else {
        const int r = i % kBM, k = (i / kBM) * 4;
        dst[(k + 0) * kBM + r] = v[j].x;
        dst[(k + 1) * kBM + r] = v[j].y;
        dst[(k + 2) * kBM + r] = v[j].z;
        dst[(k + 3) * kBM + r] = v[j].w;
      }
    }
  }
};

template <class P>
__device__ void fma_gemm(const P& p) {
  extern __shared__ __align__(16) float smem_f[];
  auto slab = [&](int buf, int op) {
    return smem_f + (2 * buf + op) * kBK * kBM;
  };
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int m0 = p.m0(), n0 = p.n0(), ns = p.slabs();
  auto a_at = [&](int m, int k, bool& ok) { return p.a_at(m, k, ok); };
  auto b_at = [&](int n, int k, bool& ok) { return p.b_at(k, n, ok); };
  FmaSlab<P::A_KMAJOR> la;
  FmaSlab<P::B_KMAJOR> lb;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (ns > 0) {
    la.load(p.k0(0), m0, a_at);
    lb.load(p.k0(0), n0, b_at);
    la.store(slab(0, 0));
    lb.store(slab(0, 1));
  }
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    const bool more = s + 1 < ns;
    if (more) {
      la.load(p.k0(s + 1), m0, a_at);
      lb.load(p.k0(s + 1), n0, b_at);
    }
    const float* sa = slab(s & 1, 0);
    const float* sb = slab(s & 1, 1);
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + k * kBM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(sa + k * kBM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + k * kBN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sb + k * kBN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      la.store(slab((s + 1) & 1, 0));
      lb.store(slab((s + 1) & 1, 1));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      p.epi(m, n, acc[i][j], acc[i][j + 1]);
    }
  }
}

}  // namespace tile
