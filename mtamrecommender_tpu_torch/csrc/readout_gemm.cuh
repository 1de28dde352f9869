// The pieces of MTAM's fused readout that its forward (fused_readout.cu)
// and its backward (fused_readout_bwd.cu) share in their "gemm" designs:
// the per-row vector work over a row's keys, the width D a template
// argument (Cols, combine_pairs, weighted_sums, row_dots), and the
// projection of every hop's K and V as one block-tiled product over all
// B*L keys (ProjGemm on tile_gemm.cuh, readout_proj_kernel,
// launch_product).  The projection writes
//   KV[j, m, e] = round_T(relu(mem[m] . W_j[:, e] + bias_j[e]))
// for the 2n planes j (Wk_0 .. Wk_n-1, then Wv_0 .. Wv_n-1) into a
// workspace [2, n, B, L, D] of type T.
#pragma once

#include <type_traits>

#include "readout_hop.cuh"
#include "tile_gemm.cuh"

namespace readout {

__device__ __forceinline__ float2 load2(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}
__device__ __forceinline__ void store2(float* x, float a, float b) {
  *reinterpret_cast<float2*>(x) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* x, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(x) = __floats2bfloat162_rn(a, b);
}

// The chain kernel's vector work, the width D a template argument so
// that every loop over a row's columns unrolls.  Column sums: thread t
// takes the column pair 2 (t % (D/2)), +1 and every kGroups-th key from
// t / (D/2); the groups' partials are added in group order.  Loads come in
// batches of several keys before the arithmetic that uses them.
template <int D>
struct Cols {
  static constexpr int kHalf = D / 2, kGroups = kThreads / kHalf;
  static_assert(kThreads % kHalf == 0 && kGroups * D == 2 * kThreads,
                "column pairs tile the block");
};

// out[s] = column threadIdx.x's total of the pair partials v[s] (for
// threadIdx.x < D); scratch holds 2 NS kThreads floats
template <int D, int NS>
__device__ __forceinline__ void combine_pairs(const float2 (&v)[NS],
                                              float* scratch,
                                              float (&out)[NS]) {
  const int pr = threadIdx.x % Cols<D>::kHalf;
  const int grp = threadIdx.x / Cols<D>::kHalf;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    scratch[s * 2 * kThreads + grp * D + 2 * pr] = v[s].x;
    scratch[s * 2 * kThreads + grp * D + 2 * pr + 1] = v[s].y;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    out[s] = 0.f;
    if (threadIdx.x < D)
      for (int g = 0; g < Cols<D>::kGroups; ++g)
        out[s] += scratch[s * 2 * kThreads + g * D + threadIdx.x];
  }
  __syncthreads();
}

// out[s] = sum_{c < nk} coef_s[c] X_s[c, e] for e = threadIdx.x < D and
// s < NS (coef_1, X_1 only when NS = 2); X_s [nk, D] row-major in global
// memory.  scratch: 2 NS kThreads floats.
template <int D, int NS, typename T>
__device__ __forceinline__ void weighted_sums(const float* coef0,
                                              const T* X0, const float* coef1,
                                              const T* X1, int nk,
                                              float* scratch,
                                              float (&out)[NS]) {
  constexpr int U = 8, G = Cols<D>::kGroups;
  const float* coef[2] = {coef0, coef1};
  const T* X[2] = {X0, X1};
  const int e = 2 * (threadIdx.x % Cols<D>::kHalf);
  float2 acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = make_float2(0.f, 0.f);
  for (int c = threadIdx.x / Cols<D>::kHalf; c < nk; c += U * G) {
    float2 v[NS][U];
    float w[NS][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cu = c + u * G;
      const bool ok = cu < nk;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        v[s][u] = ok ? load2(X[s] + (size_t)cu * D + e)
                     : make_float2(0.f, 0.f);
        w[s][u] = ok ? coef[s][cu] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        acc[s].x = fmaf(w[s][u], v[s][u].x, acc[s].x);
        acc[s].y = fmaf(w[s][u], v[s][u].y, acc[s].y);
      }
  }
  combine_pairs<D, NS>(acc, scratch, out);
}

// For every row c < nk, f(c, x_0 . R_0[c], x_1 . R_1[c]) (R_1 only when
// NX = 2): a warp takes eight rows at a time, each lane the column pairs
// 2 lane + 64 p, and lane r of the warp calls f for its row r.  x_j f32
// [D] in shared memory, R_j [nk, D] row-major in global memory.
template <int D, int NX, typename T, class F>
__device__ __forceinline__ void row_dots(const float* x0, const T* R0,
                                         const float* x1, const T* R1, int nk,
                                         F f) {
  constexpr int KR = 8, P = (D + 63) / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xs[2] = {x0, x1};
  const T* rs[2] = {R0, R1};
  float2 xv[NX][P];
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int e = 2 * lane + 64 * q;
      xv[j][q] = e < D ? *reinterpret_cast<const float2*>(xs[j] + e)
                       : make_float2(0.f, 0.f);
    }
  for (int c0 = warp; c0 < nk; c0 += KR * kWarps) {
    float2 v[KR][NX][P];
#pragma unroll
    for (int r = 0; r < KR; ++r)
#pragma unroll
      for (int j = 0; j < NX; ++j)
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const int c = c0 + r * kWarps, e = 2 * lane + 64 * q;
          v[r][j][q] = c < nk && e < D ? load2(rs[j] + (size_t)c * D + e)
                                       : make_float2(0.f, 0.f);
        }
    float acc[KR][NX];
#pragma unroll
    for (int r = 0; r < KR; ++r)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          a = fmaf(xv[j][q].x, v[r][j][q].x, a);
          a = fmaf(xv[j][q].y, v[r][j][q].y, a);
        }
        acc[r][j] = port::warp_sum(a);
      }
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const int c = c0 + r * kWarps;
      if (lane == r && c < nk) f(c, acc[r][0], acc[r][NX - 1]);
    }
  }
}

// proj, as tile_gemm.cuh's problem: KV[j, m, e] = round_T(relu(mem[m] .
// W_j[:, e] + bias_j[e])), j < n from Wk / bk, else from Wv / bv.  Rows
// past M and columns past N read zeros and are not written.
template <typename T>
struct ProjGemm {
  using Elem = T;
  static constexpr bool A_KMAJOR = false, B_KMAJOR = true;
  const T *mem, *wk, *wv, *bk, *bv;
  T* kv;
  int M, D, n;
  __device__ int m0() const { return blockIdx.x * tile::kBM; }
  __device__ int n0() const { return blockIdx.y * tile::kBN; }
  __device__ int slabs() const { return D / tile::kBK; }
  __device__ int k0(int s) const { return s * tile::kBK; }
  __device__ const T* a_at(int m, int k, bool& ok) const {
    ok = m < M;
    return mem + (size_t)(ok ? m : 0) * D + k;
  }
  __device__ const T* b_at(int k, int c, bool& ok) const {
    ok = c < 2 * n * D;
    const int j = ok ? c / D : 0, e = c % D;
    const T* w = j < n ? wk + (size_t)j * D * D : wv + (size_t)(j - n) * D * D;
    return w + (size_t)k * D + e;
  }
  __device__ void epi(int m, int c, float v0, float v1) const {
    if (m >= M || c >= 2 * n * D) return;
    const int j = c / D, e = c % D;
    const T* bias = j < n ? bk + j * D : bv + (j - n) * D;
    store2(kv + ((size_t)j * M + m) * D + e,
           port::round_to<T>(fmaxf(v0 + port::to_float(bias[e]), 0.f)),
           port::round_to<T>(fmaxf(v1 + port::to_float(bias[e + 1]), 0.f)));
  }
};

// blocks an SM of the products: two in bf16; one in f32, whose 8 x 8
// register tile and staged slab take more than the 128 registers two
// blocks would leave a thread
template <typename T>
constexpr int kProductBlocks = sizeof(T) == 4 ? 1 : 2;

template <class P>
__device__ __forceinline__ void tile_product(const P& p) {
  if constexpr (std::is_same<typename P::Elem, float>::value)
    tile::fma_gemm(p);
  else
    tile::mma_gemm(p);
}

template <typename T>
__global__ void __launch_bounds__(tile::kThreads, kProductBlocks<T>)
    readout_proj_kernel(const ProjGemm<T> p) {
  tile_product(p);
}

template <typename T, class P>
cudaError_t launch_product(void (*kernel)(const P), dim3 grid, const P& prob,
                           cudaStream_t stream) {
  const size_t smem = sizeof(T) == 4 ? tile::fma_smem_bytes()
                                     : tile::mma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, tile::kThreads, smem, stream>>>(prob);
  return cudaGetLastError();
}

}  // namespace readout
