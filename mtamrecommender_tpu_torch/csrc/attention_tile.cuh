// Shared pieces of the attention middle's "tile" designs: the forward
// (fused_attention_tile.cu) and the backward (fused_attention_bwd_tile.cu).
// Both take one block per batch row, with the whole Tq x Tk problem in
// shared memory, padded to kTile x kTile.
//
//  - bf16: each operand staged once by cp.async into a [64][D + 8] tile,
//    zeros past its valid rows (the 16-byte pad lets ldmatrix read it
//    without bank conflicts); the products on the tensor cores (mma.sync
//    m16n8k16, f32 accumulators, tile_gemm.cuh's helpers), a warp a
//    16 x 16 output tile at a time: score planes A B^T into f32
//    [64][kPlane] planes (`mma_scores`), and plane products P X or P^T X,
//    the plane read as bf16, straight to an f32 output (`mma_product`).
//  - f32: no TF32.  Register-tiled FMA, kFmaThreads threads as a 16 x 16
//    grid, a thread a 4 x 4 tile; the operands streamed in d-slices
//    through a ring of kStages shared buffers (`slice_ring`), the next
//    slices copied by cp.async while the current one is summed: 32
//    columns of two operands for a score product (`fma_scores_slice`), 64
//    columns of one for a plane product (`fma_product_slice`).
// Every sum runs in a fixed order: the same inputs give the same bits.
#pragma once

#include "common.cuh"
#include "tile_gemm.cuh"

namespace attn_tile {

using bf16 = __nv_bfloat16;

// the Python wrapper's MODES order
enum { ATT_PLAIN = 0, ATT_TIME = 1, ATT_TISAS = 2, ATT_PLAIN_DROP = 3,
       ATT_TISAS_DROP = 4 };
constexpr int kTile = 64;                 // Tq and Tk padded to this
constexpr int kMaxD = 128;
constexpr int kPlane = kTile + 4;         // an f32 plane row: 68 floats
constexpr int kPlaneBf = 2 * kPlane;      // the same 272 bytes as bf16
constexpr float kNegFill = -4294967295.0f;       // -(2^32) + 1
constexpr int kFmaThreads = 256;          // the f32 kernels' 16 x 16 grid
// f32 slices: 32 columns of two operands (score products), 64 of one
// (plane products)
constexpr int kSliceA = 32, kStrideA = kSliceA + 4;
constexpr int kSliceB = 64, kStrideB = kSliceB + 4;
constexpr int kBufFloats = 2 * kTile * kStrideA > kTile * kStrideB
                               ? 2 * kTile * kStrideA : kTile * kStrideB;
constexpr int kStages = 3;                // f32 slices in flight

__host__ __device__ constexpr int bf_stride(int D) { return D + 8; }

// ---------------------------------------------------------- bf16 (mma.sync)

// C (16 rows x two 8-column n-tiles) = A B over `ksteps` k-steps of 16
// (with `zero` false, C += A B: the sum carried on from C's values).
// A_T: A stored [k][m] (else [m][k]); B_T: B stored [k][n] (else [n][k]);
// sa, sb the row strides in elements; (m0, n0) the tile's origin.
// Fragment layouts: tile_gemm.cuh's frag_a / frag_b, at these strides.
template <bool A_T, bool B_T>
__device__ __forceinline__ void mma_tile(float (&c)[2][4], const bf16* A,
                                         int sa, const bf16* B, int sb,
                                         int m0, int n0, int ksteps,
                                         bool zero = true) {
  const int lane = threadIdx.x & 31;
  if (zero) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  }
  for (int kk = 0; kk < 16 * ksteps; kk += 16) {
    unsigned a[4], bb[4];
    if constexpr (A_T)
      tile::ldsm_x4_trans(a, A + (kk + (lane >> 4) * 8 + (lane & 7)) * sa +
                                 m0 + ((lane >> 3) & 1) * 8);
    else
      tile::ldsm_x4(a, A + (m0 + (lane & 15)) * sa + kk + (lane >> 4) * 8);
    if constexpr (B_T)
      tile::ldsm_x4_trans(bb, B + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                      sb + n0 + (lane >> 4) * 8);
    else
      tile::ldsm_x4(bb, B + (n0 + (lane >> 4) * 8 + (lane & 7)) * sb + kk +
                            ((lane >> 3) & 1) * 8);
    tile::mma_bf16(c[0], a, bb[0], bb[1]);
    tile::mma_bf16(c[1], a, bb[2], bb[3]);
  }
}

// an f32 plane = A B^T (A [64][D] the queries' rows, B [64][D] the keys'),
// over the 16 x 16 tiles holding a query row < Tq and a key < Tk, the
// block's warps taking tiles in turn
__device__ void mma_scores(float* plane, const bf16* A, const bf16* B, int S,
                           int nk, int Tq, int Tk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = (Tq + 15) / 16, nt = (Tk + 15) / 16;
  for (int u = warp; u < mt * nt; u += blockDim.x >> 5) {
    const int m0 = (u % mt) * 16, n0 = (u / mt) * 16;
    float c[2][4];
    mma_tile<false, false>(c, A, S, B, S, m0, n0, nk);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* p = plane + (m0 + g) * kPlane + n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(c[j][0], c[j][1]);
      *reinterpret_cast<float2*>(p + 8 * kPlane) =
          make_float2(c[j][2], c[j][3]);
    }
  }
}

// out[row][col], out[row][col + 1] of an [R][D] f32 output, rows < R only
__device__ __forceinline__ void store_pair(float* out, int R, int D, int row,
                                           int col, float x, float y) {
  if (row < R)
    *reinterpret_cast<float2*>(out + (size_t)row * D + col) =
        make_float2(x, y);
}

// out [R][D] f32 = P X (TRANS false: P the bf16 plane [m][k]) or P^T X
// (TRANS true: P [k][m]), X [64][D] staged; ksteps of 16 over the k axis
template <bool TRANS>
__device__ void mma_product(float* out, const float* plane, const bf16* X,
                            int S, int R, int D, int ksteps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* P = reinterpret_cast<const bf16*>(plane);
  const int mt = (R + 15) / 16, nt = D / 16;
  for (int u = warp; u < mt * nt; u += blockDim.x >> 5) {
    const int m0 = (u % mt) * 16, n0 = (u / mt) * 16;
    float c[2][4];
    mma_tile<TRANS, true>(c, P, kPlaneBf, X, S, m0, n0, ksteps);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      store_pair(out, R, D, m0 + g, col, c[j][0], c[j][1]);
      store_pair(out, R, D, m0 + g + 8, col, c[j][2], c[j][3]);
    }
  }
}

// rows [0, 64) of a [rows][D] operand into a staged tile of stride D + 8:
// row r < valid copied, zeros elsewhere, 16 bytes a piece
__device__ void stage_rows(bf16* dst, const bf16* src, int valid, int D) {
  const int ch = D / 8, S = bf_stride(D);
  for (int i = threadIdx.x; i < kTile * ch; i += blockDim.x) {
    const int r = i / ch, c = (i % ch) * 8;
    const bool ok = r < valid;
    tile::cp_async16(dst + r * S + c, src + (size_t)(ok ? r : 0) * D + c, ok);
  }
}

// ------------------------------------------------------------- f32 (FMA)

// rows [0, 64) x columns [c0, c0 + width) of a [rows][D] operand into a
// buffer of row stride `stride`: rows r < valid and columns < D copied,
// zeros elsewhere, 16 bytes a piece
__device__ void stage_slice(float* dst, int stride, int width,
                            const float* src, int valid, int D, int c0) {
  const int ch = width / 4;
  for (int i = threadIdx.x; i < kTile * ch; i += blockDim.x) {
    const int r = i / ch, c = (i % ch) * 4;
    const bool ok = r < valid && c0 + c < D;
    tile::cp_async16(dst + r * stride + c,
                     src + (ok ? (size_t)r * D + c0 + c : 0), ok);
  }
}

// The ring of STAGES buffers: `stage(s)` copies step s's slices into
// buffer s % STAGES and commits one cp.async group (an empty one past the
// last step, which keeps the count of groups); `step(s)` sums them.  Step
// s's copies are issued STAGES - 1 steps ahead; a barrier after each step
// frees its buffer.  Groups committed before the ring have landed by
// step 0.
template <int STAGES = kStages, class Stage, class Step>
__device__ __forceinline__ void slice_ring(int n_steps, Stage stage,
                                           Step step) {
  for (int s = 0; s < STAGES - 1; ++s) stage(s);
  for (int s = 0; s < n_steps; ++s) {
    stage(s + STAGES - 1);
    tile::cp_async_wait<STAGES - 1>();   // step s's slices have landed
    __syncthreads();
    step(s);
    __syncthreads();   // this buffer free again
  }
}

__device__ __forceinline__ void fma_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
}

// A score slice: rows 4ty + r (queries, x [64][kStrideA]) x columns
// tx + 16 j (keys, y [64][kStrideA]) += the slice's 32 columns of d, in
// order
__device__ __forceinline__ void fma_scores_slice(float (&acc)[4][4],
                                                 const float* x,
                                                 const float* y) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 2
  for (int e = 0; e < kSliceA; e += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      av[r] = *reinterpret_cast<const float4*>(x + (4 * ty + r) * kStrideA + e);
      bv[r] = *reinterpret_cast<const float4*>(y + (tx + 16 * r) * kStrideA + e);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[r][j] = fmaf(av[r].x, bv[j].x, acc[r][j]);
        acc[r][j] = fmaf(av[r].y, bv[j].y, acc[r][j]);
        acc[r][j] = fmaf(av[r].z, bv[j].z, acc[r][j]);
        acc[r][j] = fmaf(av[r].w, bv[j].w, acc[r][j]);
      }
  }
}

// a score product's sums into its f32 plane (the thread's 4 x 4 entries)
__device__ __forceinline__ void fma_store_plane(float* plane,
                                                const float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      plane[(4 * ty + r) * kPlane + tx + 16 * j] = acc[r][j];
}

// A plane product's 64-column slice: rows 4ty + r x columns 4tx + j of
// P x (trans false: the contraction over the keys, P [64][kPlane] zero
// past Tk) or P^T x (trans true: over the Tq queries), x [64][kStrideB];
// rows R and past left at 0 (warps whose 8 rows all are)
__device__ __forceinline__ void fma_product_slice(float (&acc)[4][4],
                                                  const float* P,
                                                  const float* x, bool trans,
                                                  int R, int Tq, int Tk) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5;
  fma_zero(acc);
  if (8 * warp >= R) return;
  if (trans) {
#pragma unroll 4
    for (int i = 0; i < Tq; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(P + i * kPlane + 4 * ty);
      const float4 bv =
          *reinterpret_cast<const float4*>(x + i * kStrideB + 4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(ar[r], bv.x, acc[r][0]);
        acc[r][1] = fmaf(ar[r], bv.y, acc[r][1]);
        acc[r][2] = fmaf(ar[r], bv.z, acc[r][2]);
        acc[r][3] = fmaf(ar[r], bv.w, acc[r][3]);
      }
    }
  } else {
    const int kn = (Tk + 3) / 4 * 4;
#pragma unroll 2
    for (int c = 0; c < kn; c += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        av[r] = *reinterpret_cast<const float4*>(P + (4 * ty + r) * kPlane + c);
        bv[r] = *reinterpret_cast<const float4*>(x + (c + r) * kStrideB + 4 * tx);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ar[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[r][0] = fmaf(ar[u], bv[u].x, acc[r][0]);
          acc[r][1] = fmaf(ar[u], bv[u].y, acc[r][1]);
          acc[r][2] = fmaf(ar[u], bv[u].z, acc[r][2]);
          acc[r][3] = fmaf(ar[u], bv[u].w, acc[r][3]);
        }
      }
    }
  }
}

// a plane product's slice into its [R][D] f32 output: rows < R, columns
// c0 + 4tx .. +3 where < D
__device__ __forceinline__ void fma_store_out(float* out, int R, int D, int c0,
                                              const float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int col = c0 + 4 * tx;
  if (col >= D) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ty + r;
    if (row < R)
      *reinterpret_cast<float4*>(out + (size_t)row * D + col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ----------------------------------------------------------- gate sums

// The backward's gate gradients (time mode), shared by its tile and wide
// designs: each of a chunk's batch rows writes its five [Tq, Tk] gate
// terms to a workspace [5][n_rows][Tq][Tk]; this launch sums them over the
// chunk's rows.
constexpr int kGateRows = 32;             // batch rows a part of the gate sums
constexpr int kMaxParts = 128;            // parts a gate launch sums
constexpr int kGateThreads = 256;

struct GateOut {
  float* out[5];  // dw1, db1, dwo1, dwo2, dbo, each [Tq, Tk]
};

// Gate gradient elements (sel, e .. e + 31) of a chunk: warp w sums parts
// w, w + 8, ... (kGateRows batch rows each, in order), then warp 0 adds
// the parts in order to 0 (or, with `accumulate`, to the sums of the
// earlier chunks).  Grid: 5 * ceil(TqTk / 32) blocks of kGateThreads.
__global__ void __launch_bounds__(kGateThreads) attn_bwd_tile_gates_kernel(
    const float* __restrict__ ws, GateOut gates, int n_rows, int TqTk,
    int accumulate) {
  constexpr int kWarps = kGateThreads / 32;
  __shared__ float s_part[kMaxParts][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (TqTk + 31) / 32;
  const int sel = blockIdx.x / groups;
  const int e = (blockIdx.x % groups) * 32 + lane;
  const int parts = (n_rows + kGateRows - 1) / kGateRows;
  const float* src = ws + (size_t)sel * n_rows * TqTk + e;
  if (e < TqTk) {
    for (int p = warp; p < parts; p += kWarps) {
      const int r1 = min(n_rows, (p + 1) * kGateRows);
      float acc = 0.f;
#pragma unroll 8
      for (int r = p * kGateRows; r < r1; ++r) acc += src[(size_t)r * TqTk];
      s_part[p][lane] = acc;
    }
  }
  __syncthreads();
  if (warp == 0 && e < TqTk) {
    float* dst = gates.out[sel] + e;
    float acc = accumulate ? *dst : 0.f;
    for (int p = 0; p < parts; ++p) acc += s_part[p][lane];
    *dst = acc;
  }
}

// Launch the gate sums of a chunk of n_rows rows starting at batch row b0
// on `stream`; returns cudaGetLastError().
inline cudaError_t launch_gate_sums(const float* ws, const GateOut& gates,
                                    int n_rows, int TqTk, int b0,
                                    cudaStream_t stream) {
  const int groups = (TqTk + 31) / 32;
  attn_bwd_tile_gates_kernel<<<5 * groups, kGateThreads, 0, stream>>>(
      ws, gates, n_rows, TqTk, b0 > 0);
  return cudaGetLastError();
}

}  // namespace attn_tile
