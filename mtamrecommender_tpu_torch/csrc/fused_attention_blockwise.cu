// Fused attention middle over long memories: an online softmax over
// 512-key blocks, forward, modes plain, time and tisas.
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py,
// _attn_kernel_blockwise (launched by _fused_attention_fwd for padded key
// counts above SINGLE_TILE_KEYS = 1024, up to MAX_KEYS = 32768).  Per
// (batch row b, query row i), the scores are those of fused_attention.cu:
//   s_c = q_i . k_c, gated (time: * sigmoid(gate) / sqrt(d)), biased
//   (tisas: (s_c + log1p|t_q - t_k|) / sqrt(d)) or scaled (plain), and
//   -2^32+1 for c >= key_len[b].
// Then, for each block of 512 keys, as the Pallas kernel does:
//   m_new = max(m, max_c s_c);  alpha = exp(m - m_new);  p_c = exp(s_c - m_new)
//   l   = l * alpha + sum_c p_c                  (the unrounded p, f32)
//   acc = acc * alpha + sum_c round(p_c) v_c     (p rounded to v's type, f32)
// and the output is acc / l, f32.  A row with key_len == 0 gets a uniform
// softmax over its Tk keys (all scores equal), as the unpadded reference
// gives; the Pallas kernel pads Tk to a multiple of 512 first and spreads
// that row's weight over the padded keys too.
//
// What bounds it: at the self-attention shape (Tq = Tk = 2048, d = 128,
// B = 64) operations: time mode does 3 products of 2d FLOPs per (query,
// key) pair, ~206 GFLOP, ~3.1 ms at the card's 67 TFLOP/s of f32 FMA
// (~0.21 ms at the bf16 tensor-core rate, which this kernel does not
// use).  At Tq = 1 (MTAM's readout hops) bytes: the row's k, v and rawk
// once, ~0.06 ms for B = 64, Tk = 2048 in f32.
//
// Design: one block of 256 threads per (batch row, tile of QT queries),
// QT = 16, or QT = 1 when Tq = 1.  Key blocks run in order; a block wholly
// at or past key_len is skipped (Pallas gives it p = 0 and alpha = 1
// exactly, so skipping changes no bit).  In a key block, 64 keys at a time
// have their k rows (and, in time mode, rawk rows) staged in shared memory
// as f32, shared by all the tile's queries; each thread scores one key
// against QPT queries (QT = 16: 4 queries a thread, so a staged k value
// is read once for four products; QT = 1: four threads split one key's d
// and sum with shuffles).  The block's 512 scores per query sit in shared
// memory; one warp per query takes the block max, writes p rounded to v's
// type over them, and updates m and l.  Then 64 v rows at a time are
// staged, and each thread keeps its (query, column) outputs in registers
// across the whole walk.  No float atomics: every sum has a fixed order.
// At Tq = 1 this gives a row one block, so B = 64 rows fill only 64 of the
// 132 SMs: the wrapper takes the split design below there (its
// `blockwise_design` == "split"), and this kernel only when forced.
//
// The tensor-core design (`blockwise_mma_kernel`, the wrapper's
// `blockwise_design` == "mma": bf16, Tq > 1, d in {16, 32, ..., 128}) is
// FlashAttention-2's structure held to the rounding above.  The kernel
// above stays for the Tq > 1 shapes the two tiled designs refuse.
// - One block of 4 warps per (64 queries, batch row), 16 query rows a
//   warp; the batch index runs fastest in the grid, so the blocks that
//   read one query tile's five gate tiles (time mode) run together and
//   find them in L2.
// - q (and tqw) pass once through shared memory into mma A fragments
//   (ldmatrix).  k (and rawk) and v rows are staged 64 keys at a time by
//   cp.async into two stages, each row padded by 16 bytes, so the eight
//   row addresses of an ldmatrix / ldmatrix.trans fall in distinct banks.
// - mma.sync m16n8k16 bf16 x bf16 -> f32 computes S = q k^T (time mode:
//   and tqw rawk^T) and O += P v; P is p rounded to bf16 in registers,
//   S's accumulator layout reused as the A fragment (no shared memory).
//   bf16 products summed in f32: the Pallas dot_general's arithmetic, up
//   to the order of the sum.
// - The score epilogue runs in the accumulator layout, where each thread
//   knows its (query, key): its t_k and gate values, two adjacent keys a
//   load, are loaded before the chunk's products so the loads overlap them.
// - The max moves once per 512-key block: each block's scores are
//   computed twice, pass 1 for the row max, pass 2 for p, l and P v.  A
//   warp's 16 x 512 f32 scores (128 KB a block) do not fit beside time
//   mode's staging (k, rawk, v: 102 KB at d = 128) with two blocks an SM;
//   the second pass costs one more q k^T (the cheap part) and, in time
//   mode, the gate's loads and transcendentals again.  Keeping the scores
//   at one block an SM was slower on the H100 (PERF.md).
// - l sums the unrounded p, O the rounded p, each in a fixed order (a
//   thread's columns, then its quad): no atomics, the same bits twice.
// What bounds it: operations, at B = 64, Tq = Tk = 2048, d = 128 ~0.14
// ms (plain, tisas) and ~0.21 ms (time) at the bf16 tensor-core rate.
// The score epilogue's accurate functions, computed twice, weigh more:
// tisas adds a log1p per (query, key), time a log1p, two tanh and a
// sigmoid (PERF.md).  Later: wgmma, TMA and warp specialisation.
//
// The register-tiled design (`blockwise_regtile_kernel`, the wrapper's
// `blockwise_design` == "regtile": f32, Tq > 1, d in {16, 32, ..., 128})
// replaces the same Pallas body for f32 self-attention.  What bounds it:
// operations, at B = 64, Tq = Tk = 2048, d = 128, 2.05 ms (plain, tisas:
// two products of 2d FLOPs a pair) and 3.08 ms (time: three) at the f32
// FMA rate of 67 TFLOP/s; tensor cores do not serve, since TF32 keeps a
// 10-bit mantissa and f32 is held to 1e-4.  So the design is SGEMM's: FMA
// from registers, each shared-memory load feeding several of them.
// - One block per (64 queries, batch row), the batch index fastest in the
//   grid, as the mma design.  Thread (g, t) = (tid / 16, tid % 16) owns
//   QPT queries, keys t + 16 j (j < 4) of each 64-key tile, and output
//   columns in the 16-byte chunks t and t + 16: QPT = 8 (128 threads, 8 x
//   4 scores, 8 x 8 outputs) in plain and tisas, QPT = 4 (256 threads) in
//   time mode, whose third product and gate need the registers.
// - q (and tqw) are staged once, k (and rawk) and v a 64-key tile at a
//   time, all by cp.async: q, k, tqw and rawk chunk-major ([d/4][64 rows]
//   of 16-byte chunks), so a warp's 16 keys of one chunk are 256
//   contiguous bytes and its two query groups' rows a broadcast; v
//   row-major.  A chunk step of S = q k^T is QPT + 4 loads for 16 QPT
//   FMAs, a key step of O += P v QPT / 4 + 2 loads for 8 QPT.
// - The max moves once per 64-key tile: a half-warp holds a query group's
//   64 scores, so the tile max and the sum of p are four xor shuffles, and
//   m, l and O's rescale stay in registers.  In f32 p is not rounded, so
//   this differs from the Pallas kernel's 512-key blocks by float rounding
//   only (tests/test_torch_blockwise_design.py holds the twin at 64-key
//   blocks to Pallas).  The gate and its transcendental functions are
//   computed once per (query, key); their operands are all loaded between
//   the products and their first use.  p passes through one [64 queries]
//   [64 keys] shared tile.
// - Shared memory at d = 128: q, k, v 32 KB each and p 16 KB, so plain and
//   tisas run two blocks an SM; time adds tqw and rawk (64 KB) and runs
//   one.  The next tile's k loads during P v, its v during the next scores.
// - Edges as above: a tile wholly at or past key_len is not visited, keys
//   past key_len score -2^32+1, keys past Tk get p = 0, query rows past Tq
//   load zeros and are not written, a row with no live key takes its Tk
//   keys at weight 1/Tk.  l and O sum in a fixed order: the same bits
//   twice.  Variants measured: PERF.md.

#include "common.cuh"

namespace {

// the Python wrapper's BLOCKWISE_MODES order
enum { BW_PLAIN = 0, BW_TIME = 1, BW_TISAS = 2 };
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyBlock = 512;  // KEY_BLOCK: the max moves once per block
constexpr int kSub = 64;        // keys staged in shared memory at a time
constexpr int kMaxD = 256;      // BLOCKWISE_MAX_D
constexpr float kNegFill = -4294967295.0f;  // -(2^32) + 1

template <int QT>
struct Tile {
  static constexpr int kPairs = QT * kSub;  // (query, key) pairs a sub-tile
  // threads that share one pair's dot products, and queries a thread takes
  static constexpr int kGroup = kPairs >= kThreads ? 1 : kThreads / kPairs;
  static constexpr int kQPT = kPairs >= kThreads ? kPairs / kThreads : 1;
  static constexpr int kOut = (QT * kMaxD + kThreads - 1) / kThreads;
};

template <int QT>
size_t smem_floats(int mode, int D) {
  const int staged = mode == BW_TIME ? 2 : 1;
  return (size_t)staged * QT * D + (size_t)staged * kSub * (D + Tile<QT>::kGroup)
         + (size_t)QT * kKeyBlock + 3 * QT;
}

template <typename T, int MODE, int QT>
__global__ void __launch_bounds__(kThreads) blockwise_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ t_q, const T* __restrict__ t_k,
    const T* __restrict__ tqw, const T* __restrict__ rawk,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ wo1, const T* __restrict__ wo2,
    const T* __restrict__ bo, const int* __restrict__ key_len,
    float* __restrict__ out, int Tq, int Tk, int D, float scale) {
  constexpr int G = Tile<QT>::kGroup, QPT = Tile<QT>::kQPT;
  constexpr int NOUT = Tile<QT>::kOut;
  constexpr bool TIME = MODE == BW_TIME;
  extern __shared__ __align__(16) float smem[];
  // a staged row's stride: D + G keeps the dot products' reads on distinct
  // banks (lanes differ in key and in their 1/G share of d)
  const int ks = D + G;
  float* s_q = smem;                             // [QT][D]
  float* s_tqw = s_q + QT * D;                   // [QT][D], time mode
  float* s_k = s_tqw + (TIME ? QT * D : 0);      // [kSub][ks]; v: [kSub][D]
  float* s_rk = s_k + kSub * ks;                 // [kSub][ks], time mode
  float* s_p = s_rk + (TIME ? kSub * ks : 0);    // [QT][kKeyBlock]
  float* s_m = s_p + QT * kKeyBlock;             // [QT] running max
  float* s_l = s_m + QT;                         // [QT] running sum
  float* s_a = s_l + QT;                         // [QT] this block's alpha

  const int tiles = (Tq + QT - 1) / QT;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * QT;
  const int nq = min(QT, Tq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < QT * D; i += kThreads) {
    const int r = i / D, e = i % D;
    const size_t src = ((size_t)b * Tq + q0 + r) * D + e;
    s_q[i] = r < nq ? port::to_float(q[src]) : 0.f;
    if (TIME) s_tqw[i] = r < nq ? port::to_float(tqw[src]) : 0.f;
  }
  if (tid < QT) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  // keys with a computed score; every other key scores -2^32+1.  With no
  // live key all Tk keys share that score, hence weight 1/Tk.
  const int live = max(0, min(key_len[b], Tk));
  const int key_end = live > 0 ? live : Tk;   // keys the weights reach
  const size_t row_k = (size_t)b * Tk;

  // the score phase's thread layout: pair (queries qg*QPT.., key kk)
  const int g = tid % G, kk = (tid / G) % kSub, qg = tid / (G * kSub);
  float acc[NOUT];
#pragma unroll
  for (int r = 0; r < NOUT; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < key_end; c0 += kKeyBlock) {
    const int n = min(kKeyBlock, Tk - c0);       // the block's keys
    // ---- scores of the block, kSub keys at a time
    for (int s0 = 0; s0 < n; s0 += kSub) {
      const int ns = min(kSub, n - s0);
      const int nlive = max(0, min(ns, live - c0 - s0));
      __syncthreads();                           // s_k, s_rk free again
      for (int i = tid; i < nlive * D; i += kThreads) {
        const int r = i / D, e = i % D;
        const size_t src = (row_k + c0 + s0 + r) * D + e;
        s_k[r * ks + e] = port::to_float(k[src]);
        if (TIME) s_rk[r * ks + e] = port::to_float(rawk[src]);
      }
      __syncthreads();
      float dot[QPT], dtm[QPT];
#pragma unroll
      for (int u = 0; u < QPT; ++u) dot[u] = dtm[u] = 0.f;
      if (kk < nlive) {
#pragma unroll 4
        for (int e = g; e < D; e += G) {
          const float kv = s_k[kk * ks + e];
          const float rv = TIME ? s_rk[kk * ks + e] : 0.f;
#pragma unroll
          for (int u = 0; u < QPT; ++u) {
            const int qi = qg * QPT + u;
            dot[u] = fmaf(s_q[qi * D + e], kv, dot[u]);
            if (TIME) dtm[u] = fmaf(s_tqw[qi * D + e], rv, dtm[u]);
          }
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < QPT; ++u) {
          dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
          if (TIME) dtm[u] += __shfl_xor_sync(0xffffffffu, dtm[u], off);
        }
      }
      if (g == 0 && kk < ns) {
        const int c = c0 + s0 + kk;
        const float tk = MODE == BW_PLAIN || kk >= nlive
                             ? 0.f : port::to_float(t_k[row_k + c]);
#pragma unroll
        for (int u = 0; u < QPT; ++u) {
          const int qi = qg * QPT + u;
          float s = kNegFill;
          if (kk < nlive && qi < nq) {
            const int i = q0 + qi;
            if (MODE == BW_PLAIN) {
              s = dot[u] * scale;
            } else {
              const float logdt = log1pf(
                  fabsf(port::to_float(t_q[(size_t)b * Tq + i]) - tk));
              if (TIME) {
                const size_t gi = (size_t)i * Tk + c;
                const float decay = tanhf(logdt * port::to_float(w1[gi]) +
                                          port::to_float(b1[gi]));
                const float gate = port::to_float(wo1[gi]) * decay +
                                   port::to_float(wo2[gi]) * tanhf(dtm[u]) +
                                   port::to_float(bo[gi]);
                s = dot[u] * port::sigmoid(gate) * scale;
              } else {
                s = (dot[u] + logdt) * scale;
              }
            }
          }
          s_p[qi * kKeyBlock + s0 + kk] = s;
        }
      }
    }
    __syncthreads();
    // ---- the block's max, p (rounded in place) and the running sums
    for (int qi = warp; qi < QT; qi += kWarps) {
      float* row = s_p + qi * kKeyBlock;
      float mx = -INFINITY;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, row[c]);
      mx = port::warp_max(mx);
      const float m_prev = s_m[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < n; c += 32) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = port::round_to<T>(p);
      }
      sum = port::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_a[qi] = alpha;
        s_l[qi] = s_l[qi] * alpha + sum;
        s_m[qi] = m_new;
      }
    }
    __syncthreads();
    // ---- acc = acc * alpha + p @ v over the keys the weights reach
#pragma unroll
    for (int r = 0; r < NOUT; ++r) {
      const int o = tid + r * kThreads;
      if (o < QT * D) acc[r] *= s_a[o / D];
    }
    const int nv_end = min(n, key_end - c0);
    for (int s0 = 0; s0 < nv_end; s0 += kSub) {
      const int nv = min(kSub, nv_end - s0);
      __syncthreads();                           // s_k free again
      for (int i = tid; i < nv * D; i += kThreads)
        s_k[i] = port::to_float(v[(row_k + c0 + s0) * D + i]);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < NOUT; ++r) {
        const int o = tid + r * kThreads;
        if (o < QT * D) {
          const int qi = o / D, e = o % D;
          const float* pr = s_p + qi * kKeyBlock + s0;
          float a = acc[r];
#pragma unroll 8
          for (int c = 0; c < nv; ++c) a = fmaf(pr[c], s_k[c * D + e], a);
          acc[r] = a;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NOUT; ++r) {
    const int o = tid + r * kThreads;
    if (o < QT * D) {
      const int qi = o / D, e = o % D;
      if (qi < nq)
        out[((size_t)b * Tq + q0 + qi) * D + e] = acc[r] / s_l[qi];
    }
  }
}

template <typename T, int MODE, int QT>
cudaError_t launch(const void* const* p, float* out, int B, int Tq, int Tk,
                   int D, float scale, cudaStream_t stream) {
  auto kernel = blockwise_kernel<T, MODE, QT>;
  const size_t smem = smem_floats<QT>(MODE, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)B * ((Tq + QT - 1) / QT);
  auto t = [p](int i) { return static_cast<const T*>(p[i]); };
  kernel<<<grid, kThreads, smem, stream>>>(
      t(0), t(1), t(2), t(3), t(4), t(5), t(6), t(7), t(8), t(9), t(10),
      t(11), static_cast<const int*>(p[12]), out, Tq, Tk, D, scale);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_tile(const void* const* p, float* out, int B, int Tq,
                        int Tk, int D, float scale, cudaStream_t stream) {
  if (Tq == 1) return launch<T, MODE, 1>(p, out, B, Tq, Tk, D, scale, stream);
  return launch<T, MODE, 16>(p, out, B, Tq, Tk, D, scale, stream);
}

template <typename T>
cudaError_t launch_mode(int mode, const void* const* p, float* out, int B,
                        int Tq, int Tk, int D, float scale,
                        cudaStream_t stream) {
  switch (mode) {
    case BW_PLAIN:
      return launch_tile<T, BW_PLAIN>(p, out, B, Tq, Tk, D, scale, stream);
    case BW_TIME:
      return launch_tile<T, BW_TIME>(p, out, B, Tq, Tk, D, scale, stream);
    case BW_TISAS:
      return launch_tile<T, BW_TISAS>(p, out, B, Tq, Tk, D, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------ tensor-core design

using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaQ = 16 * kMmaWarps;    // queries a block
constexpr int kMmaSub = 64;              // keys a staged sub-tile
constexpr int kMmaMaxD = 128;
static_assert(kMmaQ == kMmaSub, "q and tqw are staged in sub-tile arrays");

// a staged row: d values and 8 of padding (16 bytes)
__host__ __device__ constexpr int mma_stride(int D) { return D + 8; }

size_t mma_smem_bytes(int mode, int D) {
  const int arrays = mode == BW_TIME ? 3 : 2;    // k, v (and rawk)
  return (size_t)2 * arrays * kMmaSub * mma_stride(D) * sizeof(bf16);
}

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

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// row[c] and row[c + 1] (c even) of a row of n values: one 4-byte load
// where rows and pointer allow (`pairs`), else two; a column past the
// row reads some value of it (its scores are masked)
__device__ __forceinline__ __nv_bfloat162 load_pair(const bf16* row, int c,
                                                    int n, bool pairs) {
  if (pairs)
    return *reinterpret_cast<const __nv_bfloat162*>(row + min(c, n - 2));
  __nv_bfloat162 r;
  r.x = row[min(c, n - 1)];
  r.y = row[min(c + 1, n - 1)];
  return r;
}
__device__ __forceinline__ float pair_at(__nv_bfloat162 v, int odd) {
  return __bfloat162float(odd ? v.y : v.x);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t.  A: a0 (row
// g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols 2t+8, 2t+9), a3 (row
// g+8, cols 2t+8, 2t+9).  B: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8,
// 2t+9).  C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
template <int MODE, int NK>
__global__ void __launch_bounds__(kMmaThreads) blockwise_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ t_q,
    const bf16* __restrict__ t_k, const bf16* __restrict__ tqw,
    const bf16* __restrict__ rawk, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const bf16* __restrict__ wo1,
    const bf16* __restrict__ wo2, const bf16* __restrict__ bo,
    const int* __restrict__ key_len, float* __restrict__ out, int B, int Tq,
    int Tk, float scale, bool pairs) {
  constexpr int D = 16 * NK, S = mma_stride(D), TILE = kMmaSub * S;
  constexpr int CH = D / 8;                  // 16-byte chunks a row
  constexpr bool TIME = MODE == BW_TIME;
  constexpr int ARRAYS = TIME ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const int b = blockIdx.x % B;
  const int q0 = (int)(blockIdx.x / B) * kMmaQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row_q = (size_t)b * Tq, row_k = (size_t)b * Tk;

  // ---- q (and tqw) rows into A fragments, through shared memory
  for (int i = tid; i < kMmaQ * CH; i += kMmaThreads) {
    const int r = i / CH, ch = i % CH;
    const bool ok = q0 + r < Tq;
    const size_t src = (row_q + (ok ? q0 + r : 0)) * D + ch * 8;
    cp_async16(sm + r * S + ch * 8, q + src, ok);
    if constexpr (TIME) cp_async16(sm + TILE + r * S + ch * 8, tqw + src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qa[NK][4], ta[TIME ? NK : 1][4];
  {
    const bf16* a = sm + (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      ldsm_x4(qa[kk], a + kk * 16);
      if constexpr (TIME) ldsm_x4(ta[kk], a + TILE + kk * 16);
    }
  }
  __syncthreads();

  // this thread's two query rows: h = 0 (row g) and h = 1 (row g + 8)
  int qi[2];
  float tq_row[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + warp * 16 + g + 8 * h;
    if (MODE != BW_PLAIN && qi[h] < Tq)
      tq_row[h] = port::to_float(t_q[row_q + qi[h]]);
  }
  // keys with a computed score, and the keys the weights reach (all Tk
  // when none is live: uniform weights, as the kernel above)
  const int live = max(0, min(key_len[b], Tk));
  const int key_end = live > 0 ? live : Tk;

  // The walk: for each 512-key block before key_end, pass 1 over the
  // sub-tiles holding a live key, then pass 2 over those before key_end.
  auto pass_tiles = [&](int c0, int pass) {
    const int n = min(kKeyBlock, Tk - c0);
    const int upto = min(n, (pass == 1 ? live : key_end) - c0);
    return upto > 0 ? (upto + kMmaSub - 1) / kMmaSub : 0;
  };
  struct Cursor { int c0, pass, sub; };
  auto first_of = [&](int c0) {
    return Cursor{c0, pass_tiles(c0, 1) > 0 ? 1 : 2, 0};
  };
  auto advance = [&](Cursor c) {
    if (++c.sub < pass_tiles(c.c0, c.pass)) return c;
    if (c.pass == 1) return Cursor{c.c0, 2, 0};
    return first_of(c.c0 + kKeyBlock);
  };
  // a block's max starts at the masked keys' score if it has any
  auto max_init = [&](int c0) {
    return c0 + min(kKeyBlock, Tk - c0) > live ? kNegFill : -INFINITY;
  };
  auto load = [&](int stage, Cursor c) {
    bf16* sk = sm + stage * ARRAYS * TILE;
    bf16* sv = sk + TILE;
    const int base = c.c0 + c.sub * kMmaSub;
    for (int i = tid; i < kMmaSub * CH; i += kMmaThreads) {
      const int r = i / CH, ch = i % CH, key = base + r;
      const bool kok = key < live;
      const size_t src = (row_k + (kok ? key : 0)) * D + ch * 8;
      cp_async16(sk + r * S + ch * 8, k + src, kok);
      if constexpr (TIME)
        cp_async16(sv + TILE + r * S + ch * 8, rawk + src, kok);
      if (c.pass == 2) {
        const bool vok = key < key_end;
        cp_async16(sv + r * S + ch * 8,
                   v + (row_k + (vok ? key : 0)) * D + ch * 8, vok);
      }
    }
    cp_async_commit();
  };

  float o[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float bmax[2], bsum[2] = {0.f, 0.f};
  bmax[0] = bmax[1] = max_init(0);

  Cursor cur = first_of(0);
  int stage = 0;
  load(stage, cur);
  while (true) {
    const Cursor nxt = advance(cur);
    const bool more = nxt.c0 < key_end;
    if (more) {
      load(stage ^ 1, nxt);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (cur.pass == 2 && cur.sub == 0) {
      // the block's max: m_new, alpha, and O and l rescaled
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bm = bmax[h];
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
        const float m_new = fmaxf(m_run[h], bm);
        const float alpha = expf(m_run[h] - m_new);
        l_run[h] *= alpha;
#pragma unroll
        for (int n = 0; n < 2 * NK; ++n) {
          o[n][2 * h] *= alpha;
          o[n][2 * h + 1] *= alpha;
        }
        m_run[h] = m_new;
        bsum[h] = 0.f;
      }
    }

    const bf16* sk = sm + stage * ARRAYS * TILE;
    const bf16* sv = sk + TILE;
    const bf16* sr = sv + TILE;
    const int base = cur.c0 + cur.sub * kMmaSub;
    const int limit = cur.pass == 1 ? live : key_end;
#pragma unroll
    for (int j = 0; j < kMmaSub / 16; ++j) {
      if (base + 16 * j >= limit) break;     // the same for the whole block
      // the epilogue's operands at this thread's columns (c, c + 1) of
      // each n-tile, loaded before the products to overlap them
      const int cb = base + 16 * j + 2 * t;
      __nv_bfloat162 tk2[2], gt[2][2][5];    // [n], [h][n][w1 b1 wo1 wo2 bo]
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if constexpr (MODE != BW_PLAIN)
          tk2[n] = load_pair(t_k + row_k, cb + 8 * n, Tk, pairs);
        if constexpr (TIME) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t gr = (size_t)min(qi[h], Tq - 1) * Tk;
            gt[h][n][0] = load_pair(w1 + gr, cb + 8 * n, Tk, pairs);
            gt[h][n][1] = load_pair(b1 + gr, cb + 8 * n, Tk, pairs);
            gt[h][n][2] = load_pair(wo1 + gr, cb + 8 * n, Tk, pairs);
            gt[h][n][3] = load_pair(wo2 + gr, cb + 8 * n, Tk, pairs);
            gt[h][n][4] = load_pair(bo + gr, cb + 8 * n, Tk, pairs);
          }
        }
      }
      // S (and tqw rawk^T) for 16 keys: two 8-key n-tiles
      float s[2][4], tt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = tt[n][e] = 0.f;
      {
        const int kr = 16 * j + (lane >> 4) * 8 + (lane & 7);
        const int kc = ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          unsigned kb[4];
          ldsm_x4(kb, sk + kr * S + kk * 16 + kc);
          mma_bf16(s[0], qa[kk], kb[0], kb[1]);
          mma_bf16(s[1], qa[kk], kb[2], kb[3]);
          if constexpr (TIME) {
            unsigned rb[4];
            ldsm_x4(rb, sr + kr * S + kk * 16 + kc);
            mma_bf16(tt[0], ta[kk], rb[0], rb[1]);
            mma_bf16(tt[1], ta[kk], rb[2], rb[3]);
          }
        }
      }
      // the score epilogue, in the accumulator layout
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, odd = e & 1;
          const int c = cb + 8 * n + odd;
          // computed for every element (masked ones read zero-filled
          // rows and clamped operands), then masked by a select: no
          // branch, so the eight elements' chains interleave
          const float dot = s[n][e];
          float sc;
          if constexpr (MODE == BW_PLAIN) {
            sc = dot * scale;
          } else {
            const float logdt =
                log1pf(fabsf(tq_row[h] - pair_at(tk2[n], odd)));
            if constexpr (TIME) {
              const __nv_bfloat162* w = gt[h][n];
              const float decay = tanhf(logdt * pair_at(w[0], odd) +
                                        pair_at(w[1], odd));
              const float gate = pair_at(w[2], odd) * decay +
                                 pair_at(w[3], odd) * tanhf(tt[n][e]) +
                                 pair_at(w[4], odd);
              sc = dot * port::sigmoid(gate) * scale;
            } else {
              sc = (dot + logdt) * scale;
            }
          }
          sc = c < live && qi[h] < Tq ? sc : kNegFill;
          if (cur.pass == 1) {
            if (c < Tk) bmax[h] = fmaxf(bmax[h], sc);
          } else {
            const float p = c < key_end ? expf(sc - m_run[h]) : 0.f;
            bsum[h] += p;
            s[n][e] = p;
          }
        }
      }
      if (cur.pass == 2) {
        // O += round(p) v: p's accumulator layout is P's A fragment
        const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
        const int vr = 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int vc = (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < NK; ++dp) {
          unsigned vb[4];
          ldsm_x4_trans(vb, sv + vr * S + dp * 16 + vc);
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }

    if (cur.pass == 2 && nxt.c0 != cur.c0) {
      // the block's end: l = l * alpha + sum(p); the next block's max
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bs = bsum[h];
        bs += __shfl_xor_sync(0xffffffffu, bs, 1);
        bs += __shfl_xor_sync(0xffffffffu, bs, 2);
        l_run[h] += bs;
        bmax[h] = more ? max_init(nxt.c0) : -INFINITY;
      }
    }
    __syncthreads();                           // this stage free again
    if (!more) break;
    cur = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qi[h] >= Tq) continue;
    float* dst = out + (row_q + qi[h]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * h] / l_run[h], o[n][2 * h + 1] / l_run[h]);
  }
}

template <int MODE, int NK>
cudaError_t launch_mma(const void* const* p, float* out, int B, int Tq,
                       int Tk, float scale, cudaStream_t stream) {
  auto kernel = blockwise_mma_kernel<MODE, NK>;
  const size_t smem = mma_smem_bytes(MODE, 16 * NK);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)B * ((Tq + kMmaQ - 1) / kMmaQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto t = [p](int i) { return static_cast<const bf16*>(p[i]); };
  // t_k and the gate tiles read two columns at once where their rows
  // start 4-byte aligned
  bool pairs = Tk % 2 == 0;
  for (int i = 4; i <= 11; ++i)
    if (i != 5 && i != 6) pairs = pairs && (size_t)p[i] % 4 == 0;
  kernel<<<(unsigned)grid, kMmaThreads, smem, stream>>>(
      t(0), t(1), t(2), t(3), t(4), t(5), t(6), t(7), t(8), t(9), t(10),
      t(11), static_cast<const int*>(p[12]), out, B, Tq, Tk, scale, pairs);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mma_d(const void* const* p, float* out, int B, int Tq,
                         int Tk, int D, float scale, cudaStream_t stream) {
  switch (D / 16) {
    case 1: return launch_mma<MODE, 1>(p, out, B, Tq, Tk, scale, stream);
    case 2: return launch_mma<MODE, 2>(p, out, B, Tq, Tk, scale, stream);
    case 3: return launch_mma<MODE, 3>(p, out, B, Tq, Tk, scale, stream);
    case 4: return launch_mma<MODE, 4>(p, out, B, Tq, Tk, scale, stream);
    case 5: return launch_mma<MODE, 5>(p, out, B, Tq, Tk, scale, stream);
    case 6: return launch_mma<MODE, 6>(p, out, B, Tq, Tk, scale, stream);
    case 7: return launch_mma<MODE, 7>(p, out, B, Tq, Tk, scale, stream);
    case 8: return launch_mma<MODE, 8>(p, out, B, Tq, Tk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- register-tiled f32 design

constexpr int kRtQ = 64;       // queries a block
constexpr int kRtKeys = 64;    // keys a staged tile: 16 lanes x 4
constexpr int kRtMaxD = 128;
static_assert(kRtQ == kRtKeys, "q and k tiles share one layout");

// queries a thread: 8 in plain and tisas (128 threads, two blocks an SM),
// 4 in time mode (256 threads, one block an SM: its staging takes 176 KB)
__host__ __device__ constexpr int rt_qpt(int mode) {
  return mode == BW_TIME ? 4 : 8;
}
__host__ __device__ constexpr int rt_threads(int mode) {
  return 16 * kRtQ / rt_qpt(mode);
}

size_t rt_smem_bytes(int mode, int D) {
  const int tiles = mode == BW_TIME ? 5 : 3;  // q, k, v (and tqw, rawk)
  return ((size_t)tiles * kRtKeys * (D / 4) + (size_t)kRtKeys * (kRtQ / 4))
         * sizeof(float4);
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// Thread (g, t) = (tid / 16, tid % 16) owns queries QPT g .. QPT g + QPT-1
// of the tile, keys t, t+16, t+32, t+48 of each key tile, and output
// chunks (4 columns each) t and t+16.  A half-warp holds one query group's
// 64 keys, so the row max and sum are four xor shuffles.
template <int MODE, int NK>
__global__ void __launch_bounds__(rt_threads(MODE), MODE == BW_TIME ? 1 : 2)
    blockwise_regtile_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ t_q,
        const float* __restrict__ t_k, const float* __restrict__ tqw,
        const float* __restrict__ rawk, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ wo1,
        const float* __restrict__ wo2, const float* __restrict__ bo,
        const int* __restrict__ key_len, float* __restrict__ out, int B,
        int Tq, int Tk, float scale) {
  constexpr int D = 16 * NK, NCH = D / 4;
  constexpr int U = (NCH + 15) / 16;          // output chunks a thread
  constexpr int QPT = rt_qpt(MODE), H = QPT / 4, NT = rt_threads(MODE);
  constexpr bool TIME = MODE == BW_TIME;
  extern __shared__ __align__(16) float4 sm4[];
  // q, k, tqw and rawk chunk-major ([NCH][64 rows] of 16-byte chunks), v
  // row-major, p as [16 groups of 4 queries][64 keys]
  float4* sq = sm4;
  float4* sk = sq + NCH * kRtQ;
  float4* sv = sk + NCH * kRtKeys;
  float4* sp = sv + kRtKeys * NCH;
  float4* st = sp + kRtKeys * (kRtQ / 4);     // tqw, time mode
  float4* sr = st + NCH * kRtQ;               // rawk, time mode
  // the chunk-major tiles' loads: a warp takes 8 rows x 4 chunks, 64
  // contiguous bytes of each row, and writes them to 8 distinct banks
  auto row_of = [](int i) { return (i >> 3) / NCH * 8 + (i & 7); };
  auto chunk_of = [](int i) { return (i >> 3) % NCH; };

  const int b = blockIdx.x % B;
  const int q0 = (int)(blockIdx.x / B) * kRtQ;
  const int tid = threadIdx.x, g = tid >> 4, t = tid & 15;
  const size_t row_q = (size_t)b * Tq, row_k = (size_t)b * Tk;
  // keys with a computed score, and the keys the weights reach (all Tk
  // when none is live: uniform weights, as the designs above)
  const int live = max(0, min(key_len[b], Tk));
  const int key_end = live > 0 ? live : Tk;

  for (int i = tid; i < kRtQ * NCH; i += NT) {
    const int r = row_of(i), ch = chunk_of(i);
    const bool ok = q0 + r < Tq;
    const size_t src = (row_q + (ok ? q0 + r : 0)) * D + 4 * ch;
    cp_async16(sq + ch * kRtQ + r, q + src, ok);
    if constexpr (TIME) cp_async16(st + ch * kRtQ + r, tqw + src, ok);
  }
  cp_async_commit();
  auto load_k = [&](int c0) {
    for (int i = tid; i < kRtKeys * NCH; i += NT) {
      const int r = row_of(i), ch = chunk_of(i), key = c0 + r;
      const bool ok = key < live;
      const size_t src = (row_k + (ok ? key : 0)) * D + 4 * ch;
      cp_async16(sk + ch * kRtKeys + r, k + src, ok);
      if constexpr (TIME) cp_async16(sr + ch * kRtKeys + r, rawk + src, ok);
    }
    cp_async_commit();
  };
  auto load_v = [&](int c0) {
    for (int i = tid; i < kRtKeys * NCH; i += NT) {
      const int r = i / NCH, ch = i % NCH, key = c0 + r;
      const bool ok = key < key_end;
      cp_async16(sv + r * NCH + ch,
                 v + (row_k + (ok ? key : 0)) * D + 4 * ch, ok);
    }
    cp_async_commit();
  };

  int qi[QPT];
  float tq_row[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    qi[i] = q0 + QPT * g + i;
    tq_row[i] = MODE == BW_PLAIN ? 0.f : t_q[row_q + min(qi[i], Tq - 1)];
  }
  float o[QPT][U][4];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][u][e] = 0.f;
  float m_run[QPT], l_run[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) m_run[i] = -INFINITY, l_run[i] = 0.f;

  // The walk: k (and rawk) of tile n + 1 load during P v of tile n, its v
  // during the scores of tile n + 1.
  load_k(0);
  load_v(0);
  for (int c0 = 0; c0 < key_end; c0 += kRtKeys) {
    const bool more = c0 + kRtKeys < key_end;
    cp_async_wait<1>();                       // q and this tile's k in
    __syncthreads();
    // S = q k^T (time mode: and tqw rawk^T), QPT x 4 a thread, each sum
    // over d in order
    float s[QPT][4], tt[TIME ? QPT : 1][4];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        if constexpr (TIME) tt[i][j] = 0.f;
      }
#pragma unroll 4
    for (int ch = 0; ch < NCH; ++ch) {
      float4 kv[4], rv[TIME ? 4 : 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sk[ch * kRtKeys + t + 16 * j];
        if constexpr (TIME) rv[j] = sr[ch * kRtKeys + t + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float4 qv = sq[ch * kRtQ + QPT * g + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) fma4(s[i][j], qv, kv[j]);
        if constexpr (TIME) {
          const float4 tv = st[ch * kRtQ + QPT * g + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) fma4(tt[i][j], tv, rv[j]);
        }
      }
    }
    // the epilogue's operands, all loaded before the first is used
    float tkv[4], gt[TIME ? QPT : 1][4][5];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = min(c0 + t + 16 * j, Tk - 1);
      tkv[j] = MODE == BW_PLAIN ? 0.f : t_k[row_k + cc];
      if constexpr (TIME) {
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const size_t gi = (size_t)min(qi[i], Tq - 1) * Tk + cc;
          gt[i][j][0] = w1[gi];
          gt[i][j][1] = b1[gi];
          gt[i][j][2] = wo1[gi];
          gt[i][j][3] = wo2[gi];
          gt[i][j][4] = bo[gi];
        }
      }
    }
    // the scores, the tile's max, p, and the running m, l and O
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + t + 16 * j;
        float sc;
        if constexpr (MODE == BW_PLAIN) {
          sc = s[i][j] * scale;
        } else {
          const float logdt = log1pf(fabsf(tq_row[i] - tkv[j]));
          if constexpr (TIME) {
            const float* w = gt[i][j];
            const float decay = tanhf(logdt * w[0] + w[1]);
            const float gate = w[2] * decay + w[3] * tanhf(tt[i][j]) + w[4];
            sc = s[i][j] * port::sigmoid(gate) * scale;
          } else {
            sc = (s[i][j] + logdt) * scale;
          }
        }
        sc = c < live && qi[i] < Tq ? sc : kNegFill;
        s[i][j] = sc;
        if (c < key_end) bm = fmaxf(bm, sc);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
      const float m_new = fmaxf(m_run[i], bm);
      const float alpha = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = c0 + t + 16 * j < key_end ? expf(s[i][j] - m_new)
                                                  : 0.f;
        s[i][j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[i] = l_run[i] * alpha + ps;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][u][e] *= alpha;
    }
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sp[(H * g + h) * kRtKeys + t + 16 * j] =
            make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j],
                        s[4 * h + 3][j]);
    cp_async_wait<0>();                       // this tile's v in
    __syncthreads();                          // p visible; k free
    if (more) load_k(c0 + kRtKeys);
    // O += p v, each column's sum over the keys in order
#pragma unroll 4
    for (int c = 0; c < kRtKeys; ++c) {
      float pr[QPT];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 pv = sp[(H * g + h) * kRtKeys + c];
        pr[4 * h] = pv.x, pr[4 * h + 1] = pv.y;
        pr[4 * h + 2] = pv.z, pr[4 * h + 3] = pv.w;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (NCH % 16 != 0 && t + 16 * u >= NCH) continue;
        const float4 vv = sv[c * NCH + t + 16 * u];
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          o[i][u][0] = fmaf(pr[i], vv.x, o[i][u][0]);
          o[i][u][1] = fmaf(pr[i], vv.y, o[i][u][1]);
          o[i][u][2] = fmaf(pr[i], vv.z, o[i][u][2]);
          o[i][u][3] = fmaf(pr[i], vv.w, o[i][u][3]);
        }
      }
    }
    __syncthreads();                          // v and p free
    if (more) load_v(c0 + kRtKeys);
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    if (qi[i] >= Tq) continue;
    float4* dst = reinterpret_cast<float4*>(out + (row_q + qi[i]) * D);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (NCH % 16 != 0 && t + 16 * u >= NCH) continue;
      dst[t + 16 * u] = make_float4(o[i][u][0] / l_run[i],
                                    o[i][u][1] / l_run[i],
                                    o[i][u][2] / l_run[i],
                                    o[i][u][3] / l_run[i]);
    }
  }
}

template <int MODE, int NK>
cudaError_t launch_regtile(const void* const* p, float* out, int B, int Tq,
                           int Tk, float scale, cudaStream_t stream) {
  auto kernel = blockwise_regtile_kernel<MODE, NK>;
  const size_t smem = rt_smem_bytes(MODE, 16 * NK);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // plain and tisas fit two blocks an SM only with the largest carveout
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)B * ((Tq + kRtQ - 1) / kRtQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto t = [p](int i) { return static_cast<const float*>(p[i]); };
  kernel<<<(unsigned)grid, rt_threads(MODE), smem, stream>>>(
      t(0), t(1), t(2), t(3), t(4), t(5), t(6), t(7), t(8), t(9), t(10),
      t(11), static_cast<const int*>(p[12]), out, B, Tq, Tk, scale);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_regtile_d(const void* const* p, float* out, int B, int Tq,
                             int Tk, int D, float scale,
                             cudaStream_t stream) {
  switch (D / 16) {
    case 1: return launch_regtile<MODE, 1>(p, out, B, Tq, Tk, scale, stream);
    case 2: return launch_regtile<MODE, 2>(p, out, B, Tq, Tk, scale, stream);
    case 3: return launch_regtile<MODE, 3>(p, out, B, Tq, Tk, scale, stream);
    case 4: return launch_regtile<MODE, 4>(p, out, B, Tq, Tk, scale, stream);
    case 5: return launch_regtile<MODE, 5>(p, out, B, Tq, Tk, scale, stream);
    case 6: return launch_regtile<MODE, 6>(p, out, B, Tq, Tk, scale, stream);
    case 7: return launch_regtile<MODE, 7>(p, out, B, Tq, Tk, scale, stream);
    case 8: return launch_regtile<MODE, 8>(p, out, B, Tq, Tk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- split design (Tq = 1)
//
// MTAM's serving hops past 1024 keys: one query a row.  The SIMT kernel
// above gives a row one block, so B = 64 rows fill 64 of the 132 SMs and
// one row of 2048 keys keeps one SM busy alone.  Here a row's keys are cut
// into splits of `split` keys (the wrapper's choice, a function of Tk
// only, so a row's bits do not depend on the batch), and two launches:
//  1. blockwise_split_kernel, one block of 256 threads a (row b, split s),
//     s fastest in the grid:
//     the split's scores as the SIMT kernel computes them (same gate, mask
//     and fill), its max m_s, l_s = sum of the unrounded p = exp(s - m_s),
//     and acc_s = sum round_T(p) v in f32, written as the triple (m_s,
//     l_s, acc_s[D]) to an f32 workspace [B][S][D + 2].  A split wholly at
//     or past the keys the weights reach writes m = -inf, l = 0, acc = 0.
//  2. blockwise_merge_kernel, one block a row: m = max_s m_s, then l and
//     acc as sums over the splits in order of the triples rescaled by
//     exp(m_s - m), skipping the empty ones; out = acc / l.
// No float atomics: every sum has a fixed order, so the same inputs give
// the same bits.  Scores: warp w takes keys w*4.., four at a time, its
// lanes over d (k and rawk read once, coalesced, q and tqw in registers),
// warp sums; then one thread a key computes the gate and the score.  The
// weighted sum: a thread takes VEC adjacent columns of v (16 bytes a load
// where D's rows allow it, else one value), D / VEC threads a key row,
// kThreads / (D / VEC) groups of them over keys g, g + G, ...; the groups'
// sums are added in order.  16-byte loads keep enough of v in flight to
// cover the memory's latency: with one 2-byte value a load, four blocks
// an SM hold some 8 KB in flight.

constexpr int kSplitKeysMax = 1024;   // the longest split a block takes
constexpr int kSplitUnroll = 4;       // keys a warp scores at once

size_t split_smem_floats(int split, int vec) {
  return 2 * (size_t)split + (size_t)kThreads * vec;
}

// VEC values of T at p (VEC > 1: one 16-byte load) as f32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "a load is 16 bytes");
  if constexpr (VEC == 1) {
    x[0] = port::to_float(p[0]);
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = port::to_float(h[i]);
  }
}

// row b's keys [lo, lo + split) -> ws[(b * S + s) * (D + 2) ...]
template <typename T, int MODE, int NJ, int VEC>
__global__ void __launch_bounds__(kThreads) blockwise_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ t_q, const T* __restrict__ t_k,
    const T* __restrict__ tqw, const T* __restrict__ rawk,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ wo1, const T* __restrict__ wo2,
    const T* __restrict__ bo, const int* __restrict__ key_len,
    float* __restrict__ ws, int Tk, int D, int split, int S, float scale) {
  constexpr bool TIME = MODE == BW_TIME;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  float* s_dot = smem;                 // [split] q . k, then score, then p
  float* s_dtm = s_dot + split;        // [split] tqw . rawk (time mode)
  float* s_part = s_dtm + split;       // [G][D] the groups' sums
  const int s = blockIdx.x % S, b = blockIdx.x / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = max(0, min(key_len[b], Tk));
  const int key_end = live > 0 ? live : Tk;   // keys the weights reach
  const int lo = s * split;
  const int n = max(0, min(split, key_end - lo));
  float* out = ws + ((size_t)b * S + s) * (D + 2);
  if (n == 0) {                        // the whole block leaves together
    for (int e = tid; e < D + 2; e += kThreads)
      out[e] = e == 0 ? -INFINITY : 0.f;
    return;
  }
  const size_t row_k = (size_t)b * Tk + lo;   // the split's first key

  // ---- q . k (and tqw . rawk) of the split's keys; with no live key
  // every key scores the fill, and nothing is read
  if (live > 0) {
    float qr[NJ], tr[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = lane + 32 * j;
      qr[j] = e < D ? port::to_float(q[(size_t)b * D + e]) : 0.f;
      tr[j] = TIME && e < D ? port::to_float(tqw[(size_t)b * D + e]) : 0.f;
    }
    for (int r0 = warp * kSplitUnroll; r0 < n;
         r0 += kWarps * kSplitUnroll) {
      float dk[kSplitUnroll], dt[kSplitUnroll];
#pragma unroll
      for (int u = 0; u < kSplitUnroll; ++u) {
        dk[u] = dt[u] = 0.f;
        if (r0 + u < n) {
          const size_t at = (row_k + r0 + u) * D;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int e = lane + 32 * j;
            if (e < D) {
              dk[u] = fmaf(qr[j], port::to_float(k[at + e]), dk[u]);
              if (TIME)
                dt[u] = fmaf(tr[j], port::to_float(rawk[at + e]), dt[u]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSplitUnroll; ++u) {
        dk[u] = port::warp_sum(dk[u]);
        if (TIME) dt[u] = port::warp_sum(dt[u]);
        if (lane == 0 && r0 + u < n) {
          s_dot[r0 + u] = dk[u];
          s_dtm[r0 + u] = dt[u];
        }
      }
    }
  }
  __syncthreads();

  // ---- scores (one thread a key), the split's max, p and l
  float mx = -INFINITY;
  for (int r = tid; r < n; r += kThreads) {
    float sc = kNegFill;
    if (live > 0) {
      const int c = lo + r;
      if (MODE == BW_PLAIN) {
        sc = s_dot[r] * scale;
      } else {
        const float logdt = log1pf(fabsf(port::to_float(t_q[b]) -
                                         port::to_float(t_k[row_k + r])));
        if (TIME) {
          const float decay = tanhf(logdt * port::to_float(w1[c]) +
                                    port::to_float(b1[c]));
          const float gate = port::to_float(wo1[c]) * decay +
                             port::to_float(wo2[c]) * tanhf(s_dtm[r]) +
                             port::to_float(bo[c]);
          sc = s_dot[r] * port::sigmoid(gate) * scale;
        } else {
          sc = (s_dot[r] + logdt) * scale;
        }
      }
    }
    s_dot[r] = sc;
    mx = fmaxf(mx, sc);
  }
  const float m = port::block_max<kThreads>(mx, red);
  float sum = 0.f;
  for (int r = tid; r < n; r += kThreads) {
    const float p = expf(s_dot[r] - m);
    sum += p;
    s_dot[r] = port::round_to<T>(p);
  }
  const float l = port::block_sum<kThreads>(sum, red);   // ends in a barrier

  // ---- acc = sum_r round(p_r) v_r: group g of D / VEC threads over keys
  // g, g + G, ...; then the groups' sums in order
  const int tpr = D / VEC;             // threads a key row
  const int G = tpr < kThreads ? kThreads / tpr : 1;
  const int grp = tid / tpr, col = (tid % tpr) * VEC;
  float a[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = 0.f;
  if (grp < G) {
    const T* vr = v + row_k * D + col;
#pragma unroll 4
    for (int r = grp; r < n; r += G) {
      const float pr = s_dot[r];
      float x[VEC];
      load_vec<T, VEC>(vr + (size_t)r * D, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) a[i] = fmaf(pr, x[i], a[i]);
    }
    // group grp's sums at [grp][col ..]
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_part[grp * D + col + i] = a[i];
  }
  __syncthreads();
  if (tid < D) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += s_part[g * D + tid];
    out[2 + tid] = acc;
  }
  if (tid == 0) {
    out[0] = m;
    out[1] = l;
  }
}

// out[b, :] from row b's S triples, merged in split order
__global__ void __launch_bounds__(kThreads) blockwise_merge_kernel(
    const float* __restrict__ ws, float* __restrict__ out, int S, int D) {
  const int b = blockIdx.x;
  const float* w = ws + (size_t)b * S * (D + 2);
  float m = -INFINITY;
  for (int s = 0; s < S; ++s) m = fmaxf(m, w[(size_t)s * (D + 2)]);
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* t = w + (size_t)s * (D + 2);
      if (!(t[0] > -INFINITY)) continue;     // an empty split
      const float f = expf(t[0] - m);
      l += t[1] * f;
      acc += t[2 + e] * f;
    }
    out[(size_t)b * D + e] = acc / l;
  }
}

template <typename T, int MODE, int NJ, int VEC>
cudaError_t launch_split(const void* const* p, float* out, float* ws, int B,
                         int Tk, int D, int split, float scale,
                         cudaStream_t stream) {
  auto kernel = blockwise_split_kernel<T, MODE, NJ, VEC>;
  const size_t smem = split_smem_floats(split, VEC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int S = (Tk + split - 1) / split;
  const long long grid = (long long)B * S;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto t = [p](int i) { return static_cast<const T*>(p[i]); };
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      t(0), t(1), t(2), t(3), t(4), t(5), t(6), t(7), t(8), t(9), t(10),
      t(11), static_cast<const int*>(p[12]), ws, Tk, D, split, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blockwise_merge_kernel<<<B, kThreads, 0, stream>>>(ws, out, S, D);
  return cudaGetLastError();
}

// VEC: 16-byte loads of v where its rows are whole 16-byte pieces and
// v is 16-byte aligned, else one value a load
template <typename T, int MODE, int NJ>
cudaError_t launch_split_vec(const void* const* p, float* out, float* ws,
                             int B, int Tk, int D, int split, float scale,
                             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (D % kVec == 0 && reinterpret_cast<size_t>(p[2]) % 16 == 0)
    return launch_split<T, MODE, NJ, kVec>(p, out, ws, B, Tk, D, split,
                                           scale, stream);
  return launch_split<T, MODE, NJ, 1>(p, out, ws, B, Tk, D, split, scale,
                                      stream);
}

// NJ = the 32-lane columns of d a lane takes in the score phase
template <typename T, int MODE>
cudaError_t launch_split_d(const void* const* p, float* out, float* ws,
                           int B, int Tk, int D, int split, float scale,
                           cudaStream_t stream) {
  if (D <= 32)
    return launch_split_vec<T, MODE, 1>(p, out, ws, B, Tk, D, split, scale,
                                        stream);
  if (D <= 64)
    return launch_split_vec<T, MODE, 2>(p, out, ws, B, Tk, D, split, scale,
                                        stream);
  if (D <= 128)
    return launch_split_vec<T, MODE, 4>(p, out, ws, B, Tk, D, split, scale,
                                        stream);
  return launch_split_vec<T, MODE, 8>(p, out, ws, B, Tk, D, split, scale,
                                      stream);
}

template <typename T>
cudaError_t launch_split_mode(int mode, const void* const* p, float* out,
                              float* ws, int B, int Tk, int D, int split,
                              float scale, cudaStream_t stream) {
  switch (mode) {
    case BW_PLAIN:
      return launch_split_d<T, BW_PLAIN>(p, out, ws, B, Tk, D, split, scale,
                                         stream);
    case BW_TIME:
      return launch_split_d<T, BW_TIME>(p, out, ws, B, Tk, D, split, scale,
                                        stream);
    case BW_TISAS:
      return launch_split_d<T, BW_TISAS>(p, out, ws, B, Tk, D, split, scale,
                                         stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All pointers are device pointers to contiguous arrays:
// q/tqw [B,Tq,D], k/v/rawk [B,Tk,D], t_q [B,Tq], t_k [B,Tk],
// w1/b1/wo1/wo2/bo [Tq,Tk], key_len [B] int32, out [B,Tq,D] f32.  The
// floating inputs are all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1);
// operands a mode does not read may be any pointer.  1 <= Tk, 1 <= D <= 256.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_attention_blockwise_launch(
    int mode, int is_bf16, const void* q, const void* k, const void* v,
    const void* t_q, const void* t_k, const void* tqw, const void* rawk,
    const void* w1, const void* b1, const void* wo1, const void* wo2,
    const void* bo, const void* key_len, void* out, int B, int Tq, int Tk,
    int D, float scale, int device, void* stream) {
  if (B <= 0 || Tq <= 0) return cudaSuccess;
  if (Tk <= 0 || D <= 0 || D > kMaxD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* p[13] = {q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo,
                       key_len};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mode<__nv_bfloat16>(mode, p, o, B, Tq, Tk, D, scale, s);
  return launch_mode<float>(mode, p, o, B, Tq, Tk, D, scale, s);
}

// The tensor-core design: the arguments of fused_attention_blockwise_launch,
// all floating inputs bf16, 2 <= Tq, d a multiple of 16 up to 128, and q,
// k, v, tqw and rawk 16-byte aligned (staged by cp.async).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_attention_blockwise_mma_launch(
    int mode, const void* q, const void* k, const void* v, const void* t_q,
    const void* t_k, const void* tqw, const void* rawk, const void* w1,
    const void* b1, const void* wo1, const void* wo2, const void* bo,
    const void* key_len, void* out, int B, int Tq, int Tk, int D, float scale,
    int device, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Tq < 2 || Tk <= 0 || D <= 0 || D % 16 != 0 || D > kMmaMaxD)
    return cudaErrorInvalidValue;
  const void* staged[5] = {q, k, v, tqw, rawk};
  for (const void* ptr : staged)
    if (reinterpret_cast<size_t>(ptr) % 16 != 0)
      return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* p[13] = {q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo,
                       key_len};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case BW_PLAIN: return launch_mma_d<BW_PLAIN>(p, o, B, Tq, Tk, D, scale, s);
    case BW_TIME: return launch_mma_d<BW_TIME>(p, o, B, Tq, Tk, D, scale, s);
    case BW_TISAS: return launch_mma_d<BW_TISAS>(p, o, B, Tq, Tk, D, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The register-tiled design: the arguments of
// fused_attention_blockwise_launch, all floating inputs f32, 2 <= Tq, d a
// multiple of 16 up to 128, and q, k, v, tqw and rawk 16-byte aligned
// (staged by cp.async).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fused_attention_blockwise_regtile_launch(
    int mode, const void* q, const void* k, const void* v, const void* t_q,
    const void* t_k, const void* tqw, const void* rawk, const void* w1,
    const void* b1, const void* wo1, const void* wo2, const void* bo,
    const void* key_len, void* out, int B, int Tq, int Tk, int D, float scale,
    int device, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Tq < 2 || Tk <= 0 || D <= 0 || D % 16 != 0 || D > kRtMaxD)
    return cudaErrorInvalidValue;
  const void* staged[5] = {q, k, v, tqw, rawk};
  for (const void* ptr : staged)
    if (reinterpret_cast<size_t>(ptr) % 16 != 0)
      return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* p[13] = {q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo,
                       key_len};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case BW_PLAIN:
      return launch_regtile_d<BW_PLAIN>(p, o, B, Tq, Tk, D, scale, s);
    case BW_TIME:
      return launch_regtile_d<BW_TIME>(p, o, B, Tq, Tk, D, scale, s);
    case BW_TISAS:
      return launch_regtile_d<BW_TISAS>(p, o, B, Tq, Tk, D, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The split design (Tq = 1): the arguments of
// fused_attention_blockwise_launch at Tq = 1, and ws an f32 workspace of
// B * ceil(Tk / split) * (D + 2) floats; 1 <= split <= 1024 keys a split.
// Two launches (the splits, then the merge); returns the first
// cudaError_t (0 on success).
extern "C" int fused_attention_blockwise_split_launch(
    int mode, int is_bf16, const void* q, const void* k, const void* v,
    const void* t_q, const void* t_k, const void* tqw, const void* rawk,
    const void* w1, const void* b1, const void* wo1, const void* wo2,
    const void* bo, const void* key_len, void* out, void* ws, int B, int Tk,
    int D, int split, float scale, int device, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Tk <= 0 || D <= 0 || D > kMaxD || split <= 0 || split > kSplitKeysMax)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* p[13] = {q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo,
                       key_len};
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_split_mode<__nv_bfloat16>(mode, p, o, w, B, Tk, D, split,
                                            scale, s);
  return launch_split_mode<float>(mode, p, o, w, B, Tk, D, split, scale, s);
}
