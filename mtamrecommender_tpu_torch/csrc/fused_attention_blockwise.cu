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
// Not yet: tensor cores (wgmma), TMA, and split-key decoding at Tq = 1,
// where B = 64 rows fill only 64 of the 132 SMs.

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
