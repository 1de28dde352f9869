// One hop of MTAM's fused multi-hop readout, for one batch row per block:
// the pieces fused_readout.cu (forward) and fused_readout_bwd.cu (backward)
// share; the chain readout (readout_chain.cu, readout_chain_bwd.cu) takes
// its constants, softmax and the backwards' batch sums.  Per hop i, with dec the hop's f32 input query [D]:
//   q    = relu(dec_c Wq_i + bq_i)              dec_c = dec rounded to T
//   K    = relu(mem Wk_i + bk_i), V = relu(mem Wv_i + bv_i), rounded to T
//   u    = dec_c Wt_i                           (f32, not rounded)
//   tqk  = tanh(u . mem_l)                      (mem read in f32)
//   gate = wo1_i,l tanh(logdt_l w1_i,l + b1_i,l) + wo2_i,l tqk_l + bo_i,l
//   s_l  = (q . K_l) sigmoid(gate_l) scale      for l < key_len, else -2^32+1
//   w    = softmax(s);  o = (sum_l w_l V_l) qmask
//   dec' = LN_i(o + dec)                        (mean/var over D, eps 1e-8)
// Keys stream through shared memory kChunk at a time: K only for the live
// keys (a masked key's score is the fill), V only for the keys the weights
// reach (the live ones, or all L of a row with none live, whose softmax is
// uniform as in the jnp reference).  Every product sums in f32.
#pragma once

#include "common.cuh"

namespace readout {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                       // keys per shared-memory chunk
constexpr int kRowsPerWarp = kChunk / kWarps;    // chunk rows one warp owns
constexpr int kMaxD = 128;                       // 4 columns of 32 per lane
constexpr float kNegFill = -4294967295.0f;       // -(2^32) + 1
constexpr float kLnEps = 1e-8f;                  // normalize()'s epsilon

// One launch's operands (device pointers, contiguous).  T-typed: mem, dec,
// the [n,D,D] weights, the [n,D] biases and LN params; f32: logdt [B,L],
// qmask [B] and the five [n,L] gate rows; key_len [B] int32.  dl is the
// live width: the operands may be zero-padded from dl to D lanes, and the
// gemm designs' chains then average each layer norm over the dl live
// lanes and keep the padded ones 0 (the rows design takes dl == D).
struct Params {
  const void *mem, *dec;
  const float* logdt;
  const int* key_len;
  const float* qmask;
  const void *wq, *bq, *wk, *bk, *wv, *bv, *wt;
  const float *w1, *b1, *wo1, *wo2, *bo;
  const void *lng, *lnb;
  int B, L, D, n, dl;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* ptr(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// keys [0, live) are unmasked; the weights reach [0, span)
__device__ __forceinline__ int live_keys(const Params& p, int b) {
  return max(0, min(p.key_len[b], p.L));
}
__device__ __forceinline__ int span_keys(int live, int L) {
  return live > 0 ? live : L;
}

template <typename T>
__device__ __forceinline__ void load_f32(float* dst, const T* src, int n) {
  for (int t = threadIdx.x; t < n; t += kThreads) dst[t] = port::to_float(src[t]);
}

// dst[c * D + r] = src[r * D + c]: a [D, D] matrix transposed into f32
template <typename T>
__device__ __forceinline__ void load_f32_transposed(float* dst, const T* src,
                                                    int D) {
  for (int t = threadIdx.x; t < D * D; t += kThreads)
    dst[(t % D) * D + t / D] = port::to_float(src[t]);
}

// acc[r][j] = sum_k a[r0 + r][k] w[k][lane + 32 j] over a chunk of kChunk
// rows (warp `w` owns rows r0 = w * kRowsPerWarp ...), then
// epi(row, col, acc) for the rows < nr and the columns < D.  a and w are
// f32 in shared memory, a row-major [kChunk, D], w [D, D].
template <class Epi>
__device__ __forceinline__ void chunk_product(const float* a, const float* w,
                                              int nr, int D, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRowsPerWarp;
  if (r0 >= nr) return;
  float acc[kRowsPerWarp][4];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  for (int k = 0; k < D; ++k) {
    float wk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      wk[j] = c < D ? w[k * D + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float x = a[(r0 + r) * D + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(x, wk[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      if (r0 + r < nr && c < D) epi(r0 + r, c, acc[r][j]);
    }
}

// out[r][c] = round_T(relu(sum_k m[r][k] w[k][c] + bias[c]))
template <typename T>
__device__ __forceinline__ void project(const float* m, const float* w,
                                        const T* bias, float* out, int nr,
                                        int D) {
  chunk_product(m, w, nr, D, [&](int r, int c, float acc) {
    out[r * D + c] =
        port::round_to<T>(fmaxf(acc + port::to_float(bias[c]), 0.f));
  });
}

// Shared memory of the hop, carved from the dynamic allocation.
struct HopSmem {
  float* w;     // [D, D] Wk, then Wv (f32)
  float* m;     // [kChunk, D] mem chunk (f32)
  float* p;     // [kChunk, D] its projection (rounded to T)
  float* s;     // [L] scores, then softmax weights
  float* dec;   // [D] the hop's input query, replaced by its output
  float* decr;  // [D] dec rounded to T
  float* q;     // [D]
  float* u;     // [D]
};

// q = relu(dec_c Wq_i + bq_i), u = dec_c Wt_i; sm.decr = dec_c.  Ends
// with a barrier.  One thread per column, weights read from global memory.
template <typename T>
__device__ void query_side(const Params& p, int i, const HopSmem& sm) {
  const int D = p.D;
  for (int e = threadIdx.x; e < D; e += kThreads)
    sm.decr[e] = port::round_to<T>(sm.dec[e]);
  __syncthreads();
  const T* wq = ptr<T>(p.wq) + (size_t)i * D * D;
  const T* wt = ptr<T>(p.wt) + (size_t)i * D * D;
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float aq = 0.f, au = 0.f;
    for (int k = 0; k < D; ++k) {
      aq = fmaf(sm.decr[k], port::to_float(wq[(size_t)k * D + e]), aq);
      au = fmaf(sm.decr[k], port::to_float(wt[(size_t)k * D + e]), au);
    }
    sm.q[e] = fmaxf(aq + port::to_float(ptr<T>(p.bq)[i * D + e]), 0.f);
    sm.u[e] = au;
  }
  __syncthreads();
}

struct GateTerms {
  float tqk, decay, sig;
};

// the time gate of key c of row b at hop i, from the f32 raw dot u . mem_c
__device__ __forceinline__ GateTerms gate_terms(const Params& p, int i, int b,
                                                int c, float raw_tqk) {
  const size_t gi = (size_t)i * p.L + c;
  GateTerms g;
  g.tqk = tanhf(raw_tqk);
  g.decay = tanhf(p.logdt[(size_t)b * p.L + c] * p.w1[gi] + p.b1[gi]);
  g.sig = port::sigmoid(p.wo1[gi] * g.decay + p.wo2[gi] * g.tqk + p.bo[gi]);
  return g;
}

// softmax over s[0, L) in place (uniform where every score is the fill)
__device__ __forceinline__ void softmax_inplace(float* s, int L, float* red) {
  float m = -INFINITY;
  for (int c = threadIdx.x; c < L; c += kThreads) m = fmaxf(m, s[c]);
  m = port::block_max<kThreads>(m, red);
  float sum = 0.f;
  for (int c = threadIdx.x; c < L; c += kThreads) {
    const float e = expf(s[c] - m);
    s[c] = e;
    sum += e;
  }
  const float denom = port::block_sum<kThreads>(sum, red);
  for (int c = threadIdx.x; c < L; c += kThreads) s[c] = s[c] / denom;
  __syncthreads();
}

// One forward hop for row b: sm.dec (the hop's input) becomes its output.
// Where k_out / v_out are given (the backward's replay), the rounded K of
// the live keys and V of the reached keys are written there ([L, D] of
// row b).  Ends with a barrier.
template <typename T>
__device__ void hop_forward(const Params& p, int i, int b, const HopSmem& sm,
                            float* red, T* k_out, T* v_out) {
  const int D = p.D, L = p.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = live_keys(p, b), span = span_keys(live, L);
  const T* mem = ptr<T>(p.mem) + (size_t)b * L * D;
  const size_t wo = (size_t)i * D * D;

  query_side<T>(p, i, sm);
  load_f32(sm.w, ptr<T>(p.wk) + wo, D * D);
  // pass 1: the live keys' scores, K chunk by chunk
  for (int c0 = 0; c0 < live; c0 += kChunk) {
    const int nr = min(kChunk, live - c0);
    load_f32(sm.m, mem + (size_t)c0 * D, nr * D);
    __syncthreads();
    project<T>(sm.m, sm.w, ptr<T>(p.bk) + i * D, sm.p, nr, D);
    __syncthreads();
    if (k_out)
      for (int t = tid; t < nr * D; t += kThreads)
        k_out[(size_t)c0 * D + t] = from_float<T>(sm.p[t]);
    for (int r = warp; r < nr; r += kWarps) {
      float a = 0.f, t = 0.f;
      for (int e = lane; e < D; e += 32) {
        a = fmaf(sm.q[e], sm.p[r * D + e], a);
        t = fmaf(sm.u[e], sm.m[r * D + e], t);
      }
      a = port::warp_sum(a);
      t = port::warp_sum(t);
      if (lane == 0) {
        const GateTerms g = gate_terms(p, i, b, c0 + r, t);
        sm.s[c0 + r] = a * g.sig * p.scale;
      }
    }
    __syncthreads();
  }
  for (int c = live + tid; c < L; c += kThreads) sm.s[c] = kNegFill;
  __syncthreads();
  softmax_inplace(sm.s, L, red);

  // pass 2: o = sum_c w_c V_c over the reached keys (one thread a column)
  load_f32(sm.w, ptr<T>(p.wv) + wo, D * D);
  float o = 0.f;
  for (int c0 = 0; c0 < span; c0 += kChunk) {
    const int nr = min(kChunk, span - c0);
    load_f32(sm.m, mem + (size_t)c0 * D, nr * D);
    __syncthreads();
    project<T>(sm.m, sm.w, ptr<T>(p.bv) + i * D, sm.p, nr, D);
    __syncthreads();
    if (v_out)
      for (int t = tid; t < nr * D; t += kThreads)
        v_out[(size_t)c0 * D + t] = from_float<T>(sm.p[t]);
    if (tid < D)
      for (int r = 0; r < nr; ++r) o = fmaf(sm.s[c0 + r], sm.p[r * D + tid], o);
    __syncthreads();
  }

  // residual + normalize (the query mask touches o only)
  const float x = tid < D ? o * p.qmask[b] + sm.dec[tid] : 0.f;
  const float mean = port::block_sum<kThreads>(x, red) / D;
  const float dx = tid < D ? x - mean : 0.f;
  const float var = port::block_sum<kThreads>(dx * dx, red) / D;
  const float inv = 1.f / sqrtf(var + kLnEps);
  if (tid < D)
    sm.dec[tid] = dx * inv * port::to_float(ptr<T>(p.lng)[i * D + tid]) +
                  port::to_float(ptr<T>(p.lnb)[i * D + tid]);
  __syncthreads();
}

// The backward kernels' batch sums, one thread per output element, each
// over the rows in order (no atomics: the same inputs give the same
// bits): out[i*X + x] = sum_{r < rows} src[i*si + r*sr + x], or with src2
// (an outer product, x = k*D + e) sum_r src[i*si + r*sr + k] src2[... + e].
struct Job {
  const float* src;
  const float* src2;
  float* out;
  long long si, sr;
  int I, rows, X, D;
};
template <int N>
struct Jobs {
  Job job[N];
};

template <int N>
__global__ void batch_sum_kernel(Jobs<N> jobs) {
  const Job j = jobs.job[blockIdx.y];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)j.I * j.X) return;
  const int i = (int)(idx / j.X), x = (int)(idx % j.X);
  const float* s = j.src + i * j.si;
  float acc = 0.f;
  if (j.src2 == nullptr) {
    for (int r = 0; r < j.rows; ++r) acc += s[r * j.sr + x];
  } else {
    const float* s2 = j.src2 + i * j.si;
    const int k = x / j.D, e = x % j.D;
    for (int r = 0; r < j.rows; ++r)
      acc = fmaf(s[r * j.sr + k], s2[r * j.sr + e], acc);
  }
  j.out[idx] = acc;
}

// Launches the first nj jobs (one grid row each); returns its cudaError_t.
template <int N>
cudaError_t batch_sums(const Jobs<N>& jobs, int nj, cudaStream_t stream) {
  long long most = 0;
  for (int k = 0; k < nj; ++k) {
    const long long e = (long long)jobs.job[k].I * jobs.job[k].X;
    most = e > most ? e : most;
  }
  batch_sum_kernel<N><<<dim3((unsigned)((most + 255) / 256), nj), 256, 0,
                        stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace readout
