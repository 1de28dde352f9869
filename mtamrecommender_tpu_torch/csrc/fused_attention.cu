// Fused attention middle: scores -> time gate / interval bias -> key mask
// -> softmax -> (dropout) -> weighted sum of values, forward, single tile.
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py, _attn_kernel
// (launched by _fused_attention_fwd, the forward of fused_attention), in
// all five of its modes: plain, time, tisas, plain_drop and tisas_drop.
// The backward is fused_attention_bwd.cu.  Per (batch row b, query row i),
// with d = q's last dim:
//   s_c   = q_i . k_c
//   time:  logdt = log1p|t_q[i] - t_k[c]|
//          gate  = wo1[i,c]*tanh(logdt*w1[i,c] + b1[i,c])
//                  + wo2[i,c]*tanh(tqw_i . rawk_c) + bo[i,c]
//          s_c   = s_c * sigmoid(gate) / sqrt(d)
//   tisas: s_c   = (s_c + logdt) / sqrt(d)
//   plain: s_c   = s_c / sqrt(d)
//   s_c = -2^32+1 for c >= key_len[b]; w = softmax(s); out_i = sum_c w_c v_c
//   *_drop: w_c *= dm[b,i,c] (a pre-drawn f32 mask, 0 or 1/keep) in f32
//          after the softmax, as in the plain / tisas modes otherwise.
// Products take the operand type (f32 or bf16) and sum in f32; the weights
// are rounded to v's type before the weighted sum, as the Pallas kernel
// does; the output is f32.  A row whose keys are all masked gets a uniform
// softmax over its Tk keys.  (The Pallas kernel pads Tk to a multiple of
// 128 first, so for such a row it spreads the weight over the padded
// columns too; the port follows the unpadded reference instead.)
//
// What bounds it: bytes.  At the serving shapes (Tq=1, Tk=50, d=128) a
// block reads ~77 KB of k, v and rawk (f32) and does ~26 KFLOP, so the
// card's 3.35 TB/s sets the pace: ~6 us for B=256 in f32.
//
// This is the wrapper's "query" design (`attention_fwd_design`): MTAM's
// Tq = 1 hops, and every shape the "tile" design (fused_attention_tile.cu,
// a block a batch row, 2 <= Tq <= 64, Tk <= 64) does not take.
//
// Design: one block of 128 threads per (b, i).  Each warp takes four keys
// at a time and reads their k and rawk rows with coalesced loads,
// lane-strided over d, all in flight together, then sums with shuffles;
// masked keys are never read.  Scores live in shared memory (Tk <= 1024
// floats), the softmax is a block max and sum with accurate expf, and the
// weighted sum walks the live keys with one thread per output column, so
// v is read coalesced once.

#include "common.cuh"

namespace {

// the Python wrapper's MODES order
enum { ATT_PLAIN = 0, ATT_TIME = 1, ATT_TISAS = 2, ATT_PLAIN_DROP = 3,
       ATT_TISAS_DROP = 4 };
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 4;  // keys a warp scores at once
constexpr float kNegFill = -4294967295.0f;  // -(2^32) + 1

// MODE is the base mode (plain, time or tisas); DROP applies dm.
template <typename T, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads) fused_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ t_q, const T* __restrict__ t_k,
    const T* __restrict__ tqw, const T* __restrict__ rawk,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ wo1, const T* __restrict__ wo2,
    const T* __restrict__ bo, const int* __restrict__ key_len,
    const float* __restrict__ dm, float* __restrict__ out, int Tq, int Tk,
    int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;          // [D]
  float* s_tqw = s_q + D;     // [D]
  float* s_p = s_tqw + D;     // [Tk] scores, then weights
  __shared__ float s_red[kWarps];

  const int row = blockIdx.x;  // b * Tq + i
  const int b = row / Tq, i = row % Tq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < D; e += kThreads) {
    s_q[e] = port::to_float(q[(size_t)row * D + e]);
    if (MODE == ATT_TIME) s_tqw[e] = port::to_float(tqw[(size_t)row * D + e]);
  }
  const int live = max(0, min(key_len[b], Tk));  // keys with c < key_len
  const float tq = MODE == ATT_PLAIN ? 0.f : port::to_float(t_q[row]);
  const T* kb = k + (size_t)b * Tk * D;
  const T* rkb = rawk + (size_t)b * Tk * D;
  __syncthreads();

  // each warp takes kKeys keys at a time, so their loads are in flight
  // together instead of one key's latency after another's
  for (int c0 = warp * kKeys; c0 < Tk; c0 += kWarps * kKeys) {
    float acc[kKeys], acc_t[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) acc[u] = acc_t[u] = 0.f;
#pragma unroll 4
    for (int e = lane; e < D; e += 32) {
      const float qe = s_q[e];
      const float te = MODE == ATT_TIME ? s_tqw[e] : 0.f;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int c = c0 + u;
        if (c < live) {
          acc[u] = fmaf(qe, port::to_float(kb[(size_t)c * D + e]), acc[u]);
          if (MODE == ATT_TIME)
            acc_t[u] = fmaf(te, port::to_float(rkb[(size_t)c * D + e]), acc_t[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int c = c0 + u;
      if (c >= Tk) break;
      float s = kNegFill;
      if (c < live) {
        const float qk = port::warp_sum(acc[u]);
        if (MODE == ATT_TIME) {
          const float tqk = port::warp_sum(acc_t[u]);
          const int g = i * Tk + c;
          const float logdt =
              log1pf(fabsf(tq - port::to_float(t_k[(size_t)b * Tk + c])));
          const float decay =
              tanhf(logdt * port::to_float(w1[g]) + port::to_float(b1[g]));
          const float gate = port::to_float(wo1[g]) * decay +
                             port::to_float(wo2[g]) * tanhf(tqk) +
                             port::to_float(bo[g]);
          s = qk * port::sigmoid(gate) * scale;
        } else if (MODE == ATT_TISAS) {
          const float logdt =
              log1pf(fabsf(tq - port::to_float(t_k[(size_t)b * Tk + c])));
          s = (qk + logdt) * scale;
        } else {
          s = qk * scale;
        }
      }
      if (lane == 0) s_p[c] = s;
    }
  }
  __syncthreads();

  float m = -INFINITY;
  for (int c = tid; c < Tk; c += kThreads) m = fmaxf(m, s_p[c]);
  m = port::block_max<kThreads>(m, s_red);
  float sum = 0.f;
  for (int c = tid; c < Tk; c += kThreads) {
    const float e = expf(s_p[c] - m);
    s_p[c] = e;
    sum += e;
  }
  const float denom = port::block_sum<kThreads>(sum, s_red);
  for (int c = tid; c < Tk; c += kThreads) {
    float w = s_p[c] / denom;
    if (DROP) w *= dm[(size_t)row * Tk + c];
    s_p[c] = port::round_to<T>(w);
  }
  __syncthreads();

  // with a live key the masked weights are exactly 0, so only live keys
  // are summed; with none, all Tk keys carry weight 1/Tk
  const int n_sum = live > 0 ? live : Tk;
  const T* vb = v + (size_t)b * Tk * D;
  for (int e = tid; e < D; e += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < n_sum; ++c)
      acc = fmaf(s_p[c], port::to_float(vb[(size_t)c * D + e]), acc);
    out[(size_t)row * D + e] = acc;
  }
}

template <typename T, int MODE, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* t_q, const void* t_k, const void* tqw,
                   const void* rawk, const void* w1, const void* b1,
                   const void* wo1, const void* wo2, const void* bo,
                   const int* key_len, const float* dm, float* out, int B,
                   int Tq, int Tk, int D, float scale, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)D + Tk) * sizeof(float);
  fused_attention_kernel<T, MODE, DROP><<<B * Tq, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(t_q),
      static_cast<const T*>(t_k), static_cast<const T*>(tqw),
      static_cast<const T*>(rawk), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(wo1),
      static_cast<const T*>(wo2), static_cast<const T*>(bo), key_len, dm, out,
      Tq, Tk, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const void* q, const void* k, const void* v,
                        const void* t_q, const void* t_k, const void* tqw,
                        const void* rawk, const void* w1, const void* b1,
                        const void* wo1, const void* wo2, const void* bo,
                        const int* key_len, const float* dm, float* out, int B,
                        int Tq, int Tk, int D, float scale,
                        cudaStream_t stream) {
#define PORT_ATT_LAUNCH(BASE, DROP)                                          \
  launch<T, BASE, DROP>(q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1, wo2, bo, \
                        key_len, dm, out, B, Tq, Tk, D, scale, stream)
  switch (mode) {
    case ATT_PLAIN: return PORT_ATT_LAUNCH(ATT_PLAIN, false);
    case ATT_TIME: return PORT_ATT_LAUNCH(ATT_TIME, false);
    case ATT_TISAS: return PORT_ATT_LAUNCH(ATT_TISAS, false);
    case ATT_PLAIN_DROP: return PORT_ATT_LAUNCH(ATT_PLAIN, true);
    case ATT_TISAS_DROP: return PORT_ATT_LAUNCH(ATT_TISAS, true);
    default: return cudaErrorInvalidValue;
  }
#undef PORT_ATT_LAUNCH
}

}  // namespace

// All pointers are device pointers to contiguous arrays:
// q/tqw [B,Tq,D], k/v/rawk [B,Tk,D], t_q [B,Tq], t_k [B,Tk],
// w1/b1/wo1/wo2/bo [Tq,Tk], key_len [B] int32, dm [B,Tq,Tk] f32 (read by
// the '*_drop' modes only), out [B,Tq,D] f32.
// The floating inputs but dm are all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1); operands a mode does not read may be any pointer.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_attention_launch(
    int mode, int is_bf16, const void* q, const void* k, const void* v,
    const void* t_q, const void* t_k, const void* tqw, const void* rawk,
    const void* w1, const void* b1, const void* wo1, const void* wo2,
    const void* bo, const void* key_len, const void* dm, void* out, int B,
    int Tq, int Tk, int D, float scale, int device, void* stream) {
  if (B <= 0 || Tq <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* kl = static_cast<const int*>(key_len);
  const float* m = static_cast<const float*>(dm);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mode<__nv_bfloat16>(mode, q, k, v, t_q, t_k, tqw, rawk, w1,
                                      b1, wo1, wo2, bo, kl, m, o, B, Tq, Tk,
                                      D, scale, s);
  return launch_mode<float>(mode, q, k, v, t_q, t_k, tqw, rawk, w1, b1, wo1,
                            wo2, bo, kl, m, o, B, Tq, Tk, D, scale, s);
}
