// MTAM's sequential-chain readout, forward: the n Tq=1 time-attention
// hops of one batch row over precomputed keys, in one launch.
//
// Replaces: mtamrecommender_tpu/ops/pallas/readout_chain_kernel.py,
// _chain_fwd_kernel (body _hop_fwd), launched by _chain_fwd.  Per hop i,
// with cur the hop's f32 input query [D]:
//   q    = relu(cur_c Wq_i + bq_i)          cur_c = cur rounded to T
//   s0_l = q . K_i,l;  tqk_l = tanh(cur . tprec_i,l)      (f32 sums)
//   gate = gate_part_i,l + wo2_i,l tqk_l
//   s_l  = s0_l sigmoid(gate) scale         for l < key_len, else -2^32+1
//   cur  = LN_i(softmax(s) V_i qz + cur)    (mean/var over D, eps 1e-8)
// K, V, tprec [n,B,L,D] and gate_part [n,B,L] are inputs (the hop-batched
// projections stay outside the kernel); they and the weights are read in
// T and widened to f32.  Writes out [B,D] in T and the hop-input chain
// curs [n,B,D] f32, which the backward (readout_chain_bwd.cu) replays.
//
// What bounds it: bytes.  Per row and hop it reads L rows of K, V and
// tprec and does ~6 L D FLOPs on them, plus 2 D^2 for q: at B=256, L=50,
// D=128, 3 hops, 29.5 MB (bf16) for ~55 MFLOP.
//
// Design: one block of 256 threads per row, since each hop needs the
// whole row's softmax before the next hop's query exists; the hop loop
// runs inside the block with cur in shared memory.  q: one thread per
// column, Wq read coalesced from global memory.  Scores: one warp per live
// key, both dot products from one pass over the key's K and tprec rows.
// Softmax over L <= 256 in shared memory (readout_hop.cuh).  o: one thread
// per column over the keys the weights reach (the live ones, all L in a
// row with none live).  No atomics: the same inputs give the same bits.

#include "readout_hop.cuh"

namespace {

using readout::from_float;
using readout::kMaxD;
using readout::kThreads;
using readout::kWarps;

constexpr int kMaxL = 256;

struct Args {
  const void *dec, *k, *v, *t, *gp, *wo2, *wq, *bq, *lng, *lnb;
  const int* klen;
  const float* qz;
  void* out;
  float* curs;
  int B, L, D, n;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* p, size_t off) {
  return static_cast<const T*>(p) + off;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) readout_chain_kernel(Args a) {
  __shared__ float cur[kMaxD], curr[kMaxD], q[kMaxD], s[kMaxL];
  __shared__ float red[kWarps];
  const int D = a.D, L = a.L, B = a.B, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = max(0, min(a.klen[b], L));
  const int span = live > 0 ? live : L;
  const float qz = a.qz[b];
  for (int e = tid; e < D; e += kThreads)
    cur[e] = port::to_float(at<T>(a.dec, (size_t)b * D)[e]);
  __syncthreads();
  for (int i = 0; i < a.n; ++i) {
    const size_t hb = (size_t)i * B + b;
    const T* K = at<T>(a.k, hb * L * D);
    const T* V = at<T>(a.v, hb * L * D);
    const T* TP = at<T>(a.t, hb * L * D);
    const T* GP = at<T>(a.gp, hb * L);
    const T* WO2 = at<T>(a.wo2, (size_t)i * L);
    const T* WQ = at<T>(a.wq, (size_t)i * D * D);
    for (int e = tid; e < D; e += kThreads) {
      a.curs[hb * D + e] = cur[e];
      curr[e] = port::round_to<T>(cur[e]);
    }
    __syncthreads();
    for (int e = tid; e < D; e += kThreads) {
      float acc = 0.f;
      for (int k = 0; k < D; ++k)
        acc = fmaf(curr[k], port::to_float(WQ[(size_t)k * D + e]), acc);
      q[e] = fmaxf(acc + port::to_float(at<T>(a.bq, (size_t)i * D)[e]), 0.f);
    }
    __syncthreads();
    for (int l = warp; l < live; l += kWarps) {
      float s0 = 0.f, tp = 0.f;
      for (int e = lane; e < D; e += 32) {
        s0 = fmaf(q[e], port::to_float(K[(size_t)l * D + e]), s0);
        tp = fmaf(cur[e], port::to_float(TP[(size_t)l * D + e]), tp);
      }
      s0 = port::warp_sum(s0);
      tp = port::warp_sum(tp);
      if (lane == 0) {
        const float tqk = tanhf(tp);
        const float sig = port::sigmoid(port::to_float(GP[l]) +
                                        port::to_float(WO2[l]) * tqk);
        s[l] = s0 * sig * a.scale;
      }
    }
    for (int l = live + tid; l < L; l += kThreads) s[l] = readout::kNegFill;
    __syncthreads();
    readout::softmax_inplace(s, L, red);
    float o = 0.f;
    if (tid < D)
      for (int l = 0; l < span; ++l)
        o = fmaf(s[l], port::to_float(V[(size_t)l * D + tid]), o);
    // residual + normalize (the query mask touches o only)
    const float x = tid < D ? o * qz + cur[tid] : 0.f;
    const float mean = port::block_sum<kThreads>(x, red) / D;
    const float dx = tid < D ? x - mean : 0.f;
    const float var = port::block_sum<kThreads>(dx * dx, red) / D;
    const float inv = 1.f / sqrtf(var + readout::kLnEps);
    if (tid < D)
      cur[tid] = dx * inv * port::to_float(at<T>(a.lng, (size_t)i * D)[tid]) +
                 port::to_float(at<T>(a.lnb, (size_t)i * D)[tid]);
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out) + (size_t)b * D;
  for (int e = tid; e < D; e += kThreads) out[e] = from_float<T>(cur[e]);
}

}  // namespace

// All pointers are device pointers to contiguous arrays: dec [B,1,D], k,
// v, t [n,B,L,D], gp [n,B,L], wo2 [n,L], wq [n,D,D], bq/lng/lnb [n,D] and
// out [B,D], all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); klen [B]
// int32; qz [B] f32; curs [n,B,D] f32.  1 <= L <= 256, 1 <= D <= 128.
// Returns the launch's cudaError_t (0 on success).
extern "C" int readout_chain_launch(
    int is_bf16, const void* dec, const void* klen, const void* qz,
    const void* k, const void* v, const void* t, const void* gp,
    const void* wo2, const void* wq, const void* bq, const void* lng,
    const void* lnb, void* out, void* curs, int B, int L, int D, int n,
    float scale, int device, void* stream) {
  if (B < 0 || L <= 0 || L > kMaxL || D <= 0 || D > kMaxD || n <= 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
  a.dec = dec; a.k = k; a.v = v; a.t = t; a.gp = gp; a.wo2 = wo2;
  a.wq = wq; a.bq = bq; a.lng = lng; a.lnb = lnb;
  a.klen = static_cast<const int*>(klen);
  a.qz = static_cast<const float*>(qz);
  a.out = out;
  a.curs = static_cast<float*>(curs);
  a.B = B; a.L = L; a.D = D; a.n = n;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    readout_chain_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(a);
  else
    readout_chain_kernel<float><<<B, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}
