// Backward of MTAM's sequential-chain readout (readout_chain.cu).
//
// Replaces: mtamrecommender_tpu/ops/pallas/readout_chain_kernel.py,
// _chain_bwd_kernel, launched by _chain_bwd_impl (the backward of
// readout_chain's custom_vjp).  Given the cotangent g [B,D] of the last
// hop's output it returns, per row, ddec [B,D] and dk, dv, dt [n,B,L,D],
// dgp [n,B,L] in T, and, summed over the batch in f32, dwo2 [n,L], dwq
// [n,D,D], dbq, dlng, dlnb [n,D].  Per hop i, from the last back, with
// the hop recomputed from its input cur = curs[i] (q, s0, tqk, sig, the
// softmax weights w, xh and inv as in the forward):
//   dlng += g xh, dlnb += g;  dxh = g lng
//   dx = (dxh - mean(dxh) - xh mean(dxh xh)) inv;  do = dx qz;  dcur = dx
//   dw_l = do . V_l;  dv_l = w_l do
//   ds = w (dw - sum_l dw_l w_l), 0 at masked keys (the jnp reference)
//   dgate = ds s0 scale sig (1-sig);  ds0 = ds sig scale;  dgp = dgate
//   dwo2 += dgate tqk;  dpre = dgate wo2 (1 - tqk^2);  dt_l = dpre_l cur
//   dcur += sum_l dpre_l tprec_l
//   dq = sum_l ds0_l K_l;  dk_l = ds0_l q
//   dq_pre = (q > 0 ? dq : 0) rounded to T
//   dcur += dq_pre Wq^T;  dwq += cur_c^T dq_pre;  dbq += dq_pre
// where cur_c is cur rounded to T; every product sums in f32.
//
// What bounds it: bytes.  It reads K, V and tprec again and writes as
// many elements of their cotangents: at B=256, L=50, D=128, 3 hops about
// 59 MB in bf16, for a few times the forward's ~55 MFLOP.
//
// Design (two kernels, no atomics, so the same inputs give the same bits):
//  1. rows: one block of 256 threads per batch row, the reversed hop loop
//     inside it, every [L] and [D] vector of the hop in shared memory.
//     The scores and dw take a warp per live key; the [L,D] cotangents
//     are written by all threads, element by element, coalesced; dcur's
//     and dq's sums over keys take a thread per column; dq_pre Wq^T a warp
//     per row of Wq.  The per-row terms of the batch sums (cur_c, the
//     rounded dq_pre, g xh, g and dgate tqk) go to an f32 workspace.
//  2. reduce: each batch sum over the rows in order, one thread per
//     output element; dwq[i][k][e] = sum_b cur_c[i,b,k] dq_pre[i,b,e].

#include "readout_hop.cuh"

namespace {

using readout::from_float;
using readout::kMaxD;
using readout::kThreads;
using readout::kWarps;

constexpr int kMaxL = 256;
// per-row f32 vectors [kVecs, n, B, D] of the workspace, then dgate tqk
// [n, B, L]
enum { V_CURR = 0, V_DQ, V_GXH, V_G, kVecs };

struct Args {
  const void *g, *k, *v, *t, *gp, *wo2, *wq, *bq, *lng, *lnb;
  const int* klen;
  const float *qz, *curs;
  void *ddec, *dk, *dv, *dt, *dgp;
  float *vec, *dgt;   // the workspace
  int B, L, D, n;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* p, size_t off) {
  return static_cast<const T*>(p) + off;
}

template <typename T>
__device__ __forceinline__ T* out_at(void* p, size_t off) {
  return static_cast<T*>(p) + off;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chain_bwd_rows_kernel(Args a) {
  __shared__ float cur[kMaxD], curr[kMaxD], q[kMaxD], dcur[kMaxD],
      dov[kMaxD], dqp[kMaxD];
  __shared__ float s0v[kMaxL], tqkv[kMaxL], sigv[kMaxL], w[kMaxL],
      dpre[kMaxL], ds0v[kMaxL];
  __shared__ float red[kWarps];
  const int D = a.D, L = a.L, B = a.B, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = max(0, min(a.klen[b], L));
  const int span = live > 0 ? live : L;
  const float qz = a.qz[b];
  const size_t nBD = (size_t)a.n * B * D;
  for (int e = tid; e < D; e += kThreads)
    dcur[e] = port::to_float(at<T>(a.g, (size_t)b * D)[e]);
  __syncthreads();
  for (int i = a.n - 1; i >= 0; --i) {
    const size_t hb = (size_t)i * B + b;
    const T* K = at<T>(a.k, hb * L * D);
    const T* V = at<T>(a.v, hb * L * D);
    const T* TP = at<T>(a.t, hb * L * D);
    const T* GP = at<T>(a.gp, hb * L);
    const T* WO2 = at<T>(a.wo2, (size_t)i * L);
    const T* WQ = at<T>(a.wq, (size_t)i * D * D);

    // ---- the hop's forward again, from its input
    for (int e = tid; e < D; e += kThreads) {
      cur[e] = a.curs[hb * D + e];
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
        s0v[l] = s0;
        tqkv[l] = tqk;
        sigv[l] = sig;
        w[l] = s0 * sig * a.scale;
      }
    }
    for (int l = live + tid; l < L; l += kThreads) {
      s0v[l] = tqkv[l] = sigv[l] = 0.f;
      w[l] = readout::kNegFill;
    }
    __syncthreads();
    readout::softmax_inplace(w, L, red);
    float o = 0.f;
    if (tid < D)
      for (int l = 0; l < span; ++l)
        o = fmaf(w[l], port::to_float(V[(size_t)l * D + tid]), o);
    const float x = tid < D ? o * qz + cur[tid] : 0.f;
    const float mean = port::block_sum<kThreads>(x, red) / D;
    const float xc = tid < D ? x - mean : 0.f;
    const float var = port::block_sum<kThreads>(xc * xc, red) / D;
    const float inv = 1.f / sqrtf(var + readout::kLnEps);
    const float xh = xc * inv;

    // ---- layer-norm backward
    const float g = tid < D ? dcur[tid] : 0.f;
    const float dxh =
        tid < D ? g * port::to_float(at<T>(a.lng, (size_t)i * D)[tid]) : 0.f;
    if (tid < D) {
      a.vec[V_GXH * nBD + hb * D + tid] = g * xh;
      a.vec[V_G * nBD + hb * D + tid] = g;
    }
    const float m1 = port::block_sum<kThreads>(dxh, red) / D;
    const float m2 = port::block_sum<kThreads>(dxh * xh, red) / D;
    if (tid < D) {
      const float dx = (dxh - m1 - xh * m2) * inv;
      dov[tid] = dx * qz;
      dcur[tid] = dx;                         // the residual branch
    }
    __syncthreads();

    // ---- the weighted sum and the softmax transpose (live keys)
    for (int l = warp; l < live; l += kWarps) {
      float dw = 0.f;
      for (int e = lane; e < D; e += 32)
        dw = fmaf(dov[e], port::to_float(V[(size_t)l * D + e]), dw);
      dw = port::warp_sum(dw);
      if (lane == 0) dpre[l] = dw;            // dw until the next pass
    }
    __syncthreads();
    float part = 0.f;
    for (int l = tid; l < live; l += kThreads) part += dpre[l] * w[l];
    const float sdw = port::block_sum<kThreads>(part, red);
    for (int l = tid; l < L; l += kThreads) {
      const float ds = l < live ? w[l] * (dpre[l] - sdw) : 0.f;
      const float sig = sigv[l], tqk = tqkv[l];
      const float dgate = ds * s0v[l] * a.scale * sig * (1.f - sig);
      ds0v[l] = ds * sig * a.scale;
      out_at<T>(a.dgp, hb * L)[l] = from_float<T>(dgate);
      a.dgt[hb * L + l] = dgate * tqk;
      dpre[l] = dgate * port::to_float(WO2[l]) * (1.f - tqk * tqk);
    }
    __syncthreads();

    // ---- the [L, D] cotangents, element by element
    T* DK = out_at<T>(a.dk, hb * L * D);
    T* DV = out_at<T>(a.dv, hb * L * D);
    T* DT = out_at<T>(a.dt, hb * L * D);
    for (int idx = tid; idx < L * D; idx += kThreads) {
      const int l = idx / D, e = idx - l * D;
      DV[idx] = from_float<T>(w[l] * dov[e]);
      DT[idx] = from_float<T>(dpre[l] * cur[e]);
      DK[idx] = from_float<T>(ds0v[l] * q[e]);
    }

    // ---- dcur += sum_l dpre_l tprec_l;  dq = sum_l ds0_l K_l
    if (tid < D) {
      float dct = 0.f, aq = 0.f;
      for (int l = 0; l < live; ++l) {
        dct = fmaf(dpre[l], port::to_float(TP[(size_t)l * D + tid]), dct);
        aq = fmaf(ds0v[l], port::to_float(K[(size_t)l * D + tid]), aq);
      }
      dcur[tid] += dct;
      const float dq_pre = port::round_to<T>(q[tid] > 0.f ? aq : 0.f);
      dqp[tid] = dq_pre;
      a.vec[V_DQ * nBD + hb * D + tid] = dq_pre;
      a.vec[V_CURR * nBD + hb * D + tid] = curr[tid];
    }
    __syncthreads();
    // ---- dcur += dq_pre Wq^T, a warp per row of Wq
    for (int e = warp; e < D; e += kWarps) {
      float acc = 0.f;
      for (int k = lane; k < D; k += 32)
        acc = fmaf(dqp[k], port::to_float(WQ[(size_t)e * D + k]), acc);
      acc = port::warp_sum(acc);
      if (lane == 0) dcur[e] += acc;
    }
    __syncthreads();
  }
  T* ddec = out_at<T>(a.ddec, (size_t)b * D);
  for (int e = tid; e < D; e += kThreads) ddec[e] = from_float<T>(dcur[e]);
}

constexpr int kJobs = 5;   // batch sums of the reduce pass

size_t vec_floats(int B, int D, int n) {
  return (size_t)kVecs * n * B * D;
}

}  // namespace

// Workspace bytes the launch needs.
extern "C" long long readout_chain_bwd_workspace_bytes(int B, int L, int D,
                                                       int n) {
  return (long long)(vec_floats(B, D, n) + (size_t)n * B * L) *
         (long long)sizeof(float);
}

// All pointers are device pointers to contiguous arrays.  g [B,D]; the
// forward's inputs after dec as in readout_chain_launch; curs [n,B,D] f32;
// the outputs ddec [B,D], dk/dv/dt [n,B,L,D], dgp [n,B,L] in the inputs'
// type (f32 with is_bf16 = 0, bf16 with 1), dwo2 [n,L], dwq [n,D,D],
// dbq/dlng/dlnb [n,D] f32; ws the workspace of
// readout_chain_bwd_workspace_bytes.  Returns the first cudaError_t of
// the launches (0 on success).
extern "C" int readout_chain_bwd_launch(
    int is_bf16, const void* g, const void* klen, const void* qz,
    const void* k, const void* v, const void* t, const void* gp,
    const void* wo2, const void* wq, const void* bq, const void* lng,
    const void* lnb, const void* curs, void* ddec, void* dk, void* dv,
    void* dt, void* dgp, void* dwo2, void* dwq, void* dbq, void* dlng,
    void* dlnb, void* ws, int B, int L, int D, int n, float scale,
    int device, void* stream) {
  if (B < 0 || L <= 0 || L > kMaxL || D <= 0 || D > kMaxD || n <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
  a.g = g; a.k = k; a.v = v; a.t = t; a.gp = gp; a.wo2 = wo2;
  a.wq = wq; a.bq = bq; a.lng = lng; a.lnb = lnb;
  a.klen = static_cast<const int*>(klen);
  a.qz = static_cast<const float*>(qz);
  a.curs = static_cast<const float*>(curs);
  a.ddec = ddec; a.dk = dk; a.dv = dv; a.dt = dt; a.dgp = dgp;
  a.vec = static_cast<float*>(ws);
  a.dgt = a.vec + vec_floats(B, D, n);
  a.B = B; a.L = L; a.D = D; a.n = n;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    if (is_bf16)
      chain_bwd_rows_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(a);
    else
      chain_bwd_rows_kernel<float><<<B, kThreads, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long nBD = (long long)n * B * D, BD = (long long)B * D;
  const float* vec = a.vec;
  readout::Jobs<kJobs> jobs;
  jobs.job[0] = {a.dgt, nullptr, static_cast<float*>(dwo2), (long long)B * L,
                 L, n, B, L, D};
  jobs.job[1] = {vec + V_DQ * nBD, nullptr, static_cast<float*>(dbq), BD, D,
                 n, B, D, D};
  jobs.job[2] = {vec + V_GXH * nBD, nullptr, static_cast<float*>(dlng), BD, D,
                 n, B, D, D};
  jobs.job[3] = {vec + V_G * nBD, nullptr, static_cast<float*>(dlnb), BD, D,
                 n, B, D, D};
  jobs.job[4] = {vec + V_CURR * nBD, vec + V_DQ * nBD,
                 static_cast<float*>(dwq), BD, D, n, B, D * D, D};
  return readout::batch_sums(jobs, kJobs, s);
}
