// Backward of MTAM's fused multi-hop readout (fused_readout.cu).
//
// Replaces: mtamrecommender_tpu/ops/pallas/readout_kernel.py,
// _readout_bwd_kernel, launched by _readout_bwd (the backward of
// fused_readout's custom_vjp).  Given the f32 cotangent g of the last
// hop's output it returns, all f32: dmem [B,L,D], ddec [B,D], dwq, dwk,
// dwv, dwt [n,D,D], dbq, dbk, dbv [n,D], the five gate-row cotangents
// dw1, db1, dwo1, dwo2, dbo [n,L] and dlng, dlnb [n,D]; the parameter
// cotangents are sums over the batch.  Per hop i, from the last back:
//   dlng += g xh, dlnb += g;  dxh = g lng
//   dx  = (dxh - mean(dxh) - xh mean(dxh xh)) inv
//   do  = dx qmask;  ddec_in = dx              (the residual is not masked)
//   dw_l = do . V_l;  ds = w (dw - sum_l dw_l w_l), 0 at masked keys
//   dgate = ds s0 scale sig (1-sig);  ds0 = ds sig scale
//   dpre_dec = dgate wo1 (1-decay^2);  dpre_tqk = dgate wo2 (1-tqk^2)
//   dw1 += dpre_dec logdt, db1 += dpre_dec, dwo1 += dgate decay,
//   dwo2 += dgate tqk, dbo += dgate
//   du = sum_l dpre_tqk_l mem_l;  dmem += dpre_tqk u
//   ddec_in += du_c Wt^T;  dWt += dec_c^T du_c
//   dq = sum_l ds0_l K_l;  dk_l = ds0_l q;  dv_l = w_l do
//   dk_pre, dv_pre, dq_pre: zero where relu's output (K, V, q) is not > 0
//   dmem += dk_pre_c Wk^T + dv_pre_c Wv^T;  ddec_in += dq_pre_c Wq^T
//   dWk += mem^T dk_pre_c, dWv += mem^T dv_pre_c, dWq += dec_c^T dq_pre_c
//   dbk += sum dk_pre, dbv += sum dv_pre, dbq += dq_pre
// where x_c is x rounded to the input type T, as the Pallas kernel's
// .astype(in_dtype) before each product; every product sums in f32.
//
// What bounds it: operations, as the forward's (about three times its
// FLOPs: the replay's projections, dmem's two products, dWk's and dWv's).
//
// Design (three kernels, no float atomics, so the same inputs give the
// same bits):
//  1. rows: one block of 256 threads per batch row.  It replays the
//     forward hops (readout_hop.cuh), keeping each hop's input query in
//     shared memory and writing each hop's rounded K and V to a workspace
//     [2, n, B, L, D] of type T, instead of projecting them again.  Then
//     hop by hop in reverse it recomputes scores, gate and softmax from
//     that K, runs the LN and softmax backward, and streams the keys
//     through shared memory 64 at a time for dmem = dk_pre Wk^T + ... (the
//     transposed weight in shared memory), overwriting K and V in the
//     workspace with dk_pre and dv_pre.  The row owns its dmem rows, which
//     accumulate across hops in the output.  Small per-row terms (the
//     rounded query, dq_pre, du, bias and LN partials, the five gate terms
//     per key) go to f32 workspaces.
//  2. wgrad: dWk and dWv = sum over rows and keys of mem^T dk_pre (dv_pre),
//     a block per (64 x 64 tile, matrix, group of rows); each group's
//     partial is written, not added.
//  3. reduce: every batch sum (the groups' partials, dWq and dWt as sums
//     of outer products, the biases, the gate rows, the LN params) summed
//     over the rows in order, one thread per output element.

#include "readout_hop.cuh"

namespace {

using readout::HopSmem;
using readout::kChunk;
using readout::kThreads;
using readout::kWarps;
using readout::Params;

constexpr int kGroups = 8;     // row groups of the wgrad kernel
constexpr int kTile = 64;      // wgrad output tile (kTile x kTile)
constexpr int kStage = 32;     // keys staged at once by the wgrad kernel
constexpr int kMaxJobs = 16;   // batch sums of the reduce kernel (14 used)
// per-row f32 vectors [kVecs, n, B, D]: the rounded hop input, rounded
// dq_pre, rounded du, then f32 dq_pre, dbk and dbv partials, g xh, g
enum { V_DECR = 0, V_DQR, V_DUR, V_DQ, V_DBK, V_DBV, V_LNG, V_LNB, kVecs };

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

int groups(int B) { return B < kGroups ? B : kGroups; }

struct WsLayout {
  size_t kv, vec, gate, part, total;   // byte offsets
};

WsLayout layout(int B, int L, int D, int n, size_t t_size) {
  WsLayout w;
  w.kv = 0;
  w.vec = align_up(2 * (size_t)n * B * L * D * t_size);
  w.gate = w.vec + align_up((size_t)kVecs * n * B * D * sizeof(float));
  w.part = w.gate + align_up(5 * (size_t)n * B * L * sizeof(float));
  w.total = w.part + align_up((size_t)groups(B) * 2 * n * D * D * sizeof(float));
  return w;
}

size_t rows_smem_floats(int L, int D, int n) {
  return (size_t)D * D + 2 * (size_t)kChunk * D + 8 * (size_t)L +
         (8 + (size_t)n) * D;
}

// One column sum per thread group: thread t takes column t % D of x and
// returns, for t < D, the total over the groups in order.
__device__ __forceinline__ float combine_groups(float x, float* scratch,
                                                int D) {
  scratch[threadIdx.x] = x;
  __syncthreads();
  float r = 0.f;
  if (threadIdx.x < D)
    for (int g = 0; g < kThreads / D; ++g) r += scratch[g * D + threadIdx.x];
  __syncthreads();
  return r;
}

// out[e] = sum_{c < nk} coef[c] X[c, e] for e = threadIdx.x < D (0
// elsewhere); X [nk, D] row-major in global memory, read by all threads.
template <typename T>
__device__ __forceinline__ float weighted_rows(const float* coef, const T* X,
                                               int nk, int D,
                                               float* scratch) {
  const int col = threadIdx.x % D, grp = threadIdx.x / D, G = kThreads / D;
  float acc = 0.f;
#pragma unroll 4
  for (int c = grp; c < nk; c += G)
    acc = fmaf(coef[c], port::to_float(X[(size_t)c * D + col]), acc);
  return combine_groups(acc, scratch, D);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) readout_bwd_rows_kernel(
    Params p, const float* __restrict__ g_in, T* __restrict__ kv,
    float* __restrict__ vec, float* __restrict__ gate_ws,
    float* __restrict__ dmem, float* __restrict__ ddec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  __shared__ float scratch[kThreads];
  const int D = p.D, L = p.L, n = p.n, B = p.B, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  HopSmem sm;
  sm.w = smem;
  sm.m = sm.w + (size_t)D * D;
  sm.p = sm.m + kChunk * D;
  sm.s = sm.p + kChunk * D;        // weights of the hop
  float* s_s0 = sm.s + L;          // q . K_l
  float* s_tqk = s_s0 + L;
  float* s_dcy = s_tqk + L;        // decay
  float* s_sig = s_dcy + L;
  float* s_dw = s_sig + L;         // do . V_l
  float* s_ds0 = s_dw + L;
  float* s_dpt = s_ds0 + L;        // dpre_tqk
  sm.dec = s_dpt + L;
  sm.decr = sm.dec + D;
  sm.q = sm.decr + D;
  sm.u = sm.q + D;
  float* s_g = sm.u + D;           // cotangent of the hop's output
  float* s_do = s_g + D;
  float* s_dur = s_do + D;
  float* s_dqr = s_dur + D;
  float* s_decs = s_dqr + D;       // [n, D] each hop's input query

  const int live = readout::live_keys(p, b);
  const int span = readout::span_keys(live, L);
  const T* mem = readout::ptr<T>(p.mem) + (size_t)b * L * D;
  float* dm = dmem + (size_t)b * L * D;
  const size_t row_kv = (size_t)L * D;
  auto kbuf = [&](int i) { return kv + ((size_t)i * B + b) * row_kv; };
  auto vbuf = [&](int i) { return kv + ((size_t)(n + i) * B + b) * row_kv; };
  auto vslot = [&](int slot, int i) {
    return vec + (((size_t)slot * n + i) * B + b) * D;
  };
  const size_t gplane = (size_t)n * B * L;

  for (int t = tid; t < L * D; t += kThreads) dm[t] = 0.f;

  // ---- forward replay: each hop's input query, its K and V ----
  readout::load_f32(sm.dec, readout::ptr<T>(p.dec) + (size_t)b * D, D);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    for (int e = tid; e < D; e += kThreads) s_decs[i * D + e] = sm.dec[e];
    readout::hop_forward<T>(p, i, b, sm, red, kbuf(i), vbuf(i));
  }
  for (int e = tid; e < D; e += kThreads) s_g[e] = g_in[(size_t)b * D + e];

  // ---- reverse sweep ----
  for (int i = n - 1; i >= 0; --i) {
    T* K = kbuf(i);
    T* V = vbuf(i);
    const size_t wo = (size_t)i * D * D;
    for (int e = tid; e < D; e += kThreads) sm.dec[e] = s_decs[i * D + e];
    __syncthreads();
    readout::query_side<T>(p, i, sm);

    // scores, gate and softmax of the hop, from the replay's K
    for (int c = warp; c < live; c += kWarps) {
      float a = 0.f, t = 0.f;
      for (int e = lane; e < D; e += 32) {
        a = fmaf(sm.q[e], port::to_float(K[(size_t)c * D + e]), a);
        t = fmaf(sm.u[e], port::to_float(mem[(size_t)c * D + e]), t);
      }
      a = port::warp_sum(a);
      t = port::warp_sum(t);
      if (lane == 0) {
        const readout::GateTerms gt = readout::gate_terms(p, i, b, c, t);
        s_s0[c] = a;
        s_tqk[c] = gt.tqk;
        s_dcy[c] = gt.decay;
        s_sig[c] = gt.sig;
        sm.s[c] = a * gt.sig * p.scale;
      }
    }
    for (int c = live + tid; c < L; c += kThreads) {
      sm.s[c] = readout::kNegFill;
      s_s0[c] = s_tqk[c] = s_dcy[c] = s_sig[c] = 0.f;
    }
    __syncthreads();
    readout::softmax_inplace(sm.s, L, red);

    // the hop's output again, then the LN backward (thread e: column e)
    const float o = weighted_rows(sm.s, V, span, D, scratch);
    const float qz = p.qmask[b];
    const float x = tid < D ? o * qz + sm.dec[tid] : 0.f;
    const float mean = port::block_sum<kThreads>(x, red) / D;
    const float xm = tid < D ? x - mean : 0.f;
    const float var = port::block_sum<kThreads>(xm * xm, red) / D;
    const float inv = 1.f / sqrtf(var + readout::kLnEps);
    const float xh = xm * inv;
    const float g = tid < D ? s_g[tid] : 0.f;
    const float gamma =
        tid < D ? port::to_float(readout::ptr<T>(p.lng)[i * D + tid]) : 0.f;
    if (tid < D) {
      vslot(V_LNG, i)[tid] = g * xh;
      vslot(V_LNB, i)[tid] = g;
    }
    const float dxh = g * gamma;
    const float m1 = port::block_sum<kThreads>(dxh, red) / D;
    const float m2 = port::block_sum<kThreads>(dxh * xh, red) / D;
    const float dx = (dxh - m1 - xh * m2) * inv;
    float dd = dx;                 // the residual branch of ddec_in
    if (tid < D) s_do[tid] = dx * qz;
    __syncthreads();

    // weighted-sum and softmax backward
    for (int c = warp; c < span; c += kWarps) {
      float a = 0.f;
      for (int e = lane; e < D; e += 32)
        a = fmaf(s_do[e], port::to_float(V[(size_t)c * D + e]), a);
      a = port::warp_sum(a);
      if (lane == 0) s_dw[c] = a;
    }
    __syncthreads();
    float part = 0.f;
    for (int c = tid; c < span; c += kThreads) part += s_dw[c] * sm.s[c];
    const float dsum = port::block_sum<kThreads>(part, red);
    for (int c = tid; c < L; c += kThreads) {
      const float ds = c < live ? sm.s[c] * (s_dw[c] - dsum) : 0.f;
      const float sig = s_sig[c], dcy = s_dcy[c], tqk = s_tqk[c];
      const float dgate = ds * s_s0[c] * p.scale * sig * (1.f - sig);
      const size_t gi = (size_t)i * L + c;
      const float dpre_dec = dgate * p.wo1[gi] * (1.f - dcy * dcy);
      float* gw = gate_ws + ((size_t)i * B + b) * L + c;
      gw[0] = dpre_dec * p.logdt[(size_t)b * L + c];
      gw[gplane] = dpre_dec;
      gw[2 * gplane] = dgate * dcy;
      gw[3 * gplane] = dgate * tqk;
      gw[4 * gplane] = dgate;
      s_ds0[c] = ds * sig * p.scale;
      s_dpt[c] = dgate * p.wo2[gi] * (1.f - tqk * tqk);
    }
    __syncthreads();

    // du and dq (masked keys carry 0), then the query side of ddec_in
    const float du = weighted_rows(s_dpt, mem, live, D, scratch);
    const float dq = weighted_rows(s_ds0, K, live, D, scratch);
    if (tid < D) {
      const float dq_pre = sm.q[tid] > 0.f ? dq : 0.f;
      s_dqr[tid] = port::round_to<T>(dq_pre);
      s_dur[tid] = port::round_to<T>(du);
      vslot(V_DECR, i)[tid] = sm.decr[tid];
      vslot(V_DQR, i)[tid] = s_dqr[tid];
      vslot(V_DUR, i)[tid] = s_dur[tid];
      vslot(V_DQ, i)[tid] = dq_pre;
    }
    __syncthreads();
    if (tid < D) {
      const T* wt_row = readout::ptr<T>(p.wt) + wo + (size_t)tid * D;
      const T* wq_row = readout::ptr<T>(p.wq) + wo + (size_t)tid * D;
      float at = 0.f, aq = 0.f;
      for (int e = 0; e < D; ++e) {
        at = fmaf(s_dur[e], port::to_float(wt_row[e]), at);
        aq = fmaf(s_dqr[e], port::to_float(wq_row[e]), aq);
      }
      dd += at;
      dd += aq;
    }

    // dk_pre (live keys): dmem += dk_pre_c Wk^T + dpre_tqk u
    readout::load_f32_transposed(sm.w, readout::ptr<T>(p.wk) + wo, D);
    float bsum = 0.f;
    for (int c0 = 0; c0 < live; c0 += kChunk) {
      const int nr = min(kChunk, live - c0);
      for (int t = tid; t < nr * D; t += kThreads) {
        const int r = t / D, e = t % D;
        const size_t at = (size_t)(c0 + r) * D + e;
        const float v = port::to_float(K[at]) > 0.f ? s_ds0[c0 + r] * sm.q[e]
                                                    : 0.f;
        bsum += v;
        const float vr = port::round_to<T>(v);
        sm.m[t] = vr;
        K[at] = readout::from_float<T>(vr);
      }
      __syncthreads();
      readout::chunk_product(sm.m, sm.w, nr, D, [&](int r, int c, float acc) {
        float* dst = dm + (size_t)(c0 + r) * D + c;
        *dst += acc + s_dpt[c0 + r] * sm.u[c];
      });
      __syncthreads();
    }
    bsum = combine_groups(bsum, scratch, D);
    if (tid < D) vslot(V_DBK, i)[tid] = bsum;

    // dv_pre (reached keys): dmem += dv_pre_c Wv^T
    readout::load_f32_transposed(sm.w, readout::ptr<T>(p.wv) + wo, D);
    bsum = 0.f;
    for (int c0 = 0; c0 < span; c0 += kChunk) {
      const int nr = min(kChunk, span - c0);
      for (int t = tid; t < nr * D; t += kThreads) {
        const int r = t / D, e = t % D;
        const size_t at = (size_t)(c0 + r) * D + e;
        const float v = port::to_float(V[at]) > 0.f ? sm.s[c0 + r] * s_do[e]
                                                    : 0.f;
        bsum += v;
        const float vr = port::round_to<T>(v);
        sm.m[t] = vr;
        V[at] = readout::from_float<T>(vr);
      }
      __syncthreads();
      readout::chunk_product(sm.m, sm.w, nr, D, [&](int r, int c, float acc) {
        dm[(size_t)(c0 + r) * D + c] += acc;
      });
      __syncthreads();
    }
    bsum = combine_groups(bsum, scratch, D);
    if (tid < D) {
      vslot(V_DBV, i)[tid] = bsum;
      s_g[tid] = dd;
    }
    __syncthreads();
  }
  for (int e = tid; e < D; e += kThreads) ddec[(size_t)b * D + e] = s_g[e];
}

// part[g, m, i] = sum over the rows of group g and their keys of
// mem[b, l]^T A[m, i, b, l] (m = 0: dk_pre over the live keys, m = 1:
// dv_pre over the reached keys), for one kTile x kTile tile.
template <typename T>
__global__ void __launch_bounds__(256) readout_bwd_wgrad_kernel(
    const T* __restrict__ mem, const int* __restrict__ key_len,
    const T* __restrict__ kv, float* __restrict__ part, int B, int L, int D,
    int n, int G) {
  __shared__ float sx[kStage][kTile];
  __shared__ float sy[kStage][kTile];
  const int tiles = (D + kTile - 1) / kTile;
  const int k0 = (blockIdx.x / tiles) * kTile, e0 = (blockIdx.x % tiles) * kTile;
  const int m = blockIdx.y / n, i = blockIdx.y % n, g = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  const int b_lo = (int)((long long)g * B / G);
  const int b_hi = (int)((long long)(g + 1) * B / G);
  for (int b = b_lo; b < b_hi; ++b) {
    const int live = max(0, min(key_len[b], L));
    const int lim = m == 0 ? live : (live > 0 ? live : L);
    const T* mb = mem + (size_t)b * L * D;
    const T* ab = kv + (((size_t)m * n + i) * B + b) * (size_t)L * D;
    for (int l0 = 0; l0 < lim; l0 += kStage) {
      for (int t = tid; t < kStage * kTile; t += 256) {
        const int r = t / kTile, c = t % kTile, l = l0 + r;
        const bool ok = l < lim;
        sx[r][c] = ok && k0 + c < D ? port::to_float(mb[(size_t)l * D + k0 + c])
                                    : 0.f;
        sy[r][c] = ok && e0 + c < D ? port::to_float(ab[(size_t)l * D + e0 + c])
                                    : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kStage; ++r) {
        float x[4], y[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = sx[r][ty * 4 + a];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = sy[r][tx * 4 + j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(x[a], y[j], acc[a][j]);
      }
      __syncthreads();
    }
  }
  float* out = part + (((size_t)g * 2 + m) * n + i) * D * D;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty * 4 + a, e = e0 + tx * 4 + j;
      if (k < D && e < D) out[(size_t)k * D + e] = acc[a][j];
    }
}

struct Outs {
  float *dmem, *ddec, *dwq, *dbq, *dwk, *dbk, *dwv, *dbv, *dwt;
  float* gates[5];   // dw1, db1, dwo1, dwo2, dbo
  float *dlng, *dlnb;
};

template <typename T>
cudaError_t run(const Params& p, const float* g, const Outs& o, void* ws,
                cudaStream_t stream) {
  const int B = p.B, L = p.L, D = p.D, n = p.n, G = groups(B);
  const WsLayout w = layout(B, L, D, n, sizeof(T));
  char* base = static_cast<char*>(ws);
  T* kv = reinterpret_cast<T*>(base + w.kv);
  float* vec = reinterpret_cast<float*>(base + w.vec);
  float* gate = reinterpret_cast<float*>(base + w.gate);
  float* part = reinterpret_cast<float*>(base + w.part);
  cudaError_t err;
  if (B > 0) {
    const size_t smem = rows_smem_floats(L, D, n) * sizeof(float);
    err = cudaFuncSetAttribute(readout_bwd_rows_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    readout_bwd_rows_kernel<T><<<B, kThreads, smem, stream>>>(
        p, g, kv, vec, gate, o.dmem, o.ddec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int tiles = (D + kTile - 1) / kTile;
    readout_bwd_wgrad_kernel<T><<<dim3(tiles * tiles, 2 * n, G), 256, 0,
                                  stream>>>(
        static_cast<const T*>(p.mem), p.key_len, kv, part, B, L, D, n, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  readout::Jobs<kMaxJobs> jobs;
  int nj = 0;
  const long long nBD = (long long)n * B * D, BD = (long long)B * D;
  auto sum_vec = [&](int slot, float* out) {
    jobs.job[nj++] = {vec + slot * nBD, nullptr, out, BD, D, n, B, D, D};
  };
  auto outer = [&](int slot, float* out) {
    jobs.job[nj++] = {vec + V_DECR * nBD, vec + slot * nBD, out, BD, D,
                      n, B, D * D, D};
  };
  outer(V_DQR, o.dwq);
  outer(V_DUR, o.dwt);
  sum_vec(V_DQ, o.dbq);
  sum_vec(V_DBK, o.dbk);
  sum_vec(V_DBV, o.dbv);
  sum_vec(V_LNG, o.dlng);
  sum_vec(V_LNB, o.dlnb);
  const long long nBL = (long long)n * B * L;
  for (int s = 0; s < 5; ++s)
    jobs.job[nj++] = {gate + s * nBL, nullptr, o.gates[s], (long long)B * L,
                      L, n, B, L, D};
  const long long nDD = (long long)n * D * D;
  // dWk, dWv: the row groups' partials, rows = G (0 when B = 0)
  jobs.job[nj++] = {part, nullptr, o.dwk, 0, 2 * nDD, 1, G, (int)nDD, D};
  jobs.job[nj++] = {part + nDD, nullptr, o.dwv, 0, 2 * nDD, 1, G, (int)nDD, D};
  return readout::batch_sums(jobs, nj, stream);
}

}  // namespace

// Dynamic shared memory of the rows kernel, in bytes.
extern "C" long long fused_readout_bwd_smem_bytes(int L, int D, int n) {
  return (long long)rows_smem_floats(L, D, n) * (long long)sizeof(float);
}

// Workspace bytes the launch needs.
extern "C" long long fused_readout_bwd_workspace_bytes(int B, int L, int D,
                                                       int n, int is_bf16) {
  return (long long)layout(B, L, D, n, is_bf16 ? 2 : 4).total;
}

// All pointers are device pointers to contiguous arrays.  g [B,D] f32; the
// forward's inputs as in fused_readout_launch; the f32 outputs dmem
// [B,L,D], ddec [B,D], dwq/dwk/dwv/dwt [n,D,D], dbq/dbk/dbv/dlng/dlnb
// [n,D], dw1/db1/dwo1/dwo2/dbo [n,L]; ws the workspace of
// fused_readout_bwd_workspace_bytes.  Returns the first cudaError_t of the
// launches (0 on success).
extern "C" int fused_readout_bwd_launch(
    int is_bf16, const void* g, const void* mem, const void* dec,
    const void* logdt, const void* key_len, const void* qmask, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* wt, const void* w1, const void* b1,
    const void* wo1, const void* wo2, const void* bo, const void* lng,
    const void* lnb, void* dmem, void* ddec, void* dwq, void* dbq, void* dwk,
    void* dbk, void* dwv, void* dbv, void* dwt, void* dw1, void* db1,
    void* dwo1, void* dwo2, void* dbo, void* dlng, void* dlnb, void* ws,
    int B, int L, int D, int n, float scale, int device, void* stream) {
  if (B < 0 || L <= 0 || n <= 0 || D <= 0 || D > readout::kMaxD || D % 32)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  p.mem = mem; p.dec = dec;
  p.logdt = static_cast<const float*>(logdt);
  p.key_len = static_cast<const int*>(key_len);
  p.qmask = static_cast<const float*>(qmask);
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk; p.wv = wv; p.bv = bv; p.wt = wt;
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.wo1 = static_cast<const float*>(wo1);
  p.wo2 = static_cast<const float*>(wo2);
  p.bo = static_cast<const float*>(bo);
  p.lng = lng; p.lnb = lnb;
  p.B = B; p.L = L; p.D = D; p.n = n;
  p.scale = scale;
  Outs o;
  o.dmem = static_cast<float*>(dmem);
  o.ddec = static_cast<float*>(ddec);
  o.dwq = static_cast<float*>(dwq);
  o.dbq = static_cast<float*>(dbq);
  o.dwk = static_cast<float*>(dwk);
  o.dbk = static_cast<float*>(dbk);
  o.dwv = static_cast<float*>(dwv);
  o.dbv = static_cast<float*>(dbv);
  o.dwt = static_cast<float*>(dwt);
  o.gates[0] = static_cast<float*>(dw1);
  o.gates[1] = static_cast<float*>(db1);
  o.gates[2] = static_cast<float*>(dwo1);
  o.gates[3] = static_cast<float*>(dwo2);
  o.gates[4] = static_cast<float*>(dbo);
  o.dlng = static_cast<float*>(dlng);
  o.dlnb = static_cast<float*>(dlnb);
  const float* gp = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(p, gp, o, ws, s)
                 : run<float>(p, gp, o, ws, s);
}
