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
// 59 MB in bf16, for a few times the forward's ~55 MFLOP (B=64, L=150:
// 44.8 MB).  No design spends float atomics, so the same inputs give the
// same bits.
//
// 1. "staged" (1 <= L <= 64, D a multiple of 16 up to 128: MTAM's
//    training readout at L=50, d=128, and the narrow d=16), four launches:
//    a. the query pass: q = relu(cur_c Wq + bq) for every hop and row
//       (the hop inputs curs are known before the backward starts), Wq_i
//       staged in shared memory once per 4 rows, the sum over k in 16
//       slices; cur_c and q to the workspace.
//    b. the staged kernel: one block of 256 threads per batch row (two
//       blocks an SM), the reversed hop loop inside it.  Each hop's K and
//       tprec rows of the live keys and V rows of the reached keys come
//       into shared memory once, by 16-byte cp.async, and every later
//       read of them is a shared-memory read.  bf16 double-buffers across
//       hops, warps 1-7 issuing hop i-1's copies while warp 0 takes the
//       softmax of hop i; f32 (twice the bytes) has one buffer and
//       refills V once dw has read it, K and tprec once dq_pre Wq^T has
//       its operands.  One thread mapping throughout: lane c of half-warp
//       h (16 a block) owns 8 columns (`col`), so the score dots q.K_l,
//       cur.tprec_l and do.V_l take a half-warp per key (the keys' loads
//       in flight together, their lane sums in one butterfly), the key
//       sums (o = sum w_l V_l, sum dpre_l tprec_l, dq = sum ds0_l K_l)
//       take keys l = h, h+16, ... a half-warp, added h and h+1 first,
//       then the 8 warps in order, and dq_pre Wq^T takes rows e = h,
//       h+16, ... a half-warp, Wq read from L2 with 16-byte loads (bf16:
//       into registers at the hop's start).  The [L] and [D] vectors of
//       the softmax, the layer norm forward and backward and the softmax
//       transpose fit one warp (a lane 2 keys or 4 columns): warp
//       shuffles there, while warps 1-7 write dv or issue copies.  dk, dv
//       and dt leave in 16-byte streaming stores over all L keys, zero
//       past the live keys (dk, dt) and the reached ones (dv).  A hop's
//       short vectors (cur, q, lng, gate_part, wo2) come into registers a
//       hop ahead.  No row stride is padded: every shared-memory access of
//       a quarter-warp covers 128 contiguous bytes, so none conflicts.
//       L2 hints: the rows and cotangents evict first, Wq last.  The
//       lane mapping and the sums' helpers are chain_staged.cuh's, which
//       the forward's staged design shares.
//    c. the batch sums dwo2, dbq, dlng, dlnb as the rows design sums them
//       (4 below), and
//    d. dwq, the one batch sum that is a product, in a kernel of its own:
//       a 16 x 16 tile a block, 2 x 2 outputs a thread, the rows in order
//       (the reduce pass's order: the same bits).
// 2. "blocked" (65 <= L <= 256, D a multiple of 16 up to 128: MTAM's
//    training readout at the reference's L=150), four launches as the
//    staged design's: its query pass, batch sums and dwq product (none
//    depends on L), and in place of its staged kernel one block of 256
//    threads a batch row streaming each hop's rows through the forward's
//    ring (`KeyRing`, chain_staged.cuh: 3 slots of 64 keys, 32 KB in bf16
//    and 64 KB in f32 at D=128; the reasons are readout_chain.cu's).  Per
//    hop, in reverse: s0 and tqk from the K and tprec blocks into f32
//    strips of all L keys; the softmax over the strip (key l by thread l,
//    which keeps its s0, tqk, sig and e in registers for the transpose;
//    each warp takes the strip's max and sum itself); o from the V blocks
//    of the reached keys; the layer norm and its backward in warp 0; dv
//    = w do over all L keys in 16-byte streaming stores while the V
//    blocks come in again for dw = do . V_l (a half-warp a key); the
//    softmax transpose of key l by thread l; dk and dt over all L keys,
//    zero past the live ones, in 16-byte streaming stores; then a second
//    pass of the K and tprec blocks for dcur += sum_l dpre_l tprec_l and
//    dq = sum_l ds0_l K_l; dq_pre Wq^T as the staged design takes it.
//    Why the rows are streamed twice and not kept: K and tprec of a row
//    take 512 B a key in bf16 and 1,024 B in f32 at D=128, 76,800 /
//    153,600 B at L=150 and 130,560 / 261,120 B at L=255; with V's ring
//    beside them f32 would not fit past L=150 (232,448 B a block) and
//    bf16 would drop to one block an SM.  The second read finds the rows
//    in L2: the first read leaves them there (no L2 hint) and one hop of
//    B=64 rows is at most 16.7 MB of the 50 MB; the second read evicts
//    first.  The loads run in the order they are read, the next hop's K
//    and tprec blocks behind this hop's last K and tprec pass.  Shared
//    memory a block: the ring and 15,488 B of vectors and strips (four
//    strips, each reused once its last reader is behind a barrier): two
//    blocks an SM in bf16, one in f32.
// 3. "rows" (every L up to 256, D up to 128; the first design), two
//    launches: one block of 256 threads per batch row, every [L] and [D]
//    vector of the hop in shared memory, K, V and tprec read from global
//    memory key by key.  The scores and dw take a warp per live key; the
//    [L,D] cotangents are written by all threads, element by element,
//    coalesced; dcur's and dq's sums over keys take a thread per column;
//    dq_pre Wq^T a warp per row of Wq; then
// 4. reduce: each batch sum over the rows in order, one thread per
//    output element; dwq[i][k][e] = sum_b cur_c[i,b,k] dq_pre[i,b,e].
// Every design writes the per-row terms of the batch sums (cur_c, the rounded
// dq_pre, g xh, g and dgate tqk) to an f32 workspace.

#include <cstdint>
#include <initializer_list>

#include "chain_staged.cuh"

namespace {

using namespace chain_staged;
using readout::from_float;
using readout::kMaxD;
using readout::kThreads;
using readout::kWarps;

constexpr int kMaxL = 256;
// per-row f32 vectors [kVecs, n, B, D] of the workspace (V_Q: the staged
// design's alone), then dgate tqk [n, B, L]
enum { V_CURR = 0, V_DQ, V_GXH, V_G, V_Q, kVecs };

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

// ------------------------------------------------------------ staged

// The block's f32 vectors (static shared memory).
struct StagedVecs {
  float cur[kMaxD], q[kMaxD], lng[kMaxD], dcur[kMaxD], dov[kMaxD],
      dqp[kMaxD];
  float gp[kStagedKeys], wo2[kStagedKeys], s0[kStagedKeys], tp[kStagedKeys],
      tqk[kStagedKeys], sig[kStagedKeys], w[kStagedKeys], dw[kStagedKeys],
      ds0[kStagedKeys], dpre[kStagedKeys];
  float part[2][kWarps][kMaxD];   // per-warp partials of a sum over keys
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           unsigned long long policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "l"(policy));
}

// A lane's 8 f32 values, each rounded once to T, to its columns of a row
// (streaming stores: evict first).
__device__ __forceinline__ void store8(__nv_bfloat16* row, int c, int D,
                                       const float (&x)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  __stcs(reinterpret_cast<uint4*>(row + kGroup * c), u);
}
__device__ __forceinline__ void store8(float* row, int c, int D,
                                       const float (&x)[8]) {
  __stcs(reinterpret_cast<float4*>(row + 4 * c),
         make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(row + D / 2 + 4 * c),
         make_float4(x[4], x[5], x[6], x[7]));
}
// Issue copies of hop i's rows of row b into its buffer [K | V | tprec]:
// with `kt` K and tprec (the live rows), with `vv` V (the reached ones),
// by thread t of `nt` (the block's threads, or those of warps 1-7).
template <typename T>
__device__ __forceinline__ void stage_rows(const Args& a, T* buf, int i, int b,
                                           int live, int span, bool kt,
                                           bool vv, int t, int nt) {
  constexpr int kVec = 16 / sizeof(T);
  const int D = a.D, per_row = D / kVec;
  // a thread copies one 16-byte piece of every step-th row (threads past
  // step * per_row copy none)
  const int step = nt / per_row, row0 = t / per_row;
  const int off0 = (t - row0 * per_row) * kVec;
  if (row0 >= step) return;
  const size_t LD = (size_t)a.L * D, hb = (size_t)i * a.B + b;
  const unsigned long long policy = evict_first();
  if (kt) {
    const T* K = at<T>(a.k, hb * LD);
    const T* TP = at<T>(a.t, hb * LD);
    for (int l = row0; l < live; l += step) {
      const int off = l * D + off0;
      cp_async16(buf + off, K + off, policy);
      cp_async16(buf + 2 * LD + off, TP + off, policy);
    }
  }
  if (vv) {
    const T* V = at<T>(a.v, hb * LD);
    for (int l = row0; l < span; l += step) {
      const int off = l * D + off0;
      cp_async16(buf + LD + off, V + off, policy);
    }
  }
}

// A hop's short vectors, one element a thread: threads e < D hold cur[e]
// (f32), q[e] (from the query pass) and lng[e]; threads kMaxD + l, l < L,
// hold gate_part[l] and wo2[l].  Loaded into registers a hop ahead,
// stored after the last read of the hop before.
struct HopVecs {
  float cur, q, lng, gp, wo2;
};

template <typename T>
__device__ __forceinline__ HopVecs load_hop_vecs(const Args& a, int i, int b) {
  const int tid = threadIdx.x, D = a.D, L = a.L;
  const size_t hb = (size_t)i * a.B + b, nBD = (size_t)a.n * a.B * D;
  HopVecs x{0.f, 0.f, 0.f, 0.f, 0.f};
  if (tid < D) {
    x.cur = a.curs[hb * D + tid];
    x.q = a.vec[V_Q * nBD + hb * D + tid];
    x.lng = port::to_float(at<T>(a.lng, (size_t)i * D)[tid]);
  } else if (tid >= kMaxD && tid - kMaxD < L) {
    x.gp = port::to_float(at<T>(a.gp, hb * L)[tid - kMaxD]);
    x.wo2 = port::to_float(at<T>(a.wo2, (size_t)i * L)[tid - kMaxD]);
  }
  return x;
}

__device__ __forceinline__ void store_hop_vecs(StagedVecs& v, const HopVecs& x,
                                               int D, int L) {
  const int tid = threadIdx.x;
  if (tid < D) {
    v.cur[tid] = x.cur;
    v.q[tid] = x.q;
    v.lng[tid] = x.lng;
  } else if (tid >= kMaxD && tid - kMaxD < L) {
    v.gp[tid - kMaxD] = x.gp;
    v.wo2[tid - kMaxD] = x.wo2;
  }
}

// Row e of Wq_i at the lane's k columns (`fetch_wq_rows`'s slot s) for
// dq_pre Wq^T: bf16 from the registers fetched at the hop's start, f32
// loaded where it is used.
template <typename T>
__device__ __forceinline__ void wq_row(const WqRows<T>& r, const T* WQ, int s,
                                       int e, int c, int D,
                                       unsigned long long policy,
                                       float (&x)[8]) {
  if constexpr (sizeof(T) == 2) {
    unpack(r.raw[s], x);
  } else {
    const uint4 a = ldg16(WQ + (size_t)e * D + 4 * c, policy);
    const uint4 b = ldg16(WQ + (size_t)e * D + D / 2 + 4 * c, policy);
    split(reinterpret_cast<const float4&>(a), reinterpret_cast<const float4&>(b),
          x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) chain_bwd_staged_kernel(Args a) {
  constexpr int S = kStages<T>;
  extern __shared__ __align__(16) unsigned char staged_raw[];
  T* rows = reinterpret_cast<T*>(staged_raw);    // S x [K | V | tprec], [L, D]
  __shared__ __align__(16) StagedVecs v;
  const int D = a.D, L = a.L, B = a.B, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = tid >> 4, c = tid & 15;
  const bool on = kGroup * c < D;               // the lane owns columns
  const int live = max(0, min(a.klen[b], L));
  const int span = live > 0 ? live : L;
  const float qz = a.qz[b];
  const size_t nBD = (size_t)a.n * B * D, LD = (size_t)L * D;
  for (int e = tid; e < D; e += kThreads)
    v.dcur[e] = port::to_float(at<T>(a.g, (size_t)b * D)[e]);
  stage_rows<T>(a, rows + (size_t)((a.n - 1) % S) * 3 * LD, a.n - 1, b, live,
                span, true, true, tid, kThreads);
  cp_async_commit();
  store_hop_vecs(v, load_hop_vecs<T>(a, a.n - 1, b), D, L);
  for (int i = a.n - 1; i >= 0; --i) {
    const size_t hb = (size_t)i * B + b;
    const T* WQ = at<T>(a.wq, (size_t)i * D * D);
    T* buf = rows + (size_t)(i % S) * 3 * LD;
    // in flight through the hop: the next hop's short vectors and (bf16)
    // this hop's rows of Wq for dq_pre Wq^T
    const HopVecs next = i > 0 ? load_hop_vecs<T>(a, i - 1, b) : HopVecs{};
    WqRows<T> wq_rows;
    fetch_wq_rows<T>(wq_rows, WQ, h, c, D, on);
    cp_async_wait<0>();
    __syncthreads();                            // hop i's rows and vectors in
    const T* Ks = buf;
    const T* Vs = buf + LD;
    const T* Ts = buf + 2 * LD;

    // ---- the score dots q.K_l and cur.tprec_l, a half-warp a key
    {
      float qv[8], cv[8], s0[kKeySlots], tp[kKeySlots];
      lane8<T>(v.q, c, D, on, qv);
      lane8<T>(v.cur, c, D, on, cv);
      key_dots(qv, Ks, live, D, h, c, on, s0);
      key_dots(cv, Ts, live, D, h, c, on, tp);
      float x[2 * kKeySlots];
#pragma unroll
      for (int s = 0; s < kKeySlots; ++s) {
        x[s] = s0[s];
        x[kKeySlots + s] = tp[s];
      }
      // lane c ends with value half_sums_index(c): s0 of slot k, or tp of
      // slot k - kKeySlots
      const float r = half_sums(x, lane);
      const int k = half_sums_index<2 * kKeySlots>(lane);
      const int l = h + kHalves * (k % kKeySlots);
      if ((c & 1) == 0 && l < live) (k < kKeySlots ? v.s0 : v.tp)[l] = r;
    }
    __syncthreads();
    // ---- the gate and the softmax over the L keys in warp 0 (a lane 2
    // keys)
    if (warp == 0) {
      float s[2], m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = lane + 32 * j;
        s[j] = readout::kNegFill;
        if (l < live) {
          const float tqk = tanhf(v.tp[l]);
          const float sig = port::sigmoid(v.gp[l] + v.wo2[l] * tqk);
          v.tqk[l] = tqk;
          v.sig[l] = sig;
          s[j] = v.s0[l] * sig * a.scale;
        }
        if (l < L) m = fmaxf(m, s[j]);
      }
      m = port::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j] = lane + 32 * j < L ? expf(s[j] - m) : 0.f;
        sum += s[j];
      }
      sum = port::warp_sum(sum);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (lane + 32 * j < L) v.w[lane + 32 * j] = s[j] / sum;
    } else if constexpr (S == 2) {
      // bf16, warps 1-7 meanwhile: hop i-1's rows into the other buffer,
      // free since hop i+1 ended, in flight through this hop
      if (i > 0) {
        stage_rows<T>(a, rows + (size_t)((i - 1) % 2) * 3 * LD, i - 1, b,
                      live, span, true, true, tid - 32, kThreads - 32);
        cp_async_commit();
      }
    }
    __syncthreads();
    // ---- o = sum_l w_l V_l over the reached keys
    {
      float acc[8];
      key_sum(v.w, Vs, span, D, h, c, on, acc);
      warp_partial<T>(acc, v.part[0][warp], lane, c, D, on);
    }
    __syncthreads();
    // ---- residual, layer norm and its backward in warp 0 (a lane 4
    // columns)
    if (warp == 0) {
      float x[4], sx = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = lane + 32 * j;
        x[j] = e < D ? warps_sum(v.part[0], e) * qz + v.cur[e] : 0.f;
        sx += x[j];
      }
      const float mean = port::warp_sum(sx) / D;
      float sv = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = lane + 32 * j < D ? x[j] - mean : 0.f;
        sv += x[j] * x[j];
      }
      const float inv = 1.f / sqrtf(port::warp_sum(sv) / D + readout::kLnEps);
      float xh[4], dxh[4], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = lane + 32 * j;
        xh[j] = x[j] * inv;
        dxh[j] = 0.f;
        if (e < D) {
          const float g = v.dcur[e];
          dxh[j] = g * v.lng[e];
          a.vec[V_GXH * nBD + hb * D + e] = g * xh[j];
          a.vec[V_G * nBD + hb * D + e] = g;
        }
        s1 += dxh[j];
        s2 += dxh[j] * xh[j];
      }
      const float m1 = port::warp_sum(s1) / D;
      const float m2 = port::warp_sum(s2) / D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = lane + 32 * j;
        if (e < D) {
          const float dx = (dxh[j] - m1 - xh[j] * m2) * inv;
          v.dov[e] = dx * qz;
          v.dcur[e] = dx;                     // the residual branch
        }
      }
    }
    __syncthreads();
    // ---- dw_l = do . V_l over the live keys, a half-warp a key
    {
      float dv[8], dw[kKeySlots];
      lane8<T>(v.dov, c, D, on, dv);
      key_dots(dv, Vs, live, D, h, c, on, dw);
      const float r = half_sums(dw, lane);
      const int l = h + kHalves * half_sums_index<kKeySlots>(lane);
      if ((c & 3) == 0 && l < live) v.dw[l] = r;
    }
    __syncthreads();
    // ---- the softmax transpose and the gate's cotangents in warp 0 (a
    // lane 2 keys)
    if (warp == 0) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = lane + 32 * j;
        if (l < live) part += v.dw[l] * v.w[l];
      }
      const float sdw = port::warp_sum(part);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = lane + 32 * j;
        if (l >= L) continue;
        float dgate = 0.f, ds0 = 0.f, dpre = 0.f, dgt = 0.f;
        if (l < live) {                         // no score gradient else
          const float ds = v.w[l] * (v.dw[l] - sdw);
          const float sig = v.sig[l], tqk = v.tqk[l];
          dgate = ds * v.s0[l] * a.scale * sig * (1.f - sig);
          ds0 = ds * sig * a.scale;
          dpre = dgate * v.wo2[l] * (1.f - tqk * tqk);
          dgt = dgate * tqk;
        }
        v.ds0[l] = ds0;
        v.dpre[l] = dpre;
        out_at<T>(a.dgp, hb * L)[l] = from_float<T>(dgate);
        a.dgt[hb * L + l] = dgt;
      }
    } else {
      // warps 1-7 meanwhile: dv_l = w_l do over all L keys (zero past the
      // reached ones), a half-warp a key, 16-byte stores; f32: V's last
      // read is done, hop i-1's V rows into its place
      T* DV = out_at<T>(a.dv, hb * LD);
      float dv[8];
      lane8<T>(v.dov, c, D, on, dv);
      if (on)
        for (int l = h - 2; l < L; l += kHalves - 2) {
          const float wl = l < span ? v.w[l] : 0.f;
          float x[8];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) x[j] = wl * dv[j];
          store8(DV + (size_t)l * D, c, D, x);
        }
      if constexpr (S == 1) {
        if (i > 0)
          stage_rows<T>(a, buf, i - 1, b, live, span, false, true, tid - 32,
                        kThreads - 32);
      }
    }
    __syncthreads();

    // ---- dk, dt over all L keys (zero past the live ones): a half-warp a
    // key, 16-byte stores
    {
      T* DK = out_at<T>(a.dk, hb * LD);
      T* DT = out_at<T>(a.dt, hb * LD);
      float cv[8], qv[8];
      lane8<T>(v.cur, c, D, on, cv);
      lane8<T>(v.q, c, D, on, qv);
      if (on)
        for (int l = h; l < L; l += kHalves) {
          const float pl = l < live ? v.dpre[l] : 0.f;
          const float kl = l < live ? v.ds0[l] : 0.f;
          float xt[8], xk[8];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            xt[j] = pl * cv[j];
            xk[j] = kl * qv[j];
          }
          store8(DT + (size_t)l * D, c, D, xt);
          store8(DK + (size_t)l * D, c, D, xk);
        }
    }
    // ---- sum_l dpre_l tprec_l and dq = sum_l ds0_l K_l (live keys)
    {
      float acc_t[8], acc_q[8];
      key_sum(v.dpre, Ts, live, D, h, c, on, acc_t);
      key_sum(v.ds0, Ks, live, D, h, c, on, acc_q);
      warp_partial<T>(acc_t, v.part[0][warp], lane, c, D, on);
      warp_partial<T>(acc_q, v.part[1][warp], lane, c, D, on);
    }
    __syncthreads();
    if (tid < D) {
      v.dcur[tid] += warps_sum(v.part[0], tid);
    } else if (tid < 2 * D) {
      const int e = tid - D;
      const float dq = warps_sum(v.part[1], e);
      const float dq_pre = port::round_to<T>(v.q[e] > 0.f ? dq : 0.f);
      v.dqp[e] = dq_pre;
      a.vec[V_DQ * nBD + hb * D + e] = dq_pre;
    }
    __syncthreads();
    // the hop's short vectors are read no more: the next hop's take
    // their place
    if (i > 0) store_hop_vecs(v, next, D, L);
    // ---- dcur += dq_pre Wq^T: half-warp h takes rows e = h, h+16, ...
    {
      float dq8[8], acc[kSlots];
      lane8<T>(v.dqp, c, D, on, dq8);
      const unsigned long long policy = evict_last();
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        acc[s] = 0.f;
        const int e = h + kHalves * s;
        if (on && e < D) {
          float wv[8];
          wq_row<T>(wq_rows, WQ, s, e, c, D, policy, wv);
#pragma unroll
          for (int j = 0; j < kGroup; ++j) acc[s] = fmaf(dq8[j], wv[j], acc[s]);
        }
      }
      // f32: K's and tprec's last reads are done, and this product's
      // loads are in: hop i-1's rows into their place (one cp.async group
      // with its V rows)
      if constexpr (S == 1) {
        if (i > 0) {
          stage_rows<T>(a, buf, i - 1, b, live, span, true, false, tid,
                        kThreads);
          cp_async_commit();
        }
      }
      // lane c ends with row h + 16 half_sums_index(c)'s sum
      const float r = half_sums(acc, lane);
      const int e = h + kHalves * half_sums_index<kSlots>(lane);
      if ((c & 1) == 0 && e < D) v.dcur[e] += r;
    }
    __syncthreads();
  }
  T* ddec = out_at<T>(a.ddec, (size_t)b * D);
  for (int e = tid; e < D; e += kThreads) ddec[e] = from_float<T>(v.dcur[e]);
}

// ------------------------------------------------------------ blocked

// The block's f32 vectors and the ring's barriers (static shared memory):
// the strips hold a value a key (L <= kBlockedMaxKeys), each reused once
// its last reader is behind a barrier.
struct BlockedVecs {
  float cur[kMaxD], q[kMaxD], lng[kMaxD], dcur[kMaxD], dov[kMaxD],
      dqp[kMaxD];
  float sa[kBlockedMaxKeys];   // q . K_l, then dw_l = do . V_l
  float sb[kBlockedMaxKeys];   // cur . tprec_l, then e_l = exp(s_l - max)
  float sc[kBlockedMaxKeys];   // the score s_l, then ds0_l
  float sd[kBlockedMaxKeys];   // dpre_l
  float part[2][kWarps][kMaxD];   // per-warp partials of a sum over keys
  alignas(8) unsigned long long bar[kRingSlots];
};

// Load j of row b's ring, hops from the last: in each, the K and tprec
// rows of the live keys (the scores), the V rows of the reached keys (o),
// the V rows of the live keys again (dw), the K and tprec rows again (dq
// and dcur's sum), kBlockKeys keys a load.  A first read leaves the rows
// in L2 for the second (one hop of B=64 rows is at most 16.7 MB of the
// 50 MB); a second read, and V past the live keys, evict first.
template <typename T>
__device__ __forceinline__ RingLoad<T> bwd_load(const Args& a, int b, int live,
                                                int span, int nkt, int nv,
                                                int per_hop, int j) {
  const int hop = j / per_hop, r = j - hop * per_hop;
  const size_t hb = (size_t)(a.n - 1 - hop) * a.B + b;
  const size_t LD = (size_t)a.L * a.D;
  // the pass: 0 K and tprec, 1 V (reached), 2 V (live), 3 K and tprec
  const int pass = r < nkt ? 0 : r < nkt + nv ? 1 : r < 2 * nkt + nv ? 2 : 3;
  const int first = pass == 0 ? 0 : pass == 1 ? nkt : pass == 2 ? nkt + nv
                                                              : 2 * nkt + nv;
  const int k0 = (r - first) * kBlockKeys;
  const size_t off = hb * LD + (size_t)k0 * a.D;
  const bool kt = pass == 0 || pass == 3;
  return {at<T>(kt ? a.k : a.v, off), kt ? at<T>(a.t, off) : nullptr,
          min(kBlockKeys, (pass == 1 ? span : live) - k0),
          pass == 0 || (pass == 1 && live > 0)};
}

// A hop's short vectors in registers, loaded a hop ahead: threads e < D
// hold cur[e] (f32), q[e] (from the query pass) and lng[e]; thread l < L
// holds gate_part[l] and wo2[l] (kept there: the same thread takes key l
// in the softmax and its transpose).
template <typename T>
__device__ __forceinline__ HopVecs load_blocked_vecs(const Args& a, int i,
                                                     int b) {
  const int tid = threadIdx.x, D = a.D, L = a.L;
  const size_t hb = (size_t)i * a.B + b, nBD = (size_t)a.n * a.B * D;
  HopVecs x{0.f, 0.f, 0.f, 0.f, 0.f};
  if (tid < D) {
    x.cur = a.curs[hb * D + tid];
    x.q = a.vec[V_Q * nBD + hb * D + tid];
    x.lng = port::to_float(at<T>(a.lng, (size_t)i * D)[tid]);
  }
  if (tid < L) {
    x.gp = port::to_float(at<T>(a.gp, hb * L)[tid]);
    x.wo2 = port::to_float(at<T>(a.wo2, (size_t)i * L)[tid]);
  }
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) chain_bwd_blocked_kernel(Args a) {
  constexpr int kIssuer = 32;                   // lane 0 of warp 1
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ __align__(16) BlockedVecs v;
  const int D = a.D, L = a.L, B = a.B, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = tid >> 4, c = tid & 15;
  const bool on = kGroup * c < D;               // the lane owns columns
  const int live = max(0, min(a.klen[b], L));
  const int span = live > 0 ? live : L;
  const float qz = a.qz[b];
  const size_t nBD = (size_t)a.n * B * D, LD = (size_t)L * D;
  const int nkt = (live + kBlockKeys - 1) / kBlockKeys;
  const int nv = (span + kBlockKeys - 1) / kBlockKeys;
  const int per_hop = 3 * nkt + nv, total = a.n * per_hop;
  const KeyRing<T> ring{reinterpret_cast<T*>(ring_raw), v.bar, D};
  if (tid == kIssuer) {
    for (int k = 0; k < kRingSlots; ++k) mbar_init(&v.bar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < D; e += kThreads)
    v.dcur[e] = port::to_float(at<T>(a.g, (size_t)b * D)[e]);
  HopVecs hv = load_blocked_vecs<T>(a, a.n - 1, b);
  if (tid < D) {
    v.cur[tid] = hv.cur;
    v.q[tid] = hv.q;
    v.lng[tid] = hv.lng;
  }
  __syncthreads();                              // the barriers and vectors
  if (tid == kIssuer)
    for (int k = 0; k < min(kRingSlots, total); ++k)
      ring.issue(k, bwd_load<T>(a, b, live, span, nkt, nv, per_hop, k));
  // after every thread has read load j: its slot takes load j + kRingSlots
  auto release = [&](int j) {
    __syncthreads();
    if (tid == kIssuer && j + kRingSlots < total)
      ring.issue(j + kRingSlots, bwd_load<T>(a, b, live, span, nkt, nv,
                                             per_hop, j + kRingSlots));
  };
  int j = 0;                                    // the next load to read
  for (int i = a.n - 1; i >= 0; --i) {
    const size_t hb = (size_t)i * B + b;
    const T* WQ = at<T>(a.wq, (size_t)i * D * D);
    // in flight through the hop: the next hop's short vectors and (bf16)
    // this hop's rows of Wq for dq_pre Wq^T
    const HopVecs next = i > 0 ? load_blocked_vecs<T>(a, i - 1, b) : HopVecs{};
    WqRows<T> wq_rows;
    fetch_wq_rows<T>(wq_rows, WQ, h, c, D, on);

    // ---- the dots q . K_l and cur . tprec_l, a key block at a time, a
    // half-warp a key
    {
      float qv[8], cv[8];
      lane8<T>(v.q, c, D, on, qv);
      lane8<T>(v.cur, c, D, on, cv);
      for (int kb = 0; kb < nkt; ++kb, ++j) {
        ring.wait(j);
        const T* Ks = ring.slot(j);
        const T* Ts = Ks + (size_t)kBlockKeys * D;
        const int k0 = kb * kBlockKeys, nk = min(kBlockKeys, live - k0);
        float s0[kKeySlots], tp[kKeySlots], x[2 * kKeySlots];
        key_dots(qv, Ks, nk, D, h, c, on, s0);
        key_dots(cv, Ts, nk, D, h, c, on, tp);
#pragma unroll
        for (int s = 0; s < kKeySlots; ++s) {
          x[s] = s0[s];
          x[kKeySlots + s] = tp[s];
        }
        const float r = half_sums(x, lane);
        const int k = half_sums_index<2 * kKeySlots>(lane);
        const int l = h + kHalves * (k % kKeySlots);
        if ((c & 1) == 0 && l < nk) (k < kKeySlots ? v.sa : v.sb)[k0 + l] = r;
        release(j);
      }
    }
    // ---- the gate and the score of key tid, the softmax over the strip
    // (each warp takes its max and sum itself: the same bits in every
    // warp); key tid's s0, tqk, sig and e stay in its registers
    float s0l = 0.f, tqk = 0.f, sig = 0.f, sl = readout::kNegFill;
    if (tid < live) {
      s0l = v.sa[tid];
      tqk = tanhf(v.sb[tid]);
      sig = port::sigmoid(hv.gp + hv.wo2 * tqk);
      sl = s0l * sig * a.scale;
    }
    if (tid < L) v.sc[tid] = sl;
    __syncthreads();                            // the scores
    const float m = strip_max(v.sc, L, lane);
    const float el = tid < L ? expf(sl - m) : 0.f;
    if (tid < L) v.sb[tid] = el;
    __syncthreads();                            // the exponentials
    const float sum = strip_sum(v.sb, nullptr, 1.f, L, lane);
    // ---- o = sum_l w_l V_l over the reached keys, a key block at a time
    {
      float acc[8];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) acc[k] = 0.f;
      for (int kb = 0; kb < nv; ++kb, ++j) {
        ring.wait(j);
        const int k0 = kb * kBlockKeys;
        key_sum_acc(v.sb + k0, sum, ring.slot(j), min(kBlockKeys, span - k0),
                    D, h, c, on, acc);
        release(j);
      }
      warp_partial<T>(acc, v.part[0][warp], lane, c, D, on);
    }
    __syncthreads();
    // ---- residual, layer norm and its backward in warp 0 (a lane 4
    // columns)
    if (warp == 0) {
      float x[4], sx = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        x[k] = e < D ? warps_sum(v.part[0], e) * qz + v.cur[e] : 0.f;
        sx += x[k];
      }
      const float mean = port::warp_sum(sx) / D;
      float sv = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = lane + 32 * k < D ? x[k] - mean : 0.f;
        sv += x[k] * x[k];
      }
      const float inv = 1.f / sqrtf(port::warp_sum(sv) / D + readout::kLnEps);
      float xh[4], dxh[4], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        xh[k] = x[k] * inv;
        dxh[k] = 0.f;
        if (e < D) {
          const float g = v.dcur[e];
          dxh[k] = g * v.lng[e];
          a.vec[V_GXH * nBD + hb * D + e] = g * xh[k];
          a.vec[V_G * nBD + hb * D + e] = g;
        }
        s1 += dxh[k];
        s2 += dxh[k] * xh[k];
      }
      const float m1 = port::warp_sum(s1) / D;
      const float m2 = port::warp_sum(s2) / D;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        if (e < D) {
          const float dx = (dxh[k] - m1 - xh[k] * m2) * inv;
          v.dov[e] = dx * qz;
          v.dcur[e] = dx;                     // the residual branch
        }
      }
    }
    __syncthreads();
    float dv8[8];
    lane8<T>(v.dov, c, D, on, dv8);
    // ---- dv_l = w_l do over all L keys (zero past the reached ones), a
    // half-warp a key, 16-byte streaming stores, while the V rows come in
    {
      T* DV = out_at<T>(a.dv, hb * LD);
      if (on)
        for (int l = h; l < L; l += kHalves) {
          const float wl = l < span ? v.sb[l] / sum : 0.f;
          float x[8];
#pragma unroll
          for (int k = 0; k < kGroup; ++k) x[k] = wl * dv8[k];
          store8(DV + (size_t)l * D, c, D, x);
        }
    }
    // ---- dw_l = do . V_l over the live keys, a key block at a time, a
    // half-warp a key
    for (int kb = 0; kb < nkt; ++kb, ++j) {
      ring.wait(j);
      const int k0 = kb * kBlockKeys, nk = min(kBlockKeys, live - k0);
      float dw[kKeySlots];
      key_dots(dv8, ring.slot(j), nk, D, h, c, on, dw);
      const float r = half_sums(dw, lane);
      const int l = h + kHalves * half_sums_index<kKeySlots>(lane);
      if ((c & 3) == 0 && l < nk) v.sa[k0 + l] = r;
      release(j);
    }
    // ---- the softmax transpose and the gate's cotangents of key tid
    {
      const float sdw = strip_sum(v.sa, v.sb, sum, live, lane);
      float dgate = 0.f, ds0 = 0.f, dpre = 0.f, dgt = 0.f;
      if (tid < live) {                         // no score gradient else
        const float ds = (el / sum) * (v.sa[tid] - sdw);
        dgate = ds * s0l * a.scale * sig * (1.f - sig);
        ds0 = ds * sig * a.scale;
        dpre = dgate * hv.wo2 * (1.f - tqk * tqk);
        dgt = dgate * tqk;
      }
      if (tid < L) {
        v.sc[tid] = ds0;
        v.sd[tid] = dpre;
        out_at<T>(a.dgp, hb * L)[tid] = from_float<T>(dgate);
        a.dgt[hb * L + tid] = dgt;
      }
    }
    __syncthreads();
    // ---- dk, dt over all L keys (zero past the live ones): a half-warp a
    // key, 16-byte streaming stores, while the K and tprec rows come in
    {
      T* DK = out_at<T>(a.dk, hb * LD);
      T* DT = out_at<T>(a.dt, hb * LD);
      float cv[8], qv[8];
      lane8<T>(v.cur, c, D, on, cv);
      lane8<T>(v.q, c, D, on, qv);
      if (on)
        for (int l = h; l < L; l += kHalves) {
          const float pl = l < live ? v.sd[l] : 0.f;
          const float kl = l < live ? v.sc[l] : 0.f;
          float xt[8], xk[8];
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            xt[k] = pl * cv[k];
            xk[k] = kl * qv[k];
          }
          store8(DT + (size_t)l * D, c, D, xt);
          store8(DK + (size_t)l * D, c, D, xk);
        }
    }
    // ---- sum_l dpre_l tprec_l and dq = sum_l ds0_l K_l over the live
    // keys, a key block at a time
    {
      float acc_t[8], acc_q[8];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) acc_t[k] = acc_q[k] = 0.f;
      for (int kb = 0; kb < nkt; ++kb, ++j) {
        ring.wait(j);
        const T* Ks = ring.slot(j);
        const int k0 = kb * kBlockKeys, nk = min(kBlockKeys, live - k0);
        key_sum_acc(v.sd + k0, 1.f, Ks + (size_t)kBlockKeys * D, nk, D, h, c,
                    on, acc_t);
        key_sum_acc(v.sc + k0, 1.f, Ks, nk, D, h, c, on, acc_q);
        release(j);
      }
      warp_partial<T>(acc_t, v.part[0][warp], lane, c, D, on);
      warp_partial<T>(acc_q, v.part[1][warp], lane, c, D, on);
    }
    __syncthreads();
    if (tid < D) {
      v.dcur[tid] += warps_sum(v.part[0], tid);
    } else if (tid < 2 * D) {
      const int e = tid - D;
      const float dq = warps_sum(v.part[1], e);
      const float dq_pre = port::round_to<T>(v.q[e] > 0.f ? dq : 0.f);
      v.dqp[e] = dq_pre;
      a.vec[V_DQ * nBD + hb * D + e] = dq_pre;
    }
    __syncthreads();
    // the hop's short vectors are read no more: the next hop's take
    // their place
    if (i > 0 && tid < D) {
      v.cur[tid] = next.cur;
      v.q[tid] = next.q;
      v.lng[tid] = next.lng;
    }
    hv = next;
    // ---- dcur += dq_pre Wq^T: half-warp h takes rows e = h, h+16, ...
    {
      float dq8[8], acc[kSlots];
      lane8<T>(v.dqp, c, D, on, dq8);
      const unsigned long long policy = evict_last();
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        acc[s] = 0.f;
        const int e = h + kHalves * s;
        if (on && e < D) {
          float wv[8];
          wq_row<T>(wq_rows, WQ, s, e, c, D, policy, wv);
#pragma unroll
          for (int k = 0; k < kGroup; ++k) acc[s] = fmaf(dq8[k], wv[k], acc[s]);
        }
      }
      // lane c ends with row h + 16 half_sums_index(c)'s sum
      const float r = half_sums(acc, lane);
      const int e = h + kHalves * half_sums_index<kSlots>(lane);
      if ((c & 1) == 0 && e < D) v.dcur[e] += r;
    }
    __syncthreads();
  }
  T* ddec = out_at<T>(a.ddec, (size_t)b * D);
  for (int e = tid; e < D; e += kThreads) ddec[e] = from_float<T>(v.dcur[e]);
}

// The query pass, before the staged kernel: for every hop i and row b,
// cur_c = curs[i,b] rounded to T and q = relu(cur_c Wq_i + bq_i) (f32) to
// the workspace.  A block of 256 threads takes kQueryRows rows of one
// hop: Wq_i comes into shared memory by cp.async, the rows' cur_c beside
// it.  Half-warp h sums k = h, h+16, ... in order for the block's rows at
// lane c's 8 columns (`col`); the half-warps' partials are then added as
// the staged kernel adds its key sums (h and h+1 first, then the warps
// in order from 0).
constexpr int kQueryRows = 4;

size_t query_dynamic_bytes(bool bf16, int D) {
  return (size_t)D * D * (bf16 ? 2 : 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chain_bwd_query_kernel(Args a) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char query_raw[];
  T* sw = reinterpret_cast<T*>(query_raw);      // Wq_i [D, D]
  __shared__ __align__(16) float sc[kQueryRows][kMaxD];
  __shared__ float part[kWarps][kQueryRows][kMaxD];
  __shared__ float sb[kMaxD];
  const int D = a.D, B = a.B, i = blockIdx.y, r0 = blockIdx.x * kQueryRows;
  const int nr = min(kQueryRows, B - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = tid >> 4, c = tid & 15;
  const bool on = kGroup * c < D;
  const size_t nBD = (size_t)a.n * B * D, hop = (size_t)i * B;
  const T* WQ = at<T>(a.wq, (size_t)i * D * D);
  const unsigned long long policy = evict_last();
  for (int t = tid; t < D * D / kVec; t += kThreads)
    cp_async16(sw + t * kVec, WQ + t * kVec, policy);
  const float* cur = a.curs + (hop + r0) * D;
  for (int t = tid; t < nr * D / 4; t += kThreads)
    cp_async16(&sc[0][0] + (t / (D / 4)) * kMaxD + (t % (D / 4)) * 4,
               cur + 4 * t);
  cp_async_commit();
  // bq beside them: no load of it waits behind a store of q
  for (int e = tid; e < D; e += kThreads)
    sb[e] = port::to_float(at<T>(a.bq, (size_t)i * D)[e]);
  cp_async_wait<0>();
  __syncthreads();
  for (int t = tid; t < kQueryRows * D; t += kThreads) {
    const int r = t / D, e = t - r * D;
    const float x = r < nr ? port::round_to<T>(sc[r][e]) : 0.f;
    if (r < nr) a.vec[V_CURR * nBD + (hop + r0 + r) * D + e] = x;
    sc[r][e] = x;
  }
  __syncthreads();
  float acc[kQueryRows][kGroup];
#pragma unroll
  for (int r = 0; r < kQueryRows; ++r)
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[r][j] = 0.f;
  if (on) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int k = h + kHalves * s;
      if (k < D) {
        float w[8];
        load8(sw + (size_t)k * D, c, D, w);
#pragma unroll
        for (int r = 0; r < kQueryRows; ++r) {
          const float x = sc[r][k];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) acc[r][j] = fmaf(x, w[j], acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kQueryRows; ++r)
    warp_partial<T>(acc[r], part[warp][r], lane, c, D, on);
  __syncthreads();
  for (int t = tid; t < nr * D; t += kThreads) {
    const int r = t / D, e = t - r * D;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += part[w][r][e];
    a.vec[V_Q * nBD + (hop + r0 + r) * D + e] = fmaxf(x + sb[e], 0.f);
  }
}

// dwq[i][k][e] = sum_b cur_c[i,b,k] dq_pre[i,b,e] over the rows in order
// from b = 0, one fmaf a row (the reduce pass's order: the same bits): a
// block of 64 threads a 16 x 16 tile of one hop, a thread 2 x 2 outputs
// (four chains in flight), kDwqRows rows of the tile's 16 k and 16 e
// columns staged in shared memory at a time by cp.async.
constexpr int kDwqTile = 16, kDwqRows = 256, kDwqThreads = 64;

__global__ void __launch_bounds__(kDwqThreads) chain_bwd_dwq_kernel(
    const float* vec, float* dwq, int B, int D, int n) {
  __shared__ __align__(16) float sc[kDwqRows][kDwqTile];
  __shared__ __align__(16) float sd[kDwqRows][kDwqTile];
  const int tiles = D / kDwqTile, i = blockIdx.y;
  const int k0 = (blockIdx.x / tiles) * kDwqTile;
  const int e0 = (blockIdx.x % tiles) * kDwqTile;
  const int tk = 2 * (threadIdx.x / 8), te = 2 * (threadIdx.x % 8);
  const size_t nBD = (size_t)n * B * D, hop = (size_t)i * B * D;
  const float* curr = vec + V_CURR * nBD + hop + k0;
  const float* dq = vec + V_DQ * nBD + hop + e0;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int r0 = 0; r0 < B; r0 += kDwqRows) {
    const int nr = min(kDwqRows, B - r0);
    __syncthreads();                            // the last chunk is read
    // a row's 16 columns are 4 16-byte pieces (D % 16 == 0), all copied
    // by cp.async at once
    for (int t = threadIdx.x; t < nr * 4; t += kDwqThreads) {
      const int r = t / 4, c = 4 * (t % 4);
      const size_t off = (size_t)(r0 + r) * D + c;
      cp_async16(&sc[r][c], curr + off);
      cp_async16(&sd[r][c], dq + off);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 16
    for (int r = 0; r < nr; ++r) {
      const float2 c = *reinterpret_cast<const float2*>(&sc[r][tk]);
      const float2 d = *reinterpret_cast<const float2*>(&sd[r][te]);
      acc[0][0] = fmaf(c.x, d.x, acc[0][0]);
      acc[0][1] = fmaf(c.x, d.y, acc[0][1]);
      acc[1][0] = fmaf(c.y, d.x, acc[1][0]);
      acc[1][1] = fmaf(c.y, d.y, acc[1][1]);
    }
  }
  float* out = dwq + (size_t)i * D * D + (size_t)(k0 + tk) * D + e0 + te;
  *reinterpret_cast<float2*>(out) = make_float2(acc[0][0], acc[0][1]);
  *reinterpret_cast<float2*>(out + D) = make_float2(acc[1][0], acc[1][1]);
}

// The staged or (``blocked``) the blocked design's launches before the
// batch sums: the query pass, then the per-row kernel.
template <typename T>
cudaError_t launch_staged(const Args& a, cudaStream_t s, bool blocked) {
  const size_t qsmem = query_dynamic_bytes(sizeof(T) == 2, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      chain_bwd_query_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)qsmem);
  if (err != cudaSuccess) return err;
  chain_bwd_query_kernel<T><<<dim3((a.B + kQueryRows - 1) / kQueryRows, a.n),
                              kThreads, qsmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (blocked) {
    const size_t smem = ring_dynamic_bytes(sizeof(T) == 2, a.D);
    err = cudaFuncSetAttribute(chain_bwd_blocked_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    chain_bwd_blocked_kernel<T><<<a.B, kThreads, smem, s>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = staged_dynamic_bytes(sizeof(T) == 2, a.L, a.D);
  err = cudaFuncSetAttribute(chain_bwd_staged_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  chain_bwd_staged_kernel<T><<<a.B, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

constexpr int kJobs = 5;   // batch sums of the reduce pass

size_t vec_floats(int B, int D, int n) {
  return (size_t)kVecs * n * B * D;
}

// the designs, as BWD_DESIGNS orders them
enum { kStaged = 0, kBlocked = 1, kRows = 2 };

bool takes(int design, int L, int D) {
  if (design == kStaged) return staged_takes(L, D);
  if (design == kBlocked) return blocked_takes(L, D);
  return design == kRows && L >= 1 && L <= kMaxL && D >= 1 && D <= kMaxD;
}

}  // namespace

// Workspace bytes the launch needs (the same for every design, the rows
// design leaving V_Q unused; 0 for a shape the design does not take).
extern "C" long long readout_chain_bwd_workspace_bytes(int design, int B,
                                                       int L, int D, int n) {
  if (!takes(design, L, D) || B < 0 || n <= 0) return 0;
  return (long long)(vec_floats(B, D, n) + (size_t)n * B * L) *
         (long long)sizeof(float);
}

// The staged design's shared memory a block at (L, D), static and
// dynamic, in bytes (0 for a shape it does not take).
extern "C" long long readout_chain_bwd_staged_smem_bytes(int is_bf16, int L,
                                                         int D) {
  if (!staged_takes(L, D)) return 0;
  return (long long)(staged_dynamic_bytes(is_bf16 != 0, L, D) +
                     sizeof(StagedVecs));
}

// The staged design's blocks that fit on one SM at (L, D) (the occupancy
// calculator's answer, with the launch's shared memory), or the negated
// cudaError_t.
extern "C" int readout_chain_bwd_staged_blocks_per_sm(int is_bf16, int L,
                                                      int D, int device) {
  if (!staged_takes(L, D)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = staged_dynamic_bytes(is_bf16 != 0, L, D);
  const void* kernel =
      is_bf16 ? (const void*)chain_bwd_staged_kernel<__nv_bfloat16>
              : (const void*)chain_bwd_staged_kernel<float>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// The blocked design's per-row kernel's shared memory a block at (L, D),
// static and dynamic, in bytes (0 for a shape it does not take).
extern "C" long long readout_chain_bwd_blocked_smem_bytes(int is_bf16, int L,
                                                          int D) {
  if (!blocked_takes(L, D)) return 0;
  return (long long)(ring_dynamic_bytes(is_bf16 != 0, D) +
                     sizeof(BlockedVecs));
}

// The blocked design's per-row kernel's blocks that fit on one SM at (L,
// D), or the negated cudaError_t.
extern "C" int readout_chain_bwd_blocked_blocks_per_sm(int is_bf16, int L,
                                                       int D, int device) {
  if (!blocked_takes(L, D)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = ring_dynamic_bytes(is_bf16 != 0, D);
  const void* kernel =
      is_bf16 ? (const void*)chain_bwd_blocked_kernel<__nv_bfloat16>
              : (const void*)chain_bwd_blocked_kernel<float>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// design: 0 "staged" (1 <= L <= 64, D a multiple of 16 up to 128), 1
// "blocked" (64 < L <= 256, the same D; both with k, v, t, wq, dk, dv and
// dt 16-byte aligned), 2 "rows" (L <= 256, D <= 128).
// All pointers are device pointers to contiguous arrays.  g [B,D]; the
// forward's inputs after dec as in readout_chain_launch; curs [n,B,D] f32;
// the outputs ddec [B,D], dk/dv/dt [n,B,L,D], dgp [n,B,L] in the inputs'
// type (f32 with is_bf16 = 0, bf16 with 1), dwo2 [n,L], dwq [n,D,D],
// dbq/dlng/dlnb [n,D] f32; ws the workspace of
// readout_chain_bwd_workspace_bytes.  Returns the first cudaError_t of
// the launches (0 on success).
extern "C" int readout_chain_bwd_launch(
    int design, int is_bf16, const void* g, const void* klen, const void* qz,
    const void* k, const void* v, const void* t, const void* gp,
    const void* wo2, const void* wq, const void* bq, const void* lng,
    const void* lnb, const void* curs, void* ddec, void* dk, void* dv,
    void* dt, void* dgp, void* dwo2, void* dwq, void* dbq, void* dlng,
    void* dlnb, void* ws, int B, int L, int D, int n, float scale,
    int device, void* stream) {
  if (B < 0 || !takes(design, L, D) || n <= 0) return cudaErrorInvalidValue;
  if (design != kRows) {
    for (const void* p : {k, v, t, wq, (const void*)dk, (const void*)dv,
                          (const void*)dt})
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
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
    if (design != kRows)
      err = is_bf16 ? launch_staged<__nv_bfloat16>(a, s, design == kBlocked)
                    : launch_staged<float>(a, s, design == kBlocked);
    else if (is_bf16)
      chain_bwd_rows_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(a);
    else
      chain_bwd_rows_kernel<float><<<B, kThreads, 0, s>>>(a);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
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
  if (design == kRows) return readout::batch_sums(jobs, kJobs, s);
  // the staged and blocked designs: dwq, the one sum that is a product, by its own
  // kernel (a tile a block; D is a multiple of 16), the other four as the
  // rows design sums them
  if ((err = readout::batch_sums(jobs, kJobs - 1, s)) != cudaSuccess)
    return err;
  const int tiles = D / kDwqTile;
  chain_bwd_dwq_kernel<<<dim3(tiles * tiles, n), kDwqThreads, 0, s>>>(
      vec, static_cast<float*>(dwq), B, D, n);
  return cudaGetLastError();
}
