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
// What bounds it: operations.  Per hop the K and V projections, dmem's
// two products and dWk's and dWv's are 12 L D^2 FLOPs a row: at B=64,
// L=512, D=128 and 3 hops, 19.3 GFLOP against some 10 MB of operands.
//
// Two designs, chosen by the caller; neither uses float atomics, so the
// same inputs give the same bits.
//
// "gemm" (the default).  K_i = relu(mem Wk_i + bk_i) and V_i do not
// depend on the hop's query, and the cotangents dk_pre and dv_pre feed
// nothing on the chain from hop to hop (hop i-1's cotangent needs only
// the residual, du Wt^T and dq_pre Wq^T).  So only O(L D) vector work is
// left to run row by row, and every [L,D] x [D,D] product becomes one
// matrix product over all B*L keys on every SM (tile_gemm.cuh: tensor
// cores in bf16, register-tiled FMA in f32).  Five launches:
//  1. proj (readout_gemm.cuh, shared with the forward): KV = relu(mem
//     [B*L, D] @ [Wk_0 .. Wk_n-1, Wv_0 .. Wv_n-1] + bias), M = B*L, N =
//     2nD, K = D, rounded to T into the workspace [2, n, B, L, D].
//  2. chain: one block of 256 threads a row.  It replays the hops' query
//     chain from K and V (q, u, the scores q.K_l and u.mem_l, gate,
//     softmax, o, LN), keeping each hop's per-key terms in an f32 cache,
//     then runs the reverse sweep up to ddec_in and overwrites K and V
//     with dk_pre and dv_pre rounded to T, zero past the live keys (dk)
//     and past the reached keys (dv), so the products below need no key
//     mask.  dpre_tqk [n, B, L] and u [n, B, D] go to f32 workspaces.
//  3. dmem: dmem [B*L, D] = sum over the 2n planes of dpre_j @ W_j^T (K =
//     2nD, plane by plane) + sum_i dpre_tqk_i u_i in the epilogue.
//  4. dw: dW_j = mem^T @ dpre_j for the 2n planes, the B*L keys split in
//     groups that fill the card; each group's partial is written.
//  5. reduce: every batch sum, as below.
//
// "rows" (the first design, kept for comparison):
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

#include "readout_gemm.cuh"

namespace {

using readout::Cols;
using readout::combine_pairs;
using readout::HopSmem;
using readout::kChunk;
using readout::kProductBlocks;
using readout::kThreads;
using readout::kWarps;
using readout::launch_product;
using readout::load2;
using readout::Params;
using readout::ProjGemm;
using readout::readout_proj_kernel;
using readout::row_dots;
using readout::store2;
using readout::tile_product;
using readout::weighted_sums;

constexpr int kGroups = 8;     // row groups of the wgrad kernel
constexpr int kTile = 64;      // wgrad output tile (kTile x kTile)
constexpr int kStage = 32;     // keys staged at once by the wgrad kernel
constexpr int kMaxJobs = 16;   // batch sums of the reduce kernel (14 used)
// per-row f32 vectors [kVecs, n, B, D]: the rounded hop input, rounded
// dq_pre, rounded du, then f32 dq_pre, dbk and dbv partials, g xh, g
enum { V_DECR = 0, V_DQR, V_DUR, V_DQ, V_DBK, V_DBV, V_LNG, V_LNB, kVecs };

// the designs, in the order of the C interface's `design`
enum { DESIGN_GEMM = 0, DESIGN_ROWS, kDesigns };
// the gemm design's per-key f32 cache of the forward replay [kCache, n,
// B, L]: q . K_l, tqk, decay, sigmoid(gate), the softmax weight
enum { C_S0 = 0, C_TQK, C_DCY, C_SIG, C_W, kCache };
// blocks that fill the card: two on each of the H100's 132 SMs
constexpr int kFillBlocks = 264;

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

int groups(int B) { return B < kGroups ? B : kGroups; }

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// key groups of the gemm design's dw product (0 when there is no key):
// enough blocks to fill the card, each group at least 4 slabs of keys
int gemm_groups(long long M, int D, int n) {
  if (M <= 0) return 0;
  const int blocks = 2 * n * cdiv(D, tile::kBM) * cdiv(D, tile::kBN);
  const int fill = cdiv(kFillBlocks, blocks);
  const int most = cdiv(M, 4 * tile::kBK);
  return fill < most ? fill : most;
}

struct WsLayout {
  size_t kv, vec, gate, part, cache, dpt, u, total;   // byte offsets
  int G;                                              // groups of part
};

WsLayout layout(int B, int L, int D, int n, size_t t_size, int design) {
  const size_t nBL = (size_t)n * B * L, nBD = (size_t)n * B * D;
  const bool gemm = design == DESIGN_GEMM;
  WsLayout w;
  w.G = gemm ? gemm_groups((long long)B * L, D, n) : groups(B);
  w.kv = 0;
  w.vec = align_up(2 * nBL * D * t_size);
  w.gate = w.vec + align_up((size_t)kVecs * nBD * sizeof(float));
  w.part = w.gate + align_up(5 * nBL * sizeof(float));
  w.cache = w.part + align_up((size_t)w.G * 2 * n * D * D * sizeof(float));
  w.dpt = w.cache + (gemm ? align_up(kCache * nBL * sizeof(float)) : 0);
  w.u = w.dpt + (gemm ? align_up(nBL * sizeof(float)) : 0);
  w.total = w.u + (gemm ? align_up(nBD * sizeof(float)) : 0);
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

// ------------------------------------------------------------ design "gemm"

size_t chain_smem_floats(int L, int D, int n) {
  return 4 * (size_t)L + (5 * (size_t)n + 6) * D;
}

// relu's gradients written over its outputs, for every key c < L:
//   K[c, e] = round_T(v), v = c < live && K[c, e] > 0 ? ds0[c] q[e] : 0
//   V[c, e] = round_T(v), v = c < span && V[c, e] > 0 ? w[c] dov[e] : 0
// out = the columns' sums of v (dbk, dbv) for threadIdx.x < D.
template <int D, typename T>
__device__ __forceinline__ void relu_grads(T* K, int live, const float* ds0,
                                           const float* q, T* V, int span,
                                           const float* w, const float* dov,
                                           int L, float* scratch,
                                           float (&out)[2]) {
  constexpr int U = 4, G = Cols<D>::kGroups;
  const int e = 2 * (threadIdx.x % Cols<D>::kHalf);
  const float q0 = q[e], q1 = q[e + 1], d0 = dov[e], d1 = dov[e + 1];
  float2 sum[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  for (int c = threadIdx.x / Cols<D>::kHalf; c < L; c += U * G) {
    float2 kk[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cu = c + u * G;
      kk[u] = cu < live ? load2(K + (size_t)cu * D + e)
                        : make_float2(0.f, 0.f);
      vv[u] = cu < span ? load2(V + (size_t)cu * D + e)
                        : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cu = c + u * G;
      if (cu >= L) break;
      const float rk = cu < live ? ds0[cu] : 0.f;
      const float rv = cu < span ? w[cu] : 0.f;
      const float k0 = kk[u].x > 0.f ? rk * q0 : 0.f;
      const float k1 = kk[u].y > 0.f ? rk * q1 : 0.f;
      const float v0 = vv[u].x > 0.f ? rv * d0 : 0.f;
      const float v1 = vv[u].y > 0.f ? rv * d1 : 0.f;
      sum[0].x += k0;
      sum[0].y += k1;
      sum[1].x += v0;
      sum[1].y += v1;
      store2(K + (size_t)cu * D + e, port::round_to<T>(k0),
             port::round_to<T>(k1));
      store2(V + (size_t)cu * D + e, port::round_to<T>(v0),
             port::round_to<T>(v1));
    }
  }
  combine_pairs<D, 2>(sum, scratch, out);
}

// mean and 1/sqrt(var + eps) of x over the first dl threads, the live
// lanes (a padded lane's x is 0)
__device__ __forceinline__ float2 ln_stats(float x, float* red, int dl) {
  const float mean = port::block_sum<kThreads>(x, red) / dl;
  const float xm = threadIdx.x < dl ? x - mean : 0.f;
  const float var = port::block_sum<kThreads>(xm * xm, red) / dl;
  return make_float2(mean, 1.f / sqrtf(var + readout::kLnEps));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) readout_bwd_chain_kernel(
    Params p, const float* __restrict__ g_in, T* __restrict__ kv,
    float* __restrict__ vec, float* __restrict__ gate_ws,
    float* __restrict__ cache, float* __restrict__ dpt_ws,
    float* __restrict__ u_ws, float* __restrict__ ddec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  __shared__ float scratch[4 * kThreads];
  const int L = p.L, n = p.n, B = p.B, b = blockIdx.x;
  const int tid = threadIdx.x;
  float* s_w = smem;               // [L] scores, then softmax weights
  float* s_dw = s_w + L;           // [L] do . V_l
  float* s_ds0 = s_dw + L;
  float* s_dpt = s_ds0 + L;        // dpre_tqk
  float* s_dec = s_dpt + L;        // [n, D] each hop's input query
  float* s_decr = s_dec + n * D;   // [n, D] ... rounded to T
  float* s_q = s_decr + n * D;     // [n, D]
  float* s_u = s_q + n * D;        // [n, D]
  float* s_o = s_u + n * D;        // [n, D] sum_l w_l V_l
  float* s_g = s_o + n * D;        // cotangent of the hop's output
  float* s_do = s_g + D;
  float* s_dur = s_do + D;
  float* s_dqr = s_dur + D;
  float* s_at = s_dqr + D;         // du_c Wt^T
  float* s_aq = s_at + D;          // dq_pre_c Wq^T

  const int live = readout::live_keys(p, b);
  const int span = readout::span_keys(live, L);
  const T* mem = readout::ptr<T>(p.mem) + (size_t)b * L * D;
  const size_t M = (size_t)B * L;
  auto kbuf = [&](int i) { return kv + ((size_t)i * M + (size_t)b * L) * D; };
  auto vbuf = [&](int i) {
    return kv + ((size_t)(n + i) * M + (size_t)b * L) * D;
  };
  auto vslot = [&](int slot, int i) {
    return vec + (((size_t)slot * n + i) * B + b) * D;
  };
  auto cslot = [&](int slot, int i) {
    return cache + (((size_t)slot * n + i) * B + b) * L;
  };
  const size_t gplane = (size_t)n * B * L;
  const float qz = p.qmask[b];

  // ---- forward replay of the query chain (K and V from the workspace)
  readout::load_f32(s_dec, readout::ptr<T>(p.dec) + (size_t)b * D, D);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const float* dec = s_dec + i * D;
    HopSmem sm;                    // this hop's slots, for query_side
    sm.dec = s_dec + i * D;
    sm.decr = s_decr + i * D;
    sm.q = s_q + i * D;
    sm.u = s_u + i * D;
    readout::query_side<T>(p, i, sm);
    float* c_s0 = cslot(C_S0, i);
    float* c_tqk = cslot(C_TQK, i);
    float* c_dcy = cslot(C_DCY, i);
    float* c_sig = cslot(C_SIG, i);
    float* c_w = cslot(C_W, i);
    // q . K_l and u . mem_l of the live keys (into s_ds0, s_dw for now),
    // then their gate terms and scores
    row_dots<D, 2>(s_q + i * D, static_cast<const T*>(kbuf(i)), s_u + i * D,
                   mem, live, [&](int c, float a, float t) {
                     s_ds0[c] = a;
                     s_dw[c] = t;
                   });
    __syncthreads();
    for (int c = tid; c < L; c += kThreads) {
      if (c < live) {
        const float a = s_ds0[c];
        const readout::GateTerms gt = readout::gate_terms(p, i, b, c, s_dw[c]);
        c_s0[c] = a;
        c_tqk[c] = gt.tqk;
        c_dcy[c] = gt.decay;
        c_sig[c] = gt.sig;
        s_w[c] = a * gt.sig * p.scale;
      } else {
        s_w[c] = readout::kNegFill;
        c_s0[c] = c_tqk[c] = c_dcy[c] = c_sig[c] = 0.f;
      }
    }
    __syncthreads();
    readout::softmax_inplace(s_w, L, red);
    for (int c = tid; c < L; c += kThreads) c_w[c] = s_w[c];
    float o[1];
    weighted_sums<D, 1>(s_w, static_cast<const T*>(vbuf(i)), s_w,
                        static_cast<const T*>(vbuf(i)), span, scratch, o);
    if (tid < D) s_o[i * D + tid] = o[0];
    if (i + 1 < n) {   // residual + normalize: the next hop's query
      const float x = tid < D ? o[0] * qz + dec[tid] : 0.f;
      const float2 st = ln_stats(x, red, p.dl);
      const float xh = tid < p.dl ? (x - st.x) * st.y : 0.f;
      if (tid < D)
        s_dec[(i + 1) * D + tid] =
            xh * port::to_float(readout::ptr<T>(p.lng)[i * D + tid]) +
            port::to_float(readout::ptr<T>(p.lnb)[i * D + tid]);
    }
    __syncthreads();
  }
  for (int e = tid; e < D; e += kThreads) s_g[e] = g_in[(size_t)b * D + e];

  // ---- reverse sweep up to ddec_in
  for (int i = n - 1; i >= 0; --i) {
    T* K = kbuf(i);
    T* V = vbuf(i);
    const float* dec = s_dec + i * D;
    const float* q = s_q + i * D;
    const float* c_w = cslot(C_W, i);
    const float* c_s0 = cslot(C_S0, i);
    const float* c_tqk = cslot(C_TQK, i);
    const float* c_dcy = cslot(C_DCY, i);
    const float* c_sig = cslot(C_SIG, i);
    for (int c = tid; c < L; c += kThreads) s_w[c] = c_w[c];
    __syncthreads();

    // the LN backward (thread e: column e; the dl live lanes)
    const float x = tid < D ? s_o[i * D + tid] * qz + dec[tid] : 0.f;
    const float2 st = ln_stats(x, red, p.dl);
    const float xh = tid < p.dl ? (x - st.x) * st.y : 0.f;
    const float g = tid < D ? s_g[tid] : 0.f;
    const float gamma =
        tid < D ? port::to_float(readout::ptr<T>(p.lng)[i * D + tid]) : 0.f;
    if (tid < D) {
      vslot(V_LNG, i)[tid] = g * xh;
      vslot(V_LNB, i)[tid] = g;
    }
    const float dxh = g * gamma;
    const float m1 = port::block_sum<kThreads>(dxh, red) / p.dl;
    const float m2 = port::block_sum<kThreads>(dxh * xh, red) / p.dl;
    const float dx = tid < p.dl ? (dxh - m1 - xh * m2) * st.y : 0.f;
    float dd = dx;                 // the residual branch of ddec_in
    if (tid < D) s_do[tid] = dx * qz;
    __syncthreads();

    // weighted-sum and softmax backward
    row_dots<D, 1>(s_do, static_cast<const T*>(V), s_do,
                   static_cast<const T*>(V), span,
                   [&](int c, float a, float) { s_dw[c] = a; });
    __syncthreads();
    float part = 0.f;
    for (int c = tid; c < span; c += kThreads) part += s_dw[c] * s_w[c];
    const float dsum = port::block_sum<kThreads>(part, red);
    for (int c = tid; c < L; c += kThreads) {
      const float ds = c < live ? s_w[c] * (s_dw[c] - dsum) : 0.f;
      const float sig = c_sig[c], dcy = c_dcy[c], tqk = c_tqk[c];
      const float dgate = ds * c_s0[c] * p.scale * sig * (1.f - sig);
      const size_t gi = (size_t)i * L + c;
      const float dpre_dec = dgate * p.wo1[gi] * (1.f - dcy * dcy);
      float* gw = gate_ws + ((size_t)i * B + b) * L + c;
      gw[0] = dpre_dec * p.logdt[(size_t)b * L + c];
      gw[gplane] = dpre_dec;
      gw[2 * gplane] = dgate * dcy;
      gw[3 * gplane] = dgate * tqk;
      gw[4 * gplane] = dgate;
      s_ds0[c] = ds * sig * p.scale;
      const float dpt = dgate * p.wo2[gi] * (1.f - tqk * tqk);
      s_dpt[c] = dpt;
      dpt_ws[((size_t)i * B + b) * L + c] = dpt;
    }
    __syncthreads();

    // du and dq (masked keys carry 0), then the query side of ddec_in
    float dudq[2];
    weighted_sums<D, 2>(s_dpt, mem, s_ds0, static_cast<const T*>(K), live,
                        scratch, dudq);
    if (tid < D) {
      const float dq_pre = q[tid] > 0.f ? dudq[1] : 0.f;
      s_dqr[tid] = port::round_to<T>(dq_pre);
      s_dur[tid] = port::round_to<T>(dudq[0]);
      vslot(V_DECR, i)[tid] = s_decr[i * D + tid];
      vslot(V_DQR, i)[tid] = s_dqr[tid];
      vslot(V_DUR, i)[tid] = s_dur[tid];
      vslot(V_DQ, i)[tid] = dq_pre;
      u_ws[((size_t)i * B + b) * D + tid] = s_u[i * D + tid];
    }
    __syncthreads();
    const size_t wo = (size_t)i * D * D;
    row_dots<D, 2>(s_dur, readout::ptr<T>(p.wt) + wo, s_dqr,
                   readout::ptr<T>(p.wq) + wo, D,
                   [&](int e, float at, float aq) {
                     s_at[e] = at;
                     s_aq[e] = aq;
                   });
    __syncthreads();
    if (tid < D) {
      dd += s_at[tid];
      dd += s_aq[tid];
    }

    // dk_pre over the live keys, dv_pre over the reached ones, in place
    float dbias[2];
    relu_grads<D>(K, live, s_ds0, q, V, span, s_w, s_do, L, scratch, dbias);
    if (tid < D) {
      vslot(V_DBK, i)[tid] = dbias[0];
      vslot(V_DBV, i)[tid] = dbias[1];
      s_g[tid] = dd;
    }
    __syncthreads();
  }
  for (int e = tid; e < D; e += kThreads) ddec[(size_t)b * D + e] = s_g[e];
}

template <typename T, int D>
cudaError_t launch_chain(const Params& p, const float* g, T* kv, float* vec,
                         float* gate, float* cache, float* dpt, float* u,
                         float* ddec, cudaStream_t stream) {
  const size_t smem = chain_smem_floats(p.L, D, p.n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      readout_bwd_chain_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  readout_bwd_chain_kernel<T, D><<<p.B, kThreads, smem, stream>>>(
      p, g, kv, vec, gate, cache, dpt, u, ddec);
  return cudaGetLastError();
}

// The design's other two products, as tile_gemm.cuh's problems (proj's
// is readout_gemm.cuh's ProjGemm).  Rows past M and columns past N read
// zeros and are not written.

// dmem[m, c] = sum_j dpre_j[m] . W_j[c, :] (the 2n planes in order) +
// sum_i dpre_tqk_i[m] u_i[row of m, c]
template <typename T>
struct DmemGemm {
  using Elem = T;
  static constexpr bool A_KMAJOR = false, B_KMAJOR = false;
  const T *kv, *wk, *wv;
  const float *dpt, *u;
  float* dmem;
  int M, L, D, n, B;
  __device__ int m0() const { return blockIdx.x * tile::kBM; }
  __device__ int n0() const { return blockIdx.y * tile::kBN; }
  __device__ int slabs() const { return 2 * n * D / tile::kBK; }
  __device__ int k0(int s) const { return s * tile::kBK; }
  __device__ const T* a_at(int m, int k, bool& ok) const {
    ok = m < M;
    return kv + ((size_t)(k / D) * M + (ok ? m : 0)) * D + k % D;
  }
  __device__ const T* b_at(int k, int c, bool& ok) const {
    ok = c < D;
    const int j = k / D;
    const T* w = j < n ? wk + (size_t)j * D * D : wv + (size_t)(j - n) * D * D;
    return w + (size_t)(ok ? c : 0) * D + k % D;
  }
  __device__ void epi(int m, int c, float v0, float v1) const {
    if (m >= M || c >= D) return;
    const int b = m / L;
    for (int i = 0; i < n; ++i) {
      const float d = dpt[(size_t)i * M + m];
      const float* ui = u + ((size_t)i * B + b) * D + c;
      v0 = fmaf(d, ui[0], v0);
      v1 = fmaf(d, ui[1], v1);
    }
    store2(dmem + (size_t)m * D + c, v0, v1);
  }
};

// dw: part[g, j, k, e] = sum over the keys m of group g of mem[m, k]
// dpre_j[m, e]; block (tile, j, g)
template <typename T>
struct DwGemm {
  using Elem = T;
  static constexpr bool A_KMAJOR = true, B_KMAJOR = true;
  const T *mem, *kv;
  float* part;
  int M, D, n, G;
  __device__ int tiles() const { return (D + tile::kBN - 1) / tile::kBN; }
  __device__ int lo() const { return (int)((long long)blockIdx.z * M / G); }
  __device__ int hi() const {
    return (int)((long long)(blockIdx.z + 1) * M / G);
  }
  __device__ int m0() const { return (blockIdx.x / tiles()) * tile::kBM; }
  __device__ int n0() const { return (blockIdx.x % tiles()) * tile::kBN; }
  __device__ int slabs() const {
    return (hi() - lo() + tile::kBK - 1) / tile::kBK;
  }
  __device__ int k0(int s) const { return lo() + s * tile::kBK; }
  __device__ const T* a_at(int k, int key, bool& ok) const {
    ok = key < hi() && k < D;
    return mem + (size_t)(ok ? key : lo()) * D + (ok ? k : 0);
  }
  __device__ const T* b_at(int key, int e, bool& ok) const {
    ok = key < hi() && e < D;
    return kv + ((size_t)blockIdx.y * M + (ok ? key : lo())) * D +
           (ok ? e : 0);
  }
  __device__ void epi(int k, int e, float v0, float v1) const {
    if (k >= D || e >= D) return;
    store2(part + (((size_t)blockIdx.z * 2 * n + blockIdx.y) * D + k) * D + e,
           v0, v1);
  }
};

template <typename T>
__global__ void __launch_bounds__(tile::kThreads, kProductBlocks<T>)
    readout_bwd_dmem_kernel(const DmemGemm<T> p) {
  tile_product(p);
}
template <typename T>
__global__ void __launch_bounds__(tile::kThreads, kProductBlocks<T>)
    readout_bwd_dw_kernel(const DwGemm<T> p) {
  tile_product(p);
}

struct Outs {
  float *dmem, *ddec, *dwq, *dbq, *dwk, *dbk, *dwv, *dbv, *dwt;
  float* gates[5];   // dw1, db1, dwo1, dwo2, dbo
  float *dlng, *dlnb;
};

// the batch sums both designs end with: part holds G groups' dWk and dWv
cudaError_t reduce(const Params& p, const Outs& o, const float* vec,
                   const float* gate, const float* part, int G,
                   cudaStream_t stream) {
  const int B = p.B, L = p.L, D = p.D, n = p.n;
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
  // dWk, dWv: the groups' partials (none when B = 0)
  jobs.job[nj++] = {part, nullptr, o.dwk, 0, 2 * nDD, 1, G, (int)nDD, D};
  jobs.job[nj++] = {part + nDD, nullptr, o.dwv, 0, 2 * nDD, 1, G, (int)nDD, D};
  return readout::batch_sums(jobs, nj, stream);
}

template <typename T>
cudaError_t run_rows(const Params& p, const float* g, const Outs& o, void* ws,
                     cudaStream_t stream) {
  const int B = p.B, L = p.L, D = p.D, n = p.n;
  const WsLayout w = layout(B, L, D, n, sizeof(T), DESIGN_ROWS);
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
    readout_bwd_wgrad_kernel<T><<<dim3(tiles * tiles, 2 * n, w.G), 256, 0,
                                  stream>>>(
        static_cast<const T*>(p.mem), p.key_len, kv, part, B, L, D, n, w.G);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return reduce(p, o, vec, gate, part, w.G, stream);
}

template <typename T>
cudaError_t run_gemm(const Params& p, const float* g, const Outs& o, void* ws,
                     cudaStream_t stream) {
  const int B = p.B, L = p.L, D = p.D, n = p.n, M = B * L;
  const WsLayout w = layout(B, L, D, n, sizeof(T), DESIGN_GEMM);
  char* base = static_cast<char*>(ws);
  T* kv = reinterpret_cast<T*>(base + w.kv);
  float* vec = reinterpret_cast<float*>(base + w.vec);
  float* gate = reinterpret_cast<float*>(base + w.gate);
  float* part = reinterpret_cast<float*>(base + w.part);
  float* cache = reinterpret_cast<float*>(base + w.cache);
  float* dpt = reinterpret_cast<float*>(base + w.dpt);
  float* u = reinterpret_cast<float*>(base + w.u);
  const T* mem = static_cast<const T*>(p.mem);
  const T* wk = static_cast<const T*>(p.wk);
  const T* wv = static_cast<const T*>(p.wv);
  cudaError_t err;
  if (B > 0) {
    const int mt = cdiv(M, tile::kBM);
    err = launch_product<T>(
        readout_proj_kernel<T>, dim3(mt, cdiv(2 * n * D, tile::kBN)),
        ProjGemm<T>{mem, wk, wv, static_cast<const T*>(p.bk),
                    static_cast<const T*>(p.bv), kv, M, D, n},
        stream);
    if (err != cudaSuccess) return err;
    switch (D) {
      case 32:
        err = launch_chain<T, 32>(p, g, kv, vec, gate, cache, dpt, u, o.ddec,
                                  stream);
        break;
      case 64:
        err = launch_chain<T, 64>(p, g, kv, vec, gate, cache, dpt, u, o.ddec,
                                  stream);
        break;
      case 128:
        err = launch_chain<T, 128>(p, g, kv, vec, gate, cache, dpt, u, o.ddec,
                                   stream);
        break;
      default:
        err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    err = launch_product<T>(
        readout_bwd_dmem_kernel<T>, dim3(mt, cdiv(D, tile::kBN)),
        DmemGemm<T>{kv, wk, wv, dpt, u, o.dmem, M, L, D, n, B}, stream);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(D, tile::kBM) * cdiv(D, tile::kBN);
    err = launch_product<T>(readout_bwd_dw_kernel<T>,
                            dim3(tiles, 2 * n, w.G),
                            DwGemm<T>{mem, kv, part, M, D, n, w.G}, stream);
    if (err != cudaSuccess) return err;
  }
  return reduce(p, o, vec, gate, part, w.G, stream);
}

}  // namespace

// The most dynamic shared memory one of the design's kernels takes, in
// bytes (design: 0 "gemm", 1 "rows"; -1 for another value).
extern "C" long long fused_readout_bwd_smem_bytes(int L, int D, int n,
                                                  int design) {
  if (design == DESIGN_ROWS)
    return (long long)(rows_smem_floats(L, D, n) * sizeof(float));
  if (design != DESIGN_GEMM) return -1;
  const size_t chain = chain_smem_floats(L, D, n) * sizeof(float);
  const size_t most = tile::fma_smem_bytes() > tile::mma_smem_bytes()
                          ? tile::fma_smem_bytes() : tile::mma_smem_bytes();
  return (long long)(chain > most ? chain : most);
}

// Workspace bytes the launch needs.
extern "C" long long fused_readout_bwd_workspace_bytes(int B, int L, int D,
                                                       int n, int is_bf16,
                                                       int design) {
  return (long long)layout(B, L, D, n, is_bf16 ? 2 : 4, design).total;
}

// All pointers are device pointers to contiguous arrays.  g [B,D] f32; the
// forward's inputs as in fused_readout_launch; the f32 outputs dmem
// [B,L,D], ddec [B,D], dwq/dwk/dwv/dwt [n,D,D], dbq/dbk/dbv/dlng/dlnb
// [n,D], dw1/db1/dwo1/dwo2/dbo [n,L]; ws the workspace of
// fused_readout_bwd_workspace_bytes; dl the live width (1 <= dl <= D,
// the operands and g zero-padded past it; dl == D in the rows design);
// design 0 "gemm", 1 "rows".  Returns the first cudaError_t of the
// launches (0 on success).
extern "C" int fused_readout_bwd_launch(
    int is_bf16, int design, const void* g, const void* mem, const void* dec,
    const void* logdt, const void* key_len, const void* qmask, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* wt, const void* w1, const void* b1,
    const void* wo1, const void* wo2, const void* bo, const void* lng,
    const void* lnb, void* dmem, void* ddec, void* dwq, void* dbq, void* dwk,
    void* dbk, void* dwv, void* dbv, void* dwt, void* dw1, void* db1,
    void* dwo1, void* dwo2, void* dbo, void* dlng, void* dlnb, void* ws,
    int B, int L, int D, int n, int dl, float scale, int device,
    void* stream) {
  if (B < 0 || L <= 0 || n <= 0 || D <= 0 || D > readout::kMaxD || D % 32 ||
      design < 0 || design >= kDesigns ||
      (design == DESIGN_GEMM && D != 32 && D != 64 && D != 128) ||
      dl < 1 || dl > D || (design == DESIGN_ROWS && dl != D))
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
  p.B = B; p.L = L; p.D = D; p.n = n; p.dl = dl;
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
  if (design == DESIGN_ROWS)
    return is_bf16 ? run_rows<__nv_bfloat16>(p, gp, o, ws, s)
                   : run_rows<float>(p, gp, o, ws, s);
  return is_bf16 ? run_gemm<__nv_bfloat16>(p, gp, o, ws, s)
                 : run_gemm<float>(p, gp, o, ws, s);
}
