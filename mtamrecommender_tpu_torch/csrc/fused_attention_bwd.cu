// Backward of the fused attention middle (fused_attention.cu), single tile.
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py,
// _attn_bwd_kernel (launched by _fused_attention_bwd, the backward of
// fused_attention's custom_vjp), in all five modes: plain, time, tisas,
// plain_drop and tisas_drop.  Given the f32 cotangent g of the output, it
// recomputes the scores, the time gate and the softmax from the inputs and
// returns, all f32:
//   dv    = dropped^T g                  dropped = w (x dm in *_drop)
//   dwei  = g v^T (x dm in *_drop)       D_i = sum_c dwei_ic w_ic
//   ds    = w (dwei - D), 0 at masked keys (the jnp reference's where)
//   time:  dsig = ds s0 scale, ds0 = ds sig scale,
//          dgate = dsig sig (1-sig), dpre_dec = dgate wo1 (1-decay^2),
//          dpre_tqk = dgate wo2 (1-time_qk^2)
//          dtqw = dpre_tqk rawk, drawk = dpre_tqk^T tqw,
//          dw1 = sum_b dpre_dec logdt, db1 = sum_b dpre_dec,
//          dwo1 = sum_b dgate decay, dwo2 = sum_b dgate time_qk,
//          dbo = sum_b dgate
//   else:  ds0 = ds scale; the output does not depend on tqw, rawk or the
//          gate params, so dtqw, drawk and the gate gradients are neither
//          computed nor written (their pointers may be null)
//   dq = ds0 k, dk = ds0^T q
// Every product operand is rounded to the input type (f32 or bf16) where
// the Pallas kernel calls .astype(in_dtype): g, dropped, ds0, dpre_tqk;
// every product sums in f32.  dm is f32 in both precisions.
//
// What bounds it: at the training shapes (B=256, Tq=Tk=50, d=128), the
// bytes: the f32 outputs (5 [B, L, d] arrays in time mode, 3 in the
// others) outweigh up to 8 products of 2d FLOPs per live (b, i, c);
// att_bwd_bound in chip_smoke.py counts both from a run's inputs.
//
// Design (three kernels, no float atomics, so the same inputs give the
// same bits):
//  1. rows: one block per (b, i), as the forward.  Warps score four keys
//     at a time (q.k, tqw.rawk, g.v, lane-strided over d, summed with
//     shuffles; masked keys are never read), the softmax and D_i are
//     block reductions, then each thread takes keys and writes the
//     rounded dropped weight, ds0 and dpre_tqk, and the five gate terms,
//     into a per-(b, i, c) workspace; dq_i and dtqw_i are summed from
//     shared memory, one thread per column.
//  2. keys: one block per (b, 16 keys, 128 columns) sums dv, dk and drawk
//     over the queries from the workspace, 32 queries staged at a time.
//  3. gates (time mode): one thread per gate-gradient element sums the
//     workspace over the batch rows in order.
// The workspace holds 2 (8 in time mode) floats per (b, i, c); batches
// whose workspace would pass 2^25 floats run in chunks of rows, and the
// gate sums of later chunks add to the earlier ones in order.

#include "common.cuh"

namespace {

// the Python wrapper's MODES order
enum { ATT_PLAIN = 0, ATT_TIME = 1, ATT_TISAS = 2, ATT_PLAIN_DROP = 3,
       ATT_TISAS_DROP = 4 };
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 4;          // keys a warp scores at once (rows kernel)
constexpr int kKeyTile = 16;      // keys a block owns (keys kernel)
constexpr int kQueryChunk = 32;   // queries staged at once (keys kernel)
constexpr long long kWorkspaceCap = 1LL << 25;   // floats
constexpr float kNegFill = -4294967295.0f;       // -(2^32) + 1

struct GateGrads {
  float* out[5];  // dw1, db1, dwo1, dwo2, dbo, each [Tq, Tk]
};

struct BwdArgs {
  const float* g;
  const void *q, *k, *v, *t_q, *t_k, *tqw, *rawk, *w1, *b1, *wo1, *wo2, *bo;
  const int* key_len;
  const float* dm;
  float *dq, *dk, *dv, *dtqw, *drawk;
  GateGrads gates;
  float* ws;
  int B, Tq, Tk, D;
  float scale;
  cudaStream_t stream;
};

long long rows_per_chunk(bool time, int B, int Tq, int Tk) {
  const long long per_row = (long long)Tq * Tk * (time ? 8 : 2);
  long long rows = kWorkspaceCap / per_row;
  if (rows < 1) rows = 1;
  return rows < B ? rows : B;
}

// MODE is the base mode (plain, time or tisas); DROP applies dm.
template <typename T, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads) attn_bwd_rows_kernel(
    const float* __restrict__ g, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ t_q, const T* __restrict__ t_k,
    const T* __restrict__ tqw, const T* __restrict__ rawk,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ wo1, const T* __restrict__ wo2,
    const T* __restrict__ bo, const int* __restrict__ key_len,
    const float* __restrict__ dm, float* __restrict__ dq,
    float* __restrict__ dtqw, float* __restrict__ p_ws,
    float* __restrict__ ds0_ws, float* __restrict__ dpt_ws,
    float* __restrict__ gate_ws, int b0, int n_rows, int Tq, int Tk, int D,
    float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;          // [D] q_i
  float* s_tqw = s_q + D;     // [D] tqw_i
  float* s_g = s_tqw + D;     // [D] g_i rounded to T
  float* s_p = s_g + D;       // [Tk] scores, then softmax weights
  float* s_s0 = s_p + Tk;     // [Tk] q_i.k_c, then ds0 rounded to T
  float* s_tqk = s_s0 + Tk;   // [Tk] time_qk, then dpre_tqk rounded to T
  float* s_sig = s_tqk + Tk;  // [Tk] sigmoid(gate)
  float* s_dec = s_sig + Tk;  // [Tk] decay
  float* s_ldt = s_dec + Tk;  // [Tk] log1p|t_q - t_k|
  float* s_dw = s_ldt + Tk;   // [Tk] dwei (x dm)
  __shared__ float s_red[kWarps];

  const int lrow = blockIdx.x;  // (b - b0) * Tq + i
  const int b = b0 + lrow / Tq, i = lrow % Tq;
  const size_t row = (size_t)b * Tq + i;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < D; e += kThreads) {
    s_q[e] = port::to_float(q[row * D + e]);
    s_g[e] = port::round_to<T>(g[row * D + e]);
    if (MODE == ATT_TIME) s_tqw[e] = port::to_float(tqw[row * D + e]);
  }
  const int live = max(0, min(key_len[b], Tk));  // keys with c < key_len
  const float tq = MODE == ATT_PLAIN ? 0.f : port::to_float(t_q[row]);
  const T* kb = k + (size_t)b * Tk * D;
  const T* vb = v + (size_t)b * Tk * D;
  const T* rkb = rawk + (size_t)b * Tk * D;
  __syncthreads();

  for (int c0 = warp * kKeys; c0 < Tk; c0 += kWarps * kKeys) {
    float acc_s[kKeys], acc_t[kKeys], acc_w[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) acc_s[u] = acc_t[u] = acc_w[u] = 0.f;
#pragma unroll 4
    for (int e = lane; e < D; e += 32) {
      const float qe = s_q[e], ge = s_g[e];
      const float te = MODE == ATT_TIME ? s_tqw[e] : 0.f;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int c = c0 + u;
        if (c < live) {
          const size_t off = (size_t)c * D + e;
          acc_s[u] = fmaf(qe, port::to_float(kb[off]), acc_s[u]);
          acc_w[u] = fmaf(ge, port::to_float(vb[off]), acc_w[u]);
          if (MODE == ATT_TIME)
            acc_t[u] = fmaf(te, port::to_float(rkb[off]), acc_t[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int c = c0 + u;
      if (c >= Tk) break;
      float s = kNegFill, s0 = 0.f, tqk = 0.f, sig = 0.f, dec = 0.f,
            ldt = 0.f, dw = 0.f;
      if (c < live) {
        s0 = port::warp_sum(acc_s[u]);
        dw = port::warp_sum(acc_w[u]);
        if (DROP) dw *= dm[row * Tk + c];
        if (MODE == ATT_TIME) {
          tqk = tanhf(port::warp_sum(acc_t[u]));
          const int gi = i * Tk + c;
          ldt = log1pf(fabsf(tq - port::to_float(t_k[(size_t)b * Tk + c])));
          dec = tanhf(ldt * port::to_float(w1[gi]) + port::to_float(b1[gi]));
          sig = port::sigmoid(port::to_float(wo1[gi]) * dec +
                              port::to_float(wo2[gi]) * tqk +
                              port::to_float(bo[gi]));
          s = s0 * sig * scale;
        } else if (MODE == ATT_TISAS) {
          ldt = log1pf(fabsf(tq - port::to_float(t_k[(size_t)b * Tk + c])));
          s = (s0 + ldt) * scale;
        } else {
          s = s0 * scale;
        }
      }
      if (lane == 0) {
        s_p[c] = s;
        s_s0[c] = s0;
        s_tqk[c] = tqk;
        s_sig[c] = sig;
        s_dec[c] = dec;
        s_ldt[c] = ldt;
        s_dw[c] = dw;
      }
    }
  }
  __syncthreads();

  // softmax over the Tk keys (uniform when none is live), then D_i
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
  float part = 0.f;
  for (int c = tid; c < Tk; c += kThreads) {
    const float w = s_p[c] / denom;
    s_p[c] = w;
    if (c < live) part += s_dw[c] * w;
  }
  const float dsum = port::block_sum<kThreads>(part, s_red);

  // per key: the workspace terms; ds0 and dpre_tqk stay in shared memory
  const size_t ws_row = (size_t)lrow * Tk;
  const size_t plane = (size_t)n_rows * Tq * Tk;
  for (int c = tid; c < Tk; c += kThreads) {
    const float w = s_p[c];
    const float dropped = DROP ? w * dm[row * Tk + c] : w;
    p_ws[ws_row + c] = port::round_to<T>(dropped);
    const float ds = c < live ? w * (s_dw[c] - dsum) : 0.f;
    float ds0;
    if (MODE == ATT_TIME) {
      const int gi = i * Tk + c;
      const float sig = s_sig[c], dec = s_dec[c], tqk = s_tqk[c];
      const float dsig = ds * s_s0[c] * scale;
      ds0 = ds * sig * scale;
      const float dgate = dsig * sig * (1.f - sig);
      const float dpre_dec = dgate * port::to_float(wo1[gi]) * (1.f - dec * dec);
      const float dpre_tqk = dgate * port::to_float(wo2[gi]) * (1.f - tqk * tqk);
      float* gw = gate_ws + ws_row + c;
      gw[0] = dpre_dec * s_ldt[c];
      gw[plane] = dpre_dec;
      gw[2 * plane] = dgate * dec;
      gw[3 * plane] = dgate * tqk;
      gw[4 * plane] = dgate;
      const float dpt = port::round_to<T>(dpre_tqk);
      dpt_ws[ws_row + c] = dpt;
      s_tqk[c] = dpt;
    } else {
      ds0 = ds * scale;
    }
    const float ds0r = port::round_to<T>(ds0);
    ds0_ws[ws_row + c] = ds0r;
    s_s0[c] = ds0r;
  }
  __syncthreads();

  // dq_i = ds0 k, dtqw_i = dpre_tqk rawk (masked keys carry 0)
  for (int e = tid; e < D; e += kThreads) {
    float aq = 0.f, at = 0.f;
    for (int c = 0; c < live; ++c) {
      aq = fmaf(s_s0[c], port::to_float(kb[(size_t)c * D + e]), aq);
      if (MODE == ATT_TIME)
        at = fmaf(s_tqk[c], port::to_float(rkb[(size_t)c * D + e]), at);
    }
    dq[row * D + e] = aq;
    if (MODE == ATT_TIME) dtqw[row * D + e] = at;
  }
}

// dv = dropped^T g, dk = ds0^T q, drawk = dpre_tqk^T tqw for kKeyTile keys
// and kThreads columns of one batch row, summed over the queries in order.
template <typename T, bool TIME>
__global__ void __launch_bounds__(kThreads) attn_bwd_keys_kernel(
    const float* __restrict__ g, const T* __restrict__ q,
    const T* __restrict__ tqw, const float* __restrict__ p_ws,
    const float* __restrict__ ds0_ws, const float* __restrict__ dpt_ws,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ drawk,
    int b0, int Tq, int Tk, int D) {
  __shared__ float s_p[kQueryChunk][kKeyTile];
  __shared__ float s_s[kQueryChunk][kKeyTile];
  __shared__ float s_r[kQueryChunk][kKeyTile];
  const int c0 = blockIdx.x * kKeyTile;
  const int lb = blockIdx.y, b = b0 + lb;
  const int e = blockIdx.z * kThreads + threadIdx.x;
  float av[kKeyTile], ak[kKeyTile], ar[kKeyTile];
#pragma unroll
  for (int u = 0; u < kKeyTile; ++u) av[u] = ak[u] = ar[u] = 0.f;

  for (int i0 = 0; i0 < Tq; i0 += kQueryChunk) {
    const int nq = min(kQueryChunk, Tq - i0);
    for (int t = threadIdx.x; t < kQueryChunk * kKeyTile; t += kThreads) {
      const int ii = t / kKeyTile, u = t % kKeyTile, c = c0 + u;
      const bool ok = ii < nq && c < Tk;
      const size_t off = ((size_t)lb * Tq + i0 + ii) * Tk + c;
      s_p[ii][u] = ok ? p_ws[off] : 0.f;
      s_s[ii][u] = ok ? ds0_ws[off] : 0.f;
      if (TIME) s_r[ii][u] = ok ? dpt_ws[off] : 0.f;
    }
    __syncthreads();
    if (e < D) {
      for (int ii = 0; ii < nq; ++ii) {
        const size_t at = ((size_t)b * Tq + i0 + ii) * D + e;
        const float gi = port::round_to<T>(g[at]);
        const float qi = port::to_float(q[at]);
        const float ti = TIME ? port::to_float(tqw[at]) : 0.f;
#pragma unroll
        for (int u = 0; u < kKeyTile; ++u) {
          av[u] = fmaf(s_p[ii][u], gi, av[u]);
          ak[u] = fmaf(s_s[ii][u], qi, ak[u]);
          if (TIME) ar[u] = fmaf(s_r[ii][u], ti, ar[u]);
        }
      }
    }
    __syncthreads();
  }
  if (e >= D) return;
#pragma unroll
  for (int u = 0; u < kKeyTile; ++u) {
    const int c = c0 + u;
    if (c < Tk) {
      const size_t off = ((size_t)b * Tk + c) * D + e;
      dv[off] = av[u];
      dk[off] = ak[u];
      if (TIME) drawk[off] = ar[u];
    }
  }
}

// gate gradient element (sel, i, c): the chunk's batch rows in order
__global__ void attn_bwd_gates_kernel(const float* __restrict__ gate_ws,
                                      GateGrads gates, int n_rows, int TqTk,
                                      int accumulate) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 5LL * TqTk) return;
  const int sel = (int)(idx / TqTk), rest = (int)(idx % TqTk);
  const float* src = gate_ws + (size_t)sel * n_rows * TqTk + rest;
  float acc = 0.f;
  for (int lb = 0; lb < n_rows; ++lb) acc += src[(size_t)lb * TqTk];
  float* dst = gates.out[sel] + rest;
  *dst = accumulate ? *dst + acc : acc;
}

cudaError_t zero(float* p, size_t n, cudaStream_t s) {
  return n ? cudaMemsetAsync(p, 0, n * sizeof(float), s) : cudaSuccess;
}

template <typename T, int MODE, bool DROP>
cudaError_t run(const BwdArgs& a) {
  constexpr bool kTime = MODE == ATT_TIME;
  const size_t gate_n = (size_t)a.Tq * a.Tk;
  cudaError_t err;
  if (kTime && a.B == 0) {   // no batch row adds to the gate gradients
    for (int j = 0; j < 5; ++j)
      if ((err = zero(a.gates.out[j], gate_n, a.stream)) != cudaSuccess)
        return err;
  }
  const int rows = (int)rows_per_chunk(kTime, a.B, a.Tq, a.Tk);
  const size_t smem = (7 * (size_t)a.Tk + 3 * (size_t)a.D) * sizeof(float);
  for (int b0 = 0; b0 < a.B; b0 += rows) {
    const int n = min(rows, a.B - b0);
    const size_t plane = (size_t)n * a.Tq * a.Tk;
    float* p_ws = a.ws;
    float* ds0_ws = a.ws + plane;
    float* dpt_ws = a.ws + 2 * plane;
    float* gate_ws = a.ws + 3 * plane;
    attn_bwd_rows_kernel<T, MODE, DROP><<<n * a.Tq, kThreads, smem, a.stream>>>(
        a.g, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.t_q),
        static_cast<const T*>(a.t_k), static_cast<const T*>(a.tqw),
        static_cast<const T*>(a.rawk), static_cast<const T*>(a.w1),
        static_cast<const T*>(a.b1), static_cast<const T*>(a.wo1),
        static_cast<const T*>(a.wo2), static_cast<const T*>(a.bo), a.key_len,
        a.dm, a.dq, a.dtqw, p_ws, ds0_ws, dpt_ws, gate_ws, b0, n, a.Tq, a.Tk,
        a.D, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 grid((a.Tk + kKeyTile - 1) / kKeyTile, n,
                    (a.D + kThreads - 1) / kThreads);
    attn_bwd_keys_kernel<T, kTime><<<grid, kThreads, 0, a.stream>>>(
        a.g, static_cast<const T*>(a.q), static_cast<const T*>(a.tqw), p_ws,
        ds0_ws, dpt_ws, a.dk, a.dv, a.drawk, b0, a.Tq, a.Tk, a.D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (kTime) {
      const long long n_gate = 5LL * gate_n;
      attn_bwd_gates_kernel<<<(unsigned)((n_gate + 255) / 256), 256, 0,
                              a.stream>>>(gate_ws, a.gates, n, (int)gate_n,
                                          b0 > 0);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t run_mode(int mode, const BwdArgs& a) {
  switch (mode) {
    case ATT_PLAIN: return run<T, ATT_PLAIN, false>(a);
    case ATT_TIME: return run<T, ATT_TIME, false>(a);
    case ATT_TISAS: return run<T, ATT_TISAS, false>(a);
    case ATT_PLAIN_DROP: return run<T, ATT_PLAIN, true>(a);
    case ATT_TISAS_DROP: return run<T, ATT_TISAS, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory of the rows kernel, in bytes (the wrapper keeps it within
// the 48 KB a block gets without opting in).
extern "C" long long fused_attention_bwd_smem_bytes(int Tk, int D) {
  return (7LL * Tk + 3LL * D) * (long long)sizeof(float);
}

// f32 workspace the launch needs (at least 1).
extern "C" long long fused_attention_bwd_workspace_floats(int mode, int B,
                                                          int Tq, int Tk) {
  if (B <= 0 || Tq <= 0 || Tk <= 0) return 1;
  const bool time = mode == ATT_TIME;
  return rows_per_chunk(time, B, Tq, Tk) * Tq * Tk * (time ? 8 : 2);
}

// All pointers are device pointers to contiguous arrays: g [B,Tq,D] f32;
// the forward's inputs q/tqw [B,Tq,D], k/v/rawk [B,Tk,D], t_q [B,Tq],
// t_k [B,Tk], w1/b1/wo1/wo2/bo [Tq,Tk], key_len [B] int32, dm [B,Tq,Tk]
// f32 (read by the '*_drop' modes only); the f32 outputs dq/dtqw
// [B,Tq,D], dk/dv/drawk [B,Tk,D], dw1/db1/dwo1/dwo2/dbo [Tq,Tk] (dtqw,
// drawk and the gate gradients are written in time mode only, and may
// be null in the others); ws the
// f32 workspace of fused_attention_bwd_workspace_floats.  The floating
// inputs but g and dm are all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1).
// Returns the first cudaError_t of the launches (0 on success).
extern "C" int fused_attention_bwd_launch(
    int mode, int is_bf16, const void* g, const void* q, const void* k,
    const void* v, const void* t_q, const void* t_k, const void* tqw,
    const void* rawk, const void* w1, const void* b1, const void* wo1,
    const void* wo2, const void* bo, const void* key_len, const void* dm,
    void* dq, void* dk, void* dv, void* dtqw, void* drawk, void* dw1,
    void* db1, void* dwo1, void* dwo2, void* dbo, void* ws, int B, int Tq,
    int Tk, int D, float scale, int device, void* stream) {
  if (Tq <= 0 || Tk <= 0 || D <= 0 || B < 0) return cudaSuccess;
  if (fused_attention_bwd_smem_bytes(Tk, D) > 48 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BwdArgs a;
  a.g = static_cast<const float*>(g);
  a.q = q; a.k = k; a.v = v; a.t_q = t_q; a.t_k = t_k; a.tqw = tqw;
  a.rawk = rawk; a.w1 = w1; a.b1 = b1; a.wo1 = wo1; a.wo2 = wo2; a.bo = bo;
  a.key_len = static_cast<const int*>(key_len);
  a.dm = static_cast<const float*>(dm);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dtqw = static_cast<float*>(dtqw);
  a.drawk = static_cast<float*>(drawk);
  a.gates.out[0] = static_cast<float*>(dw1);
  a.gates.out[1] = static_cast<float*>(db1);
  a.gates.out[2] = static_cast<float*>(dwo1);
  a.gates.out[3] = static_cast<float*>(dwo2);
  a.gates.out[4] = static_cast<float*>(dbo);
  a.ws = static_cast<float*>(ws);
  a.B = B; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run_mode<__nv_bfloat16>(mode, a) : run_mode<float>(mode, a);
}
