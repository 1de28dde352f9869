// Backward of the fused attention middle past 64 keys (or 64 queries), up
// to 1024 keys: the "wide" design of fused_attention_bwd (the wrapper's
// `attention_bwd_design`: 2 <= Tq <= 1024, Tk <= 1024, Tq or Tk > 64).
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py,
// _attn_bwd_kernel (launched by _fused_attention_bwd for every call with
// at most 1024 keys), in all five modes, at the self-attention models'
// training steps past L=64 (Tq = Tk = L).  It computes what
// fused_attention_bwd.cu's rows design computes (that file's note gives
// the formulas) with the same rounding: g, the dropped weights, ds0 and
// dpre_tqk are rounded to the input type at each product, every sum is
// f32, dm is f32, the k, v and rawk rows of masked keys are never read and
// ds is 0 there, and a row with key_len == 0 weighs its Tk keys uniformly.
//
// What bounds it: at B=64, Tq=Tk=256, d=128, the bytes (each input read
// once, the f32 outputs written once: ~0.02 ms in time mode); its eight
// [256 x 256 x 128] products a row are ~8.6 GFLOP: ~0.009 ms on the bf16
// tensor cores, ~0.13 ms on the f32 FMA units.  The Pallas body holds a
// row's whole padded tile in VMEM and carries the gate cotangents from one
// grid step to the next; here a block's shared memory holds 16 query rows'
// strips, and dk, dv and drawk sum over every query, which no one block
// sees.
//
// Design, per chunk of batch rows (the wrapper's `wide_chunk_rows`: as
// many as its workspaces' cap holds):
//  1. the query pass, one block (128 threads) per (batch row, 16 query
//     rows): the keys streamed twice in KB-key blocks (32 in bf16, 16 in
//     f32) through a ring of two cp.async buffers.  Pass A: S0 = q k^T, DW
//     = g v^T (and TQK = tqw rawk^T) a block at a time, the scores (the
//     forward's middle) and the dropped DW into two f32 strips [16][Tk].
//     Then a warp a row: the softmax, the weights over the score strip, D_i
//     = sum DW w.  Pass C: a thread a pair, ds, ds0, dgate, dpre_dec and
//     dpre_tqk (in time mode the block's S0 and TQK recomputed by the same
//     products, the gate's transcendentals again: the strips hold only the
//     scores and DW), the gate terms to a workspace [5][rows][Tq][Tk], the
//     rounded ds0, dropped weights and dpre_tqk to planes [3][rows][Tq]
//     [Tkp] of the input type; dq += ds0 k and dtqw += dpre_tqk rawk from
//     the block, summed in registers;
//  2. the key pass, one block per (batch row, 32 keys, gradient): dk =
//     ds0^T q, dv = dropped^T g and drawk = dpre_tqk^T tqw, walking the
//     planes' query rows in 32-row steps, in order;
//  3. in time mode the gate sums (attention_tile.cuh's launch, as the tile
//     design sums), each chunk's parts added to the earlier chunks'.
// bf16: the products on the tensor cores (mma.sync m16n8k16); f32: no
// TF32, register-tiled FMA.  No float atomics: the same inputs give the
// same bits, whatever the chunking.

#include "attention_wide.cuh"

namespace {

using namespace attn_wide;
using attn_tile::ATT_PLAIN;
using attn_tile::ATT_PLAIN_DROP;
using attn_tile::ATT_TIME;
using attn_tile::ATT_TISAS;
using attn_tile::ATT_TISAS_DROP;
using attn_tile::GateOut;

struct BwdArgs {
  const float* g;
  const void *q, *k, *v, *t_q, *t_k, *tqw, *rawk, *w1, *b1, *wo1, *wo2, *bo;
  const int* key_len;
  const float* dm;          // null outside the *_drop modes
  float *dq, *dk, *dv, *dtqw, *drawk;
  void* planes;             // the chunk's [planes][n_rows][Tq][Tkp] of T
  float* ws;                // the chunk's gate terms, [5][n_rows][Tq][Tk]
  int b0, n_rows, Tq, Tk, D;
  float scale;
};

// a row of the query pass's block of rounded ds0 (and dpre_tqk), elements
template <typename T>
__host__ __device__ constexpr int pblk_stride() {
  return key_block<T>() + (sizeof(T) == 2 ? 8 : 4);
}
// a row of the key pass's staged plane block [kQB][kKT], elements
template <typename T>
__host__ __device__ constexpr int kblk_stride() {
  return kKT + (sizeof(T) == 2 ? 8 : 4);
}

template <typename T>
size_t query_smem_bytes(bool time, int Tk, int D) {
  const size_t ST = op_stride<T>(D), es = sizeof(T);
  const int KB = key_block<T>();
  return 2 * (size_t)kQT * strip_stride(Tk) * 4          // scores, DW
         + (time ? 3 : 2) * kQT * ST * es                // q, g, tqw
         + (size_t)kStages * (time ? 3 : 2) * KB * ST * es   // k, v, rawk
         + (time ? 3 : 2) * kQT * pc_stride<T>() * 4      // S0, DW, TQK
         + (time ? 2 : 1) * kQT * pblk_stride<T>() * es   // ds0, dpre_tqk
         + kQT * 4;                                       // D_i
}

template <typename T>
size_t key_smem_bytes(int D) {
  return (size_t)kStages * kQB *
         (kblk_stride<T>() + op_stride<T>(D)) * sizeof(T);
}

// ------------------------------------------------------- the query pass

template <typename T, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads) attn_bwd_wide_query_kernel(
    BwdArgs a) {
  constexpr bool TIME = MODE == ATT_TIME;
  constexpr int NT = TIME ? 3 : 2;           // q, g, tqw; pass A's operands
  constexpr int KB = key_block<T>(), PC = pc_stride<T>();
  constexpr int PB = pblk_stride<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const int ST = op_stride<T>(D), SP = strip_stride(Tk), Tkp = pad_keys(Tk);
  const int lb = blockIdx.x, b = a.b0 + lb, i0 = blockIdx.y * kQT;
  const int live = max(0, min(a.key_len[b], Tk));
  const int n_kb = Tkp / KB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sS = reinterpret_cast<float*>(smem_raw);   // scores, then weights
  float* sDW = sS + kQT * SP;
  T* sq = reinterpret_cast<T*>(sDW + kQT * SP);
  T* sg = sq + kQT * ST;
  T* stqw = sg + kQT * ST;                          // time mode only
  T* buf0 = sq + NT * kQT * ST;
  float* pc = reinterpret_cast<float*>(buf0 + kStages * NT * KB * ST);
  T* pblk = reinterpret_cast<T*>(pc + NT * kQT * PC);
  float* sdsum = reinterpret_cast<float*>(pblk + (TIME ? 2 : 1) * kQT * PB);
  auto buf = [&](int s) { return buf0 + (s % kStages) * NT * KB * ST; };
  auto in = [&](const void* p) { return static_cast<const T*>(p); };
  const size_t qrow = (size_t)b * Tq * D, krow = (size_t)b * Tk * D;

  // the block's rows of q and g (and tqw), a copy group before the ring's
  stage_rows<T>(sq, ST, in(a.q) + qrow, i0, kQT, Tq, D);
  if constexpr (sizeof(T) == 2)
    stage_rows_rounded(sg, ST, a.g + qrow, i0, kQT, Tq, D);
  else
    stage_rows<float>(sg, ST, a.g + qrow, i0, kQT, Tq, D);
  if (TIME) stage_rows<T>(stqw, ST, in(a.tqw) + qrow, i0, kQT, Tq, D);
  tile::cp_async_commit();

  // steps [0, n_kb): pass A over key block s (k, v, rawk); [n_kb, 2 n_kb):
  // pass C over it (k, rawk).  Blocks past the live keys are not copied.
  auto stage = [&](int s) {
    T* dst = buf(s);
    const bool pass_a = s < n_kb;
    const int k0 = (pass_a ? s : s - n_kb) * KB;
    if (s < 2 * n_kb && k0 < live) {
      stage_rows<T>(dst, ST, in(a.k) + krow, k0, KB, live, D);
      if (pass_a)
        stage_rows<T>(dst + KB * ST, ST, in(a.v) + krow, k0, KB, live, D);
      if (TIME)
        stage_rows<T>(dst + (pass_a ? 2 : 1) * KB * ST, ST,
                      in(a.rawk) + krow, k0, KB, live, D);
    }
    tile::cp_async_commit();
  };

  const T* t_k = in(a.t_k) + (size_t)b * Tk;
  const int r = threadIdx.x >> 3, kx = threadIdx.x & 7;   // the middle's pairs
  const int i = i0 + r;
  const float tq = (MODE == ATT_PLAIN || i >= Tq)
      ? 0.f : port::to_float(in(a.t_q)[(size_t)b * Tq + i]);
  const size_t gate_plane = (size_t)a.n_rows * Tq * Tk;
  const size_t plane = (size_t)a.n_rows * Tq * Tkp;
  T* planes = static_cast<T*>(a.planes) + ((size_t)lb * Tq + i) * Tkp;
  QueryAcc<T> dq, dtqw;
  dq.zero();
  dtqw.zero();

  attn_tile::slice_ring<kStages>(2 * n_kb, stage, [&](int s) {
    const T* x = buf(s);
    if (s < n_kb) {
      // pass A: the scores and the dropped DW of key block s
      const int k0 = s * KB;
      if (k0 < live)
        block_scores(pc, NT, sq, x, sg, x + KB * ST, stqw, x + 2 * KB * ST,
                     ST, D);
      __syncthreads();
      if (i >= Tq) return;
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) {
        const int cc = kx + 8 * j, c = k0 + cc;
        if (c >= Tk) continue;
        const bool lv = c < live;
        float sc = kNegFill, dw = 0.f;
        if (lv) {
          Gate gt;
          sc = pair_score<T, MODE>(
              pc[r * PC + cc], TIME ? pc[2 * kQT * PC + r * PC + cc] : 0.f,
              tq, MODE == ATT_PLAIN ? 0.f : port::to_float(t_k[c]),
              in(a.w1), in(a.b1), in(a.wo1), in(a.wo2), in(a.bo),
              (size_t)i * Tk + c, a.scale, gt);
          dw = pc[kQT * PC + r * PC + cc];
        }
        if (DROP) dw *= a.dm[((size_t)b * Tq + i) * Tk + c];
        sS[r * SP + c] = sc;
        sDW[r * SP + c] = dw;
      }
      return;
    }
    if (s == n_kb) {
      // a warp a row: the softmax, the weights over the scores, D_i
      for (int rr = warp; rr < kQT; rr += kThreads / 32) {
        if (i0 + rr >= Tq) continue;
        float* row = sS + rr * SP;
        const float* dwr = sDW + rr * SP;
        const float denom = row_softmax_sums(row, Tk);
        float dsum = 0.f;
        for (int c = lane; c < Tk; c += 32) {
          const float w = row[c] / denom;
          row[c] = w;
          dsum += dwr[c] * w;
        }
        dsum = port::warp_sum(dsum);
        if (lane == 0) sdsum[rr] = dsum;
      }
      __syncthreads();
    }
    // pass C over key block s - n_kb
    const int k0 = (s - n_kb) * KB;
    if (TIME && k0 < live)   // S0 and TQK again, from the same operands
      block_scores(pc, 2, sq, x, stqw, x + KB * ST, nullptr, nullptr, ST, D);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      const int cc = kx + 8 * j, c = k0 + cc;
      float os = 0.f, ow = 0.f, ot = 0.f;
      if (i < Tq && c < Tk) {
        const bool lv = c < live;
        const float w = sS[r * SP + c];
        const float ds = lv ? w * (sDW[r * SP + c] - sdsum[r]) : 0.f;
        const size_t gi = (size_t)i * Tk + c;
        float ds0;
        if (TIME) {
          Gate gt{0.f, 0.f, 0.f, 0.f};
          float s0 = 0.f, wo1 = 0.f, wo2 = 0.f;
          if (lv) {
            s0 = pc[r * PC + cc];
            pair_score<T, MODE>(s0, pc[kQT * PC + r * PC + cc], tq,
                                port::to_float(t_k[c]), in(a.w1), in(a.b1),
                                in(a.wo1), in(a.wo2), in(a.bo), gi, a.scale,
                                gt);
            wo1 = port::to_float(in(a.wo1)[gi]);
            wo2 = port::to_float(in(a.wo2)[gi]);
          }
          const float dsig = ds * s0 * a.scale;
          ds0 = ds * gt.sig * a.scale;
          const float dgate = dsig * gt.sig * (1.f - gt.sig);
          const float dpre_dec = dgate * wo1 * (1.f - gt.dec * gt.dec);
          const float dpre_tqk = dgate * wo2 * (1.f - gt.tqk * gt.tqk);
          float* gw = a.ws + ((size_t)lb * Tq + i) * Tk + c;
          gw[0] = dpre_dec * gt.ldt;
          gw[gate_plane] = dpre_dec;
          gw[2 * gate_plane] = dgate * gt.dec;
          gw[3 * gate_plane] = dgate * gt.tqk;
          gw[4 * gate_plane] = dgate;
          ot = dpre_tqk;
        } else {
          ds0 = ds * a.scale;
        }
        os = ds0;
        ow = DROP ? w * a.dm[((size_t)b * Tq + i) * Tk + c] : w;
      }
      if (i < Tq) {
        store_as<T>(planes + c, os);
        store_as<T>(planes + plane + c, ow);
        if (TIME) store_as<T>(planes + 2 * plane + c, ot);
      }
      store_as<T>(pblk + r * PB + cc, os);
      if (TIME) store_as<T>(pblk + kQT * PB + r * PB + cc, ot);
    }
    __syncthreads();
    if (k0 < live) {
      query_product(dq, pblk, PB, x, ST, D);
      if (TIME) query_product(dtqw, pblk + kQT * PB, PB, x + KB * ST, ST, D);
    }
  });
  store_query<T>(a.dq + qrow, dq, i0, Tq, D);
  if (TIME) store_query<T>(a.dtqw + qrow, dtqw, i0, Tq, D);
}

// --------------------------------------------------------- the key pass

// out [kKT keys][D] += P^T X over a step's kQB query rows: P [kQB][kKT]
// (a plane's block, row stride kblk_stride), X [kQB][stride] (the step's
// rows of q, g or tqw).  bf16: the 2 x D/16 16 x 16 output tiles, warp w
// the tiles w + 4m (m < 4); f32: thread t keys 4(t / 16) + r (r < 4),
// columns 4(t % 16) + 64m (m < 2), the queries in order.
template <typename T>
struct KeyAcc;
template <>
struct KeyAcc<bf16> {
  float c[4][2][4];   // [tile m][n-tile j][fragment]
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) c[m][j][0] = c[m][j][1] = c[m][j][2] =
          c[m][j][3] = 0.f;
  }
};
template <>
struct KeyAcc<float> {
  float v[4][2][4];   // [key r][column group m][column]
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < 2; ++m) v[r][m][0] = v[r][m][1] = v[r][m][2] =
          v[r][m][3] = 0.f;
  }
};

__device__ __forceinline__ void key_product(KeyAcc<bf16>& a, const bf16* P,
                                            const bf16* X, int stride,
                                            int D) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int u = warp + 4 * m;
    if (u < 2 * (D / 16))
      attn_tile::mma_tile<true, true>(a.c[m], P, kblk_stride<bf16>(), X,
                                      stride, 16 * (u & 1), 16 * (u >> 1),
                                      kQB / 16, false);
  }
}

__device__ __forceinline__ void key_product(KeyAcc<float>& a, const float* P,
                                            const float* X, int stride,
                                            int D) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int q = 0; q < kQB; ++q) {
    const float4 p = *reinterpret_cast<const float4*>(
        P + q * kblk_stride<float>() + 4 * ty);
    const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int col = 4 * tx + 64 * m;
      if (col >= D) continue;
      const float4 x = *reinterpret_cast<const float4*>(X + q * stride + col);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a.v[r][m][0] = fmaf(pr[r], x.x, a.v[r][m][0]);
        a.v[r][m][1] = fmaf(pr[r], x.y, a.v[r][m][1]);
        a.v[r][m][2] = fmaf(pr[r], x.z, a.v[r][m][2]);
        a.v[r][m][3] = fmaf(pr[r], x.w, a.v[r][m][3]);
      }
    }
  }
}

// the block's keys c0 + m < Tk of out [Tk][D]
__device__ __forceinline__ void store_key(float* out, const KeyAcc<bf16>& a,
                                          int c0, int Tk, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int u = warp + 4 * m;
    if (u >= 2 * (D / 16)) continue;
    const int row = c0 + 16 * (u & 1) + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * (u >> 1) + 8 * j + 2 * t;
      if (row < Tk)
        *reinterpret_cast<float2*>(out + (size_t)row * D + col) =
            make_float2(a.c[m][j][0], a.c[m][j][1]);
      if (row + 8 < Tk)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * D + col) =
            make_float2(a.c[m][j][2], a.c[m][j][3]);
    }
  }
}

__device__ __forceinline__ void store_key(float* out, const KeyAcc<float>& a,
                                          int c0, int Tk, int D) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = c0 + 4 * ty + r;
    if (row >= Tk) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int col = 4 * tx + 64 * m;
      if (col < D)
        *reinterpret_cast<float4*>(out + (size_t)row * D + col) =
            make_float4(a.v[r][m][0], a.v[r][m][1], a.v[r][m][2],
                        a.v[r][m][3]);
    }
  }
}

// Block (row lb, key tile blockIdx.y, gradient blockIdx.z): dk = ds0^T q,
// dv = dropped^T g, drawk = dpre_tqk^T tqw over the 32 keys.
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_wide_key_kernel(
    BwdArgs a) {
  constexpr int PS = kblk_stride<T>();
  constexpr int per = 16 / sizeof(T);        // elements a 16-byte piece
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const int ST = op_stride<T>(D), Tkp = pad_keys(Tk);
  const int lb = blockIdx.x, b = a.b0 + lb, c0 = blockIdx.y * kKT;
  const int o = blockIdx.z;                  // 0 dk, 1 dv, 2 drawk
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  auto pbuf = [&](int s) { return buf0 + (s % kStages) * kQB * (PS + ST); };
  const T* plane = static_cast<const T*>(a.planes) +
                   ((size_t)o * a.n_rows + lb) * Tq * Tkp + c0;
  const size_t qrow = (size_t)b * Tq * D;
  const T* x = static_cast<const T*>(o == 0 ? a.q : a.tqw) + qrow;
  const int n_steps = (Tq + kQB - 1) / kQB;

  auto stage = [&](int s) {
    if (s < n_steps) {
      T* P = pbuf(s);
      T* X = P + kQB * PS;
      const int q0 = s * kQB;
      constexpr int ch = kKT / per;
      for (int e = threadIdx.x; e < kQB * ch; e += blockDim.x) {
        const int rr = e / ch, cc = (e % ch) * per;
        const bool ok = q0 + rr < Tq;
        tile::cp_async16(P + rr * PS + cc,
                         ok ? plane + (size_t)(q0 + rr) * Tkp + cc : plane,
                         ok);
      }
      if (o != 1)
        stage_rows<T>(X, ST, x, q0, kQB, Tq, D);
      else if constexpr (sizeof(T) == 2)
        stage_rows_rounded(X, ST, a.g + qrow, q0, kQB, Tq, D);
      else
        stage_rows<float>(X, ST, a.g + qrow, q0, kQB, Tq, D);
    }
    tile::cp_async_commit();
  };

  KeyAcc<T> acc;
  acc.zero();
  attn_tile::slice_ring<kStages>(n_steps, stage, [&](int s) {
    const T* P = pbuf(s);
    key_product(acc, P, P + kQB * PS, ST, D);
  });
  float* out = (o == 0 ? a.dk : o == 1 ? a.dv : a.drawk) + (size_t)b * Tk * D;
  store_key(out, acc, c0, Tk, D);
}

// ------------------------------------------------------------- launches

template <typename K>
cudaError_t launch(K kernel, dim3 grid, const BwdArgs& a, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_query(int mode, const BwdArgs& a, cudaStream_t s) {
  const dim3 grid(a.n_rows, (a.Tq + kQT - 1) / kQT);
  const size_t smem = query_smem_bytes<T>(mode == ATT_TIME, a.Tk, a.D);
  switch (mode) {
    case ATT_PLAIN:
      return launch(attn_bwd_wide_query_kernel<T, ATT_PLAIN, false>, grid, a,
                    smem, s);
    case ATT_TIME:
      return launch(attn_bwd_wide_query_kernel<T, ATT_TIME, false>, grid, a,
                    smem, s);
    case ATT_TISAS:
      return launch(attn_bwd_wide_query_kernel<T, ATT_TISAS, false>, grid, a,
                    smem, s);
    case ATT_PLAIN_DROP:
      return launch(attn_bwd_wide_query_kernel<T, ATT_PLAIN, true>, grid, a,
                    smem, s);
    default:
      return launch(attn_bwd_wide_query_kernel<T, ATT_TISAS, true>, grid, a,
                    smem, s);
  }
}

template <typename T>
cudaError_t launch_key(bool time, const BwdArgs& a, cudaStream_t s) {
  const dim3 grid(a.n_rows, pad_keys(a.Tk) / kKT, time ? 3 : 2);
  return launch(attn_bwd_wide_key_kernel<T>, grid, a, key_smem_bytes<T>(a.D),
                s);
}

}  // namespace

// The arguments of fused_attention_bwd_launch (fused_attention_bwd.cu),
// with Tq >= 1, 1 <= Tk <= 1024, D a multiple of 16 up to 128, g, q, k, v
// (and tqw, rawk in time mode) 16-byte aligned; chunk_rows, the batch rows
// a pass takes (at least 1; in time mode B, or a multiple of 32 below B,
// at most 4096); planes, (3 in time mode, else 2) * chunk_rows * Tq *
// pad_keys(Tk) elements of the input type; ws, in time mode 5 * chunk_rows
// * Tq * Tk floats for the gate terms (unread in the other modes).
// Returns the first cudaError_t of the launches (0 on success).
extern "C" int fused_attention_bwd_wide_launch(
    int mode, int is_bf16, const void* g, const void* q, const void* k,
    const void* v, const void* t_q, const void* t_k, const void* tqw,
    const void* rawk, const void* w1, const void* b1, const void* wo1,
    const void* wo2, const void* bo, const void* key_len, const void* dm,
    void* dq, void* dk, void* dv, void* dtqw, void* drawk, void* dw1,
    void* db1, void* dwo1, void* dwo2, void* dbo, void* planes, void* ws,
    int B, int Tq, int Tk, int D, float scale, int chunk_rows, int device,
    void* stream) {
  using attn_tile::kGateRows;
  using attn_tile::kMaxParts;
  const bool time = mode == ATT_TIME;
  if (Tq < 1 || Tk < 1 || Tk > 1024 || D < 16 || D > 128 || D % 16 || B < 0 ||
      mode < ATT_PLAIN || mode > ATT_TISAS_DROP)
    return cudaErrorInvalidValue;
  if (B > 0 && (chunk_rows < 1 ||
                (time && (chunk_rows > kMaxParts * kGateRows ||
                          (chunk_rows < B && chunk_rows % kGateRows)))))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GateOut gates = {{static_cast<float*>(dw1), static_cast<float*>(db1),
                    static_cast<float*>(dwo1), static_cast<float*>(dwo2),
                    static_cast<float*>(dbo)}};
  const size_t gate_n = (size_t)Tq * Tk;
  if (time && B == 0) {   // no batch row adds to the gate gradients
    for (int j = 0; j < 5; ++j)
      if ((err = cudaMemsetAsync(gates.out[j], 0, gate_n * sizeof(float),
                                 s)) != cudaSuccess)
        return err;
  }
  BwdArgs a;
  a.g = static_cast<const float*>(g);
  a.q = q; a.k = k; a.v = v; a.t_q = t_q; a.t_k = t_k; a.tqw = tqw;
  a.rawk = rawk; a.w1 = w1; a.b1 = b1; a.wo1 = wo1; a.wo2 = wo2; a.bo = bo;
  a.key_len = static_cast<const int*>(key_len);
  a.dm = (mode == ATT_PLAIN_DROP || mode == ATT_TISAS_DROP)
             ? static_cast<const float*>(dm) : nullptr;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dtqw = static_cast<float*>(dtqw);
  a.drawk = static_cast<float*>(drawk);
  a.planes = planes;
  a.ws = static_cast<float*>(ws);
  a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.scale = scale;
  for (int b0 = 0; b0 < B; b0 += chunk_rows) {
    a.b0 = b0;
    a.n_rows = min(chunk_rows, B - b0);
    err = is_bf16 ? launch_query<bf16>(mode, a, s)
                  : launch_query<float>(mode, a, s);
    if (err != cudaSuccess) return err;
    err = is_bf16 ? launch_key<bf16>(time, a, s) : launch_key<float>(time, a, s);
    if (err != cudaSuccess) return err;
    if (time && (err = attn_tile::launch_gate_sums(
                     a.ws, gates, a.n_rows, (int)gate_n, b0, s)) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

// The shared memory a block of the query pass (`key` 0) or of the key pass
// (`key` 1) takes for a mode at (Tk, D), in bytes.
extern "C" long long fused_attention_bwd_wide_smem_bytes(int mode, int is_bf16,
                                                         int Tk, int D,
                                                         int key) {
  if (Tk < 1 || Tk > 1024 || D < 16 || D > 128 || D % 16) return 0;
  const bool time = mode == ATT_TIME;
  if (key)
    return (long long)(is_bf16 ? key_smem_bytes<bf16>(D)
                               : key_smem_bytes<float>(D));
  return (long long)(is_bf16 ? query_smem_bytes<bf16>(time, Tk, D)
                             : query_smem_bytes<float>(time, Tk, D));
}
