// Backward of the fused attention middle at Tq, Tk <= 64: the "tile" design
// of fused_attention_bwd (the wrapper's `attention_bwd_design`).
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py,
// _attn_bwd_kernel (launched by _fused_attention_bwd), in all five modes,
// at the shapes of the three self-attention models' training steps (Tq =
// Tk = 50 at L=50).  It computes what fused_attention_bwd.cu's rows design
// computes (that file's note gives the formulas) with the same rounding:
// g, the dropped weights, ds0 and dpre_tqk are rounded to the input type
// at each product, every sum is f32, dm is f32, the k, v and rawk rows of
// masked keys are never read and ds is 0 there, and a row with key_len ==
// 0 weighs its Tk keys uniformly.
//
// What bounds it: at B=256, Tq=Tk=50, d=128, the bytes (each input read
// once, the f32 outputs written once: ~0.015 / 0.019 ms in bf16 / f32 in
// time mode).  Its eight [64 x 64 x d] products, at the padded size, are
// ~2.1 GFLOP: ~0.002 ms on the bf16 tensor cores, ~0.03 ms on the f32 FMA
// units.
//
// Design: one block per batch row (512 threads in bf16, 256 in f32), the
// whole Tq x Tk problem in shared memory, padded to 64 x 64:
//  1. the score products S0 = q k^T, TQK = tqw rawk^T (time mode) and
//     DW = g v^T into three f32 [64][68] planes;
//  2. the elementwise middle, a warp per query row: the gate recompute,
//     the softmax, D_i, ds, ds0, dgate, dpre_dec and dpre_tqk.  The planes
//     become ds0, dpre_tqk and the dropped weights, rounded to the input
//     type (bf16 written over the row's own f32 values: a 272-byte row
//     holds either), zero past Tq and Tk; in time mode the five gate
//     terms go to a workspace [5][rows][Tq][Tk];
//  3. the gradient products dq = ds0 k, dk = ds0^T q, dv = dropped^T g,
//     dtqw = dpre_tqk rawk and drawk = dpre_tqk^T tqw, straight to global.
// bf16: every operand staged once by cp.async (g rounded on the way), 64
// rows with zeros past Tq or the live keys, rows padded 16 bytes so
// ldmatrix meets no bank conflict; the products on the tensor cores
// (mma.sync m16n8k16, f32 accumulators, tile_gemm.cuh's helpers), a warp a
// 16 x 16 output tile at a time.  The score products start as their
// operands land (three cp.async groups).
// f32: no TF32 (f32 is held to 1e-4): register-tiled FMA, a thread a 4 x 4
// tile, the operands streamed in d-slices through three shared buffers
// (32 columns of two operands for a score product, 64 columns of one for
// a gradient product), the next two slices copied while the current one
// is summed: six [64][128] f32 operands do not fit beside the planes, and
// at 105 KB two blocks share an SM.  The staging, the products and the
// slice ring are attention_tile.cuh's, which the forward's tile design
// (fused_attention_tile.cu) shares.
// The gate gradients: a second launch (attention_tile.cuh's gate sums)
// sums the workspace over the batch, each part of kGateRows rows in order
// by one warp, then the parts in order.  A batch runs in chunks of whole parts (the wrapper's
// `gate_chunk_rows`: as many as its workspace cap holds), each adding its
// parts to the sums so far, so the order never depends on the chunking.  No float atomics: the same inputs
// give the same bits.

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

constexpr int kThreads = kFmaThreads;      // the f32 kernel's
constexpr int kMmaThreads = 512;           // the bf16 kernel's

struct TileArgs {
  const float* g;
  const void *q, *k, *v, *t_q, *t_k, *tqw, *rawk, *w1, *b1, *wo1, *wo2, *bo;
  const int* key_len;
  const float* dm;          // null outside the *_drop modes
  float *dq, *dk, *dv, *dtqw, *drawk;
  float* ws;                // the chunk's gate terms, [5][n_rows][Tq][Tk]
  int b0, n_rows, Tq, Tk, D;
  float scale;
};

size_t smem_bytes(bool bf16_in, bool time, int D) {
  const size_t planes = (size_t)(time ? 3 : 2) * kTile * kPlane * 4;
  if (!bf16_in) return planes + kStages * (size_t)kBufFloats * 4;
  return planes + (size_t)(time ? 6 : 4) * kTile * bf_stride(D) * 2;
}

// ------------------------------------------------------ the middle (both)

// A warp per query row i (of 64): lanes take keys lane and lane + 32.
// Reads the f32 planes S0, TQK (time mode) and DW; writes ds0, dpre_tqk
// and the dropped weights over them, rounded to T (as T), 0 past Tq and
// Tk; in time mode the gate terms of the row to the workspace.
template <typename T, int MODE>
__device__ void middle(const TileArgs& a, int b, int lb, float* pS,
                       float* pT, float* pW) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int Tq = a.Tq, Tk = a.Tk;
  const int live = max(0, min(a.key_len[b], Tk));
  const bool drop = a.dm != nullptr;
  const T* t_k = static_cast<const T*>(a.t_k) + (size_t)b * Tk;
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* wo1 = static_cast<const T*>(a.wo1);
  const T* wo2 = static_cast<const T*>(a.wo2);
  const T* bo = static_cast<const T*>(a.bo);
  const size_t gate_plane = (size_t)a.n_rows * Tq * Tk;
  const float scale = a.scale;

  for (int i = warp; i < kTile; i += warps) {
    float* rs = pS + i * kPlane;
    float* rt = pT + i * kPlane;
    float* rw = pW + i * kPlane;
    float os[2] = {0.f, 0.f}, ot[2] = {0.f, 0.f}, ow[2] = {0.f, 0.f};
    if (i < Tq) {
      const size_t row = (size_t)b * Tq + i;
      const float tq = MODE == ATT_PLAIN
          ? 0.f : port::to_float(static_cast<const T*>(a.t_q)[row]);
      float s[2], s0[2], dw[2], dmv[2] = {0.f, 0.f};
      float sig[2] = {0.f, 0.f}, dec[2] = {0.f, 0.f}, tqk[2] = {0.f, 0.f},
            ldt[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const bool in = c < Tk, lv = c < live;
        s0[h] = lv ? rs[c] : 0.f;
        dw[h] = lv ? rw[c] : 0.f;
        float sc = 0.f;
        if (lv) {
          if (MODE == ATT_TIME) {
            const int gi = i * Tk + c;
            tqk[h] = tanhf(rt[c]);
            ldt[h] = log1pf(fabsf(tq - port::to_float(t_k[c])));
            dec[h] = tanhf(ldt[h] * port::to_float(w1[gi]) +
                           port::to_float(b1[gi]));
            sig[h] = port::sigmoid(port::to_float(wo1[gi]) * dec[h] +
                                   port::to_float(wo2[gi]) * tqk[h] +
                                   port::to_float(bo[gi]));
            sc = s0[h] * sig[h] * scale;
          } else if (MODE == ATT_TISAS) {
            ldt[h] = log1pf(fabsf(tq - port::to_float(t_k[c])));
            sc = (s0[h] + ldt[h]) * scale;
          } else {
            sc = s0[h] * scale;
          }
        }
        s[h] = lv ? sc : (in ? kNegFill : -INFINITY);
        if (drop && in) dmv[h] = a.dm[row * Tk + c];
        if (drop) dw[h] *= dmv[h];
      }
      // softmax over the Tk keys (uniform when none is live), then D_i
      const float m = port::warp_max(fmaxf(s[0], s[1]));
      float e[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        e[h] = lane + 32 * h < Tk ? expf(s[h] - m) : 0.f;
      const float denom = port::warp_sum(e[0] + e[1]);
      const float w[2] = {e[0] / denom, e[1] / denom};
      const float dsum = port::warp_sum(dw[0] * w[0] + dw[1] * w[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if (c >= Tk) continue;
        const float ds = c < live ? w[h] * (dw[h] - dsum) : 0.f;
        float ds0;
        if (MODE == ATT_TIME) {
          const int gi = i * Tk + c;
          const float dsig = ds * s0[h] * scale;
          ds0 = ds * sig[h] * scale;
          const float dgate = dsig * sig[h] * (1.f - sig[h]);
          const float dpre_dec =
              dgate * port::to_float(wo1[gi]) * (1.f - dec[h] * dec[h]);
          const float dpre_tqk =
              dgate * port::to_float(wo2[gi]) * (1.f - tqk[h] * tqk[h]);
          float* gw = a.ws + ((size_t)lb * Tq + i) * Tk + c;
          gw[0] = dpre_dec * ldt[h];
          gw[gate_plane] = dpre_dec;
          gw[2 * gate_plane] = dgate * dec[h];
          gw[3 * gate_plane] = dgate * tqk[h];
          gw[4 * gate_plane] = dgate;
          ot[h] = port::round_to<T>(dpre_tqk);
        } else {
          ds0 = ds * scale;
        }
        os[h] = port::round_to<T>(ds0);
        ow[h] = port::round_to<T>(drop ? w[h] * dmv[h] : w[h]);
      }
    }
    __syncwarp();   // the row's f32 values are all read before the writes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      if constexpr (sizeof(T) == 2) {
        reinterpret_cast<bf16*>(rs)[c] = __float2bfloat16_rn(os[h]);
        reinterpret_cast<bf16*>(rw)[c] = __float2bfloat16_rn(ow[h]);
        if (MODE == ATT_TIME)
          reinterpret_cast<bf16*>(rt)[c] = __float2bfloat16_rn(ot[h]);
      } else {
        rs[c] = os[h];
        rw[c] = ow[h];
        if (MODE == ATT_TIME) rt[c] = ot[h];
      }
    }
  }
}

// ---------------------------------------------------------- bf16 (mma.sync)

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// g (f32) the same way, rounded to bf16
__device__ void stage_g(bf16* dst, const float* src, int valid, int D) {
  const int ch = D / 8, S = bf_stride(D);
  for (int i = threadIdx.x; i < kTile * ch; i += kMmaThreads) {
    const int r = i / ch, c = (i % ch) * 8;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      const float4* p =
          reinterpret_cast<const float4*>(src + (size_t)r * D + c);
      const float4 x = p[0], y = p[1];
      out = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                       pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
    }
    *reinterpret_cast<uint4*>(dst + r * S + c) = out;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kMmaThreads) attn_bwd_tile_mma_kernel(
    TileArgs a) {
  constexpr bool TIME = MODE == ATT_TIME;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, S = bf_stride(D), Tq = a.Tq, Tk = a.Tk;
  const int lb = blockIdx.x, b = a.b0 + lb;
  const int live = max(0, min(a.key_len[b], Tk));
  float* pS = reinterpret_cast<float*>(smem_raw);
  float* pW = pS + kTile * kPlane;
  float* pT = pW + kTile * kPlane;            // time mode only
  bf16* tiles = reinterpret_cast<bf16*>(pS + (TIME ? 3 : 2) * kTile * kPlane);
  bf16* sv = tiles;
  bf16* sg = sv + kTile * S;
  bf16* sq = sg + kTile * S;
  bf16* sk = sq + kTile * S;
  bf16* stq = sk + kTile * S;                 // time mode: tqw, rawk
  bf16* srk = stq + kTile * S;
  const size_t qrow = (size_t)b * Tq * D, krow = (size_t)b * Tk * D;
  auto in = [&](const void* p) { return static_cast<const bf16*>(p); };

  // three copy groups: (v, g), (q, k), (tqw, rawk)
  stage_rows(sv, in(a.v) + krow, live, D);
  stage_g(sg, a.g + qrow, Tq, D);
  tile::cp_async_commit();
  stage_rows(sq, in(a.q) + qrow, Tq, D);
  stage_rows(sk, in(a.k) + krow, live, D);
  tile::cp_async_commit();
  if (TIME) {
    stage_rows(stq, in(a.tqw) + qrow, Tq, D);
    stage_rows(srk, in(a.rawk) + krow, live, D);
    tile::cp_async_commit();
  }
  const int nk = D / 16;
  if (TIME) tile::cp_async_wait<2>(); else tile::cp_async_wait<1>();
  __syncthreads();
  mma_scores(pW, sg, sv, S, nk, Tq, Tk);
  if (TIME) tile::cp_async_wait<1>(); else tile::cp_async_wait<0>();
  __syncthreads();
  mma_scores(pS, sq, sk, S, nk, Tq, Tk);
  if (TIME) {
    tile::cp_async_wait<0>();
    __syncthreads();
    mma_scores(pT, stq, srk, S, nk, Tq, Tk);
  }
  __syncthreads();
  middle<bf16, MODE>(a, b, lb, pS, pT, pW);
  __syncthreads();

  const int kq = (Tq + 15) / 16, kk = (Tk + 15) / 16;
  mma_product<false>(a.dq + qrow, pS, sk, S, Tq, D, kk);
  mma_product<true>(a.dk + krow, pS, sq, S, Tk, D, kq);
  mma_product<true>(a.dv + krow, pW, sg, S, Tk, D, kq);
  if (TIME) {
    mma_product<false>(a.dtqw + qrow, pT, srk, S, Tq, D, kk);
    mma_product<true>(a.drawk + krow, pT, stq, S, Tk, D, kq);
  }
}

// ------------------------------------------------------------- f32 (FMA)

template <int MODE>
__global__ void __launch_bounds__(kThreads) attn_bwd_tile_fma_kernel(
    TileArgs a) {
  constexpr bool TIME = MODE == ATT_TIME;
  constexpr int NA = TIME ? 3 : 2, NB = TIME ? 5 : 3;   // products
  extern __shared__ __align__(16) float smem_f[];
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const int lb = blockIdx.x, b = a.b0 + lb;
  const int live = max(0, min(a.key_len[b], Tk));
  const int warp = threadIdx.x >> 5;
  float* pS = smem_f;
  float* pW = pS + kTile * kPlane;
  float* pT = pW + kTile * kPlane;            // time mode only
  float* buf0 = pS + NA * kTile * kPlane;
  auto buf = [&](int s) { return buf0 + (s % kStages) * kBufFloats; };
  const size_t qrow = (size_t)b * Tq * D, krow = (size_t)b * Tk * D;
  auto in = [&](const void* p) { return static_cast<const float*>(p); };
  const float* g = a.g + qrow;
  const float* q = in(a.q) + qrow;
  const float* k = in(a.k) + krow;
  const float* v = in(a.v) + krow;
  const float* tqw = TIME ? in(a.tqw) + qrow : nullptr;
  const float* rawk = TIME ? in(a.rawk) + krow : nullptr;

  // the steps: score product p's slice j (p < NA: DW = g v^T, S0 = q k^T,
  // TQK = tqw rawk^T), then gradient product p's slice j (dq = ds0 k,
  // dk = ds0^T q, dv = dropped^T g, dtqw = dpt rawk, drawk = dpt^T tqw)
  const int sa = (D + kSliceA - 1) / kSliceA, sb = (D + kSliceB - 1) / kSliceB;
  const int n_a = NA * sa, n_steps = n_a + NB * sb;
  // gradient product p: its operand (and the operand's valid rows), its
  // plane, its output (and rows), and whether the plane is read
  // transposed (a contraction over the queries)
  struct Grad {
    const float* op;
    int valid;
    const float* plane;
    float* out;
    int rows;
    bool trans;
  };
  auto grad = [&](int p) -> Grad {
    switch (p) {
      case 0: return {k, live, pS, a.dq + qrow, Tq, false};
      case 1: return {q, Tq, pS, a.dk + krow, Tk, true};
      case 2: return {g, Tq, pW, a.dv + krow, Tk, true};
      case 3: return {rawk, live, pT, a.dtqw + qrow, Tq, false};
      default: return {tqw, Tq, pT, a.drawk + krow, Tk, true};
    }
  };

  auto stage = [&](int s) {
    float* dst = buf(s);
    if (s >= n_steps) {
      // past the last step: an empty group keeps the count of groups
    } else if (s < n_a) {
      const int p = s / sa, c0 = (s % sa) * kSliceA;
      const float* x = p == 0 ? g : p == 1 ? q : tqw;
      const float* y = p == 0 ? v : p == 1 ? k : rawk;
      stage_slice(dst, kStrideA, kSliceA, x, Tq, D, c0);
      stage_slice(dst + kTile * kStrideA, kStrideA, kSliceA, y, live, D, c0);
    } else {
      const Grad gr = grad((s - n_a) / sb);
      stage_slice(dst, kStrideB, kSliceB, gr.op, gr.valid, D,
                  ((s - n_a) % sb) * kSliceB);
    }
    tile::cp_async_commit();
  };

  float acc[4][4];
  slice_ring(n_steps, stage, [&](int s) {
    if (s == n_a) {
      middle<float, MODE>(a, b, lb, pS, pT, pW);
      __syncthreads();
    }
    const float* x = buf(s);
    if (s < n_a) {
      // rows 4ty + r (queries) x columns tx + 16 j (keys), summed over
      // the slice's 32 columns of d in order
      const int p = s / sa, slice = s % sa;
      if (slice == 0) fma_zero(acc);
      if (8 * warp < Tq) fma_scores_slice(acc, x, x + kTile * kStrideA);
      if (slice == sa - 1)
        fma_store_plane(p == 0 ? pW : p == 1 ? pS : pT, acc);
    } else {
      // rows 4ty + r x columns 4tx + j of the output's slice
      const Grad gr = grad((s - n_a) / sb);
      fma_product_slice(acc, gr.plane, x, gr.trans, gr.rows, Tq, Tk);
      fma_store_out(gr.out, gr.rows, D, ((s - n_a) % sb) * kSliceB, acc);
    }
  });
}

template <typename K>
cudaError_t launch_tile(K kernel, int threads, const TileArgs& a, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.n_rows, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(bool is_bf16, const TileArgs& a, size_t smem,
                        cudaStream_t stream) {
  return is_bf16
      ? launch_tile(attn_bwd_tile_mma_kernel<MODE>, kMmaThreads, a, smem,
                    stream)
      : launch_tile(attn_bwd_tile_fma_kernel<MODE>, kThreads, a, smem,
                    stream);
}

}  // namespace

// The arguments of fused_attention_bwd_launch (fused_attention_bwd.cu),
// with 1 <= Tq, Tk <= 64, D a multiple of 16 up to 128, q, k, v, tqw,
// rawk and g 16-byte aligned, and in time mode chunk_rows, the batch rows
// a launch takes (B, or a multiple of 32 below B, at most 4096), and ws,
// 5 * chunk_rows * Tq * Tk floats for their gate terms (unread in the
// other modes).  Returns the first cudaError_t of the launches (0 on
// success).
extern "C" int fused_attention_bwd_tile_launch(
    int mode, int is_bf16, const void* g, const void* q, const void* k,
    const void* v, const void* t_q, const void* t_k, const void* tqw,
    const void* rawk, const void* w1, const void* b1, const void* wo1,
    const void* wo2, const void* bo, const void* key_len, const void* dm,
    void* dq, void* dk, void* dv, void* dtqw, void* drawk, void* dw1,
    void* db1, void* dwo1, void* dwo2, void* dbo, void* ws, int B, int Tq,
    int Tk, int D, float scale, int chunk_rows, int device, void* stream) {
  const bool time = mode == ATT_TIME;
  if (Tq < 1 || Tq > kTile || Tk < 1 || Tk > kTile || D < 16 || D > kMaxD ||
      D % 16 || B < 0 || mode < 0 || mode > ATT_TISAS_DROP)
    return cudaErrorInvalidValue;
  if (time && B > 0 &&
      (chunk_rows < 1 || chunk_rows > kMaxParts * kGateRows ||
       (chunk_rows < B && chunk_rows % kGateRows)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool drop = mode == ATT_PLAIN_DROP || mode == ATT_TISAS_DROP;
  const int base = mode == ATT_PLAIN_DROP ? ATT_PLAIN
                   : mode == ATT_TISAS_DROP ? ATT_TISAS : mode;
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
  TileArgs a;
  a.g = static_cast<const float*>(g);
  a.q = q; a.k = k; a.v = v; a.t_q = t_q; a.t_k = t_k; a.tqw = tqw;
  a.rawk = rawk; a.w1 = w1; a.b1 = b1; a.wo1 = wo1; a.wo2 = wo2; a.bo = bo;
  a.key_len = static_cast<const int*>(key_len);
  a.dm = drop ? static_cast<const float*>(dm) : nullptr;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dtqw = static_cast<float*>(dtqw);
  a.drawk = static_cast<float*>(drawk);
  a.ws = static_cast<float*>(ws);
  a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.scale = scale;
  const size_t smem = smem_bytes(is_bf16 != 0, time, D);
  const int rows = time ? chunk_rows : B;
  for (int b0 = 0; b0 < B; b0 += rows) {
    a.b0 = b0;
    a.n_rows = min(rows, B - b0);
    switch (base) {
      case ATT_PLAIN: err = launch_mode<ATT_PLAIN>(is_bf16, a, smem, s); break;
      case ATT_TIME: err = launch_mode<ATT_TIME>(is_bf16, a, smem, s); break;
      default: err = launch_mode<ATT_TISAS>(is_bf16, a, smem, s); break;
    }
    if (err != cudaSuccess) return err;
    if (time && (err = launch_gate_sums(a.ws, gates, a.n_rows, (int)gate_n,
                                        b0, s)) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}
