// Forward of the fused attention middle at 2 <= Tq <= 64, Tk <= 64: the
// "tile" design of fused_attention (the wrapper's `attention_fwd_design`).
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py,
// _attn_kernel (launched by _fused_attention_fwd), in all five modes, at
// the shapes of the three self-attention models' blocks (Tq = Tk = 50 at
// L=50, in training and serving).  It computes what fused_attention.cu's
// "query" design computes (that file's note gives the formulas) with the
// same rounding: products take the input type and sum in f32, the gate's
// transcendentals are the accurate ones, a masked key scores -2^32 + 1,
// the softmax is f32, dm (f32) multiplies the weights after it, the
// weights are rounded to v's type before the weighted sum, the output is
// f32, and a row with key_len == 0 weighs its Tk keys uniformly.  The k
// and rawk rows of masked keys are never read, nor their v rows when a
// key is live.
//
// What bounds it: at B=256, Tq=Tk=50, d=128, the bytes (each input read
// once, the output written once: ~0.005 / 0.009 ms in bf16 / f32 in time
// mode).  Its three [64 x 64 x d] products at the padded size are ~0.8
// GFLOP: ~0.001 ms on the bf16 tensor cores, ~0.012 ms on the f32 FMA
// units.  The query design read each batch row's keys once per query.
//
// Design: one block per batch row (512 threads in bf16, 256 in f32), the
// whole Tq x Tk problem in shared memory, padded to 64 x 64:
//  1. the score products S0 = q k^T and, in time mode, TQK = tqw rawk^T
//     into f32 [64][68] planes;
//  2. the elementwise middle, a warp per query row, lanes on keys lane and
//     lane + 32: the gate, the scale, the mask, the softmax and the drop
//     mask; the weights, rounded to the input type, written over the
//     row's own S0 entries (as bf16 in bf16: a 272-byte row holds either),
//     zero past Tq and Tk;
//  3. out = W v, straight to global.
// bf16: q and k (then tqw and rawk) staged by cp.async as two copy
// groups, 64 rows with zeros past Tq or the live keys; the products on
// the tensor cores (attention_tile.cuh's mma_scores and mma_product).  In
// time mode v is staged over q once S0 is done, while TQK and the middle
// run: 102 KB a block (68 KB in the other modes, v in its own tile), so
// two blocks share an SM and B = 256 runs in one wave on 132 SMs.
// f32: no TF32 (f32 is held to 1e-5): register-tiled FMA, the operands
// streamed in d-slices through attention_tile.cuh's ring of three
// buffers (32 columns of q and k, or of tqw and rawk, for a score slice;
// 64 columns of v for an output slice): 88 KB a block in time mode.
// No float atomics: the same inputs give the same bits.

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

constexpr int kMmaThreads = 512;   // the bf16 kernel's

struct FwdArgs {
  const void *q, *k, *v, *t_q, *t_k, *tqw, *rawk, *w1, *b1, *wo1, *wo2, *bo;
  const int* key_len;
  const float* dm;          // read by the *_drop modes only
  float* out;
  int Tq, Tk, D;
  float scale;
};

size_t smem_bytes(bool bf16_in, bool time, int D) {
  const size_t planes = (size_t)(time ? 2 : 1) * kTile * kPlane * 4;
  if (!bf16_in) return planes + kStages * (size_t)kBufFloats * 4;
  // q, k, and tqw, rawk (v over q) or v
  return planes + (size_t)(time ? 4 : 3) * kTile * bf_stride(D) * 2;
}

// A warp per query row i (of 64): lanes take keys lane and lane + 32.
// Reads the f32 planes S0 and TQK (time mode) at the live keys; writes
// the weights (times dm in the drop modes) rounded to T, as T, over the
// row's S0 entries, 0 past Tq and Tk.
template <typename T, int MODE, bool DROP>
__device__ void middle(const FwdArgs& a, int b, float* pS, const float* pT) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int Tq = a.Tq, Tk = a.Tk;
  const int live = max(0, min(a.key_len[b], Tk));
  const T* t_k = static_cast<const T*>(a.t_k) + (size_t)b * Tk;
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* wo1 = static_cast<const T*>(a.wo1);
  const T* wo2 = static_cast<const T*>(a.wo2);
  const T* bo = static_cast<const T*>(a.bo);
  const float scale = a.scale;

  for (int i = warp; i < kTile; i += warps) {
    float* rs = pS + i * kPlane;
    float w[2] = {0.f, 0.f};
    if (i < Tq) {
      const size_t row = (size_t)b * Tq + i;
      const float tq = MODE == ATT_PLAIN
          ? 0.f : port::to_float(static_cast<const T*>(a.t_q)[row]);
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        float sc = kNegFill;
        if (c < live) {
          const float qk = rs[c];
          if (MODE == ATT_TIME) {
            const int gi = i * Tk + c;
            const float logdt = log1pf(fabsf(tq - port::to_float(t_k[c])));
            const float decay = tanhf(logdt * port::to_float(w1[gi]) +
                                      port::to_float(b1[gi]));
            const float gate = port::to_float(wo1[gi]) * decay +
                               port::to_float(wo2[gi]) *
                                   tanhf(pT[i * kPlane + c]) +
                               port::to_float(bo[gi]);
            sc = qk * port::sigmoid(gate) * scale;
          } else if (MODE == ATT_TISAS) {
            const float logdt = log1pf(fabsf(tq - port::to_float(t_k[c])));
            sc = (qk + logdt) * scale;
          } else {
            sc = qk * scale;
          }
        }
        s[h] = c < Tk ? sc : -INFINITY;
      }
      // softmax over the Tk keys (uniform when none is live)
      const float m = port::warp_max(fmaxf(s[0], s[1]));
      float e[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        e[h] = lane + 32 * h < Tk ? expf(s[h] - m) : 0.f;
      const float denom = port::warp_sum(e[0] + e[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if (c >= Tk) continue;
        float wv = e[h] / denom;
        if (DROP) wv *= a.dm[row * Tk + c];
        w[h] = port::round_to<T>(wv);
      }
    }
    __syncwarp();   // the row's f32 values are all read before the writes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      if constexpr (sizeof(T) == 2)
        reinterpret_cast<bf16*>(rs)[c] = __float2bfloat16_rn(w[h]);
      else
        rs[c] = w[h];
    }
  }
}

// ---------------------------------------------------------- bf16 (mma.sync)

template <int MODE, bool DROP>
__global__ void __launch_bounds__(kMmaThreads, 2) attn_fwd_tile_mma_kernel(
    FwdArgs a) {
  constexpr bool TIME = MODE == ATT_TIME;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, S = bf_stride(D), Tq = a.Tq, Tk = a.Tk;
  const int b = blockIdx.x;
  const int live = max(0, min(a.key_len[b], Tk));
  const int span = live > 0 ? live : Tk;      // the v rows the weights reach
  float* pS = reinterpret_cast<float*>(smem_raw);
  float* pT = pS + kTile * kPlane;            // time mode only
  bf16* sq = reinterpret_cast<bf16*>(pS + (TIME ? 2 : 1) * kTile * kPlane);
  bf16* sk = sq + kTile * S;
  bf16* sx = sk + kTile * S;                  // time mode: tqw; else v
  bf16* srk = sx + kTile * S;                 // time mode: rawk
  bf16* sv = TIME ? sq : sx;
  const size_t qrow = (size_t)b * Tq * D, krow = (size_t)b * Tk * D;
  auto in = [&](const void* p) { return static_cast<const bf16*>(p); };

  // two copy groups: (q, k), then (tqw, rawk) in time mode, else v
  stage_rows(sq, in(a.q) + qrow, Tq, D);
  stage_rows(sk, in(a.k) + krow, live, D);
  tile::cp_async_commit();
  if (TIME) {
    stage_rows(sx, in(a.tqw) + qrow, Tq, D);
    stage_rows(srk, in(a.rawk) + krow, live, D);
  } else {
    stage_rows(sv, in(a.v) + krow, span, D);
  }
  tile::cp_async_commit();
  const int nk = D / 16;
  tile::cp_async_wait<1>();
  __syncthreads();
  mma_scores(pS, sq, sk, S, nk, Tq, Tk);
  if (TIME) {
    __syncthreads();   // every warp is done with q: v goes over it
    stage_rows(sv, in(a.v) + krow, span, D);
    tile::cp_async_commit();
    tile::cp_async_wait<1>();   // tqw and rawk have landed
    __syncthreads();
    mma_scores(pT, sx, srk, S, nk, Tq, Tk);
  }
  __syncthreads();
  middle<bf16, MODE, DROP>(a, b, pS, pT);
  tile::cp_async_wait<0>();
  __syncthreads();
  mma_product<false>(a.out + qrow, pS, sv, S, Tq, D, (Tk + 15) / 16);
}

// ------------------------------------------------------------- f32 (FMA)

template <int MODE, bool DROP>
__global__ void __launch_bounds__(kFmaThreads, 2) attn_fwd_tile_fma_kernel(
    FwdArgs a) {
  constexpr bool TIME = MODE == ATT_TIME;
  constexpr int NA = TIME ? 2 : 1;   // score products
  extern __shared__ __align__(16) float smem_f[];
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const int b = blockIdx.x;
  const int live = max(0, min(a.key_len[b], Tk));
  const int span = live > 0 ? live : Tk;      // the v rows the weights reach
  const int warp = threadIdx.x >> 5;
  float* pS = smem_f;
  float* pT = pS + kTile * kPlane;            // time mode only
  float* buf0 = pS + NA * kTile * kPlane;
  auto buf = [&](int s) { return buf0 + (s % kStages) * kBufFloats; };
  const size_t qrow = (size_t)b * Tq * D, krow = (size_t)b * Tk * D;
  auto in = [&](const void* p) { return static_cast<const float*>(p); };
  const float* q = in(a.q) + qrow;
  const float* k = in(a.k) + krow;
  const float* v = in(a.v) + krow;
  const float* tqw = TIME ? in(a.tqw) + qrow : nullptr;
  const float* rawk = TIME ? in(a.rawk) + krow : nullptr;

  // the steps: score product p's slice j (S0 = q k^T, then TQK = tqw
  // rawk^T in time mode), then the output's slice j (out = W v)
  const int sa = (D + kSliceA - 1) / kSliceA, sb = (D + kSliceB - 1) / kSliceB;
  const int n_a = NA * sa, n_steps = n_a + sb;

  auto stage = [&](int s) {
    float* dst = buf(s);
    if (s >= n_steps) {
      // past the last step: an empty group keeps the count of groups
    } else if (s < n_a) {
      const int p = s / sa, c0 = (s % sa) * kSliceA;
      stage_slice(dst, kStrideA, kSliceA, p == 0 ? q : tqw, Tq, D, c0);
      stage_slice(dst + kTile * kStrideA, kStrideA, kSliceA,
                  p == 0 ? k : rawk, live, D, c0);
    } else {
      stage_slice(dst, kStrideB, kSliceB, v, span, D, (s - n_a) * kSliceB);
    }
    tile::cp_async_commit();
  };

  float acc[4][4];
  slice_ring(n_steps, stage, [&](int s) {
    if (s == n_a) {
      middle<float, MODE, DROP>(a, b, pS, pT);
      __syncthreads();
    }
    const float* x = buf(s);
    if (s < n_a) {
      const int p = s / sa, slice = s % sa;
      if (slice == 0) fma_zero(acc);
      if (8 * warp < Tq) fma_scores_slice(acc, x, x + kTile * kStrideA);
      if (slice == sa - 1) fma_store_plane(p == 0 ? pS : pT, acc);
    } else {
      fma_product_slice(acc, pS, x, false, Tq, Tq, Tk);
      fma_store_out(a.out + qrow, Tq, D, (s - n_a) * kSliceB, acc);
    }
  });
}

// the kernel of a mode and input type
template <int MODE, bool DROP>
void* kernel_of(bool is_bf16) {
  return is_bf16 ? reinterpret_cast<void*>(attn_fwd_tile_mma_kernel<MODE, DROP>)
                 : reinterpret_cast<void*>(attn_fwd_tile_fma_kernel<MODE, DROP>);
}

void* kernel_for(int mode, bool is_bf16) {
  switch (mode) {
    case ATT_PLAIN: return kernel_of<ATT_PLAIN, false>(is_bf16);
    case ATT_TIME: return kernel_of<ATT_TIME, false>(is_bf16);
    case ATT_TISAS: return kernel_of<ATT_TISAS, false>(is_bf16);
    case ATT_PLAIN_DROP: return kernel_of<ATT_PLAIN, true>(is_bf16);
    case ATT_TISAS_DROP: return kernel_of<ATT_TISAS, true>(is_bf16);
    default: return nullptr;
  }
}

bool takes(int mode, int Tq, int Tk, int D) {
  return mode >= ATT_PLAIN && mode <= ATT_TISAS_DROP && Tq >= 1 &&
         Tq <= kTile && Tk >= 1 && Tk <= kTile && D >= 16 && D <= kMaxD &&
         D % 16 == 0;
}

}  // namespace

// The arguments of fused_attention_launch (fused_attention.cu), with
// 1 <= Tq, Tk <= 64, D a multiple of 16 up to 128, and q, k, v (and tqw,
// rawk in time mode) 16-byte aligned.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fused_attention_tile_launch(
    int mode, int is_bf16, const void* q, const void* k, const void* v,
    const void* t_q, const void* t_k, const void* tqw, const void* rawk,
    const void* w1, const void* b1, const void* wo1, const void* wo2,
    const void* bo, const void* key_len, const void* dm, void* out, int B,
    int Tq, int Tk, int D, float scale, int device, void* stream) {
  if (!takes(mode, Tq, Tk, D) || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FwdArgs a;
  a.q = q; a.k = k; a.v = v; a.t_q = t_q; a.t_k = t_k; a.tqw = tqw;
  a.rawk = rawk; a.w1 = w1; a.b1 = b1; a.wo1 = wo1; a.wo2 = wo2; a.bo = bo;
  a.key_len = static_cast<const int*>(key_len);
  a.dm = static_cast<const float*>(dm);
  a.out = static_cast<float*>(out);
  a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.scale = scale;
  const size_t smem = smem_bytes(is_bf16 != 0, mode == ATT_TIME, D);
  const void* kernel = kernel_for(mode, is_bf16 != 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  return cudaLaunchKernel(kernel, dim3(B), dim3(is_bf16 ? kMmaThreads
                                                        : kFmaThreads),
                          params, smem, static_cast<cudaStream_t>(stream));
}

// The shared memory a block of a mode's kernel takes at width D, in bytes
// (0 for a shape the kernel does not take).
extern "C" long long fused_attention_tile_smem_bytes(int mode, int is_bf16,
                                                     int D) {
  if (!takes(mode, 1, 1, D)) return 0;
  return (long long)smem_bytes(is_bf16 != 0, mode == ATT_TIME, D);
}

// The blocks of a mode's kernel that fit on one SM at width D (the
// occupancy calculator's answer, with the launch's shared memory), or the
// negated cudaError_t.
extern "C" int fused_attention_tile_blocks_per_sm(int mode, int is_bf16,
                                                  int D, int device) {
  if (!takes(mode, 1, 1, D)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = smem_bytes(is_bf16 != 0, mode == ATT_TIME, D);
  const void* kernel = kernel_for(mode, is_bf16 != 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, is_bf16 ? kMmaThreads : kFmaThreads, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}
