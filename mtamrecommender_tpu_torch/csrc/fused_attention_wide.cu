// Forward of the fused attention middle past 64 keys (or 64 queries), up to
// 1024 keys: the "wide" design of fused_attention (the wrapper's
// `attention_fwd_design`: 2 <= Tq <= 1024, Tk <= 1024, Tq or Tk > 64).
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py,
// _attn_kernel (launched by _fused_attention_fwd for every call with at
// most 1024 keys), in all five modes, at the self-attention models' blocks
// past L=64 (Tq = Tk = L: Time_Aware_SA, SASrec, TiSAS and PISTRec, in
// training and serving).  It computes what fused_attention.cu's "query"
// design computes (that file's note gives the formulas) with the same
// rounding: products take the input type and sum in f32, the gate's
// transcendentals are the accurate ones (once per pair), a masked key
// scores -2^32 + 1, the softmax is f32 over the whole row, dm (f32)
// multiplies the weights after it, the weights are rounded to v's type
// before the weighted sum, the output is f32, and a row with key_len == 0
// weighs its Tk keys uniformly.  The k and rawk rows of masked keys are
// never read, nor their v rows when a key is live.
//
// What bounds it: at B=64, Tq=Tk=256, d=128, the bytes (each input read
// once, the output written once: ~0.007 / 0.012 ms in bf16 / f32 in time
// mode); its three [256 x 256 x 128] products a row are ~3.2 GFLOP:
// ~0.003 ms on the bf16 tensor cores, ~0.05 ms on the f32 FMA units.  The
// Pallas body holds a row's whole padded Tq x Tk tile in VMEM, which past
// 64 keys a block's shared memory cannot; the query design it replaced
// here read each row's keys once per query.
//
// Design: one block (128 threads) per (batch row, 16 query rows), grid
// (B, ceil(Tq / 16)); the 16 rows' f32 score strip [16][Tk] lives in
// shared memory (64 KB at Tk = 1024):
//  1. the keys in blocks of KB (32 in bf16, 16 in f32), k (and rawk in
//     time mode) by cp.async into a ring of two buffers: the block's score
//     products S0 = q k^T (and TQK = tqw rawk^T) into small f32 planes, then
//     the elementwise middle, a thread a (query, key) pair: the gate, the
//     scale, the key mask, into the strip;
//  2. the softmax over each strip row, a warp a row: its max, e = exp(s -
//     max) over the strip, the sum, the weights e / sum times dm, rounded
//     to the input type, written over the row (as bf16 in bf16);
//  3. v streamed again in KB-key blocks through the same ring: out += W v,
//     the sums in registers, the block's rows written once at the end.
// bf16: the products on the tensor cores (mma.sync m16n8k16, attention_
// tile.cuh's fragments); f32: no TF32 (f32 is held to 1e-5), register-
// tiled FMA.  Key blocks past the live keys skip their score products, and
// past the keys the weights reach skip the weighted sum.  No float atomics:
// the same inputs give the same bits.

#include "attention_wide.cuh"

namespace {

using namespace attn_wide;
using attn_tile::ATT_PLAIN;
using attn_tile::ATT_PLAIN_DROP;
using attn_tile::ATT_TIME;
using attn_tile::ATT_TISAS;
using attn_tile::ATT_TISAS_DROP;

struct FwdArgs {
  const void *q, *k, *v, *t_q, *t_k, *tqw, *rawk, *w1, *b1, *wo1, *wo2, *bo;
  const int* key_len;
  const float* dm;          // read by the *_drop modes only
  float* out;
  int Tq, Tk, D;
  float scale;
};

template <typename T>
size_t smem_bytes(bool time, int Tk, int D) {
  const int np = time ? 2 : 1;           // q (tqw); k (rawk); S0 (TQK)
  const size_t ST = op_stride<T>(D);
  return (size_t)kQT * strip_stride(Tk) * 4                   // the strip
         + np * kQT * ST * sizeof(T)                           // q, tqw
         + (size_t)kStages * np * key_block<T>() * ST * sizeof(T)   // ring
         + np * kQT * pc_stride<T>() * 4;                     // S0, TQK
}

template <typename T, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads) attn_fwd_wide_kernel(FwdArgs a) {
  constexpr bool TIME = MODE == ATT_TIME;
  constexpr int NP = TIME ? 2 : 1;
  constexpr int KB = key_block<T>(), PC = pc_stride<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const int ST = op_stride<T>(D), SP = strip_stride(Tk);
  const int b = blockIdx.x, i0 = blockIdx.y * kQT;
  const int live = max(0, min(a.key_len[b], Tk));
  const int span = live > 0 ? live : Tk;      // the v rows the weights reach
  const int n_kb = pad_keys(Tk) / KB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* strip = reinterpret_cast<float*>(smem_raw);
  T* sq = reinterpret_cast<T*>(strip + kQT * SP);
  T* stqw = sq + kQT * ST;                    // time mode only
  T* buf0 = sq + NP * kQT * ST;
  float* pc = reinterpret_cast<float*>(buf0 + kStages * NP * KB * ST);
  auto buf = [&](int s) { return buf0 + (s % kStages) * NP * KB * ST; };
  auto in = [&](const void* p) { return static_cast<const T*>(p); };
  const size_t qrow = (size_t)b * Tq * D, krow = (size_t)b * Tk * D;

  // the block's query rows (and tqw), a copy group before the ring's
  stage_rows<T>(sq, ST, in(a.q) + qrow, i0, kQT, Tq, D);
  if (TIME) stage_rows<T>(stqw, ST, in(a.tqw) + qrow, i0, kQT, Tq, D);
  tile::cp_async_commit();

  // steps [0, n_kb): key block s's scores; [n_kb, 2 n_kb): its weighted
  // sum.  A block no product reads is not copied.
  auto stage = [&](int s) {
    T* dst = buf(s);
    if (s < n_kb) {
      const int k0 = s * KB;
      if (k0 < live) {
        stage_rows<T>(dst, ST, in(a.k) + krow, k0, KB, live, D);
        if (TIME) stage_rows<T>(dst + KB * ST, ST, in(a.rawk) + krow, k0, KB,
                                live, D);
      }
    } else if (s < 2 * n_kb) {
      const int k0 = (s - n_kb) * KB;
      if (k0 < span) stage_rows<T>(dst, ST, in(a.v) + krow, k0, KB, span, D);
    }
    tile::cp_async_commit();
  };

  const T* t_k = in(a.t_k) + (size_t)b * Tk;
  const int r = threadIdx.x >> 3, kx = threadIdx.x & 7;   // the middle's pairs
  const int i = i0 + r;
  const float tq = (MODE == ATT_PLAIN || i >= Tq)
      ? 0.f : port::to_float(in(a.t_q)[(size_t)b * Tq + i]);
  // the weights as the input type: the strip's rows, 2 SP bf16 or SP f32
  const T* P = reinterpret_cast<const T*>(strip);
  const int sp = sizeof(T) == 2 ? 2 * SP : SP;
  QueryAcc<T> acc;
  acc.zero();

  attn_tile::slice_ring<kStages>(2 * n_kb, stage, [&](int s) {
    if (s < n_kb) {
      const int k0 = s * KB;
      const T* x = buf(s);
      if (k0 < live)
        block_scores(pc, NP, sq, x, stqw, x + KB * ST, nullptr, nullptr, ST,
                     D);
      __syncthreads();
      if (i >= Tq) return;
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) {
        const int cc = kx + 8 * j, c = k0 + cc;
        if (c >= Tk) continue;
        float sc = kNegFill;
        if (c < live) {
          Gate gt;
          sc = pair_score<T, MODE>(
              pc[r * PC + cc], TIME ? pc[kQT * PC + r * PC + cc] : 0.f, tq,
              MODE == ATT_PLAIN ? 0.f : port::to_float(t_k[c]), in(a.w1),
              in(a.b1), in(a.wo1), in(a.wo2), in(a.bo), (size_t)i * Tk + c,
              a.scale, gt);
        }
        strip[r * SP + c] = sc;
      }
      return;
    }
    if (s == n_kb) {
      // the softmax, a warp a strip row; the weights (0 past Tk) written
      // over the row as T, each 32-key chunk read before it is written
      const int ncols = n_kb * KB;
      for (int rr = warp; rr < kQT; rr += kThreads / 32) {
        float* row = strip + rr * SP;
        T* wrow = reinterpret_cast<T*>(row);
        const int ii = i0 + rr;
        const float denom = ii < Tq ? row_softmax_sums(row, Tk) : 1.f;
        for (int c0 = 0; c0 < ncols; c0 += 32) {
          const int c = c0 + lane;
          float w = 0.f;
          if (ii < Tq && c < Tk) {
            w = row[c] / denom;
            if (DROP) w *= a.dm[((size_t)b * Tq + ii) * Tk + c];
          }
          __syncwarp();
          if (c < ncols) store_as<T>(wrow + c, w);
        }
      }
      __syncthreads();
    }
    const int k0 = (s - n_kb) * KB;
    if (k0 < span) query_product(acc, P + k0, sp, buf(s), ST, D);
  });
  store_query<T>(a.out + qrow, acc, i0, Tq, D);
}

template <typename T>
void* kernel_for(int mode) {
  switch (mode) {
    case ATT_PLAIN: return reinterpret_cast<void*>(
        attn_fwd_wide_kernel<T, ATT_PLAIN, false>);
    case ATT_TIME: return reinterpret_cast<void*>(
        attn_fwd_wide_kernel<T, ATT_TIME, false>);
    case ATT_TISAS: return reinterpret_cast<void*>(
        attn_fwd_wide_kernel<T, ATT_TISAS, false>);
    case ATT_PLAIN_DROP: return reinterpret_cast<void*>(
        attn_fwd_wide_kernel<T, ATT_PLAIN, true>);
    case ATT_TISAS_DROP: return reinterpret_cast<void*>(
        attn_fwd_wide_kernel<T, ATT_TISAS, true>);
    default: return nullptr;
  }
}

bool takes(int mode, int Tq, int Tk, int D) {
  return mode >= ATT_PLAIN && mode <= ATT_TISAS_DROP && Tq >= 1 &&
         Tk >= 1 && Tk <= 1024 && D >= 16 && D <= 128 && D % 16 == 0;
}

size_t smem_of(int mode, bool is_bf16, int Tk, int D) {
  return is_bf16 ? smem_bytes<bf16>(mode == ATT_TIME, Tk, D)
                 : smem_bytes<float>(mode == ATT_TIME, Tk, D);
}

}  // namespace

// The arguments of fused_attention_launch (fused_attention.cu), with Tq >=
// 1, 1 <= Tk <= 1024, D a multiple of 16 up to 128, and q, k, v (and tqw,
// rawk in time mode) 16-byte aligned.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fused_attention_wide_launch(
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
  const size_t smem = smem_of(mode, is_bf16 != 0, Tk, D);
  const void* kernel = is_bf16 ? kernel_for<bf16>(mode) : kernel_for<float>(mode);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  return cudaLaunchKernel(kernel, dim3(B, (Tq + kQT - 1) / kQT),
                          dim3(kThreads), params, smem,
                          static_cast<cudaStream_t>(stream));
}

// The shared memory a block of a mode's kernel takes at (Tk, D), in bytes
// (0 for a shape the kernel does not take).
extern "C" long long fused_attention_wide_smem_bytes(int mode, int is_bf16,
                                                     int Tk, int D) {
  if (!takes(mode, 1, Tk, D)) return 0;
  return (long long)smem_of(mode, is_bf16 != 0, Tk, D);
}

// The blocks of a mode's kernel that fit on one SM at (Tk, D) (the
// occupancy calculator's answer, with the launch's shared memory), or the
// negated cudaError_t.
extern "C" int fused_attention_wide_blocks_per_sm(int mode, int is_bf16,
                                                  int Tk, int D, int device) {
  if (!takes(mode, 1, Tk, D)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = smem_of(mode, is_bf16 != 0, Tk, D);
  const void* kernel = is_bf16 ? kernel_for<bf16>(mode) : kernel_for<float>(mode);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}
