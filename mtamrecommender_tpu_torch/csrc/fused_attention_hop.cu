// Fused attention middle, forward, at one query row: the wrapper's "hop"
// design (`attention_fwd_design`: Tq = 1, 1 <= Tk <= 64, D a multiple of
// 16 up to 128; MTAM's serving hops at L=50, d=128 and the narrow d=16).
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py,
// _attn_kernel (launched by _fused_attention_fwd) at those shapes, in all
// five of its modes (plain, time, tisas, plain_drop, tisas_drop).  The
// same function as fused_attention.cu (the "query" design, which keeps
// every other shape the tile design does not take), per batch row b:
//   s_c   = q . k_c
//   time:  logdt = log1p|t_q - t_k[c]|
//          gate  = wo1[c]*tanh(logdt*w1[c] + b1[c]) + wo2[c]*tanh(tqw . rawk_c)
//                  + bo[c]
//          s_c   = s_c * sigmoid(gate) / sqrt(D)
//   tisas: s_c   = (s_c + logdt) / sqrt(D)
//   plain: s_c   = s_c / sqrt(D)
//   s_c = -2^32+1 for c >= key_len[b]; w = softmax(s) (x dm[b,c] in the
//   *_drop modes), rounded to v's type; out = sum_c w_c v_c   (f32 [D])
// Products take the operand type and sum in f32.  A row with no live key
// gets a uniform softmax over its Tk keys, as the unpadded reference.
//
// What bounds it: bytes, then latency.  At B=256, Tk=50, D=128 in time
// mode a row reads the live keys' k and rawk rows and the reached keys'
// v rows, ~1.6 / 3.1 us of the card's 3.35 TB/s for the batch (bf16 /
// f32), and each block's chain of dependent steps (the rows' arrival, the
// dots, the softmax, the weighted sum) is longer than that.  The query
// design (a block of 128 threads) requested each phase's rows only when
// the phase began, summed a key's dots with two 5-step shuffles, ran a
// key's gate on 32 lanes one key after another and its weighted sum as a
// chain of up to 50 dependent FMAs a column.
//
// Design: one block of 256 threads a batch row, on the chain readout's
// thread mapping (chain_staged.cuh: lane c of half-warp h owns 8
// columns).
// 1. At the block's start one thread requests every row the block reads,
//    by bulk copies (TMA, evict first) into shared memory: the live keys'
//    k rows (and rawk rows in time mode) on one mbarrier, then the reached
//    keys' v rows (the live ones; all Tk in a row with none live) on a
//    second, so v lands while the scores and the softmax run.  Each block
//    of rows is contiguous in global memory: one instruction a block.
// 2. While they come in: q (and tqw) into shared memory, and warp 0 loads
//    the per-key terms of its two keys a lane (t_k, the gate parameters,
//    the drop mask) and computes the time-only half of the gate (decay)
//    or tisas's logdt.
// 3. Scores: half-warp h takes keys h, h+16, h+32, h+48, its lanes' dots
//    over their 8 columns, all keys' loads in flight together; the keys'
//    k and rawk dots summed over the 16 lanes in one butterfly
//    (`half_sums`).
// 4. Gate and softmax in warp 0, two keys a lane, shuffles only: the
//    transcendentals once a key, keys in parallel.
// 5. o = sum_c w_c v_c by key slices (half-warp h the keys h, h+16, ...
//    in key order), the two half-warps of a warp added, then the 8 warps'
//    partials in order from warp 0.  No atomics: the same inputs give the
//    same bits.
// Shared memory a block: (3 in time mode, else 2) x Tk x D of the operand
// type (at most 48 KB in bf16, 96 KB in f32) and ~6 KB of f32 vectors:
// two blocks an SM in f32, B=256 in one wave.

#include <cstdint>
#include <initializer_list>

#include "chain_staged.cuh"

namespace {

using namespace chain_staged;
using readout::kNegFill;
using readout::kThreads;
using readout::kWarps;

// the Python wrapper's MODES order
enum { ATT_PLAIN = 0, ATT_TIME = 1, ATT_TISAS = 2, ATT_PLAIN_DROP = 3,
       ATT_TISAS_DROP = 4 };

struct Args {
  const void *q, *k, *v, *t_q, *t_k, *tqw, *rawk, *w1, *b1, *wo1, *wo2, *bo;
  const int* key_len;
  const float* dm;
  float* out;
  int Tk, D;
  float scale;
};

// The block's f32 vectors and the copies' barriers (static shared memory).
struct HopVecs {
  float q[kMaxD], tqw[kMaxD];
  float s0[kStagedKeys], tqk[kStagedKeys], w[kStagedKeys];
  float part[kWarps][kMaxD];   // per-warp partials of o
  // the mbarriers of the k (and rawk) rows and of the v rows
  alignas(8) unsigned long long bar[2];
};

template <typename T>
__device__ __forceinline__ const T* at(const void* p, size_t off) {
  return static_cast<const T*>(p) + off;
}

// rows of T staged a block: k and v, and rawk in time mode
constexpr int staged_planes(int mode) { return mode == ATT_TIME ? 3 : 2; }

// MODE is the base mode (plain, time or tisas); DROP applies dm.
template <typename T, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads, 2) attn_fwd_hop_kernel(Args a) {
  constexpr bool kTime = MODE == ATT_TIME;
  constexpr int kIssuer = 32;    // lane 0 of warp 1 (warp 0 loads key terms)
  extern __shared__ __align__(16) unsigned char hop_raw[];
  __shared__ __align__(16) HopVecs v;
  const int D = a.D, Tk = a.Tk, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = tid >> 4, c = tid & 15;
  const bool on = kGroup * c < D;              // the lane owns columns
  const int live = max(0, min(a.key_len[b], Tk));
  const int span = live > 0 ? live : Tk;
  const size_t LD = (size_t)Tk * D;
  T* Ks = reinterpret_cast<T*>(hop_raw);       // [K | V | rawk], [Tk, D]
  T* Vs = Ks + LD;
  T* Rs = Ks + 2 * LD;
  // ---- 1. every row the block reads, requested before anything else
  if (tid == kIssuer) {
    mbar_init(&v.bar[0]);
    mbar_init(&v.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned long long policy = evict_first();
    const unsigned kbytes = (unsigned)(live * D * sizeof(T));
    mbar_expect(&v.bar[0], (kTime ? 2 : 1) * kbytes);
    if (kbytes) {
      bulk_copy(Ks, at<T>(a.k, b * LD), kbytes, &v.bar[0], policy);
      if (kTime)
        bulk_copy(Rs, at<T>(a.rawk, b * LD), kbytes, &v.bar[0], policy);
    }
    const unsigned vbytes = (unsigned)(span * D * sizeof(T));
    mbar_expect(&v.bar[1], vbytes);
    bulk_copy(Vs, at<T>(a.v, b * LD), vbytes, &v.bar[1], policy);
  }
  // ---- 2. q and tqw; warp 0: its keys' terms (keys lane and lane + 32)
  if (tid < D) {
    v.q[tid] = port::to_float(at<T>(a.q, (size_t)b * D)[tid]);
    if (kTime) v.tqw[tid] = port::to_float(at<T>(a.tqw, (size_t)b * D)[tid]);
  }
  // time: wo1 decay (`part`), wo2 and bo; tisas: logdt (`part`)
  float part[2] = {0.f, 0.f}, wo2[2] = {0.f, 0.f}, bo[2] = {0.f, 0.f};
  float keep[2] = {1.f, 1.f};
  if (warp == 0) {
    const float tq =
        MODE == ATT_PLAIN ? 0.f : port::to_float(at<T>(a.t_q, b)[0]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int l = lane + 32 * j;
      if (MODE != ATT_PLAIN && l < live) {
        const float tk = port::to_float(at<T>(a.t_k, (size_t)b * Tk)[l]);
        const float logdt = log1pf(fabsf(tq - tk));
        if (kTime) {
          part[j] = port::to_float(at<T>(a.wo1, 0)[l]) *
                    tanhf(logdt * port::to_float(at<T>(a.w1, 0)[l]) +
                          port::to_float(at<T>(a.b1, 0)[l]));
          wo2[j] = port::to_float(at<T>(a.wo2, 0)[l]);
          bo[j] = port::to_float(at<T>(a.bo, 0)[l]);
        } else {
          part[j] = logdt;
        }
      }
      if (DROP && l < Tk) keep[j] = a.dm[(size_t)b * Tk + l];
    }
  }
  __syncthreads();                             // q, tqw and the barriers
  // ---- 3. the score dots, a half-warp a key
  {
    float qv[8];
    lane8<T>(v.q, c, D, on, qv);
    mbar_wait(&v.bar[0], 0);                   // k (and rawk) in
    float s0[kKeySlots];
    key_dots(qv, Ks, live, D, h, c, on, s0);
    if constexpr (kTime) {
      float tv[8], tp[kKeySlots];
      lane8<T>(v.tqw, c, D, on, tv);
      key_dots(tv, Rs, live, D, h, c, on, tp);
      // both dots' lane sums in one butterfly: lane c ends with value
      // half_sums_index(c), s0 of slot k or tqw . rawk of slot k - 4
      float x[2 * kKeySlots];
#pragma unroll
      for (int s = 0; s < kKeySlots; ++s) {
        x[s] = s0[s];
        x[kKeySlots + s] = tp[s];
      }
      const float r = half_sums(x, lane);
      const int k = half_sums_index<2 * kKeySlots>(lane);
      const int l = h + kHalves * (k % kKeySlots);
      if ((c & 1) == 0 && l < live) (k < kKeySlots ? v.s0 : v.tqk)[l] = r;
    } else {
      const float r = half_sums(s0, lane);
      const int l = h + kHalves * half_sums_index<kKeySlots>(lane);
      if ((c & 3) == 0 && l < live) v.s0[l] = r;
    }
  }
  __syncthreads();                             // the dots
  // ---- 4. the gate and the softmax over the Tk keys in warp 0
  if (warp == 0) {
    float s[2], m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int l = lane + 32 * j;
      s[j] = kNegFill;
      if (l < live) {
        const float qk = v.s0[l];
        if (kTime) {
          const float gate = part[j] + wo2[j] * tanhf(v.tqk[l]) + bo[j];
          s[j] = qk * port::sigmoid(gate) * a.scale;
        } else if (MODE == ATT_TISAS) {
          s[j] = (qk + part[j]) * a.scale;
        } else {
          s[j] = qk * a.scale;
        }
      }
      if (l < Tk) m = fmaxf(m, s[j]);
    }
    m = port::warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j] = lane + 32 * j < Tk ? expf(s[j] - m) : 0.f;
      sum += s[j];
    }
    sum = port::warp_sum(sum);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int l = lane + 32 * j;
      if (l < Tk) {
        float w = s[j] / sum;
        if (DROP) w *= keep[j];
        v.w[l] = port::round_to<T>(w);
      }
    }
  }
  __syncthreads();                             // the weights
  // ---- 5. o = sum_c w_c v_c over the reached keys
  mbar_wait(&v.bar[1], 0);                     // v in
  {
    float acc[8];
    key_sum(v.w, Vs, span, D, h, c, on, acc);
    warp_partial<T>(acc, v.part[warp], lane, c, D, on);
  }
  __syncthreads();
  if (tid < D) a.out[(size_t)b * D + tid] = warps_sum(v.part, tid);
}

bool hop_takes(int Tk, int D) { return staged_takes(Tk, D); }

template <typename T, int MODE>
size_t dynamic_bytes(int Tk, int D) {
  return (size_t)staged_planes(MODE) * Tk * D * sizeof(T);
}

// The kernel's dynamic shared memory limit, raised to the most any shape
// takes (Tk = kStagedKeys, D = kMaxD), once a device.
template <typename T, int MODE, bool DROP>
cudaError_t allow_smem(int device) {
  static unsigned raised = 0;                   // a bit a device
  if (device < 32 && (raised >> device) & 1u) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_hop_kernel<T, MODE, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dynamic_bytes<T, MODE>(kStagedKeys, kMaxD));
  if (err == cudaSuccess && device < 32) raised |= 1u << device;
  return err;
}

template <typename T, int MODE, bool DROP>
cudaError_t launch(const Args& a, int B, int device, cudaStream_t s) {
  cudaError_t err = allow_smem<T, MODE, DROP>(device);
  if (err != cudaSuccess) return err;
  attn_fwd_hop_kernel<T, MODE, DROP>
      <<<B, kThreads, dynamic_bytes<T, MODE>(a.Tk, a.D), s>>>(a);
  return cudaGetLastError();
}

// The kernel of (mode, type) as a pointer, its dynamic shared memory at
// (Tk, D) in `smem`, after `allow_smem`; nullptr for an unknown mode or
// the cudaError_t of `allow_smem` in `err`.
template <typename T>
const void* kernel_of(int mode, int Tk, int D, int device, size_t* smem,
                      cudaError_t* err) {
  switch (mode) {
#define PORT_HOP_KERNEL(ID, BASE, DROP)                         \
  case ID:                                                      \
    *smem = dynamic_bytes<T, BASE>(Tk, D);                      \
    *err = allow_smem<T, BASE, DROP>(device);                   \
    return (const void*)attn_fwd_hop_kernel<T, BASE, DROP>;
    PORT_HOP_KERNEL(ATT_PLAIN, ATT_PLAIN, false)
    PORT_HOP_KERNEL(ATT_TIME, ATT_TIME, false)
    PORT_HOP_KERNEL(ATT_TISAS, ATT_TISAS, false)
    PORT_HOP_KERNEL(ATT_PLAIN_DROP, ATT_PLAIN, true)
    PORT_HOP_KERNEL(ATT_TISAS_DROP, ATT_TISAS, true)
#undef PORT_HOP_KERNEL
    default: return nullptr;
  }
}

template <typename T>
cudaError_t launch_mode(int mode, const Args& a, int B, int device,
                        cudaStream_t s) {
  switch (mode) {
    case ATT_PLAIN: return launch<T, ATT_PLAIN, false>(a, B, device, s);
    case ATT_TIME: return launch<T, ATT_TIME, false>(a, B, device, s);
    case ATT_TISAS: return launch<T, ATT_TISAS, false>(a, B, device, s);
    case ATT_PLAIN_DROP: return launch<T, ATT_PLAIN, true>(a, B, device, s);
    case ATT_TISAS_DROP: return launch<T, ATT_TISAS, true>(a, B, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The design's shared memory a block at (mode, Tk, D), static and
// dynamic, in bytes (0 for a shape or mode it does not take).
extern "C" long long fused_attention_hop_smem_bytes(int mode, int is_bf16,
                                                    int Tk, int D) {
  if (!hop_takes(Tk, D) || mode < 0 || mode > 4) return 0;
  const size_t row = (size_t)Tk * D * (is_bf16 ? 2 : 4);
  return (long long)(staged_planes(mode) * row + sizeof(HopVecs));
}

// The design's blocks that fit on one SM at (mode, Tk, D) (the occupancy
// calculator's answer, with the launch's shared memory), or the negated
// cudaError_t.
extern "C" int fused_attention_hop_blocks_per_sm(int mode, int is_bf16,
                                                 int Tk, int D, int device) {
  if (!hop_takes(Tk, D)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  size_t smem = 0;
  const void* k =
      is_bf16 ? kernel_of<__nv_bfloat16>(mode, Tk, D, device, &smem, &err)
              : kernel_of<float>(mode, Tk, D, device, &smem, &err);
  if (!k) return -(int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                      smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// fused_attention_launch's interface (fused_attention.cu), at Tq = 1,
// 1 <= Tk <= 64 and D a multiple of 16 up to 128 (else
// cudaErrorInvalidValue); k and v, and rawk in time mode, 16-byte aligned
// (else cudaErrorMisalignedAddress): the bulk copies move 16-byte units.
// All pointers are device pointers to contiguous arrays: q/tqw [B,1,D],
// k/v/rawk [B,Tk,D], t_q [B,1], t_k [B,Tk], w1/b1/wo1/wo2/bo [1,Tk],
// key_len [B] int32, dm [B,1,Tk] f32 (the '*_drop' modes only), out
// [B,1,D] f32; the floating inputs but dm all f32 (is_bf16 = 0) or all
// bf16 (is_bf16 = 1); operands a mode does not read may be any pointer.
// Returns the launch's cudaError_t (0 on success).
extern "C" int fused_attention_hop_launch(
    int mode, int is_bf16, const void* q, const void* k, const void* v,
    const void* t_q, const void* t_k, const void* tqw, const void* rawk,
    const void* w1, const void* b1, const void* wo1, const void* wo2,
    const void* bo, const void* key_len, const void* dm, void* out, int B,
    int Tq, int Tk, int D, float scale, int device, void* stream) {
  if (Tq != 1 || B < 0 || !hop_takes(Tk, D) || mode < 0 || mode > 4)
    return cudaErrorInvalidValue;
  const bool time = mode == ATT_TIME;
  for (const void* p : {k, v, time ? rawk : v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
  a.q = q; a.k = k; a.v = v; a.t_q = t_q; a.t_k = t_k; a.tqw = tqw;
  a.rawk = rawk; a.w1 = w1; a.b1 = b1; a.wo1 = wo1; a.wo2 = wo2; a.bo = bo;
  a.key_len = static_cast<const int*>(key_len);
  a.dm = static_cast<const float*>(dm);
  a.out = static_cast<float*>(out);
  a.Tk = Tk; a.D = D;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_mode<__nv_bfloat16>(mode, a, B, device, s)
                 : launch_mode<float>(mode, a, B, device, s);
}
