// Shared pieces of the chain readout's "staged" and "blocked" designs, the
// forward (readout_chain.cu) and the backward (readout_chain_bwd.cu), and
// of the attention forward's "hop" and "blocked" designs
// (fused_attention_hop.cu, fused_attention_blocked.cu).  Each
// takes one block of 256 threads a batch row, with D a multiple of 16 up
// to 128.  At 1 <= L <= kStagedKeys keys ("staged", "hop") a hop's K (and
// tprec or rawk) rows of the live keys and V rows of the reached keys
// come into shared memory once (the chain backward by 16-byte cp.async,
// `stage_rows`; the two forwards by bulk copies, `bulk_copy`); at
// kStagedKeys < L <= kBlockedMaxKeys ("blocked") they stream through a
// ring of shared-memory slots, kBlockKeys keys a slot (`KeyRing`), and
// each key's f32 score sits in a strip of L floats.  One thread mapping:
// lane c of half-warp h (16 a block) owns 8 columns (`col`), so
//  - a dot product against every key (`key_dots`) takes a half-warp a key,
//    keys l = h, h+16, ..., the keys' loads in flight together and their
//    lane sums in one butterfly (`half_sums`);
//  - a sum over keys (`key_sum`) takes keys l = h, h+16, ... a half-warp in
//    key order, then the two half-warps of a warp are added
//    (`warp_partial`) and the 8 warps' partials in order from warp 0
//    (`warps_sum`);
//  - a product with Wq takes its rows h, h+16, ... a half-warp, each row
//    at the lane's columns by 16-byte loads from L2 (`fetch_wq_rows`).
// Every sum runs in a fixed order: the same inputs give the same bits.
// L2 hints: the streamed rows evict first, Wq (read by every block of a
// hop) last.
#pragma once

#include <cstdint>

#include "readout_hop.cuh"

namespace chain_staged {

using readout::kMaxD;
using readout::kThreads;
using readout::kWarps;

constexpr int kStagedKeys = 64;               // the staged designs' largest L
constexpr int kHalves = kThreads / 16;        // half-warps a block
constexpr int kGroup = 8;                     // columns a lane owns
constexpr int kSlots = kMaxD / kHalves;       // rows of Wq a half-warp takes
constexpr int kKeySlots = kStagedKeys / kHalves;   // keys a half-warp takes
constexpr unsigned kFull = 0xffffffffu;

inline bool staged_takes(int L, int D) {
  return L >= 1 && L <= kStagedKeys && D >= 16 && D <= kMaxD && D % 16 == 0;
}

// The blocked designs: keys a ring slot holds (a slot of K and tprec rows
// is one key_dots / key_sum span: kKeySlots keys a half-warp), and the
// longest L (the score strips' length: one key a thread)
constexpr int kBlockKeys = kStagedKeys;
constexpr int kBlockedMaxKeys = kThreads;
// the ring's slots, each [2, kBlockKeys, D] (K then tprec rows, or V rows
// in the first half): 3 in either type (see readout_chain.cu's note)
constexpr int kRingSlots = 3;

inline bool blocked_takes(int L, int D) {
  return L > kStagedKeys && L <= kBlockedMaxKeys && D >= 16 && D <= kMaxD &&
         D % 16 == 0;
}

inline size_t ring_dynamic_bytes(bool bf16, int D) {
  return (size_t)kRingSlots * 2 * kBlockKeys * D * (bf16 ? 2 : 4);
}

// hops of K, V and tprec rows in shared memory at once: bf16
// double-buffers across hops, f32 (twice the bytes) stages one hop at a
// time, refilled piece by piece once its last reads are done
template <typename T>
constexpr int kStages = sizeof(T) == 2 ? 2 : 1;

inline size_t staged_dynamic_bytes(bool bf16, int L, int D) {
  return bf16 ? (size_t)2 * 3 * L * D * 2 : (size_t)3 * L * D * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// L2 policies: the rows and cotangents stream through once (evict first);
// Wq is read by every block of a hop (evict last)
__device__ __forceinline__ unsigned long long evict_first() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ unsigned long long evict_last() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint4 ldg16(const void* src,
                                       unsigned long long policy) {
  uint4 r;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(src), "l"(policy));
  return r;
}

// Bulk copies (TMA) into shared memory, completed on an mbarrier: one
// thread issues a block of rows with one instruction, and no thread
// stalls on the copies until it waits on the barrier.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)));
}
// The issuing thread's arrival, expecting `bytes` of copies (0: none).
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` completes.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar,
                                          unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}
// The same without an L2 hint (the rows stay in L2 as any load leaves
// them: for a second read).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One load of a KeyRing: `rows` rows of D elements of `a` into its slot's
// first half and, where `b` is given, of `b` into the second half.
// `again`: the rows are read again later in the launch (no L2 hint), else
// this is their last read (evict first).
template <typename T>
struct RingLoad {
  const T* a;
  const T* b;
  int rows;
  bool again;
};

// The blocked designs' ring: NSLOTS slots of [PLANES, kBlockKeys, D] in
// dynamic shared memory (the chain pair's kRingSlots slots of two planes;
// fused_attention_blocked.cu's plain and tisas modes twice as many of
// one, in the same bytes), an mbarrier a slot.  Loads are numbered in the
// order the block consumes them; load j goes to slot j % NSLOTS, and its
// barrier completes the phase of parity (j / NSLOTS) & 1.  One thread
// issues load j + NSLOTS once every thread has read load j (behind a
// __syncthreads), so NSLOTS - 1 loads stay in flight while one is read,
// and no load waits on the hop chain.  A load's `b` rows go to the
// second plane (PLANES = 2 only).
template <typename T, int PLANES = 2, int NSLOTS = kRingSlots>
struct KeyRing {
  T* base;
  unsigned long long* bar;
  int D;

  __device__ __forceinline__ T* slot(int j) const {
    return base + (size_t)(j % NSLOTS) * PLANES * kBlockKeys * D;
  }
  __device__ __forceinline__ void wait(int j) const {
    mbar_wait(&bar[j % NSLOTS], (unsigned)(j / NSLOTS) & 1u);
  }
  // by one thread, with load j's slot free
  __device__ __forceinline__ void issue(int j, const RingLoad<T>& ld) const {
    T* dst = slot(j);
    unsigned long long* b = &bar[j % NSLOTS];
    const unsigned bytes = (unsigned)((size_t)ld.rows * D * sizeof(T));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(b, ld.b ? 2 * bytes : bytes);
    T* dst_b = dst + (size_t)kBlockKeys * D;
    if (ld.again) {
      bulk_copy(dst, ld.a, bytes, b);
      if (ld.b) bulk_copy(dst_b, ld.b, bytes, b);
    } else {
      const unsigned long long policy = evict_first();
      bulk_copy(dst, ld.a, bytes, b, policy);
      if (ld.b) bulk_copy(dst_b, ld.b, bytes, b, policy);
    }
  }
};

// The 8 columns lane c of a half-warp owns, so that each 16-byte access
// of a quarter-warp covers 128 contiguous bytes (no bank conflict, full
// sectors): in bf16 8c .. 8c+7 (one vector), in f32 4c .. 4c+3 and D/2 +
// 4c .. D/2 + 4c+3 (two).  x[j] is column col<T>(c, j, D).
template <typename T>
__device__ __forceinline__ int col(int c, int j, int D) {
  if constexpr (sizeof(T) == 2) return kGroup * c + j;
  else return j < 4 ? 4 * c + j : D / 2 + 4 * c + j - 4;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void split(const float4& a, const float4& b,
                                      float (&x)[8]) {
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// A lane's 8 elements of a row of T in shared memory, as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int c, int D,
                                      float (&x)[8]) {
  unpack(*reinterpret_cast<const uint4*>(row + kGroup * c), x);
}
__device__ __forceinline__ void load8(const float* row, int c, int D,
                                      float (&x)[8]) {
  split(*reinterpret_cast<const float4*>(row + 4 * c),
        *reinterpret_cast<const float4*>(row + D / 2 + 4 * c), x);
}
// A lane's 8 elements of an f32 vector of the block (0 past D's lanes).
template <typename T>
__device__ __forceinline__ void lane8(const float* vec, int c, int D, bool on,
                                      float (&x)[8]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) x[j] = on ? vec[col<T>(c, j, D)] : 0.f;
}

// x[k] (k < N, N a power of 2 up to 16) summed over the 16 lanes of a
// half-warp (every lane of the warp calls): each xor level halves the
// values a lane carries (lanes with the offset's bit set keep the upper
// half), so the sums take N - 1 + 4 - log2 N shuffles where N separate
// butterflies take 4 N, and every sum pairs its lanes as a butterfly does
// (xor 8, 4, 2, 1).  Returns the sum of x[k] in every lane whose bits 3
// .. 4 - log2 N, read as a number (bit 3 first), are k.
template <int N>
__device__ __forceinline__ float half_sums(float (&x)[N], int lane) {
#pragma unroll
  for (int off = 8, n = N; off > 0; off >>= 1) {
    if (n > 1) {
      const bool up = lane & off;
#pragma unroll
      for (int k = 0; k < n / 2; ++k) {
        const float send = up ? x[k] : x[k + n / 2];
        const float keep = up ? x[k + n / 2] : x[k];
        x[k] = keep + __shfl_xor_sync(kFull, send, off);
      }
      n /= 2;
    } else {
      x[0] += __shfl_xor_sync(kFull, x[0], off);
    }
  }
  return x[0];
}

// the value index a lane of a half-warp holds after half_sums<N>
template <int N>
__device__ __forceinline__ int half_sums_index(int lane) {
  int k = 0;
#pragma unroll
  for (int off = 8, n = N; n > 1; off >>= 1, n /= 2) k = 2 * k + ((lane & off) != 0);
  return k;
}

// d[s] = a . X[l] over the lane's columns for keys l = h + 16 s, s <
// kKeySlots, 0 at l >= n: the keys' loads all in flight together
template <typename T>
__device__ __forceinline__ void key_dots(const float (&a)[8], const T* X,
                                         int n, int D, int h, int c, bool on,
                                         float (&d)[kKeySlots]) {
#pragma unroll
  for (int s = 0; s < kKeySlots; ++s) {
    const int l = h + kHalves * s;
    d[s] = 0.f;
    if (on && l < n) {
      float x[8];
      load8(X + (size_t)l * D, c, D, x);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) d[s] = fmaf(a[j], x[j], d[s]);
    }
  }
}

// acc += sum over keys l = h, h+16, ... < n of (coef[l] / denom) X[l] over
// the lane's columns, in key order (the blocked designs: a slot's keys,
// coef and X at the slot's first key, acc carried across the slots)
template <typename T>
__device__ __forceinline__ void key_sum_acc(const float* coef, float denom,
                                            const T* X, int n, int D, int h,
                                            int c, bool on, float (&acc)[8]) {
#pragma unroll
  for (int s = 0; s < kKeySlots; ++s) {
    const int l = h + kHalves * s;
    if (on && l < n) {
      float x[8];
      load8(X + (size_t)l * D, c, D, x);
      const float k = coef[l] / denom;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[j] = fmaf(k, x[j], acc[j]);
    }
  }
}

// acc = sum over keys l = h, h+16, ... < n of coef[l] X[l] over the lane's
// columns, in key order (x / 1 is x: the same bits)
template <typename T>
__device__ __forceinline__ void key_sum(const float* coef, const T* X, int n,
                                        int D, int h, int c, bool on,
                                        float (&acc)[8]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) acc[j] = 0.f;
  key_sum_acc(coef, 1.f, X, n, D, h, c, on, acc);
}

// The largest of v[0, n) (n <= MAXN: the chain pair's kBlockedMaxKeys,
// the attention's 1024), in every lane of the calling warp; every warp
// that calls gets the same value.
template <int MAXN = kBlockedMaxKeys>
__device__ __forceinline__ float strip_max(const float* v, int n, int lane) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXN / 32; ++j) {
    const int l = lane + 32 * j;
    if (l < n) m = fmaxf(m, v[l]);
  }
  return port::warp_max(m);
}
// The sum of v[l] (w[l] / denom, where w is given) over l < n (n <=
// MAXN), a lane its keys lane, lane + 32, ... in order, then a butterfly:
// the same bits in every lane of every warp that calls.
template <int MAXN = kBlockedMaxKeys>
__device__ __forceinline__ float strip_sum(const float* v, const float* w,
                                           float denom, int n, int lane) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MAXN / 32; ++j) {
    const int l = lane + 32 * j;
    if (l < n) s += w ? v[l] * (w[l] / denom) : v[l];
  }
  return port::warp_sum(s);
}

// a warp's two half-warp partials added (lane + lane ^ 16) and stored to
// part at the lane's columns (every lane of the warp calls)
template <typename T>
__device__ __forceinline__ void warp_partial(float (&acc)[8], float* part,
                                             int lane, int c, int D, bool on) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], 16);
  if (lane < 16 && on)
#pragma unroll
    for (int j = 0; j < kGroup; ++j) part[col<T>(c, j, D)] = acc[j];
}

// sum of the warps' partials of column e, warp 0 first
__device__ __forceinline__ float warps_sum(const float (&part)[kWarps][kMaxD],
                                          int e) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[w][e];
  return s;
}

// Rows e = h + 16 s of a [D, D] matrix at the lane's columns, s < kSlots:
// in bf16 loaded ahead (eight 16-byte vectors a lane in registers), in
// f32 (twice the registers) where each is used.
template <typename T>
struct WqRows {
  uint4 raw[kSlots];
};
template <>
struct WqRows<float> {};

template <typename T>
__device__ __forceinline__ void fetch_wq_rows(WqRows<T>& r, const T* WQ,
                                              int h, int c, int D, bool on) {
  if constexpr (sizeof(T) == 2) {
    const unsigned long long policy = evict_last();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = h + kHalves * s;
      if (on && e < D) r.raw[s] = ldg16(WQ + (size_t)e * D + kGroup * c, policy);
    }
  }
}


}  // namespace chain_staged
