// Fused attention middle, forward, at one query row past 64 keys: the
// wrapper's "blocked" design (`attention_fwd_design`: Tq = 1, 65 <= Tk <=
// 1024, D a multiple of 16 up to 128; MTAM's serving hops at 65 <= L <=
// 255, the reference's cap of L=150 among them, and the plain-kind
// readout's hops up to 1024 keys).
//
// Replaces: mtamrecommender_tpu/ops/pallas/attention_kernel.py,
// _attn_kernel (launched by _fused_attention_fwd) at those shapes, in all
// five of its modes (plain, time, tisas, plain_drop, tisas_drop).  The
// same function as fused_attention_hop.cu, per batch row b:
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
// What bounds it: bytes, then latency.  At B=64, Tk=150, D=128 in time
// mode the batch reads 7.4 / 14.7 MB of k, rawk and v (bf16 / f32), ~2.2
// / 4.4 us at 3.35 TB/s; at Tk=1024, B=256 in plain mode 67 / 134 MB, ~20
// / 40 us.  The query design (fused_attention.cu, a block of 128 threads a
// query row) requested the k and rawk rows only when the scoring began,
// kept the scores and the softmax in a Tk-float array, and summed each
// output column as a serial chain of up to Tk dependent FMAs.
//
// Design: one block of 256 threads a batch row, on the chain readout's
// thread mapping (chain_staged.cuh: lane c of half-warp h owns 8 columns).
// The hop design stages a row's rows whole; past 64 keys they do not fit
// (3 Tk D es bytes: 768 KB at Tk=1024, D=128 in f32), so:
// 1. The rows stream through a ring of shared-memory slots of kBlockKeys =
//    64 keys (`KeyRing`, chain_staged.cuh, the chain pair's ring), one
//    bulk copy (TMA, evict first) a block of rows and an mbarrier a slot.
//    The loads are numbered in reading order: the live keys' k blocks,
//    then the reached keys' v blocks (the live ones; all Tk in a row with
//    none live), so the first v blocks arrive while the scores and the
//    softmax run.  In time mode a slot is [2, 64, D], a block's k rows then its
//    rawk rows (a v block uses the first plane), 3 slots; plain and tisas
//    read no rawk, so the same bytes make 6 slots of one plane, and twice
//    as many loads stay in flight.  The ring is 96 KB (bf16) / 192 KB
//    (f32) at D=128 in every mode.
// 2. While the first slots are in flight: q (and tqw) into shared memory,
//    and each thread the per-key terms of its keys tid + 256 i (t_k, the
//    gate row at query 0, and in the drop modes dm, which goes to a
//    strip): the time-only half of the gate (wo1 decay) or tisas's logdt,
//    kept in registers.
// 3. Scores: a k block at a time, half-warp h the keys h, h+16, h+32,
//    h+48 of the block, its lanes' dots over their 8 columns with the four
//    keys' loads in flight together, the k and rawk dots summed over the
//    16 lanes in one butterfly (`half_sums`), into f32 strips of all Tk
//    keys (s0 and tqk, then e: 12 KB at Tk=1024, in dynamic shared memory
//    sized by Tk).
// 4. Each thread scores its keys (gate, scale, mask); the softmax over the
//    whole strip, each warp taking the strip's max and sum itself (the
//    same bits in every warp), two barriers.
// 5. o = sum_c w_c v_c a v block at a time, keys c = h, h+16, ... a
//    half-warp in key order across the blocks, each weight w_c = e_c /
//    sum (x dm_c) rounded to v's type where it is used; then the two
//    half-warps of a warp added and the 8 warps' partials in order from
//    warp 0.  No atomics: the same inputs give the same bits.
// Occupancy: at B=64 a block a row fills 64 of the 132 SMs.  A two-CTA
// cluster splitting a row's keys would use the rest at the cost of a
// merge over distributed shared memory; it is not built.  Shared memory a
// block at D=128: the ring, 3 x Tk floats of strips (Tk rounded up to 32)
// and 5 KB of vectors: two blocks an SM in bf16 up to Tk = 992, one in
// f32.

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

constexpr int kMaxKeys = 1024;                        // SINGLE_TILE_KEYS
constexpr int kKeysPerThread = kMaxKeys / kThreads;   // the per-key terms

struct Args {
  const void *q, *k, *v, *t_q, *t_k, *tqw, *rawk, *w1, *b1, *wo1, *wo2, *bo;
  const int* key_len;
  const float* dm;
  float* out;
  int Tk, D;
  float scale;
};

// a ring slot's planes (k, then rawk in time mode) and the slots in the
// same bytes
__host__ __device__ constexpr int ring_planes(int mode) {
  return mode == ATT_TIME ? 2 : 1;
}
__host__ __device__ constexpr int ring_slots(int mode) {
  return kRingSlots * 2 / ring_planes(mode);
}

// The block's f32 vectors and the ring's barriers (static shared memory).
struct BlockedVecs {
  float q[kMaxD], tqw[kMaxD];
  float part[kWarps][kMaxD];   // per-warp partials of o
  alignas(8) unsigned long long bar[2 * kRingSlots];
};

__host__ __device__ constexpr size_t ring_bytes(size_t es, int D) {
  return (size_t)kRingSlots * 2 * kBlockKeys * D * es;
}
// a strip's floats: Tk rounded up to a warp's lanes
__host__ __device__ constexpr int strip_len(int Tk) {
  return (Tk + 31) / 32 * 32;
}

template <typename T>
__device__ __forceinline__ const T* at(const void* p, size_t off) {
  return static_cast<const T*>(p) + off;
}

// acc += w_l X[l] over keys l = h, h+16, ... < n at the lane's columns, in
// key order, w_l = e[l] / sum (x keep[l] where DROP) rounded to T: the
// hop design's weights, each computed where it is used
template <typename T, bool DROP>
__device__ __forceinline__ void weighted_rows(const float* e,
                                              const float* keep, float sum,
                                              const T* X, int n, int D,
                                              int h, int c, bool on,
                                              float (&acc)[8]) {
#pragma unroll
  for (int s = 0; s < kKeySlots; ++s) {
    const int l = h + kHalves * s;
    if (on && l < n) {
      float x[8];
      load8(X + (size_t)l * D, c, D, x);
      float w = e[l] / sum;
      if (DROP) w *= keep[l];
      w = port::round_to<T>(w);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[j] = fmaf(w, x[j], acc[j]);
    }
  }
}

// MODE is the base mode (plain, time or tisas); DROP applies dm.
template <typename T, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads, 2) attn_fwd_blocked_kernel(Args a) {
  constexpr bool kTime = MODE == ATT_TIME;
  constexpr int kPlanes = ring_planes(MODE), kSlots = ring_slots(MODE);
  constexpr int kIssuer = 32;                   // lane 0 of warp 1
  extern __shared__ __align__(128) unsigned char blocked_raw[];
  __shared__ __align__(16) BlockedVecs v;
  const int D = a.D, Tk = a.Tk, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = tid >> 4, c = tid & 15;
  const bool on = kGroup * c < D;               // the lane owns columns
  const int live = max(0, min(a.key_len[b], Tk));
  const int span = live > 0 ? live : Tk;
  const int nkt = (live + kBlockKeys - 1) / kBlockKeys;   // k loads
  const int total = nkt + (span + kBlockKeys - 1) / kBlockKeys;
  const size_t LD = (size_t)Tk * D;
  const KeyRing<T, kPlanes, kSlots> ring{reinterpret_cast<T*>(blocked_raw),
                                         v.bar, D};
  // the strips: s0 (q . k_c, then the score), tqk (tqw . rawk_c in time
  // mode, dm in the drop modes), e (exp(s_c - max))
  float* s0 = reinterpret_cast<float*>(blocked_raw + ring_bytes(sizeof(T), D));
  float* tqk = s0 + strip_len(Tk);
  float* e = tqk + strip_len(Tk);
  // load j: the live keys' k (and rawk) block j < nkt, else the reached
  // keys' v block j - nkt; each read once (evict first)
  auto load = [&](int j) -> RingLoad<T> {
    const bool kt = j < nkt;
    const int k0 = (kt ? j : j - nkt) * kBlockKeys;
    const size_t off = b * LD + (size_t)k0 * D;
    return {at<T>(kt ? a.k : a.v, off),
            kTime && kt ? at<T>(a.rawk, off) : nullptr,
            min(kBlockKeys, (kt ? live : span) - k0), false};
  };
  // ---- 1. the first kSlots loads, requested before anything else
  if (tid == kIssuer) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&v.bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < min(kSlots, total); ++j) ring.issue(j, load(j));
  }
  // ---- 2. q and tqw; key tid + 256 i's terms: time, wo1 decay (`part`),
  // wo2 and bo; tisas, logdt (`part`); the drop modes' dm to its strip
  if (tid < D) {
    v.q[tid] = port::to_float(at<T>(a.q, (size_t)b * D)[tid]);
    if (kTime) v.tqw[tid] = port::to_float(at<T>(a.tqw, (size_t)b * D)[tid]);
  }
  float part[kKeysPerThread], wo2[kKeysPerThread], bo[kKeysPerThread];
  const float tq = MODE == ATT_PLAIN ? 0.f : port::to_float(at<T>(a.t_q, b)[0]);
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int l = tid + kThreads * i;
    part[i] = wo2[i] = bo[i] = 0.f;
    if (MODE != ATT_PLAIN && l < live) {
      const float tk = port::to_float(at<T>(a.t_k, (size_t)b * Tk)[l]);
      const float logdt = log1pf(fabsf(tq - tk));
      if (kTime) {
        part[i] = port::to_float(at<T>(a.wo1, 0)[l]) *
                  tanhf(logdt * port::to_float(at<T>(a.w1, 0)[l]) +
                        port::to_float(at<T>(a.b1, 0)[l]));
        wo2[i] = port::to_float(at<T>(a.wo2, 0)[l]);
        bo[i] = port::to_float(at<T>(a.bo, 0)[l]);
      } else {
        part[i] = logdt;
      }
    }
    if (DROP && l < Tk) tqk[l] = a.dm[(size_t)b * Tk + l];
  }
  __syncthreads();                              // q, tqw and the barriers
  // after every thread has read load j: its slot takes load j + kSlots
  auto release = [&](int j) {
    __syncthreads();
    if (tid == kIssuer && j + kSlots < total)
      ring.issue(j + kSlots, load(j + kSlots));
  };
  // ---- 3. the score dots, a k block at a time, a half-warp a key
  {
    float qv[8], tv[8];
    lane8<T>(v.q, c, D, on, qv);
    if constexpr (kTime) lane8<T>(v.tqw, c, D, on, tv);
    for (int j = 0; j < nkt; ++j) {
      ring.wait(j);
      const T* Ks = ring.slot(j);
      const int k0 = j * kBlockKeys, nk = min(kBlockKeys, live - k0);
      float d0[kKeySlots];
      key_dots(qv, Ks, nk, D, h, c, on, d0);
      if constexpr (kTime) {
        float dt[kKeySlots], x[2 * kKeySlots];
        key_dots(tv, Ks + (size_t)kBlockKeys * D, nk, D, h, c, on, dt);
#pragma unroll
        for (int s = 0; s < kKeySlots; ++s) {
          x[s] = d0[s];
          x[kKeySlots + s] = dt[s];
        }
        // lane c ends with value half_sums_index(c): s0 of slot k, or tqk
        // of slot k - kKeySlots
        const float r = half_sums(x, lane);
        const int k = half_sums_index<2 * kKeySlots>(lane);
        const int l = h + kHalves * (k % kKeySlots);
        if ((c & 1) == 0 && l < nk) (k < kKeySlots ? s0 : tqk)[k0 + l] = r;
      } else {
        const float r = half_sums(d0, lane);
        const int l = h + kHalves * half_sums_index<kKeySlots>(lane);
        if ((c & 3) == 0 && l < nk) s0[k0 + l] = r;
      }
      release(j);
    }
  }
  // ---- 4. the scores of this thread's keys, the softmax over the strip:
  // each warp takes the strip's max and sum itself (the same bits in
  // every warp)
  float sc[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int l = tid + kThreads * i;
    sc[i] = kNegFill;
    if (l < live) {
      const float qk = s0[l];
      if (kTime) {
        const float gate = part[i] + wo2[i] * tanhf(tqk[l]) + bo[i];
        sc[i] = qk * port::sigmoid(gate) * a.scale;
      } else if (MODE == ATT_TISAS) {
        sc[i] = (qk + part[i]) * a.scale;
      } else {
        sc[i] = qk * a.scale;
      }
    }
    if (l < Tk) s0[l] = sc[i];
  }
  __syncthreads();                              // the scores
  const float m = strip_max<kMaxKeys>(s0, Tk, lane);
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int l = tid + kThreads * i;
    if (l < Tk) e[l] = expf(sc[i] - m);
  }
  __syncthreads();                              // the exponentials
  const float sum = strip_sum<kMaxKeys>(e, nullptr, 1.f, Tk, lane);
  // ---- 5. o = sum_c w_c v_c over the reached keys, a v block at a time
  float acc[8];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) acc[k] = 0.f;
  for (int j = nkt; j < total; ++j) {
    ring.wait(j);
    const int k0 = (j - nkt) * kBlockKeys;
    weighted_rows<T, DROP>(e + k0, tqk + k0, sum, ring.slot(j),
                           min(kBlockKeys, span - k0), D, h, c, on, acc);
    release(j);
  }
  warp_partial<T>(acc, v.part[warp], lane, c, D, on);
  __syncthreads();
  if (tid < D) a.out[(size_t)b * D + tid] = warps_sum(v.part, tid);
}

bool blocked_attention_takes(int Tk, int D) {
  return Tk > kStagedKeys && Tk <= kMaxKeys && D >= 16 && D <= kMaxD &&
         D % 16 == 0;
}

template <typename T>
size_t dynamic_bytes(int Tk, int D) {
  return ring_bytes(sizeof(T), D) + (size_t)3 * strip_len(Tk) * sizeof(float);
}

// The kernel's dynamic shared memory limit, raised to the most any shape
// takes (Tk = kMaxKeys, D = kMaxD), once a device.
template <typename T, int MODE, bool DROP>
cudaError_t allow_smem(int device) {
  static unsigned raised = 0;                   // a bit a device
  if (device < 32 && (raised >> device) & 1u) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_blocked_kernel<T, MODE, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dynamic_bytes<T>(kMaxKeys, kMaxD));
  if (err == cudaSuccess && device < 32) raised |= 1u << device;
  return err;
}

template <typename T, int MODE, bool DROP>
cudaError_t launch(const Args& a, int B, int device, cudaStream_t s) {
  cudaError_t err = allow_smem<T, MODE, DROP>(device);
  if (err != cudaSuccess) return err;
  attn_fwd_blocked_kernel<T, MODE, DROP>
      <<<B, kThreads, dynamic_bytes<T>(a.Tk, a.D), s>>>(a);
  return cudaGetLastError();
}

// The kernel of (mode, type) as a pointer, its dynamic shared memory at
// (Tk, D) in `smem`, after `allow_smem`; nullptr for an unknown mode or
// the cudaError_t of `allow_smem` in `err`.
template <typename T>
const void* kernel_of(int mode, int Tk, int D, int device, size_t* smem,
                      cudaError_t* err) {
  *smem = dynamic_bytes<T>(Tk, D);
  switch (mode) {
#define PORT_BLOCKED_KERNEL(ID, BASE, DROP)                     \
  case ID:                                                      \
    *err = allow_smem<T, BASE, DROP>(device);                   \
    return (const void*)attn_fwd_blocked_kernel<T, BASE, DROP>;
    PORT_BLOCKED_KERNEL(ATT_PLAIN, ATT_PLAIN, false)
    PORT_BLOCKED_KERNEL(ATT_TIME, ATT_TIME, false)
    PORT_BLOCKED_KERNEL(ATT_TISAS, ATT_TISAS, false)
    PORT_BLOCKED_KERNEL(ATT_PLAIN_DROP, ATT_PLAIN, true)
    PORT_BLOCKED_KERNEL(ATT_TISAS_DROP, ATT_TISAS, true)
#undef PORT_BLOCKED_KERNEL
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
extern "C" long long fused_attention_blocked_smem_bytes(int mode, int is_bf16,
                                                        int Tk, int D) {
  if (!blocked_attention_takes(Tk, D) || mode < 0 || mode > 4) return 0;
  return (long long)((is_bf16 ? dynamic_bytes<__nv_bfloat16>(Tk, D)
                              : dynamic_bytes<float>(Tk, D)) +
                     sizeof(BlockedVecs));
}

// The design's blocks that fit on one SM at (mode, Tk, D) (the occupancy
// calculator's answer, with the launch's shared memory), or the negated
// cudaError_t.
extern "C" int fused_attention_blocked_blocks_per_sm(int mode, int is_bf16,
                                                     int Tk, int D,
                                                     int device) {
  if (!blocked_attention_takes(Tk, D)) return -(int)cudaErrorInvalidValue;
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
// 64 < Tk <= 1024 and D a multiple of 16 up to 128 (else
// cudaErrorInvalidValue); k and v, and rawk in time mode, 16-byte aligned
// (else cudaErrorMisalignedAddress): the bulk copies move 16-byte units.
// All pointers are device pointers to contiguous arrays: q/tqw [B,1,D],
// k/v/rawk [B,Tk,D], t_q [B,1], t_k [B,Tk], w1/b1/wo1/wo2/bo [1,Tk],
// key_len [B] int32, dm [B,1,Tk] f32 (the '*_drop' modes only), out
// [B,1,D] f32; the floating inputs but dm all f32 (is_bf16 = 0) or all
// bf16 (is_bf16 = 1); operands a mode does not read may be any pointer.
// Returns the launch's cudaError_t (0 on success).
extern "C" int fused_attention_blocked_launch(
    int mode, int is_bf16, const void* q, const void* k, const void* v,
    const void* t_q, const void* t_k, const void* tqw, const void* rawk,
    const void* w1, const void* b1, const void* wo1, const void* wo2,
    const void* bo, const void* key_len, const void* dm, void* out, int B,
    int Tq, int Tk, int D, float scale, int device, void* stream) {
  if (Tq != 1 || B < 0 || !blocked_attention_takes(Tk, D) || mode < 0 ||
      mode > 4)
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
