// MTAM's sequential-chain readout, forward: the n Tq=1 time-attention
// hops of one batch row over precomputed keys, in one launch.
//
// Replaces: mtamrecommender_tpu/ops/pallas/readout_chain_kernel.py,
// _chain_fwd_kernel (body _hop_fwd), launched by _chain_fwd.  Per hop i,
// with cur the hop's f32 input query [D]:
//   q    = relu(cur_c Wq_i + bq_i)          cur_c = cur rounded to T
//   s0_l = q . K_i,l;  tqk_l = tanh(cur . tprec_i,l)      (f32 sums)
//   gate = gate_part_i,l + wo2_i,l tqk_l
//   s_l  = s0_l sigmoid(gate) scale         for l < key_len, else -2^32+1
//   cur  = LN_i(softmax(s) V_i qz + cur)    (mean/var over D, eps 1e-8)
// K, V, tprec [n,B,L,D] and gate_part [n,B,L] are inputs (the hop-batched
// projections stay outside the kernel); they and the weights are read in
// T and widened to f32.  Writes out [B,D] in T and the hop-input chain
// curs [n,B,D] f32, which the backward (readout_chain_bwd.cu) replays.
//
// What bounds it: bytes, then latency.  Per row and hop it reads L rows
// of K, V and tprec and does ~6 L D FLOPs on them, plus 2 D^2 for q: at
// B=256, L=50, D=128, 3 hops, 29.5 MB (bf16) for ~55 MFLOP; at B=64,
// L=150, 22.4 MB (bf16) for ~28 MFLOP.  Each hop
// waits for the last, so a block's serial chain of dependent steps sets
// its time unless the rows' loads hide behind it; the first hop's rows
// are behind nothing.
//
// Every design takes one block of 256 threads per batch row, since each
// hop needs the whole row's softmax before the next hop's query exists;
// the hop loop runs inside the block.  No atomics: the same inputs give
// the same bits.
// 1. "staged" (1 <= L <= 64, D a multiple of 16 up to 128: MTAM's
//    training readout at L=50, d=128, and the narrow d=16; two blocks an
//    SM).  Each hop's K and tprec rows of the live keys and V rows of the
//    reached keys come into shared memory once, each block of rows by one
//    bulk copy (TMA: `cp.async.bulk`, evict first) that one thread issues
//    and an mbarrier completes, so no thread stalls issuing copies.  None
//    of them depends on the chain, and they are issued in the order they
//    are needed: hop 0's K and tprec alone, then, once a hop's K and
//    tprec are in, its V rows and (bf16, two buffers) hop i+1's K and
//    tprec into the other buffer; f32 (twice the bytes) has one buffer
//    (two would halve the blocks an SM) and refills K and tprec once the
//    score dots have read them.  q is summed while the hop's rows come
//    in: half-warp h takes k = h, h+16, ... at its lane's columns (Wq by
//    16-byte loads from L2, evict last: bf16 into registers a hop ahead,
//    f32 prefetched into L2 a hop ahead and loaded in two halves), the
//    half-warps added h and h+1 first, then the 8 warps in order from 0,
//    each lane summing the partials of its own columns.  One thread
//    mapping throughout (chain_staged.cuh): lane c of half-warp h owns 8
//    columns.  The dots cur . tprec_l and q . K_l: a half-warp a key, both
//    dots' lane sums in one butterfly.  The gate and the softmax over the
//    L keys in warp 0 (a lane 2 keys), o = sum_l w_l V_l by key slices of
//    a half-warp (the q sum's order), the residual and layer norm in warp
//    0 (a lane 4 columns).  A hop's gate and layer-norm operands and bq
//    come into registers at its start.
// 2. "blocked" (65 <= L <= 256, D a multiple of 16 up to 128: MTAM's
//    training readout at the reference's L=150).  Staging a whole hop
//    stops at 64 keys: 3 L D es bytes (twice that for staged's two bf16
//    buffers) is 391,680 B at L=255, D=128 in either type, past the
//    232,448 a block may have.  So each hop's rows stream in blocks of
//    kBlockKeys = 64 keys through a ring of kRingSlots = 3 slots of [2,
//    64, D] (K then tprec rows, or V rows in the first half: 32 KB in
//    bf16, 64 KB in f32 at D=128), one bulk copy (TMA, evict first) a
//    block of rows and an mbarrier a slot (`KeyRing`, chain_staged.cuh).
//    The loads are numbered in the order they are read: a hop's K and
//    tprec blocks of the live keys, then its V blocks of the reached
//    ones, hop after hop; one thread issues load j + 3 as soon as every
//    thread has read load j, so two loads are in flight while one is
//    read, and since no load depends on the chain, the next hop's K and
//    tprec blocks come in while this hop's V blocks are read.  Per hop: q
//    as in the staged design (while the first blocks come in); the dots
//    q . K_l and cur . tprec_l a key block at a time, a half-warp a key,
//    into f32 strips of all L <= 256 keys; the gate and the score of key
//    l by thread l; the softmax over the whole strip (as the Pallas
//    kernel takes it), each warp taking the strip's max and sum itself,
//    the same bits in every warp, so the weights w_l = e_l / sum need no
//    third barrier; o = sum_l w_l V_l a V block at a time, keys l = h,
//    h+16, ... a half-warp taken in key order across the blocks (the
//    staged design's order at the same L); the residual and layer norm
//    in warp 0.  Shared memory a block: the ring's 98,304 B (bf16) or
//    196,608 B (f32) at D=128 and 7,808 B of vectors and strips: two
//    blocks an SM in bf16, one in f32.  Three slots is the most f32 fits
//    at 64 keys a slot, and in bf16 keeps two blocks an SM for B past
//    the 132 SMs; 64 keys a slot is staged's key_dots / key_sum span (4
//    keys a half-warp), each block one barrier wait and one
//    __syncthreads.  MTAM's B=64 fills 64 of the 132 SMs; a 2-CTA cluster
//    a row (half the key blocks each, max, sum and o merged over
//    distributed shared memory) would use the rest, at the cost of three
//    cluster barriers a hop on a chain that is already barrier-bound; it
//    is not built, and B past 132 rows fills the card without it.
// 3. "rows" (every L up to 256, D up to 128; the first design): cur and
//    the hop's [L] vectors in shared memory, K, V and tprec read from
//    global memory key by key.  q: one thread per column, Wq read
//    coalesced from global memory.  Scores: one warp per live key, both
//    dot products from one pass over the key's K and tprec rows.  Softmax
//    over L <= 256 in shared memory (readout_hop.cuh).  o: one thread per
//    column over the keys the weights reach (the live ones, all L in a
//    row with none live).

#include <initializer_list>

#include "chain_staged.cuh"

namespace {

using namespace chain_staged;
using readout::from_float;
using readout::kMaxD;
using readout::kThreads;
using readout::kWarps;

constexpr int kMaxL = 256;

struct Args {
  const void *dec, *k, *v, *t, *gp, *wo2, *wq, *bq, *lng, *lnb;
  const int* klen;
  const float* qz;
  void* out;
  float* curs;
  int B, L, D, n;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* p, size_t off) {
  return static_cast<const T*>(p) + off;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chain_fwd_rows_kernel(Args a) {
  __shared__ float cur[kMaxD], curr[kMaxD], q[kMaxD], s[kMaxL];
  __shared__ float red[kWarps];
  const int D = a.D, L = a.L, B = a.B, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = max(0, min(a.klen[b], L));
  const int span = live > 0 ? live : L;
  const float qz = a.qz[b];
  for (int e = tid; e < D; e += kThreads)
    cur[e] = port::to_float(at<T>(a.dec, (size_t)b * D)[e]);
  __syncthreads();
  for (int i = 0; i < a.n; ++i) {
    const size_t hb = (size_t)i * B + b;
    const T* K = at<T>(a.k, hb * L * D);
    const T* V = at<T>(a.v, hb * L * D);
    const T* TP = at<T>(a.t, hb * L * D);
    const T* GP = at<T>(a.gp, hb * L);
    const T* WO2 = at<T>(a.wo2, (size_t)i * L);
    const T* WQ = at<T>(a.wq, (size_t)i * D * D);
    for (int e = tid; e < D; e += kThreads) {
      a.curs[hb * D + e] = cur[e];
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
        s[l] = s0 * sig * a.scale;
      }
    }
    for (int l = live + tid; l < L; l += kThreads) s[l] = readout::kNegFill;
    __syncthreads();
    readout::softmax_inplace(s, L, red);
    float o = 0.f;
    if (tid < D)
      for (int l = 0; l < span; ++l)
        o = fmaf(s[l], port::to_float(V[(size_t)l * D + tid]), o);
    // residual + normalize (the query mask touches o only)
    const float x = tid < D ? o * qz + cur[tid] : 0.f;
    const float mean = port::block_sum<kThreads>(x, red) / D;
    const float dx = tid < D ? x - mean : 0.f;
    const float var = port::block_sum<kThreads>(dx * dx, red) / D;
    const float inv = 1.f / sqrtf(var + readout::kLnEps);
    if (tid < D)
      cur[tid] = dx * inv * port::to_float(at<T>(a.lng, (size_t)i * D)[tid]) +
                 port::to_float(at<T>(a.lnb, (size_t)i * D)[tid]);
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out) + (size_t)b * D;
  for (int e = tid; e < D; e += kThreads) out[e] = from_float<T>(cur[e]);
}

// ------------------------------------------------------------ staged

// The block's f32 vectors and the copies' barriers (static shared memory).
struct StagedVecs {
  float cur[kMaxD];
  float s0[kStagedKeys], tp[kStagedKeys], w[kStagedKeys];
  float part[kWarps][kMaxD];   // per-warp partials of q's and o's sums
  // per buffer, the mbarriers of its K and tprec rows and of its V rows
  alignas(8) unsigned long long bar[2][2];
};

// By one thread: hop i's K and tprec rows of the live keys (`kt`, on
// bar[0]) and V rows of the reached ones (`vv`, on bar[1]) of row b into
// `buf` [K | V | tprec], each block of rows one contiguous bulk copy.
// The buffer's last reads must be behind a barrier.
template <typename T>
__device__ __forceinline__ void stage_hop(const Args& a, T* buf,
                                          unsigned long long (&bar)[2], int i,
                                          int b, int live, int span, bool kt,
                                          bool vv) {
  const size_t LD = (size_t)a.L * a.D, hb = (size_t)i * a.B + b;
  const unsigned long long policy = evict_first();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (kt) {
    const unsigned bytes = (unsigned)((size_t)live * a.D * sizeof(T));
    mbar_expect(&bar[0], 2 * bytes);
    if (bytes) {
      bulk_copy(buf, at<T>(a.k, hb * LD), bytes, &bar[0], policy);
      bulk_copy(buf + 2 * LD, at<T>(a.t, hb * LD), bytes, &bar[0], policy);
    }
  }
  if (vv) {
    const unsigned bytes = (unsigned)((size_t)span * a.D * sizeof(T));
    mbar_expect(&bar[1], bytes);
    bulk_copy(buf + LD, at<T>(a.v, hb * LD), bytes, &bar[1], policy);
  }
}

// A lane's 8 columns (col<T>) of an f32 vector of the block, by 16-byte
// loads (in bf16 its columns are contiguous)
template <typename T>
__device__ __forceinline__ void vec8(const float* vec, int c, int D,
                                     float (&x)[8]) {
  if constexpr (sizeof(T) == 2)
    split(*reinterpret_cast<const float4*>(vec + kGroup * c),
          *reinterpret_cast<const float4*>(vec + kGroup * c + 4), x);
  else
    load8(vec, c, D, x);
}

// prefetch.global.L2 of the lines of [p, p + bytes) by the block's threads
// (evict last: every block reads them)
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = (size_t)threadIdx.x * 128; off < bytes;
       off += (size_t)kThreads * 128)
    asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(c + off));
}

// q's partial sum of half-warp h at the lane's columns: acc[j] = sum over
// k = h, h+16, ... of cur_c[k] Wq[k][col j] in k order, cur_c = cur
// rounded to T.  bf16 takes the rows fetched ahead (`fetch_wq_rows`); f32
// loads them in two halves, each half's loads in flight together.
template <typename T>
__device__ __forceinline__ void q_partial(const WqRows<T>& wq_rows,
                                          const T* WQ, const float* cur,
                                          int h, int c, int D, bool on,
                                          float (&acc)[8]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) acc[j] = 0.f;
  if (!on) return;
  constexpr int kHalf = sizeof(T) == 2 ? kSlots : kSlots / 2;
  const unsigned long long policy = evict_last();
#pragma unroll
  for (int s0 = 0; s0 < kSlots; s0 += kHalf) {
    uint4 raw[kHalf][2];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int s = 0; s < kHalf; ++s) {
        const int k = h + kHalves * (s0 + s);
        if (k < D) {
          raw[s][0] = ldg16(WQ + (size_t)k * D + 4 * c, policy);
          raw[s][1] = ldg16(WQ + (size_t)k * D + D / 2 + 4 * c, policy);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      const int k = h + kHalves * (s0 + s);
      if (k < D) {
        float w[8];
        if constexpr (sizeof(T) == 2)
          unpack(wq_rows.raw[s0 + s], w);
        else
          split(reinterpret_cast<const float4&>(raw[s][0]),
                reinterpret_cast<const float4&>(raw[s][1]), w);
        const float x = port::round_to<T>(cur[k]);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) acc[j] = fmaf(x, w[j], acc[j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) chain_fwd_staged_kernel(Args a) {
  constexpr int S = kStages<T>;
  constexpr int kIssuer = 32;                   // lane 0 of warp 1
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
  const size_t LD = (size_t)L * D;
  if (tid == kIssuer) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mbar_init(&v.bar[j][0]);
      mbar_init(&v.bar[j][1]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  WqRows<T> wq_rows;                            // bf16: hop i's rows of Wq
  fetch_wq_rows<T>(wq_rows, at<T>(a.wq, 0), h, c, D, on);
  if (tid < D) v.cur[tid] = port::to_float(at<T>(a.dec, (size_t)b * D)[tid]);
  __syncthreads();                              // the barriers and cur
  // hop 0's K and tprec rows first: V's and the next hop's copies wait
  // until they are in, so that nothing shares the bandwidth with them
  if (tid == kIssuer)
    stage_hop<T>(a, rows, v.bar[0], 0, b, live, span, true, false);
  for (int i = 0; i < a.n; ++i) {
    const size_t hb = (size_t)i * B + b;
    const T* WQ = at<T>(a.wq, (size_t)i * D * D);
    T* buf = rows + (size_t)(i % S) * 3 * LD;
    unsigned long long(&bar)[2] = v.bar[i % S];
    const unsigned parity = (i / S) & 1;        // the buffer's use, mod 2
    const T* Ks = buf;
    const T* Vs = buf + LD;
    const T* Ts = buf + 2 * LD;
    // in flight through the hop's first phases: bq at the lane's columns,
    // and warp 0's gate and layer-norm operands (a lane 2 keys and 4
    // columns)
    float bq[8];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      bq[j] = on ? port::to_float(at<T>(a.bq, (size_t)i * D)[col<T>(c, j, D)])
                 : 0.f;
    float gp[2] = {0.f, 0.f}, wo2[2] = {0.f, 0.f};
    float lng[4] = {0.f, 0.f, 0.f, 0.f}, lnb[4] = {0.f, 0.f, 0.f, 0.f};
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = lane + 32 * j;
        if (l < L) {
          gp[j] = port::to_float(at<T>(a.gp, hb * L)[l]);
          wo2[j] = port::to_float(at<T>(a.wo2, (size_t)i * L)[l]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = lane + 32 * j;
        if (e < D) {
          lng[j] = port::to_float(at<T>(a.lng, (size_t)i * D)[e]);
          lnb[j] = port::to_float(at<T>(a.lnb, (size_t)i * D)[e]);
        }
      }
    }
    if (tid < D) a.curs[hb * D + tid] = v.cur[tid];
    // ---- q's partial sums, while the hop's rows come in: half-warp h
    // takes k = h, h+16, ... (cur is the last hop's, in since its barrier)
    {
      float acc[8];
      q_partial<T>(wq_rows, WQ, v.cur, h, c, D, on, acc);
      warp_partial<T>(acc, v.part[warp], lane, c, D, on);
    }
    // the next hop's rows of Wq: bf16 into registers, f32 into L2
    if (i + 1 < a.n) {
      if constexpr (sizeof(T) == 2)
        fetch_wq_rows<T>(wq_rows, WQ + (size_t)D * D, h, c, D, on);
      else
        prefetch_l2(WQ + (size_t)D * D, (size_t)D * D * sizeof(T));
    }
    __syncthreads();                            // q's partials
    mbar_wait(&bar[0], parity);                 // K and tprec in
    if (tid == kIssuer) {
      // the hop's V rows; bf16: hop i+1's K and tprec rows into the other
      // buffer, free since hop i-1's o
      stage_hop<T>(a, buf, bar, i, b, live, span, false, true);
      if (S == 2 && i + 1 < a.n)
        stage_hop<T>(a, rows + (size_t)((i + 1) % 2) * 3 * LD,
                     v.bar[(i + 1) % 2], i + 1, b, live, span, true, false);
    }
    {
      // ---- the dots cur . tprec_l (no q needed), a half-warp a key
      float tp[kKeySlots];
      {
        float cv[8];
        lane8<T>(v.cur, c, D, on, cv);
        key_dots(cv, Ts, live, D, h, c, on, tp);
      }
      // ---- q at the lane's columns: the warps' partials in order from
      // warp 0 (every half-warp the same sums), + bq, relu
      float qv[8];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) qv[j] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        float p[8];
        vec8<T>(v.part[w], c, D, p);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) qv[j] += p[j];
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        qv[j] = on ? fmaxf(qv[j] + bq[j], 0.f) : 0.f;
      // ---- the score dots q . K_l, a half-warp a key; both dots' lane
      // sums in one butterfly
      float s0[kKeySlots];
      key_dots(qv, Ks, live, D, h, c, on, s0);
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
    // f32: K and tprec are read no more; hop i+1's rows into their place
    if (S == 1 && tid == kIssuer && i + 1 < a.n)
      stage_hop<T>(a, buf, bar, i + 1, b, live, span, true, false);
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
          const float sig = port::sigmoid(gp[j] + wo2[j] * tqk);
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
    }
    __syncthreads();                            // the weights
    mbar_wait(&bar[1], parity);                 // V in
    // ---- o = sum_l w_l V_l over the reached keys
    {
      float acc[8];
      key_sum(v.w, Vs, span, D, h, c, on, acc);
      warp_partial<T>(acc, v.part[warp], lane, c, D, on);
    }
    __syncthreads();
    // ---- residual and layer norm in warp 0 (a lane 4 columns)
    if (warp == 0) {
      float x[4], sx = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = lane + 32 * j;
        x[j] = e < D ? warps_sum(v.part, e) * qz + v.cur[e] : 0.f;
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = lane + 32 * j;
        if (e < D) v.cur[e] = x[j] * inv * lng[j] + lnb[j];
      }
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out) + (size_t)b * D;
  for (int e = tid; e < D; e += kThreads) out[e] = from_float<T>(v.cur[e]);
}

// ------------------------------------------------------------ blocked

// The block's f32 vectors and the ring's barriers (static shared memory):
// the strips hold a value a key, L <= kBlockedMaxKeys.
struct BlockedVecs {
  float cur[kMaxD];
  float s0[kBlockedMaxKeys];   // q . K_l, then the score s_l
  float tp[kBlockedMaxKeys];   // cur . tprec_l
  float e[kBlockedMaxKeys];    // exp(s_l - max)
  float part[kWarps][kMaxD];   // per-warp partials of q's and o's sums
  alignas(8) unsigned long long bar[kRingSlots];
};

// Load j of row b's ring: hop j / per_hop, and in it first the K and
// tprec rows of the live keys, kBlockKeys keys a load, then the V rows of
// the reached ones.  Each is read once (evict first).
template <typename T>
__device__ __forceinline__ RingLoad<T> fwd_load(const Args& a, int b, int live,
                                                int span, int nkt, int per_hop,
                                                int j) {
  const int i = j / per_hop, r = j - i * per_hop;
  const size_t hb = (size_t)i * a.B + b, LD = (size_t)a.L * a.D;
  const bool kt = r < nkt;
  const int k0 = (kt ? r : r - nkt) * kBlockKeys;
  const size_t off = hb * LD + (size_t)k0 * a.D;
  return {at<T>(kt ? a.k : a.v, off), kt ? at<T>(a.t, off) : nullptr,
          min(kBlockKeys, (kt ? live : span) - k0), false};
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) chain_fwd_blocked_kernel(Args a) {
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
  const int nkt = (live + kBlockKeys - 1) / kBlockKeys;
  const int nv = (span + kBlockKeys - 1) / kBlockKeys;
  const int per_hop = nkt + nv, total = a.n * per_hop;
  const KeyRing<T> ring{reinterpret_cast<T*>(ring_raw), v.bar, D};
  if (tid == kIssuer) {
    for (int k = 0; k < kRingSlots; ++k) mbar_init(&v.bar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  WqRows<T> wq_rows;                            // bf16: hop i's rows of Wq
  fetch_wq_rows<T>(wq_rows, at<T>(a.wq, 0), h, c, D, on);
  if (tid < D) v.cur[tid] = port::to_float(at<T>(a.dec, (size_t)b * D)[tid]);
  __syncthreads();                              // the barriers and cur
  if (tid == kIssuer)
    for (int k = 0; k < min(kRingSlots, total); ++k)
      ring.issue(k, fwd_load<T>(a, b, live, span, nkt, per_hop, k));
  // after every thread has read load j: its slot takes load j + kRingSlots
  auto release = [&](int j) {
    __syncthreads();
    if (tid == kIssuer && j + kRingSlots < total)
      ring.issue(j + kRingSlots, fwd_load<T>(a, b, live, span, nkt, per_hop,
                                             j + kRingSlots));
  };
  int j = 0;                                    // the next load to read
  for (int i = 0; i < a.n; ++i) {
    const size_t hb = (size_t)i * B + b;
    const T* WQ = at<T>(a.wq, (size_t)i * D * D);
    // in flight through the hop's first phases: bq at the lane's columns,
    // key tid's gate operands, warp 0's layer-norm operands (a lane 4
    // columns)
    float bq[8];
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      bq[k] = on ? port::to_float(at<T>(a.bq, (size_t)i * D)[col<T>(c, k, D)])
                 : 0.f;
    float gp = 0.f, wo2 = 0.f;
    if (tid < L) {
      gp = port::to_float(at<T>(a.gp, hb * L)[tid]);
      wo2 = port::to_float(at<T>(a.wo2, (size_t)i * L)[tid]);
    }
    float lng[4] = {0.f, 0.f, 0.f, 0.f}, lnb[4] = {0.f, 0.f, 0.f, 0.f};
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        if (e < D) {
          lng[k] = port::to_float(at<T>(a.lng, (size_t)i * D)[e]);
          lnb[k] = port::to_float(at<T>(a.lnb, (size_t)i * D)[e]);
        }
      }
    }
    if (tid < D) a.curs[hb * D + tid] = v.cur[tid];
    // ---- q's partial sums (the staged design's): half-warp h takes k =
    // h, h+16, ...
    {
      float acc[8];
      q_partial<T>(wq_rows, WQ, v.cur, h, c, D, on, acc);
      warp_partial<T>(acc, v.part[warp], lane, c, D, on);
    }
    if (i + 1 < a.n) {
      if constexpr (sizeof(T) == 2)
        fetch_wq_rows<T>(wq_rows, WQ + (size_t)D * D, h, c, D, on);
      else
        prefetch_l2(WQ + (size_t)D * D, (size_t)D * D * sizeof(T));
    }
    __syncthreads();                            // q's partials
    // ---- q at the lane's columns: the warps' partials in order from
    // warp 0, + bq, relu; cur at the lane's columns
    float qv[8], cv[8];
    lane8<T>(v.cur, c, D, on, cv);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) qv[k] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      float p[8];
      vec8<T>(v.part[w], c, D, p);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) qv[k] += p[k];
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) qv[k] = on ? fmaxf(qv[k] + bq[k], 0.f) : 0.f;
    // ---- the dots q . K_l and cur . tprec_l, a key block at a time, a
    // half-warp a key; both dots' lane sums in one butterfly
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
      // lane c ends with value half_sums_index(c): s0 of slot k, or tp of
      // slot k - kKeySlots
      const float r = half_sums(x, lane);
      const int k = half_sums_index<2 * kKeySlots>(lane);
      const int l = h + kHalves * (k % kKeySlots);
      if ((c & 1) == 0 && l < nk) (k < kKeySlots ? v.s0 : v.tp)[k0 + l] = r;
      release(j);
    }
    // ---- the gate and the score of key tid, the softmax over the strip:
    // each warp takes the strip's max and sum itself (the same bits in
    // every warp), so the weights w_l = e_l / sum need no third barrier
    float sl = readout::kNegFill;
    if (tid < live) {
      const float tqk = tanhf(v.tp[tid]);
      const float sig = port::sigmoid(gp + wo2 * tqk);
      sl = v.s0[tid] * sig * a.scale;
    }
    if (tid < L) v.s0[tid] = sl;
    __syncthreads();                            // the scores
    const float m = strip_max(v.s0, L, lane);
    if (tid < L) v.e[tid] = expf(sl - m);
    __syncthreads();                            // the exponentials
    const float sum = strip_sum(v.e, nullptr, 1.f, L, lane);
    // ---- o = sum_l w_l V_l over the reached keys, a key block at a time
    float acc[8];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) acc[k] = 0.f;
    for (int kb = 0; kb < nv; ++kb, ++j) {
      ring.wait(j);
      const int k0 = kb * kBlockKeys;
      key_sum_acc(v.e + k0, sum, ring.slot(j), min(kBlockKeys, span - k0), D,
                  h, c, on, acc);
      release(j);
    }
    warp_partial<T>(acc, v.part[warp], lane, c, D, on);
    __syncthreads();
    // ---- residual and layer norm in warp 0 (a lane 4 columns)
    if (warp == 0) {
      float x[4], sx = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        x[k] = e < D ? warps_sum(v.part, e) * qz + v.cur[e] : 0.f;
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
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k;
        if (e < D) v.cur[e] = x[k] * inv * lng[k] + lnb[k];
      }
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out) + (size_t)b * D;
  for (int e = tid; e < D; e += kThreads) out[e] = from_float<T>(v.cur[e]);
}

template <typename T>
cudaError_t launch_blocked(const Args& a, cudaStream_t s) {
  const size_t smem = ring_dynamic_bytes(sizeof(T) == 2, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      chain_fwd_blocked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  chain_fwd_blocked_kernel<T><<<a.B, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_staged(const Args& a, cudaStream_t s) {
  const size_t smem = staged_dynamic_bytes(sizeof(T) == 2, a.L, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      chain_fwd_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  chain_fwd_staged_kernel<T><<<a.B, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// the designs, as FWD_DESIGNS orders them
enum { kStaged = 0, kBlocked = 1, kRows = 2 };

bool takes(int design, int L, int D) {
  if (design == kStaged) return staged_takes(L, D);
  if (design == kBlocked) return blocked_takes(L, D);
  return design == kRows && L >= 1 && L <= kMaxL && D >= 1 && D <= kMaxD;
}

}  // namespace

// The staged design's shared memory a block at (L, D), static and
// dynamic, in bytes (0 for a shape it does not take).
extern "C" long long readout_chain_staged_smem_bytes(int is_bf16, int L,
                                                     int D) {
  if (!staged_takes(L, D)) return 0;
  return (long long)(staged_dynamic_bytes(is_bf16 != 0, L, D) +
                     sizeof(StagedVecs));
}

// The staged design's blocks that fit on one SM at (L, D) (the occupancy
// calculator's answer, with the launch's shared memory), or the negated
// cudaError_t.
extern "C" int readout_chain_staged_blocks_per_sm(int is_bf16, int L, int D,
                                                  int device) {
  if (!staged_takes(L, D)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = staged_dynamic_bytes(is_bf16 != 0, L, D);
  const void* kernel =
      is_bf16 ? (const void*)chain_fwd_staged_kernel<__nv_bfloat16>
              : (const void*)chain_fwd_staged_kernel<float>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// The blocked design's shared memory a block at (L, D), static and
// dynamic, in bytes (0 for a shape it does not take).
extern "C" long long readout_chain_blocked_smem_bytes(int is_bf16, int L,
                                                      int D) {
  if (!blocked_takes(L, D)) return 0;
  return (long long)(ring_dynamic_bytes(is_bf16 != 0, D) +
                     sizeof(BlockedVecs));
}

// The blocked design's blocks that fit on one SM at (L, D), or the
// negated cudaError_t.
extern "C" int readout_chain_blocked_blocks_per_sm(int is_bf16, int L, int D,
                                                   int device) {
  if (!blocked_takes(L, D)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = ring_dynamic_bytes(is_bf16 != 0, D);
  const void* kernel =
      is_bf16 ? (const void*)chain_fwd_blocked_kernel<__nv_bfloat16>
              : (const void*)chain_fwd_blocked_kernel<float>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// design: 0 "staged" (1 <= L <= 64, D a multiple of 16 up to 128), 1
// "blocked" (64 < L <= 256, the same D; both with k, v, t and wq 16-byte
// aligned), 2 "rows" (L <= 256, D <= 128).  All pointers
// are device pointers to contiguous arrays: dec [B,1,D], k, v, t
// [n,B,L,D], gp [n,B,L], wo2 [n,L], wq [n,D,D], bq/lng/lnb [n,D] and out
// [B,D], all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); klen [B] int32;
// qz [B] f32; curs [n,B,D] f32.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int readout_chain_launch(
    int design, int is_bf16, const void* dec, const void* klen,
    const void* qz, const void* k, const void* v, const void* t,
    const void* gp, const void* wo2, const void* wq, const void* bq,
    const void* lng, const void* lnb, void* out, void* curs, int B, int L,
    int D, int n, float scale, int device, void* stream) {
  if (B < 0 || !takes(design, L, D) || n <= 0) return cudaErrorInvalidValue;
  if (design != kRows) {
    for (const void* p : {k, v, t, wq})
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
  a.dec = dec; a.k = k; a.v = v; a.t = t; a.gp = gp; a.wo2 = wo2;
  a.wq = wq; a.bq = bq; a.lng = lng; a.lnb = lnb;
  a.klen = static_cast<const int*>(klen);
  a.qz = static_cast<const float*>(qz);
  a.out = out;
  a.curs = static_cast<float*>(curs);
  a.B = B; a.L = L; a.D = D; a.n = n;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == kStaged)
    return is_bf16 ? launch_staged<__nv_bfloat16>(a, s)
                   : launch_staged<float>(a, s);
  if (design == kBlocked)
    return is_bf16 ? launch_blocked<__nv_bfloat16>(a, s)
                   : launch_blocked<float>(a, s);
  if (is_bf16)
    chain_fwd_rows_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(a);
  else
    chain_fwd_rows_kernel<float><<<B, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}
