// Embedding row gather and its backward, a sequential scatter-add.
//
// Replaces: mtamrecommender_tpu/ops/pallas/embedding_kernel.py,
//   _gather_kernel  (launched by _gather_impl, the forward of gather):
//       out[i, :] = table[ids[i], :], in the table's type;
//   _scatter_kernel (launched by _scatter_add_impl, gather's backward):
//       out = zeros[V, d] in grad's type; for i = 0, 1, ..., n-1 in order:
//       out[ids[i], :] = out[ids[i], :] + grad[i, :]
//   The Pallas grid runs in order, so each row's cotangents are added in
//   ascending position order and rounded to grad's type after every add
//   (its row buffer is grad.dtype).  In bf16 that is not dtable's "sum in
//   f32, round once", and it is what this kernel reproduces, bit for bit.
//   Ids outside [0, V) match no row; gather writes zeros for them.
//
// What bounds them.  gather: bytes, n rows read and n rows written (at
// the L = 2048 cell: n = 131,072 ids, d = 128, 64 MB each way in f32,
// ~40 us at 3.35 TB/s).  scatter_add: bytes (grad read once, the table
// written once: 10 / 20 us bf16 / f32 at that cell) or the longest chain.
// No add may be reassociated, so each (row, column) is one dependent
// chain of as many adds as the row has ids: at that cell's category table
// (19 rows, the longest 8,606 ids) ~8,600 adds at ~4 cycles (f32) or ~6
// (one bf16 fma) each, 20-30 us.  But the columns are independent chains
// whose loads do not depend on them: the design parallelises over rows
// and column slices and keeps the loads far ahead of the adds.
//
// Design of gather ("vector", the default for rows of a multiple of 16
// bytes: every d that is a multiple of 8 in bf16 or of 4 in f32).  At the
// L = 2048 cell the table (at most 2.5 MB) sits in L2 and the output is
// nearly all of the bytes, so the kernel has to keep the output's writes
// streaming: every lane busy, many rows in flight, a grid sized to the
// card.  Below a few thousand ids a call is latency-bound instead.
//  * The output is n x W words of 16 bytes (W = row_bytes / 16).  A warp's
//    item is a tile of 32 rows and kVecSteps steps of 32 consecutive words
//    of it: in step s lane l takes word w = s * 32 + l of the tile, row
//    w / W, column w % W, so each store instruction writes 512 contiguous
//    bytes whatever W is (a row of W <= 32 words takes W lanes).
//  * The ids are read once, coalesced: lane l of the item loads the id of
//    the tile's row l when the item's words fall in that row, and a
//    shuffle hands each lane its row's id.
//  * A lane issues all of its kVecSteps loads (8 rows a warp at d = 128
//    in bf16) into registers before its first store.  The table is read
//    through the read-only path with an L2 evict-last policy (it is small
//    and re-read); the output goes out with streaming stores (st.global.cs,
//    evict first), so that output lines do not push table rows out of L2.
//    An id outside [0, V) loads nothing and stores zeros.
//  * The grid is one warp an item up to kVecBlocksPerSM blocks an SM (four
//    waves of the kVecResident blocks an SM that 64 registers a thread
//    allow), each warp walking the items with a stride of the grid's warps
//    past that (n > 270,336 at d = 128 in bf16 on 132 SMs).
// The earlier design ("warp_row", the rows of other widths, or forced):
// one warp per row, lanes over the row in the widest word (16, 8, 4 or 2
// bytes) that divides it.  gather_design() picks between them by the row's
// bytes; the wrapper's gather_design agrees.
//
// Design of scatter_add ("columns", the default), no float atomics, the
// same bits on every run; the wrapper's scatter_plan picks the route.
//  * n <= 256 (a user table: one id a sequence): scatter_small, one
//    launch and no workspace.  A warp a table row finds the row's ids with
//    ballots over the n ids in shared memory and adds their rows in
//    position order, 16 rows' loads in flight, lanes over the columns.
//  * Else four launches, over a workspace the wrapper keeps between calls.
//    columns_sort: one block a chunk of 1,024 ids sorts its keys (id << 10
//    | position, cub::BlockRadixSort over the bits the vocab needs), so
//    each id's entries form a run in position order, and writes each
//    entry's rank in its run and the chunk's column of counts [chunk][V].
//    columns_rows: a block a tile of 32 rows, its 8 warps over the chunks,
//    turns the counts into where each (chunk, row) run starts in the row's
//    list, takes the tile's lists' room with one integer atomicAdd (where
//    a list lies varies between runs; what it holds does not), and lists
//    the hot rows, those with more than 64 ids.  columns_place writes each
//    position into its row's list: every list is in position order.
//    columns_sum, one launch of 128-thread blocks in two roles.  Hot rows:
//    a block a (row, 32-column slice) at a time, persistent over them; one
//    warp runs the slice's 32 chains, a column a lane, from a ring of 4
//    stages of 128 positions in shared memory (64 / 32 KB in flight, f32
//    / bf16) that its other three warps fill with 16-byte cp.async
//    copies, a stage a warp in turn (its positions loaded before it waits
//    for the stage), each stage's copies completing on an mbarrier the
//    chain warp waits on; the chain warp frees a stage on a second one.
//    Cold rows (at most 64 ids): a warp a row, lanes over the columns, the
//    row's list read at once and 16 rows' loads in flight.
//  * bf16 adds are one fma.rn.bf16(x, 1, acc): the exact sum rounded once,
//    which equals the f32 sum rounded to bf16.  Two bf16 values whose
//    exponents differ by at most 15 sum exactly in f32 (at most 24
//    significant bits); past that the smaller is below 2^-15 of the
//    larger, and both roundings give the larger.
// The earlier design ("segments", forced only: the wrapper's
// _design="segments") keeps its four launches: count, offsets (one
// block), place, and a warp a row walking the row's list 16 rows ahead.

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

int sm_count(int device) {
  static int counts[64] = {0};
  int& c = counts[device & 63];
  if (c == 0 && cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount,
                                       device) != cudaSuccess)
    c = 132;
  return c;
}

// ------------------------------------------------------ gather: "vector"

constexpr int kVecSteps = 8;         // 16-byte words a lane loads, then stores
constexpr int kVecResident = 4;      // blocks an SM its registers must allow
constexpr int kVecBlocksPerSM = 16;  // the grid's most blocks an SM

__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint4 load_evict_last(const uint4* p,
                                                 unsigned long long policy) {
  uint4 r;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "l"(policy));
  return r;
}

// Items of the vector design: tiles of 32 rows times the STEPS-step
// batches of a tile's 32 * W words.
template <int STEPS>
__host__ __device__ long long vector_items(int n, long long W) {
  return (long long)((n + 31) / 32) * ((W + STEPS - 1) / STEPS);
}

int vector_blocks(int n, long long row_bytes, int sms) {
  const long long want =
      (vector_items<kVecSteps>(n, row_bytes / 16) + kWarps - 1) / kWarps;
  const long long most = (long long)sms * kVecBlocksPerSM;
  return (int)(want < most ? want : most);
}

template <int STEPS>
__global__ void __launch_bounds__(kThreads, kVecResident)
    gather_vector_kernel(const uint4* __restrict__ table,
                         const int* __restrict__ ids, uint4* __restrict__ out,
                         int n, int V, int W) {
  const int lane = threadIdx.x & 31;
  const int batches = (W + STEPS - 1) / STEPS;
  const long long items = vector_items<STEPS>(n, W);
  const unsigned long long policy = evict_last_policy();
  for (long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       item < items; item += (long long)gridDim.x * kWarps) {
    const int tile = (int)(item / batches);
    const int s0 = (int)(item - (long long)tile * batches) * STEPS;
    const int steps = min(STEPS, W - s0);
    const int rows = min(32, n - tile * 32);
    // the tile's rows this item's words fall in; lane r loads row r's id
    const int first = s0 * 32 / W, last = ((s0 + steps) * 32 - 1) / W;
    int id = -1;
    if (lane >= first && lane <= last && lane < rows)
      id = __ldcs(ids + tile * 32 + lane);
    uint4 v[STEPS];
    unsigned live = 0;              // the steps whose word this lane stores
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int w = (s0 + s) * 32 + lane;
      const int r = w / W;
      const int row_id = __shfl_sync(kFull, id, r & 31);
      v[s] = make_uint4(0u, 0u, 0u, 0u);
      if (s < steps && r < rows) {
        live |= 1u << s;
        if (row_id >= 0 && row_id < V)
          v[s] = load_evict_last(table + (size_t)row_id * W + (w - r * W),
                                 policy);
      }
    }
    uint4* dst = out + (size_t)tile * 32 * W;
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      if (live >> s & 1u) __stcs(dst + (s0 + s) * 32 + lane, v[s]);
  }
}

// ---------------------------------------------------- gather: "warp_row"

template <typename W>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const W* __restrict__ table, const int* __restrict__ ids,
    W* __restrict__ out, int n, int V, int words) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < n; i += stride) {
    const int id = ids[i];
    W* dst = out + (size_t)i * words;
    if (id < 0 || id >= V) {
      for (int j = lane; j < words; j += 32) dst[j] = W{};
      continue;
    }
    const W* src = table + (size_t)id * words;
    for (int j = lane; j < words; j += 32) dst[j] = src[j];
  }
}

template <typename W>
cudaError_t launch_gather(const void* table, const int* ids, void* out, int n,
                          int V, size_t row_bytes, cudaStream_t stream) {
  const int words = (int)(row_bytes / sizeof(W));
  int blocks = (n + kWarps - 1) / kWarps;
  blocks = blocks > 16384 ? 16384 : blocks;
  gather_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(table), ids, static_cast<W*>(out), n, V, words);
  return cudaGetLastError();
}

// ------------------------------------------- scatter_add: "columns" design

constexpr int kSmallN = 256;       // up to it: scatter_small, one launch
constexpr int kChunk = 1024;       // ids a columns_sort block sorts
constexpr int kPosBits = 10;       // log2(kChunk)
constexpr int kMaxVocab = (1 << 22) - 1;   // id << kPosBits | position
constexpr int kSortThreads = 512;
constexpr int kHotMin = 64;        // a row with more ids: column-sliced chains
constexpr int kSlice = 32;         // columns a hot chain warp owns, a lane each
constexpr int kStage = 128;        // positions a ring stage holds
constexpr int kStages = 4;         // ring stages: 64 / 32 KB f32 / bf16
constexpr int kSumThreads = 128;   // hot: 1 chain warp + 3 copy warps
constexpr int kCopyWarps = kSumThreads / 32 - 1;
constexpr int kColdRows = kSumThreads / 32;   // cold: a warp a row
constexpr int kHotPerSM = 2;       // hot blocks a SM, at most
static_assert(kSmallN == kThreads, "one id a thread in scatter_small");
static_assert(kHotMin <= 64, "a cold row's list: two ids a lane");

// One fma.rn.bf16 (x * 1 + acc, rounded once): equal to the f32 sum of
// two bf16 values rounded to bf16 (see the note at the top).
__device__ __forceinline__ unsigned short bf16_add(unsigned short acc,
                                                   unsigned short x) {
  unsigned short r;
  asm("{\n .reg .b16 one;\n mov.b16 one, 0x3f80;\n"
      " fma.rn.bf16 %0, %1, one, %2;\n}\n"
      : "=h"(r) : "h"(x), "h"(acc));
  return r;
}
__device__ __forceinline__ unsigned bf16x2_add(unsigned acc, unsigned x) {
  unsigned r;
  asm("{\n .reg .b32 one;\n mov.b32 one, 0x3f803f80;\n"
      " fma.rn.bf16x2 %0, %1, one, %2;\n}\n"
      : "=r"(r) : "r"(x), "r"(acc));
  return r;
}

// B bytes at p (aligned to min(B, 16)) as 32-bit words.
template <int B>
__device__ __forceinline__ void load_words(const void* p,
                                           unsigned (&w)[B / 4]) {
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int k = 0; k < B / 16; ++k) {
      const uint4 x = static_cast<const uint4*>(p)[k];
      w[4 * k] = x.x; w[4 * k + 1] = x.y; w[4 * k + 2] = x.z;
      w[4 * k + 3] = x.w;
    }
  } else if constexpr (B == 8) {
    const uint2 x = *static_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = *static_cast<const unsigned*>(p);
  }
}

template <int B>
__device__ __forceinline__ void store_words(void* p,
                                            const unsigned (&w)[B / 4]) {
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int k = 0; k < B / 16; ++k)
      static_cast<uint4*>(p)[k] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  } else if constexpr (B == 8) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *static_cast<unsigned*>(p) = w[0];
  }
}

// A lane's CPL consecutive columns of a row, in T's own bits, and the
// chain's add on them: f32 adds; bf16 fma.rn.bf16x2, two columns a word.
template <typename T, int CPL>
struct Cols {
  static constexpr int kBytes = CPL * (int)sizeof(T);
  unsigned w[kBytes / 4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kBytes / 4; ++j) w[j] = 0u;
  }
  __device__ __forceinline__ void load(const T* p) { load_words<kBytes>(p, w); }
  __device__ __forceinline__ void store(T* p) const {
    store_words<kBytes>(p, w);
  }
  __device__ __forceinline__ void add(const Cols& x) {
#pragma unroll
    for (int j = 0; j < kBytes / 4; ++j) {
      if constexpr (sizeof(T) == 4)
        w[j] = __float_as_uint(__uint_as_float(w[j]) + __uint_as_float(x.w[j]));
      else
        w[j] = bf16x2_add(w[j], x.w[j]);
    }
  }
};

// d = 32 in bf16: one 16-bit value a lane
template <>
struct Cols<__nv_bfloat16, 1> {
  static constexpr int kBytes = 2;
  unsigned short h;
  __device__ __forceinline__ void zero() { h = 0; }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    h = *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<unsigned short*>(p) = h;
  }
  __device__ __forceinline__ void add(const Cols& x) { h = bf16_add(h, x.h); }
};

// rows a cold warp loads at once: up to 64 registers of them
template <typename T, int CPL>
constexpr int kUnroll = Cols<T, CPL>::kBytes >= 32 ? 8 : 16;

// n <= kSmallN: warp w of the block owns table row 8 * blockIdx.x + w; it
// finds the row's ids with ballots over the n ids (in shared memory) and
// adds their grad rows in position order.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads) scatter_small(
    const T* __restrict__ grad, const int* __restrict__ ids, int n, int V,
    T* __restrict__ out) {
  constexpr int d = CPL * 32;
  constexpr int U = kUnroll<T, CPL>;
  __shared__ int s_ids[kSmallN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  s_ids[tid] = tid < n ? ids[tid] : -1;
  __syncthreads();
  const int row = blockIdx.x * kWarps + warp;
  if (row >= V) return;
  Cols<T, CPL> acc;
  acc.zero();
  for (int g = 0; g < n; g += 32) {
    unsigned mask = __ballot_sync(kFull, s_ids[g + lane] == row);
    while (mask) {
      int at[U];
      int got = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        at[u] = g + (mask ? __ffs(mask) - 1 : 0);
        got += mask != 0;
        mask &= mask - 1;
      }
      Cols<T, CPL> x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u].load(grad + (size_t)(u < got ? at[u] : at[0]) * d + lane * CPL);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < got) acc.add(x[u]);
    }
  }
  acc.store(out + (size_t)row * d + lane * CPL);
}

// The chunk's keys sorted: skey[c*kChunk + j] the j-th (id << kPosBits |
// position in the chunk; ids outside [0, V) as V, last), srank the entry's
// rank in its id's run, count[c][v] the run's length (0 for an id not in
// the chunk).  Block 0 zeroes the two counters columns_rows takes.
struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

__global__ void __launch_bounds__(kSortThreads) columns_sort(
    const int* __restrict__ ids, int n, int V, unsigned* __restrict__ skey,
    int* __restrict__ srank, int* __restrict__ count,
    int* __restrict__ counters) {
  constexpr int kKeys = kChunk / kSortThreads;
  using Sort = cub::BlockRadixSort<unsigned, kSortThreads, kKeys>;
  using Scan = cub::BlockScan<int, kSortThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ unsigned s_key[kChunk + 1];
  const int tid = threadIdx.x, c = blockIdx.x, base = c * kChunk;
  const int len = min(kChunk, n - base);
  const unsigned invalid = (unsigned)V << kPosBits;
  if (c == 0 && tid < 2) counters[tid] = 0;
  int* cnt = count + (size_t)c * V;
  for (int v = tid; v < V; v += kSortThreads) cnt[v] = 0;
  unsigned key[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int i = tid * kKeys + k;
    const int id = i < len ? ids[base + i] : -1;
    key[k] = (id >= 0 && id < V ? (unsigned)id << kPosBits : invalid) |
             (unsigned)i;
  }
  Sort(tmp.sort).Sort(key, 0, kPosBits + (32 - __clz(V)));
#pragma unroll
  for (int k = 0; k < kKeys; ++k) s_key[tid * kKeys + k] = key[k];
  if (tid == 0) s_key[kChunk] = kFull;   // past the end: never an id
  __syncthreads();
  int first[kKeys];   // the index of the entry's run's first entry
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int j = tid * kKeys + k;
    first[k] = j == 0 || (s_key[j - 1] >> kPosBits) != (key[k] >> kPosBits)
                   ? j : 0;
  }
  Scan(tmp.scan).InclusiveScan(first, first, MaxOp());
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int j = tid * kKeys + k;
    const unsigned v = key[k] >> kPosBits;
    skey[base + j] = key[k];
    srank[base + j] = j - first[k];
    if (v < (unsigned)V && (s_key[j + 1] >> kPosBits) != v)
      cnt[v] = j - first[k] + 1;   // the run ends here
  }
}

// Rows [32 * blockIdx.x, +32), a lane each; warp w takes a contiguous
// eighth of the chunks.  count[c][v] becomes where chunk c's run of v
// starts in the workspace's lists; start[v] and len[v] the row's list;
// the rows with more than kHotMin ids go to hot[] (counters[1] of them).
__global__ void __launch_bounds__(kThreads) columns_rows(
    int* __restrict__ count, int S, int V, int* __restrict__ start,
    int* __restrict__ len, int* __restrict__ hot, int* __restrict__ counters) {
  __shared__ int s_part[kWarps][32];
  __shared__ int s_start[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = blockIdx.x * 32 + lane;
  const bool live = v < V;
  const int per = (S + kWarps - 1) / kWarps;
  const int lo = min(S, warp * per), hi = min(S, lo + per);
  int sum = 0;
  for (int c0 = lo; c0 < hi; c0 += 8) {
    int x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = live && c0 + u < hi ? count[(size_t)(c0 + u) * V + v] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) sum += x[u];
  }
  s_part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_part[w][lane];
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int base = 0;
    if (lane == 31 && incl > 0) base = atomicAdd(&counters[0], incl);
    base = __shfl_sync(kFull, base, 31);
    const int st = base + incl - total;
    if (live) {
      start[v] = st;
      len[v] = total;
      if (total > kHotMin) hot[atomicAdd(&counters[1], 1)] = v;
    }
    s_start[lane] = st;
  }
  __syncthreads();
  int off = s_start[lane];
  for (int w = 0; w < warp; ++w) off += s_part[w][lane];
  for (int c0 = lo; c0 < hi; c0 += 8) {
    int x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = live && c0 + u < hi ? count[(size_t)(c0 + u) * V + v] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (live && c0 + u < hi) {
        count[(size_t)(c0 + u) * V + v] = off;
        off += x[u];
      }
  }
}

// sorted[list of v, in position order] = each position i with ids[i] = v
__global__ void __launch_bounds__(kSortThreads) columns_place(
    const unsigned* __restrict__ skey, const int* __restrict__ srank,
    const int* __restrict__ count, int V, int* __restrict__ sorted) {
  const int c = blockIdx.x, base = c * kChunk;
  for (int j = threadIdx.x; j < kChunk; j += kSortThreads) {
    const unsigned key = skey[base + j];
    const unsigned v = key >> kPosBits;
    if (v < (unsigned)V)
      sorted[count[(size_t)c * V + v] + srank[base + j]] =
          base + (int)(key & (kChunk - 1));
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state) : "r"(smem_addr(bar)) : "memory");
}
// the mbarrier sees one arrival once the thread's earlier cp.async copies
// have landed (noinc: the arrival counts against the barrier's count)
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Blocks [0, hot_blocks): hot rows, a (row, slice) item at a time
// (item = blockIdx.x, + hot_blocks, ...; hot row item / CPL, slice item %
// CPL).  The rest: cold rows, 4 a block.
template <typename T, int CPL>
__global__ void __launch_bounds__(kSumThreads, 4) columns_sum(
    const T* __restrict__ grad, const int* __restrict__ sorted,
    const int* __restrict__ start, const int* __restrict__ len,
    const int* __restrict__ hot, const int* __restrict__ counters, int V,
    int hot_blocks, T* __restrict__ out) {
  constexpr int d = CPL * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x >= hot_blocks) {
    // a cold row: its list (at most 64 positions) read at once, then U
    // rows' loads in flight, added in order
    constexpr int U = kUnroll<T, CPL>;
    const int v = ((int)blockIdx.x - hot_blocks) * kColdRows + warp;
    if (v >= V) return;
    const int r = len[v];
    if (r > kHotMin) return;             // the column chains write it
    const int* list = sorted + start[v];
    const int idx0 = r > 0 ? list[min(lane, r - 1)] : 0;
    const int idx1 = r > 32 ? list[min(32 + lane, r - 1)] : 0;
    Cols<T, CPL> acc;
    acc.zero();
    for (int e0 = 0; e0 < r; e0 += U) {
      const int idx = e0 < 32 ? idx0 : idx1;
      Cols<T, CPL> x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = __shfl_sync(kFull, idx, (e0 + u) & 31);
        x[u].load(grad + (size_t)pos * d + lane * CPL);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e0 + u < r) acc.add(x[u]);
    }
    acc.store(out + (size_t)v * d + lane * CPL);
    return;
  }

  // hot rows: warp 0 runs the chains, warps 1-3 fill the ring
  extern __shared__ __align__(128) unsigned char s_ring[];
  __shared__ __align__(8) unsigned long long s_full[kStages];
  __shared__ __align__(8) unsigned long long s_empty[kStages];
  T* ring = reinterpret_cast<T*>(s_ring);   // [kStages][kStage][kSlice]
  const int items = counters[1] * CPL;
  if ((int)blockIdx.x >= items) return;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&s_full[s], 32);   // a copy warp's lanes
      mbar_init(&s_empty[s], 1);   // the chain warp's lane 0
    }
  }
  __syncthreads();
  int k = 0;   // the block's stages so far, over all its items
  if (warp == 0) {
    for (int item = blockIdx.x; item < items; item += hot_blocks) {
      const int v = hot[item / CPL], q = item % CPL;
      const int r = len[v];
      Cols<T, 1> acc;
      acc.zero();
      for (int e0 = 0; e0 < r; e0 += kStage, ++k) {
        const int slot = k % kStages;
        mbar_wait(&s_full[slot], (k / kStages) & 1);
        const T* at = ring + (size_t)slot * kStage * kSlice + lane;
        const int m = min(kStage, r - e0);
        if (m == kStage) {
#pragma unroll
          for (int p0 = 0; p0 < kStage; p0 += 32) {
            Cols<T, 1> x[32];
#pragma unroll
            for (int u = 0; u < 32; ++u) x[u].load(at + (p0 + u) * kSlice);
#pragma unroll
            for (int u = 0; u < 32; ++u) acc.add(x[u]);
          }
        } else {
          for (int p = 0; p < m; ++p) {
            Cols<T, 1> x;
            x.load(at + p * kSlice);
            acc.add(x);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&s_empty[slot]);
      }
      acc.store(out + (size_t)v * d + q * kSlice + lane);
    }
    return;
  }
  // copy warps: stage k is warp 1 + k % 3's; 16-byte pieces, kPieces a
  // position's slice, so that one instruction copies kPer positions
  constexpr int kPieces = kSlice * (int)sizeof(T) / 16;
  constexpr int kPer = 32 / kPieces;
  constexpr int kElems = 16 / (int)sizeof(T);
  const int me = warp - 1, piece = lane % kPieces, p0 = lane / kPieces;
  for (int item = blockIdx.x; item < items; item += hot_blocks) {
    const int v = hot[item / CPL], q = item % CPL;
    const int r = len[v];
    const int* list = sorted + start[v];
    const T* src = grad + q * kSlice + piece * kElems;
    for (int e0 = 0; e0 < r; e0 += kStage, ++k) {
      if (k % kCopyWarps != me) continue;
      // the stage's positions first: their loads overlap the wait
      int idx[kStage / 32];
#pragma unroll
      for (int m = 0; m < kStage / 32; ++m) {
        const int e = e0 + 32 * m + lane;
        idx[m] = e < r ? list[e] : -1;
      }
      const int slot = k % kStages;
      if (k >= kStages) mbar_wait(&s_empty[slot], ((k / kStages) - 1) & 1);
      T* dst = ring + (size_t)slot * kStage * kSlice + piece * kElems;
#pragma unroll
      for (int j = 0; j < kStage / kPer; ++j) {
        const int p = p0 + kPer * j;
        const int pos = __shfl_sync(kFull, idx[kPer * j / 32], p & 31);
        if (pos >= 0) cp_async16(dst + p * kSlice, src + (size_t)pos * d);
      }
      mbar_arrive_copies(&s_full[slot]);
    }
  }
}

// The workspace of the "columns" design, in ints, each array a multiple
// of 4 ints (16 bytes): counters[4], skey and srank [S * kChunk],
// count [S][V], start, len and hot [V], sorted [n].
long long round4(long long x) { return (x + 3) & ~3LL; }

struct ColumnsWs {
  int* counters;
  unsigned* skey;
  int *srank, *count, *start, *len, *hot, *sorted;
  ColumnsWs(int n, int V, void* ws) {
    const long long S = (n + kChunk - 1) / kChunk;
    int* p = static_cast<int*>(ws);
    counters = p;
    p += 4;
    skey = reinterpret_cast<unsigned*>(p);
    p += S * kChunk;
    srank = p;
    p += S * kChunk;
    count = p;
    p += round4(S * V);
    start = p;
    p += round4(V);
    len = p;
    p += round4(V);
    hot = p;
    p += round4(V);
    sorted = p;
  }
  static long long ints(int n, int V) {
    const long long S = (n + kChunk - 1) / kChunk;
    return 4 + 2 * S * kChunk + round4(S * V) + 3 * round4(V) + round4(n);
  }
};

template <typename T, int CPL>
cudaError_t launch_columns(const T* grad, const int* ids, T* out, int n,
                           int V, void* ws, int device, cudaStream_t stream) {
  if (n <= kSmallN) {
    scatter_small<T, CPL><<<(V + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        grad, ids, n, V, out);
    return cudaGetLastError();
  }
  if (V > kMaxVocab) return cudaErrorInvalidValue;
  const int S = (n + kChunk - 1) / kChunk;
  ColumnsWs w(n, V, ws);
  columns_sort<<<S, kSortThreads, 0, stream>>>(ids, n, V, w.skey, w.srank,
                                               w.count, w.counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  columns_rows<<<(V + 31) / 32, kThreads, 0, stream>>>(
      w.count, S, V, w.start, w.len, w.hot, w.counters);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  columns_place<<<S, kSortThreads, 0, stream>>>(w.skey, w.srank, w.count, V,
                                                w.sorted);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto kernel = columns_sum<T, CPL>;
  constexpr int smem = kStages * kStage * kSlice * (int)sizeof(T);
  static unsigned long long sized = 0;  // once per instantiation and device
  const unsigned long long bit = 1ull << (device & 63);
  if (!(sized & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized |= bit;
  }
  // at most n / (kHotMin + 1) rows are hot; on the card, how many are
  const int hot_rows = n / (kHotMin + 1) < V ? n / (kHotMin + 1) : V;
  const long long items = (long long)hot_rows * CPL;
  const long long most = (long long)kHotPerSM * sm_count(device);
  const int hot_blocks = (int)(items < most ? items : most);
  kernel<<<hot_blocks + (V + kColdRows - 1) / kColdRows, kSumThreads, smem,
           stream>>>(grad, w.sorted, w.start, w.len, w.hot, w.counters, V,
                     hot_blocks, out);
  return cudaGetLastError();
}

// ----------------------------- scatter_add: the earlier "segments" design

constexpr int kSegment = 1024;     // ids a counting / placing warp owns
constexpr int kSegUnroll = 16;     // a row chain's loads in flight

__device__ __forceinline__ bool in_table(int id, int V) {
  return id >= 0 && id < V;
}

// count[s][v]: occurrences of id v among segment s's ids
__global__ void __launch_bounds__(kThreads) scatter_count(
    const int* __restrict__ ids, int n, int V, int S, int* __restrict__ count) {
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= S) return;
  const int lane = threadIdx.x & 31;
  const int end = min(n, (seg + 1) * kSegment);
  int* cnt = count + (size_t)seg * V;
  for (int base = seg * kSegment; base < end; base += 32) {
    const int i = base + lane;
    const int id = i < end ? ids[i] : -1;
    const bool ok = in_table(id, V);
    const unsigned peers = __match_any_sync(kFull, ok ? id : -1);
    if (ok && lane == __ffs(peers) - 1) cnt[id] += __popc(peers);
    __syncwarp();
  }
}

// count[s][v] <- the occurrences of v in segments before s (the segment's
// offset inside v's run); start[v] <- where v's run begins; start[V] <- the
// number of ids in [0, V).  One block.
__global__ void __launch_bounds__(1024) scatter_offsets(
    int* __restrict__ count, int S, int V, int* __restrict__ start) {
  __shared__ int s_warp[32];
  __shared__ int s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int v = tid; v < V; v += blockDim.x) {
    int run = 0;
    for (int s = 0; s < S; ++s) {
      const int c = count[(size_t)s * V + v];
      count[(size_t)s * V + v] = run;
      run += c;
    }
    start[v] = run;
  }
  if (tid == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < V; base += blockDim.x) {
    const int v = base + tid;
    const int x = v < V ? start[v] : 0;
    int incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? s_warp[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    if (warp > 0) incl += s_warp[warp - 1];
    const int carry = s_carry;
    if (v < V) start[v] = carry + incl - x;
    __syncthreads();
    if (tid == blockDim.x - 1) s_carry = carry + incl;
    __syncthreads();
  }
  if (tid == 0) start[V] = s_carry;
}

// sorted[start[v] + offset + rank] = i for each position i with ids[i] = v
__global__ void __launch_bounds__(kThreads) scatter_place(
    const int* __restrict__ ids, int n, int V, int S,
    const int* __restrict__ start, int* __restrict__ offsets,
    int* __restrict__ sorted) {
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= S) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int end = min(n, (seg + 1) * kSegment);
  int* off = offsets + (size_t)seg * V;
  for (int base = seg * kSegment; base < end; base += 32) {
    const int i = base + lane;
    const int id = i < end ? ids[i] : -1;
    const bool ok = in_table(id, V);
    const unsigned peers = __match_any_sync(kFull, ok ? id : -1);
    if (ok) sorted[start[id] + off[id] + __popc(peers & below)] = i;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) off[id] += __popc(peers);
    __syncwarp();
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int CPL>  // CPL = d / 32 columns per lane
__global__ void __launch_bounds__(kThreads) scatter_sum(
    const T* __restrict__ grad, const int* __restrict__ start,
    const int* __restrict__ sorted, int V, T* __restrict__ out) {
  constexpr int d = CPL * 32;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int v = blockIdx.x * kWarps + (threadIdx.x >> 5); v < V; v += stride) {
    const int begin = start[v], end = start[v + 1];
    float acc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
    for (int e0 = begin; e0 < end; e0 += kSegUnroll) {
      float x[kSegUnroll][CPL];
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u) {
        const int e = e0 + u;
        const size_t src = e < end ? (size_t)sorted[e] * d : 0;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          x[u][c] = e < end ? port::to_float(grad[src + lane + 32 * c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u) {
        if (e0 + u >= end) break;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          acc[c] = port::round_to<T>(acc[c] + x[u][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      store(out + (size_t)v * d + lane + 32 * c, acc[c]);
  }
}

int segments(int n) { return n <= 0 ? 0 : (n + kSegment - 1) / kSegment; }

long long segments_ws_ints(int n, int V) {
  return (long long)segments(n) * V + V + 1 + (n > 0 ? n : 0);
}

template <typename T, int CPL>
cudaError_t launch_segments(const T* grad, const int* ids, T* out, int n,
                            int V, void* ws_, cudaStream_t stream) {
  const int S = segments(n);
  int* count = static_cast<int*>(ws_);          // [S][V]
  int* start = count + (size_t)S * V;           // [V + 1]
  int* sorted = start + V + 1;                  // [n]
  cudaError_t err =
      cudaMemsetAsync(count, 0, (size_t)S * V * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int seg_blocks = (S + kWarps - 1) / kWarps;
  if (S > 0) {
    scatter_count<<<seg_blocks, kThreads, 0, stream>>>(ids, n, V, S, count);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  scatter_offsets<<<1, 1024, 0, stream>>>(count, S, V, start);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (S > 0) {
    scatter_place<<<seg_blocks, kThreads, 0, stream>>>(ids, n, V, S, start,
                                                       count, sorted);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  int blocks = (V + kWarps - 1) / kWarps;
  blocks = blocks > 16384 ? 16384 : blocks;
  scatter_sum<T, CPL><<<blocks, kThreads, 0, stream>>>(grad, start, sorted, V,
                                                       out);
  return cudaGetLastError();
}

// design: 0 "small" / 1 "columns" (the columns design; its launch takes
// the small route up to kSmallN ids), 2 "segments"
template <typename T, int CPL>
cudaError_t launch_scatter(int design, const void* grad_, const int* ids,
                           void* out_, int n, int V, void* ws, int device,
                           cudaStream_t stream) {
  const T* grad = static_cast<const T*>(grad_);
  T* out = static_cast<T*>(out_);
  if (design == 2)
    return launch_segments<T, CPL>(grad, ids, out, n, V, ws, stream);
  if ((design == 0) != (n <= kSmallN)) return cudaErrorInvalidValue;
  return launch_columns<T, CPL>(grad, ids, out, n, V, ws, device, stream);
}

template <typename T>
cudaError_t launch_scatter_d(int d, int design, const void* grad,
                             const int* ids, void* out, int n, int V,
                             void* ws, int device, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_scatter<T, 1>(design, grad, ids, out, n, V, ws, device, s);
    case 64:
      return launch_scatter<T, 2>(design, grad, ids, out, n, V, ws, device, s);
    case 128:
      return launch_scatter<T, 4>(design, grad, ids, out, n, V, ws, device, s);
    case 256:
      return launch_scatter<T, 8>(design, grad, ids, out, n, V, ws, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The gather design a row of row_bytes takes: 0 "vector" (a multiple of
// 16 bytes), else 1 "warp_row"; the wrapper's gather_design agrees.
extern "C" int gather_design(long long row_bytes) {
  return row_bytes % 16 == 0 ? 0 : 1;
}

// Blocks of a vector-design launch over n rows on a card of sms SMs; the
// wrapper's gather_grid agrees.
extern "C" int gather_vector_blocks(int n, long long row_bytes, int sms) {
  return vector_blocks(n, row_bytes, sms);
}

// table [V, row_bytes] of any type, ids [n] int32, out [n, row_bytes];
// device pointers to contiguous arrays aligned to 16 bytes, row_bytes
// even; design 0 "vector" (row_bytes a multiple of 16) or 1 "warp_row".
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gather_launch(const void* table, const void* ids, void* out,
                             int n, int V, long long row_bytes, int design,
                             int device, void* stream) {
  if (row_bytes % 2 != 0 || design < 0 || design > 1 ||
      (design == 0 && row_bytes % 16 != 0))
    return cudaErrorInvalidValue;
  if (n <= 0 || row_bytes <= 0) return cudaSuccess;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const int* id = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    gather_vector_kernel<kVecSteps>
        <<<vector_blocks(n, row_bytes, sm_count(device)), kThreads, 0, s>>>(
            static_cast<const uint4*>(table), id, static_cast<uint4*>(out), n,
            V, (int)(row_bytes / 16));
    return cudaGetLastError();
  }
  const size_t rb = (size_t)row_bytes;
  if (rb % 16 == 0) return launch_gather<uint4>(table, id, out, n, V, rb, s);
  if (rb % 8 == 0) return launch_gather<uint2>(table, id, out, n, V, rb, s);
  if (rb % 4 == 0)
    return launch_gather<unsigned int>(table, id, out, n, V, rb, s);
  return launch_gather<unsigned short>(table, id, out, n, V, rb, s);
}

// Bytes of workspace a scatter_add of n ids into V rows needs in a design
// (0 small, 1 columns, 2 segments); the wrapper's scatter_plan agrees.
extern "C" long long scatter_workspace_bytes(int n, int V, int design) {
  if (V <= 0) return 0;
  if (design == 2) return 4 * segments_ws_ints(n, V);
  if (n <= kSmallN) return 0;
  return 4 * ColumnsWs::ints(n, V);
}

// grad [n, d] f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned;
// ids [n] int32; out [V, d] in grad's type; ws ws_bytes >=
// scatter_workspace_bytes(n, V, design), 16-byte aligned; all device
// pointers to contiguous arrays; d is 32, 64, 128 or 256; design 0 (n <=
// 256), 1 (n > 256, V <= 4,194,303) or 2.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int scatter_add_launch(int is_bf16, const void* grad,
                                  const void* ids, void* out, void* ws,
                                  long long ws_bytes, int n, int V, int d,
                                  int design, int device, void* stream) {
  if (V <= 0) return cudaSuccess;
  if (n < 0 || design < 0 || design > 2 ||
      ws_bytes < scatter_workspace_bytes(n, V, design))
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const int* id = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_scatter_d<__nv_bfloat16>(d, design, grad, id, out, n, V,
                                           ws, device, s);
  return launch_scatter_d<float>(d, design, grad, id, out, n, V, ws, device,
                                 s);
}
