// Embedding-table backward: dtable[v, :] = sum_n [ids[n] == v] * ct[n, :].
//
// Replaces: mtamrecommender_tpu/ops/pallas/embedding_kernel.py,
// _dtable_kernel (launched by _dtable_impl, the backward of take_dtable).
// ct is f32 or bf16 [n, d], d in {32, 64, 128, 256}; the sums run in f32
// and the table [V, d] is written once in ct's type, with zeros for rows
// no id names.  Ids outside [0, V) match no row.
//
// What bounds it: bytes.  ct read once, ids read once, the table written
// once: at the training step's item table (n = 12,800 ids, d = 128, V =
// 3,712, f32) that is 8.5 MB, 2.5 us at 3.35 TB/s; the adds (n * d f32)
// are ~1.6 MFLOP.  What makes it hard is the ids: about half of a step's
// ids are the padding id 0, and every position id repeats once per
// sequence, so one row may collect thousands of cotangent rows, while
// most item ids appear once or twice.
//
// Design: sort, then sum runs; no float atomics, and the sum order is
// fixed, so a training step gives the same bits on every run.  The
// wrapper's dtable_plan picks the route and sizes the workspace.
//  * n <= 256 (a user table: one id a sequence): dtable_small, one pass
//    with no workspace.  A warp a table row finds the row's ids with
//    ballots over the n ids in shared memory and adds their ct rows in
//    position order.
//  * Else two passes.  dtable_chunks: one block a chunk of C = 256 or
//    1024 consecutive ids (256 while that keeps the grid to one wave of
//    128 blocks, so that a step's 12,800 ids spread over 50 SMs; fewer,
//    larger chunks past it, for fewer partial rows to merge).  The block sorts its chunk's 32-bit keys (id << log2(C) |
//    position; cub::BlockRadixSort over only the bits the vocab needs),
//    so each id's entries form one run in position order; ids outside
//    [0, V) sort last and are dropped.  The sorted chunk is cut into
//    fixed slices of 32 or 64 entries, one a warp, so a long run (the
//    padding id) is split across warps: each warp walks its slice in
//    order with up to 64 / CPL ct rows in flight (16-byte loads) and adds
//    each run in f32 registers.  A run that ends in its slice is written
//    as one f32 partial row; the pieces of a run that crosses slice edges
//    go to shared memory, and the warp where it starts adds them in slice
//    order.  Each chunk writes one partial row and its id per distinct id
//    (ascending), and its count.
//    dtable_rows: one block a tile of R = 1, 2, 4 or 8 table rows (more
//    for a larger table, so that fewer blocks search).  A thread a chunk
//    finds the chunk's runs in the tile (an 8-way search of the sorted
//    ids); the block lists them chunk by chunk and cuts the list into 8
//    equal ranges, one a warp, so a row named in every chunk is shared by
//    all 8 warps.  Each warp adds its range's partial rows, in list order,
//    into its own f32 sums in shared memory; a row's 8 sums are added in
//    warp order and the row is written once, rounded to ct's type (zeros
//    where no id names it).
// So a row's sum runs: per chunk, each slice in position order, the
// slices in slice order; then the chunks in order, in 8 contiguous groups
// added in group order.  The workspace is at most n * d f32 partials plus
// n + chunks ints; a chunk writes only its distinct ids' rows.  The key
// packs the id into 22 bits: V <= 4,194,303 (the wrapper raises above it
// before any launch).

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

constexpr int kMaxChunk = 1024;
constexpr int kMaxVocab = (1 << 22) - 1;   // id << log2(kMaxChunk) | position
constexpr int kSmallN = 256;               // up to it: one pass, no sort
constexpr int kThreads2 = 256;
constexpr int kWarps2 = kThreads2 / 32;
constexpr int kMaxTile = 8;                // table rows a dtable_rows block
constexpr int kSmallTile = kWarps2;        // rows a dtable_small block, a warp each
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSmallN == kThreads2, "one id a thread in dtable_small");

// The first pass's block for a chunk of C ids (256 or 1024).
template <int C>
struct Chunk {
  static constexpr int kThreads = C < 512 ? C : 512;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kKeys = C / kThreads;      // sort keys a thread
  static constexpr int kSlice = C / kWarps;       // sorted entries a warp walks
  static constexpr int kPosBits = C == 256 ? 8 : 10;
  static_assert(C == 1 << kPosBits && C <= kMaxChunk && kSlice % 32 == 0,
                "chunk shape");
};

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// N consecutive values at p (aligned to N * sizeof(T)), as f32.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 x = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z; v[4 * k + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[k];
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[8 * k + 2 * j] = bf16_lo(w[j]);
        v[8 * k + 2 * j + 1] = bf16_hi(w[j]);
      }
    }
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(x.x); v[1] = bf16_hi(x.x);
    v[2] = bf16_lo(x.y); v[3] = bf16_hi(x.y);
  } else if constexpr (N == 2) {
    const unsigned x = *reinterpret_cast<const unsigned*>(p);
    v[0] = bf16_lo(x); v[1] = bf16_hi(x);
  } else {
    v[0] = __uint_as_float(
        (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* p,
                                          const float (&v)[N]) {
  if constexpr (N == 1) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(v[0]);
  } else {
    unsigned w[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
      w[j] = bf16_bits(v[2 * j]) | (bf16_bits(v[2 * j + 1]) << 16);
    if constexpr (N % 8 == 0) {
#pragma unroll
      for (int k = 0; k < N / 8; ++k)
        reinterpret_cast<uint4*>(p)[k] =
            make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    } else if constexpr (N == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N], const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] += v[j];
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
}

// Pass 1: chunk blockIdx.x's partial rows.  part[(c*C + r) * d] is the
// f32 sum of the chunk's r-th distinct id (ascending), run_id[c*C + r]
// that id, run_count[c] the chunk's number of distinct ids.
template <typename T, int CPL, int C>  // CPL = d / 32 columns per lane
__global__ void __launch_bounds__(Chunk<C>::kThreads) dtable_chunks(
    const T* __restrict__ ct, const int* __restrict__ ids, int n, int V,
    float* __restrict__ part, int* __restrict__ run_id,
    int* __restrict__ run_count) {
  constexpr int d = CPL * 32;
  constexpr int kWarps = Chunk<C>::kWarps, kKeys = Chunk<C>::kKeys;
  constexpr int kSlice = Chunk<C>::kSlice, kPosBits = Chunk<C>::kPosBits;
  using Sort = cub::BlockRadixSort<unsigned, Chunk<C>::kThreads, kKeys>;
  __shared__ typename Sort::TempStorage sort_tmp;
  __shared__ unsigned s_key[C + 1];
  __shared__ int s_runs[kWarps];       // runs starting in each slice
  __shared__ int s_tail_run[kWarps];   // run leaving the slice, begun in it
  __shared__ int s_head_cont[kWarps];  // the slice is inside one run
  // [2 * kWarps][d]: slot 2w the piece of slice w's first run when that
  // run began earlier, slot 2w + 1 the piece of a run begun in slice w
  // that goes on past it
  extern __shared__ __align__(16) float s_piece[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * C;
  const int len = min(C, n - base);
  const unsigned invalid = (unsigned)V << kPosBits;  // keys >= it: no row

  unsigned key[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int i = tid * kKeys + k;
    const int id = i < len ? ids[base + i] : -1;
    key[k] = (id >= 0 && id < V ? (unsigned)id << kPosBits : invalid) |
             (unsigned)i;
  }
  Sort(sort_tmp).Sort(key, 0, kPosBits + (32 - __clz(V)));
#pragma unroll
  for (int k = 0; k < kKeys; ++k) s_key[tid * kKeys + k] = key[k];
  if (tid == 0) s_key[C] = kFull;  // past the end: never a row's id
  __syncthreads();

  // this warp's slice of the sorted chunk, [a, a + kSlice): each lane
  // classifies entries a + 32 h + lane (in range; first, last of its
  // run), and the walk reads those bits, not shared memory
  const int a = warp * kSlice;
  constexpr int kHalves = kSlice / 32;
  unsigned valid_m[kHalves], start_m[kHalves], end_m[kHalves];
  int starts = 0;
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    const int i = a + 32 * h + lane;
    const unsigned k = s_key[i];
    const unsigned id = k >> kPosBits;
    const bool valid = k < invalid;
    valid_m[h] = __ballot_sync(kFull, valid);
    start_m[h] = __ballot_sync(
        kFull, valid && (i == 0 || (s_key[i - 1] >> kPosBits) != id));
    end_m[h] = __ballot_sync(kFull, valid && (s_key[i + 1] >> kPosBits) != id);
    starts += __popc(start_m[h]);
  }
  if (lane == 0) {
    s_runs[warp] = starts;
    s_tail_run[warp] = -1;
    s_head_cont[warp] = 0;
  }
  __syncthreads();
  int run = -1;  // index of the run open at the slice's first entry
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    run += w < warp ? s_runs[w] : 0;
    total += s_runs[w];
  }
  if (tid == 0) run_count[blockIdx.x] = total;
  // each run's id, written by the lane whose entry starts it
  int before = run + 1;
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    if ((start_m[h] >> lane) & 1)
      run_id[base + before + __popc(start_m[h] & ((1u << lane) - 1))] =
          (int)(s_key[a + 32 * h + lane] >> kPosBits);
    before += __popc(start_m[h]);
  }

  const T* ct_lane = ct + (size_t)base * d + lane * CPL;
  float* piece = s_piece + lane * CPL;
  float acc[CPL];
  zero(acc);
  bool open = false;       // acc holds a piece not yet written
  bool begun_here = false; // the open piece's run starts in this slice
  // kGroup rows' loads issued at once (64 / CPL: 64 registers of them),
  // from clamped positions so that none waits on a branch
  constexpr int kGroup = 64 / CPL < kSlice ? 64 / CPL : kSlice;
  const int last_pos = len - 1;
#pragma unroll
  for (int j0 = 0; j0 < kSlice; j0 += kGroup) {
    if (!((valid_m[j0 / 32] >> (j0 % 32)) & 1)) break;  // sorted: no more
    float v[kGroup][CPL];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int pos = min((int)(s_key[a + j0 + u] & (C - 1)), last_pos);
      load_row(ct_lane + (size_t)pos * d, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + u;
      const unsigned bit = 1u << (j % 32);
      if (!(valid_m[j / 32] & bit)) break;
      const bool start = start_m[j / 32] & bit;
      if (start || !open) {
        zero(acc);
        begun_here = start;
        run += start;
      }
      add_to(acc, v[u]);
      open = true;
      if (end_m[j / 32] & bit) {  // the run ends here
        if (begun_here)
          store_row(part + (size_t)(base + run) * d + lane * CPL, acc);
        else
          store_row(piece + (2 * warp) * d, acc);
        open = false;
      }
    }
  }
  if (open) {  // the run goes on past the slice
    if (begun_here) {
      store_row(piece + (2 * warp + 1) * d, acc);
      if (lane == 0) s_tail_run[warp] = run;
    } else {
      store_row(piece + (2 * warp) * d, acc);
      if (lane == 0) s_head_cont[warp] = 1;
    }
  }
  __syncthreads();

  // runs that cross slice edges: their pieces in slice order
  const int r = s_tail_run[warp];
  if (r >= 0) {
    load_row(piece + (2 * warp + 1) * d, acc);
    for (int w = warp + 1; w < kWarps; ++w) {
      float v[CPL];
      load_row(piece + (2 * w) * d, v);
      add_to(acc, v);
      if (!s_head_cont[w]) break;
    }
    store_row(part + (size_t)(base + r) * d + lane * CPL, acc);
  }
}

// The first index of sorted list[0, cnt) whose value is >= key (cnt if
// none): each round loads K probes at once, step = ceil(span / K) apart,
// and keeps the step below the first probe >= key (K = 8: 4 rounds for
// cnt <= 1024).
template <int K>
__device__ __forceinline__ int lower_bound_k(const int* __restrict__ list,
                                             int cnt, int key) {
  int lo = 0, hi = cnt;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + K - 1) / K;
    int probe[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      probe[j] = list[min(lo + step * (j + 1) - 1, hi - 1)];
    int below = 0;  // probes inside [lo, hi) that are < key: a prefix
#pragma unroll
    for (int j = 0; j < K; ++j)
      below += lo + step * (j + 1) - 1 < hi && probe[j] < key;
    const int next_lo = lo + step * below;
    hi = min(hi, next_lo + step - 1);  // the next probe (K steps reach hi)
    lo = next_lo;
  }
  return lo;
}

// Pass 2: table rows [R * blockIdx.x, +R), R = 1, 2, 4 or 8 (rows_per
// block: more for a larger table, so that fewer blocks search the chunk
// lists).  A thread per chunk finds the chunk's runs for those rows; the
// block lists them, chunk by chunk, and cuts the list into 8 equal
// contiguous ranges, one a warp, so a row named in every chunk (the
// padding id) is shared by all warps.  Each warp adds its range's
// partial rows in list order, per row; the eight sums of a row are added
// in warp order and rounded once to T.
template <int CPL>  // partial rows a warp loads at once: 32 / CPL registers
constexpr int kUnroll = 32 / CPL < 4 ? 4 : (32 / CPL > 16 ? 16 : 32 / CPL);

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads2) dtable_rows(
    const float* __restrict__ part, const int* __restrict__ run_id,
    const int* __restrict__ run_count, int chunk, int chunks, int V, int R,
    T* __restrict__ out) {
  constexpr int d = CPL * 32;
  constexpr int U = kUnroll<CPL>;
  using Scan = cub::BlockScan<int, kThreads2>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_src[kThreads2 * kMaxTile];           // list: partial row
  __shared__ unsigned char s_row[kThreads2 * kMaxTile]; // list: row - lo
  extern __shared__ __align__(16) float s_sum[];        // [warp][row][d]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = blockIdx.x * R;
  // this warp's sums of the R rows: s_sum[warp][row][d], lane's columns
  float* my = s_sum + warp * kMaxTile * d + lane * CPL;
  for (int q = 0; q < R; ++q) {
    float z[CPL];
    zero(z);
    store_row(my + q * d, z);
  }
  for (int c0 = 0; c0 < chunks; c0 += kThreads2) {
    const int c = c0 + tid;
    int len = 0, at = 0, next[kMaxTile];
    if (c < chunks) {
      const int* list = run_id + (size_t)c * chunk;
      const int cnt = run_count[c];
      const int first = lower_bound_k<8>(list, cnt, lo);
      if (first < cnt) {
#pragma unroll
        for (int j = 0; j < kMaxTile; ++j)  // the candidates, loaded at once
          next[j] = list[min(first + j, cnt - 1)];
#pragma unroll
        for (int j = 0; j < kMaxTile; ++j)  // those in the rows: a prefix
          len += j < R && first + j < cnt && next[j] < lo + R;
      }
      at = c * chunk + first;
    }
    int off, total;
    Scan(scan_tmp).ExclusiveSum(len, off, total);
#pragma unroll
    for (int j = 0; j < kMaxTile; ++j)
      if (j < len) {
        s_src[off + j] = at + j;
        s_row[off + j] = (unsigned char)(next[j] - lo);
      }
    __syncthreads();
    const int e_end = (int)((long long)(warp + 1) * total / kWarps2);
    for (int e = (int)((long long)warp * total / kWarps2); e < e_end; e += U) {
      int src[U], row[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // past the range's end: its last again
        const int ee = min(e + u, e_end - 1);
        src[u] = s_src[ee];
        row[u] = s_row[ee];
      }
      float v[U][CPL];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_row(part + (size_t)src[u] * d + lane * CPL, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e + u < e_end) {
          float a[CPL];
          load_row(my + row[u] * d, a);
          add_to(a, v[u]);
          store_row(my + row[u] * d, a);
        }
    }
    __syncthreads();  // the list and the scan's storage are reused
  }
  __syncthreads();
  if (warp < R && lo + warp < V) {
    float sum[CPL];
    load_row(s_sum + warp * d + lane * CPL, sum);
    for (int w = 1; w < kWarps2; ++w) {
      float v[CPL];
      load_row(s_sum + (w * kMaxTile + warp) * d + lane * CPL, v);
      add_to(sum, v);
    }
    store_row(out + (size_t)(lo + warp) * d + lane * CPL, sum);
  }
}

// n <= kSmallN (a user table's one id a sequence): one pass, no
// workspace.  Warp w of the block owns table row 8 * blockIdx.x + w; it
// finds the row's ids with ballots over the n ids (in shared memory) and
// adds their ct rows in position order, kUnroll rows in flight.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads2) dtable_small(
    const T* __restrict__ ct, const int* __restrict__ ids, int n, int V,
    T* __restrict__ out) {
  constexpr int d = CPL * 32;
  __shared__ int s_ids[kSmallN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  s_ids[tid] = tid < n ? ids[tid] : -1;
  __syncthreads();
  const int row = blockIdx.x * kSmallTile + warp;
  if (row >= V) return;
  float acc[CPL];
  zero(acc);
  for (int g = 0; g < n; g += 32) {
    unsigned mask = __ballot_sync(kFull, s_ids[g + lane] == row);
    while (mask) {
      int at[kUnroll<CPL>];
      int got = 0;
#pragma unroll
      for (int u = 0; u < kUnroll<CPL>; ++u) {
        at[u] = g + (mask ? __ffs(mask) - 1 : 0);
        got += mask != 0;
        mask &= mask - 1;
      }
      float v[kUnroll<CPL>][CPL];
#pragma unroll
      for (int u = 0; u < kUnroll<CPL>; ++u)
        load_row(ct + (size_t)(u < got ? at[u] : at[0]) * d + lane * CPL, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll<CPL>; ++u)
        if (u < got) add_to(acc, v[u]);
    }
  }
  store_row(out + (size_t)row * d + lane * CPL, acc);
}

template <typename T, int CPL, int C>
cudaError_t launch_chunks(const T* ct, const int* ids, int n, int V,
                          float* part, int* run_id, int* run_count,
                          int device, cudaStream_t stream) {
  auto kernel = dtable_chunks<T, CPL, C>;
  constexpr int smem = 2 * Chunk<C>::kWarps * CPL * 32 * sizeof(float);
  static unsigned long long sized = 0;  // once per instantiation and device
  const unsigned long long bit = 1ull << (device & 63);
  if (!(sized & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized |= bit;
  }
  kernel<<<(n + C - 1) / C, Chunk<C>::kThreads, smem, stream>>>(
      ct, ids, n, V, part, run_id, run_count);
  return cudaGetLastError();
}

template <typename T, int CPL>
cudaError_t launch(const void* ct_, const int* ids, int n, int V, int chunk,
                   void* ws, void* out_, int device, cudaStream_t stream) {
  constexpr int d = CPL * 32;
  const T* ct = static_cast<const T*>(ct_);
  T* out = static_cast<T*>(out_);
  if (chunk == 0) {
    if (n > kSmallN) return cudaErrorInvalidValue;
    dtable_small<T, CPL><<<(V + kSmallTile - 1) / kSmallTile, kThreads2, 0,
                           stream>>>(ct, ids, n, V, out);
    return cudaGetLastError();
  }
  float* part = static_cast<float*>(ws);
  int* run_id = reinterpret_cast<int*>(part + (size_t)n * d);
  int* run_count = run_id + n;
  cudaError_t err;
  switch (chunk) {
    case 256:
      err = launch_chunks<T, CPL, 256>(ct, ids, n, V, part, run_id, run_count,
                                       device, stream);
      break;
    case 1024:
      err = launch_chunks<T, CPL, 1024>(ct, ids, n, V, part, run_id,
                                        run_count, device, stream);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  // rows a block: at least 256 blocks where the table allows
  const int R = V >= 2048 ? 8 : V >= 1024 ? 4 : V >= 512 ? 2 : 1;
  auto rows = dtable_rows<T, CPL>;
  constexpr int smem = kWarps2 * kMaxTile * d * sizeof(float);
  static unsigned long long sized = 0;  // once per instantiation and device
  const unsigned long long bit = 1ull << (device & 63);
  if (!(sized & bit)) {
    err = cudaFuncSetAttribute(
        rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized |= bit;
  }
  rows<<<(V + R - 1) / R, kThreads2, smem, stream>>>(
      part, run_id, run_count, chunk, (n + chunk - 1) / chunk, V, R, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* ct, const int* ids, int n, int V,
                     int chunk, void* ws, void* out, int device,
                     cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 1>(ct, ids, n, V, chunk, ws, out, device, s);
    case 64: return launch<T, 2>(ct, ids, n, V, chunk, ws, out, device, s);
    case 128: return launch<T, 4>(ct, ids, n, V, chunk, ws, out, device, s);
    case 256: return launch<T, 8>(ct, ids, n, V, chunk, ws, out, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ct [n, d] f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned;
// ids [n] int32; out [V, d] in ct's type; chunk 0 (one pass, n <= 256,
// no ws) or 256 or 1024 ids a first-pass block, with ws 4 * (n * d
// + n + ceil(n / chunk)) bytes (dtable_plan in the wrapper picks both);
// all device pointers to contiguous arrays; d is 32, 64, 128 or 256;
// 0 <= V <= 4,194,303.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int dtable_launch(int is_bf16, const void* ct, const void* ids,
                             void* out, void* ws, int n, int V, int d,
                             int chunk, int device, void* stream) {
  if (V <= 0) return cudaSuccess;
  if (V > kMaxVocab) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const int* id = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(d, ct, id, n, V, chunk, ws, out, device,
                                   s);
  return launch_d<float>(d, ct, id, n, V, chunk, ws, out, device, s);
}
