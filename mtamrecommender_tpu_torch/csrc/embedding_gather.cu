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
// What bounds them: bytes.  gather reads n rows and writes n rows (at the
// L = 2048 cell: n = 131,072 ids, d = 128, 64 MB each way in f32, ~40 us
// at 3.35 TB/s); scatter_add reads grad once and writes the table.  What
// makes scatter_add hard is the order: a row's adds form one dependent
// chain (at that cell each of the ~19 category rows collects ~6,900 of
// them), so the chain's latency, not bandwidth, sets its time.
//
// Design.  gather: one warp per row, lanes over the row in the widest
// word (16, 8, 4 or 2 bytes) that divides it, so an f32 d = 128 row is one
// 16-byte load a lane.  scatter_add, with no float atomics:
//   1. scatter_count: one warp per segment of 1,024 ids counts each id's
//      occurrences in its segment (__match_any_sync groups a step's equal
//      ids; int adds, one owner per segment, so the counts are exact);
//   2. scatter_offsets: one block turns them into each id's run start and
//      each segment's offset inside the run (an exclusive scan);
//   3. scatter_place: each segment's warp walks its ids again in order and
//      writes position i to its slot, so every id's run lists its
//      positions in ascending order (embedding_dtable.cu's ordered list,
//      built once for the whole table);
//   4. scatter_sum: one warp per table row walks its run in order, lanes
//      over d, 16 rows' loads in flight at once, adding and rounding
//      after each add; a row no id names is written as zeros.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSegment = 1024;     // ids a counting / placing warp owns
constexpr int kUnroll = 16;        // a row chain's loads in flight

// ---------------------------------------------------------------- gather

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

// ----------------------------------------------------------- scatter_add

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
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? id : -1);
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
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? s_warp[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
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
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? id : -1);
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
    for (int e0 = begin; e0 < end; e0 += kUnroll) {
      float x[kUnroll][CPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u;
        const size_t src = e < end ? (size_t)sorted[e] * d : 0;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          x[u][c] = e < end ? port::to_float(grad[src + lane + 32 * c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
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

template <typename T, int CPL>
cudaError_t launch_scatter(const void* grad, const int* ids, void* out, int n,
                           int V, int* ws, cudaStream_t stream) {
  const int S = segments(n);
  int* count = ws;                              // [S][V]
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
  scatter_sum<T, CPL><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(grad), start, sorted, V, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scatter_d(int d, const void* grad, const int* ids,
                             void* out, int n, int V, int* ws,
                             cudaStream_t stream) {
  switch (d) {
    case 32: return launch_scatter<T, 1>(grad, ids, out, n, V, ws, stream);
    case 64: return launch_scatter<T, 2>(grad, ids, out, n, V, ws, stream);
    case 128: return launch_scatter<T, 4>(grad, ids, out, n, V, ws, stream);
    case 256: return launch_scatter<T, 8>(grad, ids, out, n, V, ws, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table [V, row_bytes] of any type, ids [n] int32, out [n, row_bytes];
// device pointers to contiguous arrays, row_bytes even.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gather_launch(const void* table, const void* ids, void* out,
                             int n, int V, long long row_bytes, int device,
                             void* stream) {
  if (n <= 0 || row_bytes <= 0) return cudaSuccess;
  if (row_bytes % 2 != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* id = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rb = (size_t)row_bytes;
  if (rb % 16 == 0) return launch_gather<uint4>(table, id, out, n, V, rb, s);
  if (rb % 8 == 0) return launch_gather<uint2>(table, id, out, n, V, rb, s);
  if (rb % 4 == 0)
    return launch_gather<unsigned int>(table, id, out, n, V, rb, s);
  return launch_gather<unsigned short>(table, id, out, n, V, rb, s);
}

// Ints of workspace a scatter_add of n ids into V rows needs.
extern "C" long long scatter_workspace_ints(int n, int V) {
  return (long long)segments(n) * V + V + 1 + (n > 0 ? n : 0);
}

// grad [n, d] f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), ids [n] int32, out
// [V, d] in grad's type, ws scatter_workspace_ints int32; device pointers
// to contiguous arrays; d is 32, 64, 128 or 256.  Returns the cudaError_t
// of the launches (0 on success).
extern "C" int scatter_add_launch(int is_bf16, const void* grad,
                                  const void* ids, void* out, void* ws, int n,
                                  int V, int d, int device, void* stream) {
  if (V <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* id = static_cast<const int*>(ids);
  int* w = static_cast<int*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_scatter_d<__nv_bfloat16>(d, grad, id, out, n, V, w, s);
  return launch_scatter_d<float>(d, grad, id, out, n, V, w, s);
}
