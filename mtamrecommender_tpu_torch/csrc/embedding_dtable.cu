// Embedding-table backward: dtable[v, :] = sum_n [ids[n] == v] * ct[n, :].
//
// Replaces: mtamrecommender_tpu/ops/pallas/embedding_kernel.py,
// _dtable_kernel (launched by _dtable_impl, the backward of take_dtable).
// ct is f32 or bf16 [n, d]; the sums run in f32 and the table [V, d] is
// written once in ct's type, with zeros for rows no id names.  Ids outside
// [0, V) match no row.
//
// What bounds it: bytes.  At the training step's shapes (n = 12,800 ids,
// d = 128) the call reads ct once (6.6 MB in f32) and writes the table
// (1.9 MB for the 3,712-row item table): ~2.5 us at 3.35 TB/s; the adds
// are ~1.6 MFLOP.  What makes it hard is the ids: about half of a step's
// ids are the padding id 0, and every position id repeats ~256 times, so
// one row may collect thousands of cotangent rows.
//
// Design: the TPU kernel's tiled one-hot (a [chunk, 128-row] one-hot
// contracted with ct on the MXU) turned into gathers, with a fixed
// summation order and no float atomics, so a training step gives the same
// bits on every run.  dtable_partial: block (tile, segment) owns R table
// rows and one segment of the ids.  It streams its ids through shared
// memory 256 at a time, compacts the ones that fall in its rows into an
// ordered list (warp ballots and a prefix over the 8 warps), and warp w
// adds list entries w, w+8, w+16, ... into its own f32 accumulator
// [R, d] in shared memory, 8 entries' rows loaded at once per lane.  The
// block then sums its 8 warp accumulators in order into an f32 partial
// [S, V, d].  dtable_finish sums the S segment partials in order and
// rounds once to ct's type.  Segments bound a heavy row's serial chain:
// row 0's ~6,400 entries split over up to 16 segments and 8 warps.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                  // table rows per block
constexpr int kUnroll = 8;                 // entries a warp loads at once
constexpr int kMaxSegments = 16;
constexpr int kIdsPerSegment = 1024;       // aim; rounded to kThreads

template <typename T, int CPL>  // CPL = d / 32 columns per lane
__global__ void __launch_bounds__(kThreads) dtable_partial(
    const T* __restrict__ ct, const int* __restrict__ ids, int n, int V,
    int seg_len, float* __restrict__ partial) {
  constexpr int d = CPL * 32;
  extern __shared__ __align__(16) float acc[];  // [kWarps][kRows][d]
  __shared__ int s_n[kThreads];
  __shared__ int s_row[kThreads];
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = blockIdx.x * kRows;
  const int s = blockIdx.y;
  const int n_begin = s * seg_len;
  const int n_end = min(n, n_begin + seg_len);
  const int hi = min(V, lo + kRows);

  for (int i = tid; i < kWarps * kRows * d; i += kThreads) acc[i] = 0.f;
  float* my = acc + warp * kRows * d;
  __syncthreads();

  for (int base = n_begin; base < n_end; base += kThreads) {
    const int i = base + tid;
    const int id = i < n_end ? ids[i] : -1;
    const bool hit = id >= lo && id < hi;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (hit) {
      const int pos = off + __popc(mask & ((1u << lane) - 1u));
      s_n[pos] = i;
      s_row[pos] = id - lo;
    }
    __syncthreads();
    // warp w takes entries w, w + kWarps, ... in list (= id) order
    for (int e0 = warp; e0 < total; e0 += kWarps * kUnroll) {
      float v[kUnroll][CPL];
      int row[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kWarps;
        row[u] = e < total ? s_row[e] : -1;
        const size_t src = e < total ? (size_t)s_n[e] * d : 0;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          v[u][c] = e < total ? port::to_float(ct[src + lane + 32 * c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row[u] < 0) continue;
#pragma unroll
        for (int c = 0; c < CPL; ++c) my[row[u] * d + lane + 32 * c] += v[u][c];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    if (lo + r >= V) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += acc[(w * kRows + r) * d + c];
    partial[((size_t)s * V + lo + r) * d + c] = sum;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void dtable_finish(const float* __restrict__ partial, int S,
                              size_t size, T* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += partial[(size_t)s * size + i];
  store(out + i, sum);
}

void segments(int n, int* S, int* seg_len) {
  int want = (n + kIdsPerSegment - 1) / kIdsPerSegment;
  want = want < 1 ? 1 : (want > kMaxSegments ? kMaxSegments : want);
  int per = (n + want - 1) / want;
  per = (per + kThreads - 1) / kThreads * kThreads;
  *seg_len = per < kThreads ? kThreads : per;
  *S = n <= 0 ? 1 : (n + *seg_len - 1) / *seg_len;
}

template <typename T, int CPL>
cudaError_t launch(const void* ct, const int* ids, int n, int V, float* ws,
                   void* out, cudaStream_t stream) {
  int S, seg_len;
  segments(n, &S, &seg_len);
  const int d = CPL * 32;
  auto kernel = dtable_partial<T, CPL>;
  const size_t smem = (size_t)kWarps * kRows * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((V + kRows - 1) / kRows, S);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(ct), ids, n,
                                           V, seg_len, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t size = (size_t)V * d;
  dtable_finish<T><<<(unsigned)((size + 255) / 256), 256, 0, stream>>>(
      ws, S, size, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* ct, const int* ids, int n, int V,
                     float* ws, void* out, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 1>(ct, ids, n, V, ws, out, stream);
    case 64: return launch<T, 2>(ct, ids, n, V, ws, out, stream);
    case 128: return launch<T, 4>(ct, ids, n, V, ws, out, stream);
    case 256: return launch<T, 8>(ct, ids, n, V, ws, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of f32 workspace a launch with n ids into a [V, d] table needs.
extern "C" long long dtable_workspace_floats(int n, int V, int d) {
  int S, seg_len;
  segments(n, &S, &seg_len);
  return (long long)S * V * d;
}

// ct [n, d] f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), ids [n] int32, out
// [V, d] in ct's type, ws dtable_workspace_floats f32; all device pointers
// to contiguous arrays; d is 32, 64, 128 or 256.  Returns the cudaError_t
// of the launches (0 on success).
extern "C" int dtable_launch(int is_bf16, const void* ct, const void* ids,
                             void* out, void* ws, int n, int V, int d,
                             int device, void* stream) {
  if (V <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int* id = static_cast<const int*>(ids);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(d, ct, id, n, V, w, out, s);
  return launch_d<float>(d, ct, id, n, V, w, out, s);
}
