// MTAM's fused multi-hop readout, forward: every hop of the Tq=1
// time-aware attention over a row's behaviour memory, projections
// included, in one launch (the hop is in readout_hop.cuh).
//
// Replaces: mtamrecommender_tpu/ops/pallas/readout_kernel.py,
// _readout_kernel (body _hop_forward), launched by _readout_fwd.
// Returns the last hop's output, f32 [B, D].
//
// What bounds it: operations.  Per row and hop the K and V projections
// are 4 L D^2 FLOPs against L D input values: at B=64, L=512, D=128, 3 hops
// that is 6.4 GFLOP for 8.4 MB (bf16) of memory, well above the card's
// FLOP-per-byte line in f32 and bf16 alike.
//
// Design: one block of 256 threads per batch row, since each hop needs
// the whole row's softmax before the next hop's query exists.  A row's K
// and V at L=1024 do not fit in shared memory, so keys stream through it
// 64 at a time, twice per hop: the first pass projects K and keeps only
// the [L] f32 scores, the second projects V and accumulates the weighted
// sum.  The current weight matrix (f32, 64 KB at D=128) stays in shared
// memory during its pass; each warp computes 8 chunk rows x 128 columns
// with FMA on CUDA cores (no tensor cores yet).  At B=64 that is 64 busy
// SMs of 132, and 1 at B=1.  No float atomics: the same inputs give the
// same bits.

#include "readout_hop.cuh"

namespace {

using readout::HopSmem;
using readout::Params;

size_t smem_floats(int L, int D) {
  return (size_t)D * D + 2 * (size_t)readout::kChunk * D + L + 4 * (size_t)D;
}

template <typename T>
__global__ void __launch_bounds__(readout::kThreads)
    fused_readout_kernel(Params p, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[readout::kWarps];
  const int D = p.D, b = blockIdx.x;
  HopSmem sm;
  sm.w = smem;
  sm.m = sm.w + (size_t)D * D;
  sm.p = sm.m + readout::kChunk * D;
  sm.s = sm.p + readout::kChunk * D;
  sm.dec = sm.s + p.L;
  sm.decr = sm.dec + D;
  sm.q = sm.decr + D;
  sm.u = sm.q + D;
  readout::load_f32(sm.dec, readout::ptr<T>(p.dec) + (size_t)b * D, D);
  __syncthreads();
  for (int i = 0; i < p.n; ++i)
    readout::hop_forward<T>(p, i, b, sm, red, (T*)nullptr, (T*)nullptr);
  for (int e = threadIdx.x; e < D; e += readout::kThreads)
    out[(size_t)b * D + e] = sm.dec[e];
}

template <typename T>
cudaError_t run(const Params& p, float* out, cudaStream_t stream) {
  const size_t smem = smem_floats(p.L, p.D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_readout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_readout_kernel<T><<<p.B, readout::kThreads, smem, stream>>>(p, out);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the kernel, in bytes.
extern "C" long long fused_readout_smem_bytes(int L, int D) {
  return (long long)smem_floats(L, D) * (long long)sizeof(float);
}

// All pointers are device pointers to contiguous arrays: mem [B,L,D], dec
// [B,D], wq/wk/wv/wt [n,D,D], bq/bk/bv/lng/lnb [n,D], all f32 (is_bf16 =
// 0) or all bf16 (is_bf16 = 1); logdt [B,L], qmask [B] and
// w1/b1/wo1/wo2/bo [n,L] f32; key_len [B] int32; out [B,D] f32.  D is 32,
// 64 or 128.  Returns the launch's cudaError_t (0 on success).
extern "C" int fused_readout_launch(
    int is_bf16, const void* mem, const void* dec, const void* logdt,
    const void* key_len, const void* qmask, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wt, const void* w1, const void* b1, const void* wo1,
    const void* wo2, const void* bo, const void* lng, const void* lnb,
    void* out, int B, int L, int D, int n, float scale, int device,
    void* stream) {
  if (B <= 0) return cudaSuccess;
  if (L <= 0 || n <= 0 || D <= 0 || D > readout::kMaxD || D % 32)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  p.mem = mem; p.dec = dec;
  p.logdt = static_cast<const float*>(logdt);
  p.key_len = static_cast<const int*>(key_len);
  p.qmask = static_cast<const float*>(qmask);
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk; p.wv = wv; p.bv = bv; p.wt = wt;
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.wo1 = static_cast<const float*>(wo1);
  p.wo2 = static_cast<const float*>(wo2);
  p.bo = static_cast<const float*>(bo);
  p.lng = lng; p.lnb = lnb;
  p.B = B; p.L = L; p.D = D; p.n = n;
  p.scale = scale;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(p, o, s) : run<float>(p, o, s);
}
